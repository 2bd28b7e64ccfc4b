// K15 chain_perturb: one step of the strictly sequential chains, the
// plan's top-level leaf perturbed by an exactly-zero term derived from the
// previous step's total.
//
// Replaces: elasticsearch_tpu/ops/bm25_device.py `_chain_perturb` (:1085)
// with the scan carry of `execute_sequential_sparse` (:1058),
// `execute_sequential` (:1105), `execute_shards_sequential` (:1171) and
// `execute_rescore_sequential` (:1225): `eps = optimization_barrier(carry)
// * 0.0`, then `leaf + eps`, where the carry is the previous step's total
// hit count as f32 (0.0 before the first step).
//
// Bound on an H100: bytes. The step reads each leaf element (4 B) and the
// previous total (4 B) once and writes each output element (4 B) once.
// The leaves are a plan's boost (one value a row) or its term weights (a
// few dozen), so a launch is bound by its own cost.
//
// Design: one thread per element. The total is read on the device, so the
// host never waits for step q - 1 before it enqueues step q, and step q's
// work cannot start before step q - 1's total exists: the stream orders
// them, as the scan's data dependency orders the reference's iterations.
// out[i] = leaf[i] + (float)total * 0.0f in IEEE fp32 (no contraction,
// explicit round-to-nearest): totals are finite and never negative, so the
// term is +0.0 and every finite leaf keeps its bits, except -0.0, which
// becomes +0.0, as in the reference's chain. A NaN leaf is returned as the
// quieted operand (its sign and payload, quiet bit set), which is what
// XLA:CPU's add returns; the card's add would return its canonical NaN
// 0x7fffffff instead. A null total (the first step) reads as 0. The output
// is a new buffer: the staged plan is never written.
#include "common.cuh"

__global__ void chain_perturb_kernel(
    const float* __restrict__ leaf,
    const int32_t* __restrict__ prev_total,
    int64_t n,
    float* __restrict__ out) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) {
        return;
    }
    const float carry = prev_total ? __int2float_rn(*prev_total) : 0.0f;
    const float eps = __fmul_rn(carry, 0.0f);
    const float x = leaf[i];
    out[i] = x != x ? __uint_as_float(__float_as_uint(x) | 0x00400000u)
                    : __fadd_rn(x, eps);
}

// leaf f32[n], prev_total i32[1] on the device or null -> out f32[n].
extern "C" int esk_chain_perturb(
    const void* leaf,
    const void* prev_total,
    long long n,
    void* out,
    void* stream) {
    if (n == 0) {
        return 0;
    }
    chain_perturb_kernel<<<esk_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const float*)leaf, (const int32_t*)prev_total, (int64_t)n,
        (float*)out);
    ESK_RETURN_IF_ERROR();
    return 0;
}
