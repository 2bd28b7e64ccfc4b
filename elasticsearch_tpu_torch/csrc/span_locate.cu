// K4 span_locate: binary search of candidates in a sorted posting span.
//
// Replaces: elasticsearch_tpu/ops/bm25_device.py `_span_locate` (:949) and
// `_span_member` (:969), as used by `_sparse_lead_inner` (:875) and
// `_const_membership` (:815).
//
// Bound on an H100: bytes. The function must read each candidate (4 B) and
// write pos (4 B) and found (1 B); the log2(plane) probes per candidate are
// dependent random reads that mostly hit L2 (neighbouring candidates are
// doc-ascending, so they probe the same span regions).
//
// Design: one thread per candidate running exactly the reference's fixed
// max(1, bit_length(plane)) steps, with its int32 midpoint and clipping,
// so pos is bit-identical even for candidates outside the span. The span
// bounds are read from device memory (term_starts[j], term_ends[j]), so a
// plan's per-term rows never round-trip to the host.
#include "common.cuh"

__global__ void span_locate_kernel(
    const int32_t* __restrict__ flat,
    int64_t flat_len,
    const int32_t* __restrict__ starts,
    const int32_t* __restrict__ ends,
    int j,
    const int32_t* __restrict__ cands,
    int p,
    int steps,
    int32_t* __restrict__ pos_out,
    uint8_t* __restrict__ found_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p) {
        return;
    }
    const int32_t c = cands[i];
    int32_t lo = starts[j];
    int32_t hi = ends[j];
    const int32_t end = hi;
    const int64_t limit = flat_len - 1;
    for (int s = 0; s < steps; ++s) {
        const int32_t mid = (lo + hi) >> 1;
        const int64_t m = esk_clamp64(mid, 0, limit);
        const bool go = flat[m] < c;
        lo = go ? mid + 1 : lo;
        hi = go ? hi : mid;
    }
    const int64_t pos = esk_clamp64(lo, 0, limit);
    pos_out[i] = (int32_t)pos;
    found_out[i] = (lo < end && flat[pos] == c) ? 1 : 0;
}

extern "C" int esk_span_locate(
    const void* flat,
    long long flat_len,
    const void* starts,
    const void* ends,
    int j,
    const void* cands,
    int p,
    int steps,
    void* pos_out,
    void* found_out,
    void* stream) {
    if (p == 0) {
        return 0;
    }
    span_locate_kernel<<<esk_blocks(p, 256), 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)flat, (int64_t)flat_len, (const int32_t*)starts,
        (const int32_t*)ends, j, (const int32_t*)cands, p, steps,
        (int32_t*)pos_out, (uint8_t*)found_out);
    ESK_RETURN_IF_ERROR();
    return 0;
}
