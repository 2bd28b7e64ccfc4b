// K4 span_locate: binary search of candidates in a sorted posting span,
// for Q rows at once.
//
// Replaces: elasticsearch_tpu/ops/bm25_device.py `_span_locate` (:949) and
// `_span_member` (:969), as used by `_sparse_lead_inner` (:875) and
// `_const_membership` (:815) — solo, and under the vmap of
// `execute_batch_sparse` (:1050), where every row has its own span. A solo
// query is the row count Q = 1.
//
// Bound on an H100: bytes. The function must read each candidate (4 B) and
// write pos (4 B) and found (1 B); the log2(plane) probes per candidate are
// dependent random reads that mostly hit L2 (neighbouring candidates are
// doc-ascending, so they probe the same span regions).
//
// Design: one thread per (candidate, row) running exactly the reference's
// fixed max(1, bit_length(plane)) steps, with its int32 midpoint and
// clipping, so pos is bit-identical even for candidates outside the span.
// The span bounds are read from device memory (row q's starts[q, j],
// ends[q, j]), so a plan's per-term rows never round-trip to the host.
//
// Stacked mode (K4s; under the vmap of `execute_shards_batch` :1161): the
// flat plane is S shards' equal-length planes, [S, flat_len], and row r
// is the pair (query r / S, shard r % S), searching shard r % S's plane.
// S = 1 is the mode above.
#include "common.cuh"

__global__ void span_locate_kernel(
    const int32_t* __restrict__ flat,
    int64_t flat_len,
    const int32_t* __restrict__ starts,
    const int32_t* __restrict__ ends,
    int n_spans,
    int j,
    const int32_t* __restrict__ cands,
    int p,
    int steps,
    int32_t* __restrict__ pos_out,
    uint8_t* __restrict__ found_out,
    int n_shards) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p) {
        return;
    }
    const int64_t q = blockIdx.y;
    // One segment skips the shard offset: measured on the H100, a 64-bit
    // modulo in every thread cost this kernel 4-9 % at one and four rows.
    if (n_shards > 1) {
        flat += (int64_t)(blockIdx.y % (unsigned)n_shards) * flat_len;
    }
    const int64_t at = q * p + i;
    const int32_t c = cands[at];
    int32_t lo = starts[q * n_spans + j];
    int32_t hi = ends[q * n_spans + j];
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
    pos_out[at] = (int32_t)pos;
    found_out[at] = (lo < end && flat[pos] == c) ? 1 : 0;
}

// starts/ends i32[n_rows, n_spans], cands i32[n_rows, p]; outputs pos
// i32[n_rows, p] and found u8[n_rows, p] against row q's span j. flat is
// [n_shards, flat_len]; row q searches plane q % n_shards.
extern "C" int esk_span_locate(
    const void* flat,
    long long flat_len,
    const void* starts,
    const void* ends,
    int n_spans,
    int j,
    const void* cands,
    int n_rows,
    int p,
    int steps,
    void* pos_out,
    void* found_out,
    int n_shards,
    void* stream) {
    if (p == 0 || n_rows == 0 || n_shards <= 0) {
        return 0;
    }
    span_locate_kernel<<<dim3(esk_blocks(p, 256), n_rows), 256, 0,
                         (cudaStream_t)stream>>>(
        (const int32_t*)flat, (int64_t)flat_len, (const int32_t*)starts,
        (const int32_t*)ends, n_spans, j, (const int32_t*)cands, p, steps,
        (int32_t*)pos_out, (uint8_t*)found_out, n_shards);
    ESK_RETURN_IF_ERROR();
    return 0;
}
