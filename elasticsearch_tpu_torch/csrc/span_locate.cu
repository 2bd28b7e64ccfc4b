// K4 span_locate: binary search of candidates in a sorted posting span,
// for Q rows at once; and its fold mode, a filter-led conjunction's must
// terms searched and scored in one launch.
//
// Replaces: elasticsearch_tpu/ops/bm25_device.py `_span_locate` (:949) and
// `_span_member` (:969), as used by `_sparse_lead_inner` (:875) and
// `_const_membership` (:815) — solo, and under the vmap of
// `execute_batch_sparse` (:1050), where every row has its own span. A solo
// query is the row count Q = 1. The fold mode replaces the must-term loop
// of `_sparse_lead_inner` (:911-919): per term, the search, the tn gather,
// the contribution and the fold into the score and the matched mask.
//
// Bound on an H100: bytes. The function must read each candidate (4 B) and
// write pos (4 B) and found (1 B); the probes per candidate are dependent
// random reads that mostly hit L2 (neighbouring candidates are
// doc-ascending, so they probe the same span regions). At cfg2's sizes a
// launch is a few microseconds of device time, below its wrapper's host
// time (ops/kernels.py `_launch` keeps that short).
//
// Design: one thread per (candidate, row) running the reference's search
// with its int32 midpoint and clipping. The reference runs a fixed
// max(1, bit_length(plane)) steps of a deterministic map of (lo, hi):
// mid = (lo + hi) >> 1, go = flat[clip(mid)] < c, lo = go ? mid + 1 : lo,
// hi = go ? hi : mid. A step that leaves (lo, hi) unchanged leaves every
// later step unchanged too (the map depends on nothing else), so a thread
// stops at the first such step, within the same bound of steps, and ends
// in the reference's state bit for bit, including the step past the span
// (lo = hi, flat[min(end, limit)] < c moves lo to end + 1, and the next
// step confirms it). The probes fall from bit_length(plane) to about
// log2(span) + 2. The span bounds are read from device memory (row q's
// starts[q, j], ends[q, j]), so a plan's per-term rows never round-trip to
// the host.
//
// Fold mode: candidates i32[Q, P] (the reference's `safe`), in_range
// bool[Q, P] (cand != num_docs), the must terms' spans and weights [Q, T],
// the flat doc and tn planes. Each thread takes one (row, candidate) and,
// for each term j in order, searches, reads tn at pos where found, and
// folds score = score + (found ? w - w / (1 + tn) : +0.0) from +0.0, each
// operation rounded on its own (the file builds with -fmad=false
// -prec-div=true), and matched |= found, found including in_range. One
// launch writes score f32[Q, P] and matched bool[Q, P]: the T searches, T
// gathers and ~9T elementwise launches of the loop become one.
//
// Stacked mode (K4s; under the vmap of `execute_shards_batch` :1161): the
// flat planes are S shards' equal-length planes, [S, flat_len], and row r
// is the pair (query r / S, shard r % S), searching shard r % S's plane.
// S = 1 is the mode above. The fold mode takes the same rows.
#include "common.cuh"

// The reference's search of c from (lo, hi) = (start, end), at most
// `steps` steps, leaving at the first step that changes neither bound.
// Returns lo.
__device__ __forceinline__ int32_t span_search(const int32_t* __restrict__ flat,
                                               int64_t limit, int32_t lo,
                                               int32_t hi, int32_t c,
                                               int steps) {
    for (int s = 0; s < steps; ++s) {
        const int32_t mid = (lo + hi) >> 1;
        const bool go = flat[esk_clamp64(mid, 0, limit)] < c;
        const int32_t nlo = go ? mid + 1 : lo;
        const int32_t nhi = go ? hi : mid;
        if (nlo == lo && nhi == hi) {
            break;
        }
        lo = nlo;
        hi = nhi;
    }
    return lo;
}

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
    const int32_t end = ends[q * n_spans + j];
    const int64_t limit = flat_len - 1;
    const int32_t lo =
        span_search(flat, limit, starts[q * n_spans + j], end, c, steps);
    const int64_t pos = esk_clamp64(lo, 0, limit);
    pos_out[at] = (int32_t)pos;
    found_out[at] = (lo < end && flat[pos] == c) ? 1 : 0;
}

__global__ void span_fold_kernel(
    const int32_t* __restrict__ flat,
    const float* __restrict__ tn,
    int64_t flat_len,
    const int32_t* __restrict__ starts,
    const int32_t* __restrict__ ends,
    const float* __restrict__ weights,
    int n_terms,
    const int32_t* __restrict__ cands,
    const uint8_t* __restrict__ in_range,
    int p,
    int steps,
    float* __restrict__ score_out,
    uint8_t* __restrict__ matched_out,
    int n_shards) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p) {
        return;
    }
    const int64_t q = blockIdx.y;
    if (n_shards > 1) {
        const int64_t off = (int64_t)(blockIdx.y % (unsigned)n_shards) * flat_len;
        flat += off;
        tn += off;
    }
    const int64_t at = q * p + i;
    const int32_t c = cands[at];
    const bool live = in_range[at] != 0;
    const int64_t limit = flat_len - 1;
    const int64_t row = q * n_terms;
    float score = 0.0f;
    bool matched = false;
    for (int j = 0; j < n_terms; ++j) {
        const int32_t end = ends[row + j];
        const int32_t lo = span_search(flat, limit, starts[row + j], end, c, steps);
        const int64_t pos = esk_clamp64(lo, 0, limit);
        const bool found = live && lo < end && flat[pos] == c;
        float contrib = 0.0f;
        if (found) {
            const float w = weights[row + j];
            contrib = __fsub_rn(w, __fdiv_rn(w, __fadd_rn(1.0f, tn[pos])));
        }
        score = __fadd_rn(score, contrib);
        matched = matched || found;
    }
    score_out[at] = score;
    matched_out[at] = matched ? 1 : 0;
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

// The fold mode: flat (i32) and tn (f32) are [n_shards, flat_len];
// starts/ends i32 and weights f32 [n_rows, n_terms]; cands i32 and
// in_range u8 [n_rows, p]; outputs score f32 and matched u8 [n_rows, p].
extern "C" int esk_span_fold(
    const void* flat,
    const void* tn,
    long long flat_len,
    const void* starts,
    const void* ends,
    const void* weights,
    int n_terms,
    const void* cands,
    const void* in_range,
    int n_rows,
    int p,
    int steps,
    void* score_out,
    void* matched_out,
    int n_shards,
    void* stream) {
    if (p == 0 || n_rows == 0 || n_shards <= 0) {
        return 0;
    }
    span_fold_kernel<<<dim3(esk_blocks(p, 256), n_rows), 256, 0,
                       (cudaStream_t)stream>>>(
        (const int32_t*)flat, (const float*)tn, (int64_t)flat_len,
        (const int32_t*)starts, (const int32_t*)ends, (const float*)weights,
        n_terms, (const int32_t*)cands, (const uint8_t*)in_range, p, steps,
        (float*)score_out, (uint8_t*)matched_out, n_shards);
    ESK_RETURN_IF_ERROR();
    return 0;
}
