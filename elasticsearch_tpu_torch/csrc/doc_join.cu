// K13 doc_join: the block join of nested documents to their parents, and
// the doc-set mark of ids queries, for Q rows at once.
//
// Replaces: elasticsearch_tpu/ops/bm25_device.py `_eval_nested` (:271),
// its scatters of the child's matches and sum / avg / max / min scores
// into parent space through `parent_of` (:283-319), and the `doc_set`
// scatter of `_eval_node` (:200-207), solo and under the vmap of
// `execute_batch` (a solo query is the row count Q = 1).
//
// Bound on an H100: bytes. Per row the join must read each nested doc's
// matched byte and score (NN x 5 B) and the CSR plane child_start
// ((N + 1) x 4 B), and write each parent's matched byte and score
// (N x 5 B); the mark mode reads the ids (ND x 4 B) and writes N x 5 B.
//
// Design (join mode): one thread per (row, parent) folds that parent's
// children [child_start[p], child_start[p + 1]) in ascending order, which
// is the order of the reference's scatter (XLA's CPU scatter applies the
// updates in index order, and the builder appends a parent's nested
// objects when it commits that parent, so parent_of is nondecreasing and
// each parent's children are one contiguous run). Neighbouring threads
// read neighbouring runs, so the loads coalesce. An atomic scatter would
// fold in no fixed order, and neither would torch.segment_reduce.
// Every step is the reference's composition, NaN bits included (XLA:CPU
// on x86; the card's arithmetic would return its canonical NaN):
//   sum / avg   acc = acc + v over the matched children from +0.0, a NaN
//               update replacing the sum, else a NaN sum staying, else
//               x86's default NaN where the add made one; avg divides by
//               max(count, 1), a NaN sum staying;
//   max / min   the NEG_INF sign trick: updates v (max) or -1 * v (min: a
//               NaN keeps its sign) fold into -inf through XLA's max (a
//               NaN wins; of two NaNs the accumulator if its sign is set,
//               else the update; +0.0 over -0.0), then -best for min (a
//               sign-bit flip, NaN included);
//   last        where(matched, reduced * boost, 0), a NaN operand of the
//               product surviving as it is; `none` scores 0.
// Mark mode: the outputs are zeroed on the stream, then one thread per
// (row, id) sets matched and boost at each id >= 0 (equal ids write equal
// values).
//
// Stacked mode (K13s; under the vmap of `execute_shards` /
// `execute_shards_batch` :1155-1168): child_start is S shards' CSR planes,
// [S, N + 1], and row r, the pair (query r / S, shard r % S), joins
// through shard r % S's; the child planes [R, NN] are the rows' own (the
// child evaluated over the stacked nested tree). The mark mode needs no
// stacked form: a row's ids are its shard's local ids. S = 1 is the mode
// above.
#include "common.cuh"

#define ESK_JOIN_NONE 0
#define ESK_JOIN_SUM 1
#define ESK_JOIN_AVG 2
#define ESK_JOIN_MAX 3
#define ESK_JOIN_MIN 4

__device__ __forceinline__ bool esk_isnan(float x) { return x != x; }

__device__ __forceinline__ float esk_default_nan() {
    return __uint_as_float(0xffc00000u);
}

// r, with a NaN result replaced by the first NaN operand, else by x86's
// default NaN where the operation made it.
__device__ __forceinline__ float esk_propagate(float r, float a, float b) {
    if (!esk_isnan(r)) {
        return r;
    }
    if (esk_isnan(a)) {
        return a;
    }
    if (esk_isnan(b)) {
        return b;
    }
    return esk_default_nan();
}

// The scatter's add: a NaN update wins, then a NaN accumulator.
__device__ __forceinline__ float esk_scatter_add(float acc, float v) {
    if (esk_isnan(v)) {
        return v;
    }
    if (esk_isnan(acc)) {
        return acc;
    }
    const float r = __fadd_rn(acc, v);
    return esk_isnan(r) ? esk_default_nan() : r;
}

// The scatter's max.
__device__ __forceinline__ float esk_scatter_max(float acc, float v) {
    const bool na = esk_isnan(acc);
    const bool nv = esk_isnan(v);
    if (na && nv) {
        return (__float_as_uint(acc) >> 31) ? acc : v;
    }
    if (na) {
        return acc;
    }
    if (nv) {
        return v;
    }
    if (acc == v) {  // equal values, or +0.0 against -0.0: +0.0 wins
        return (__float_as_uint(acc) == 0u) ? acc : v;
    }
    return acc > v ? acc : v;
}

__global__ void doc_join_kernel(
    const uint8_t* __restrict__ child_matched,
    const float* __restrict__ child_scores,
    const int32_t* __restrict__ child_start,
    const float* __restrict__ boost,
    int nn,
    int n,
    int mode,
    int n_shards,
    uint8_t* __restrict__ matched_out,
    float* __restrict__ scores_out) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) {
        return;
    }
    const int64_t row = blockIdx.y;
    if (n_shards > 1) {
        child_start += (row % n_shards) * ((int64_t)n + 1);
    }
    const uint8_t* cm = child_matched + row * nn;
    const float* cs = child_scores + row * nn;
    const int lo = child_start[p];
    const int hi = child_start[p + 1];
    const bool extremum = mode == ESK_JOIN_MAX || mode == ESK_JOIN_MIN;
    float acc = extremum ? -ESK_INF : 0.0f;
    float count = 0.0f;
    bool any = false;
    for (int c = lo; c < hi; ++c) {
        if (!cm[c]) {
            continue;
        }
        any = true;
        const float v = cs[c];
        if (extremum) {
            const float u = (mode == ESK_JOIN_MIN && !esk_isnan(v))
                ? __uint_as_float(__float_as_uint(v) ^ 0x80000000u) : v;
            acc = esk_scatter_max(acc, u);
        } else {
            acc = esk_scatter_add(acc, v);
            count = __fadd_rn(count, 1.0f);
        }
    }
    const int64_t at = row * n + p;
    matched_out[at] = any ? 1 : 0;
    float reduced = acc;
    if (mode == ESK_JOIN_NONE || !any) {
        scores_out[at] = 0.0f;
        return;
    }
    if (mode == ESK_JOIN_AVG) {
        const float denom = count > 1.0f ? count : 1.0f;
        reduced = esk_propagate(__fdiv_rn(acc, denom), acc, denom);
    } else if (mode == ESK_JOIN_MIN) {
        reduced = __uint_as_float(__float_as_uint(acc) ^ 0x80000000u);
    }
    const float b = boost[row];
    scores_out[at] = esk_propagate(__fmul_rn(reduced, b), reduced, b);
}

__global__ void doc_mark_kernel(
    const int32_t* __restrict__ ids,
    int nd,
    const float* __restrict__ boost,
    int n,
    uint8_t* __restrict__ matched_out,
    float* __restrict__ scores_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nd) {
        return;
    }
    const int64_t row = blockIdx.y;
    const int32_t d = ids[row * nd + i];
    if (d < 0 || d >= n) {
        return;
    }
    matched_out[row * n + d] = 1;
    scores_out[row * n + d] = boost[row];
}

// Join mode: child_matched u8[n_rows, nn], child_scores f32[n_rows, nn],
// child_start i32[n + 1], boost f32[n_rows] -> matched u8[n_rows, n],
// scores f32[n_rows, n] under `mode` (ESK_JOIN_*); stacked: n_shards > 1
// and child_start i32[n_shards, n + 1].
extern "C" int esk_doc_join(
    const void* child_matched,
    const void* child_scores,
    const void* child_start,
    const void* boost,
    int n_rows,
    int nn,
    int n,
    int mode,
    int n_shards,
    void* matched_out,
    void* scores_out,
    void* stream) {
    if (n == 0 || n_rows == 0) {
        return 0;
    }
    doc_join_kernel<<<dim3(esk_blocks(n, 256), n_rows), 256, 0,
                      (cudaStream_t)stream>>>(
        (const uint8_t*)child_matched, (const float*)child_scores,
        (const int32_t*)child_start, (const float*)boost, nn, n, mode,
        n_shards, (uint8_t*)matched_out, (float*)scores_out);
    ESK_RETURN_IF_ERROR();
    return 0;
}

// Mark mode: ids i32[n_rows, nd] (-1 padding), boost f32[n_rows] ->
// matched u8[n_rows, n], scores f32[n_rows, n] (boost where matched).
extern "C" int esk_doc_mark(
    const void* ids,
    const void* boost,
    int n_rows,
    int nd,
    int n,
    void* matched_out,
    void* scores_out,
    void* stream) {
    if (n == 0 || n_rows == 0) {
        return 0;
    }
    cudaStream_t s = (cudaStream_t)stream;
    cudaMemsetAsync(matched_out, 0, (size_t)n_rows * n, s);
    cudaMemsetAsync(scores_out, 0, (size_t)n_rows * n * sizeof(float), s);
    ESK_RETURN_IF_ERROR();
    if (nd > 0) {
        doc_mark_kernel<<<dim3(esk_blocks(nd, 256), n_rows), 256, 0, s>>>(
            (const int32_t*)ids, nd, (const float*)boost, n,
            (uint8_t*)matched_out, (float*)scores_out);
        ESK_RETURN_IF_ERROR();
    }
    return 0;
}
