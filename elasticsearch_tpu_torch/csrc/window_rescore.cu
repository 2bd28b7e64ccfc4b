// K5 window_rescore: the rescore window's gather, combine and top-k, for Q
// rows at once.
//
// Replaces: in elasticsearch_tpu/ops/bm25_device.py, `_rescore_inner`
// (:1197, under `execute_rescore` :1216) from the gather of the rescore
// plane at the window's ids to its `lax.top_k` (fused mode), and the
// gather of `scores_at` (:1835; gather mode). The window itself comes
// from K1-K4 (`_inner_for(spec)` at k = window), the rescore plane from
// the dense evaluation (K1, K6).
//
// Bound on an H100: launch latency. A row reads its W window scores and
// ids (8 B each) and gathers W scores and eligible bytes (5 B each) from
// the rescore plane: under 20 KB for BASELINE config 4's window of 1,000.
//
// Design: one block per row (Q rows in one launch).
//   Gather mode: out_s[j] = eligible[ids[j]] ? scores[ids[j]] : 0.0,
//   out_m[j] = eligible[ids[j]] — `where(eligible, scores, 0)[ids]` and
//   `eligible[ids]`.
//   Fused mode: for window position j with first-phase score s and doc
//   ids[j], rs/rm as above; comb = rm ? qw*s + rw*rs : qw*s, or -inf where
//   s is -inf (a padding slot). Each product and the sum round on their
//   own (__fmul_rn / __fadd_rn, and the file builds with -fmad=false), as
//   the reference's and torch's separate ops do. The block sorts the
//   window's composites (total-order bits of comb above the inverted
//   position, common.cuh) in shared memory, which is lax.top_k's order:
//   comb descending, lower window position first; it returns the top
//   min(k, W) combined scores and the doc ids at their positions. The
//   shared window is the power of two above W: 8 KB at W = 1,000, 128 KB at
//   the node's largest window (10,000, padded to 16,384), which takes
//   dynamic shared memory above 48 KB; a longer window is refused.
//   Out-of-range ids clamp to [0, N - 1], as JAX's gather clamps.
#include "common.cuh"

#define WR_THREADS 1024

__device__ __forceinline__ int64_t wr_doc(const int32_t* ids, int64_t j,
                                          int64_t n) {
    return esk_clamp64((int64_t)ids[j], 0, n - 1);
}

__global__ void window_gather_kernel(
    const float* __restrict__ scores, const uint8_t* __restrict__ eligible,
    int64_t n, const int32_t* __restrict__ ids, int w,
    float* __restrict__ out_s, uint8_t* __restrict__ out_m) {
    const int64_t q = blockIdx.x;
    const float* sc = scores + q * n;
    const uint8_t* el = eligible + q * n;
    for (int j = threadIdx.x; j < w; j += blockDim.x) {
        const int64_t d = wr_doc(ids, q * w + j, n);
        const bool e = el[d] != 0;
        out_s[q * w + j] = e ? sc[d] : 0.0f;
        out_m[q * w + j] = e;
    }
}

// comb at window position j of row q.
__device__ __forceinline__ float wr_comb(
    const float* __restrict__ s, const int32_t* __restrict__ ids,
    const float* __restrict__ rscores, const uint8_t* __restrict__ relig,
    int64_t n, int64_t q, int w, int j, float qw, float rw) {
    const float sv = s[q * w + j];
    const int64_t d = wr_doc(ids, q * w + j, n);
    const bool rm = relig[q * n + d] != 0;
    const float a = __fmul_rn(qw, sv);
    float comb = a;
    if (rm) {
        comb = __fadd_rn(a, __fmul_rn(rw, rscores[q * n + d]));
    }
    return sv > -ESK_INF ? comb : -ESK_INF;
}

__global__ void window_rescore_kernel(
    const float* __restrict__ s, const int32_t* __restrict__ ids, int w,
    const float* __restrict__ rscores, const uint8_t* __restrict__ relig,
    int64_t n, float qw, float rw, int kk, int ch,
    float* __restrict__ top_s, int32_t* __restrict__ top_ids) {
    extern __shared__ uint64_t sm[];
    const int64_t q = blockIdx.x;
    for (int j = threadIdx.x; j < ch; j += blockDim.x) {
        sm[j] = j < w ? esk_composite(
                            wr_comb(s, ids, rscores, relig, n, q, w, j, qw, rw),
                            (uint32_t)j)
                      : 0;  // below every real composite
    }
    esk_bitonic_desc(sm, ch);
    for (int r = threadIdx.x; r < kk; r += blockDim.x) {
        const int j = (int)esk_composite_index(sm[r]);
        top_s[q * kk + r] = wr_comb(s, ids, rscores, relig, n, q, w, j, qw, rw);
        top_ids[q * kk + r] = ids[q * w + j];
    }
}

// Gather mode. scores f32[n_rows, n], eligible u8[n_rows, n], ids
// i32[n_rows, w] -> out_s f32[n_rows, w], out_m u8[n_rows, w].
extern "C" int esk_window_gather(
    const void* scores, const void* eligible, long long n, const void* ids,
    int n_rows, int w, void* out_s, void* out_m, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (n_rows <= 0 || w <= 0) {
        return 0;
    }
    window_gather_kernel<<<n_rows, WR_THREADS, 0, st>>>(
        (const float*)scores, (const uint8_t*)eligible, (int64_t)n,
        (const int32_t*)ids, w, (float*)out_s, (uint8_t*)out_m);
    ESK_RETURN_IF_ERROR();
    return 0;
}

// Fused mode. s f32[n_rows, w] and ids i32[n_rows, w] (the first phase's
// window), rscores f32[n_rows, n] and relig u8[n_rows, n] (the rescore
// plane and its eligibility); ch: the power of two >= w (<= 16384),
// kk <= w. Outputs top_s f32[n_rows, kk], top_ids i32[n_rows, kk].
extern "C" int esk_window_rescore(
    const void* s, const void* ids, int n_rows, int w, const void* rscores,
    const void* relig, long long n, float qw, float rw, int kk, int ch,
    void* top_s, void* top_ids, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (n_rows <= 0 || kk <= 0) {
        return 0;
    }
    const size_t smem = (size_t)ch * sizeof(uint64_t);
    ESK_SMEM_OPT_IN(window_rescore_kernel, smem);
    window_rescore_kernel<<<n_rows, WR_THREADS, smem, st>>>(
        (const float*)s, (const int32_t*)ids, w, (const float*)rscores,
        (const uint8_t*)relig, (int64_t)n, qw, rw, kk, ch, (float*)top_s,
        (int32_t*)top_ids);
    ESK_RETURN_IF_ERROR();
    return 0;
}
