// K3 masked_topk: top-k by (score desc, index asc) plus the eligible count,
// for Q rows at once.
//
// Replaces: the masked `jax.lax.top_k` + `jnp.sum(eligible)` of
// elasticsearch_tpu/ops/bm25_device.py `_execute_inner` (:741),
// `_sparse_bool_inner` (:865), `_sparse_lead_inner` (:940) and
// `_sparse_terms_inner` (:1031) — solo, and under the vmaps of
// `execute_batch` (:1261) and `execute_batch_sparse` (:1050). A solo query
// is the row count Q = 1.
//
// Bound on an H100: bytes. The function must read each key (4 B) and
// eligible byte (1 B) once; for the k <= 10,000 of a search the output is
// negligible. The shared-memory bitonic sorts below do O(log^2 chunk)
// compare-exchanges per key, so this first kernel is compute-heavy next to
// that bound; it is kept because it is simple and exactly right.
//
// Design: lax.top_k's order is score descending, lower index first on
// ties. Each key becomes one 64-bit composite, the order-preserving bits of
// the score (with -0.0 canonicalised to +0.0) above the inverted index
// within its row, so a plain descending sort of composites IS that order
// and needs no tie logic. Pass 1: each block (chunk, row) sorts one chunk
// of a row's composites in shared memory and keeps its top min(k, chunk).
// Further passes merge each row's survivors the same way until one block
// a row remains; rows never meet. torch.topk documents no tie order and
// is not used. The winning scores are gathered back from the input, so
// the output keeps the input's exact bits. `total` is an integer
// reduction over each row's eligible mask.
//
// Stacked mode (K3s; the per-shard top-k of `_shards_inner` :1137 under
// the vmap of `execute_shards_batch` :1161): row r is the pair (query
// r / S, shard r % S). Its keys are that pair's own candidates, so no
// shard plane is read and the row mode above serves it unchanged, over
// Q x S rows in one launch. The flat merge over [Q, S * k'] is the row
// mode over Q rows.
#include "common.cuh"

#define TK_THREADS 1024
#define CNT_THREADS 256

__device__ __forceinline__ uint32_t f32_order(float f) {
    uint32_t b = __float_as_uint(f);
    if (b == 0x80000000u) {
        b = 0u;
    }
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Row q's input is key_f/key_c + q * in_stride, n entries long; its
// survivors go to out + q * out_stride, kk per block.
__global__ void topk_block_kernel(
    const float* __restrict__ key_f,
    const uint64_t* __restrict__ key_c,
    int n, int64_t in_stride, int kk, int ch, int64_t out_stride,
    uint64_t* __restrict__ out) {
    extern __shared__ uint64_t sm[];
    const int64_t row_in = (int64_t)blockIdx.y * in_stride;
    const int lo = blockIdx.x * ch;
    const int len = min(ch, n - lo);
    for (int i = threadIdx.x; i < ch; i += blockDim.x) {
        uint64_t v = 0;  // below every real composite (even -inf's)
        if (i < len) {
            const int g = lo + i;
            v = key_f != nullptr
                    ? (((uint64_t)f32_order(key_f[row_in + g]) << 32) |
                       (uint64_t)(~(uint32_t)g))
                    : key_c[row_in + g];
        }
        sm[i] = v;
    }
    __syncthreads();
    for (int k = 2; k <= ch; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < ch; i += blockDim.x) {
                const int ixj = i ^ j;
                if (ixj > i) {
                    const uint64_t a = sm[i];
                    const uint64_t b = sm[ixj];
                    const bool desc = (i & k) == 0;
                    if (desc ? (a < b) : (a > b)) {
                        sm[i] = b;
                        sm[ixj] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
    const int m = min(kk, len);
    uint64_t* dst = out + (int64_t)blockIdx.y * out_stride +
                    (int64_t)blockIdx.x * kk;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
        dst[i] = sm[i];
    }
}

__global__ void topk_decode_kernel(
    const uint64_t* __restrict__ comp, int64_t comp_stride, int kk,
    int n_rows, const float* __restrict__ key_f, int64_t m,
    float* __restrict__ top_scores, int32_t* __restrict__ top_idx) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (int64_t)n_rows * kk) {
        return;
    }
    const int64_t q = t / kk;
    const int r = (int)(t % kk);
    const uint32_t idx = ~(uint32_t)(comp[q * comp_stride + r] & 0xffffffffull);
    top_idx[t] = (int32_t)idx;
    top_scores[t] = key_f[q * m + idx];
}

__global__ void count_true_kernel(
    const uint8_t* __restrict__ mask, int64_t n, int32_t* __restrict__ total) {
    __shared__ int warp_sums[CNT_THREADS / 32];
    const uint8_t* row = mask + (int64_t)blockIdx.y * n;
    int c = 0;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        c += row[i] != 0;
    }
    for (int off = 16; off > 0; off >>= 1) {
        c += __shfl_down_sync(0xffffffffu, c, off);
    }
    if ((threadIdx.x & 31) == 0) {
        warp_sums[threadIdx.x >> 5] = c;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int s = 0;
        for (int w = 0; w < CNT_THREADS / 32; ++w) {
            s += warp_sums[w];
        }
        atomicAdd(total + blockIdx.y, s);
    }
}

// key f32[n_rows, m] (ineligible entries already -inf), eligible
// u8[n_rows, m]. ch: power-of-two chunk (1024..16384) with ch > k.
// buf_a/buf_b: u64 scratch of n_rows * ceil(m / ch) * k entries each.
// Outputs top_scores/top_idx [n_rows, min(k, m)] and total i32[n_rows].
extern "C" int esk_masked_topk(
    const void* key,
    const void* eligible,
    int n_rows,
    int m,
    int k,
    int ch,
    void* buf_a,
    void* buf_b,
    void* top_scores,
    void* top_idx,
    void* total,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_rows <= 0) {
        return 0;
    }
    cudaMemsetAsync(total, 0, sizeof(int32_t) * (size_t)n_rows, s);
    ESK_RETURN_IF_ERROR();
    if (m > 0) {
        const int grid = esk_imin(esk_blocks(m, CNT_THREADS),
                                  esk_imin(132 * 8, 1 + 132 * 64 / n_rows));
        count_true_kernel<<<dim3(grid, n_rows), CNT_THREADS, 0, s>>>(
            (const uint8_t*)eligible, (int64_t)m, (int32_t*)total);
        ESK_RETURN_IF_ERROR();
    }
    const int kk = esk_imin(k, m);
    if (kk <= 0) {
        return 0;
    }
    const size_t smem = (size_t)ch * sizeof(uint64_t);
    if (smem > 48 * 1024) {
        cudaFuncSetAttribute(topk_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
        ESK_RETURN_IF_ERROR();
    }
    const float* in_f = (const float*)key;
    const uint64_t* in_c = nullptr;
    int64_t in_stride = m;
    uint64_t* out = (uint64_t*)buf_a;
    uint64_t* spare = (uint64_t*)buf_b;
    // Every pass writes a row's survivors at the first pass's row stride.
    const int64_t out_stride = (int64_t)esk_blocks(m, ch) * kk;
    int n = m;
    while (true) {
        const int nb = esk_blocks(n, ch);
        topk_block_kernel<<<dim3(nb, n_rows), TK_THREADS, smem, s>>>(
            in_f, in_c, n, in_stride, kk, ch, out_stride, out);
        ESK_RETURN_IF_ERROR();
        const int last = n - (nb - 1) * ch;
        n = (nb - 1) * kk + esk_imin(kk, last);
        if (nb == 1) {
            break;
        }
        in_f = nullptr;
        in_c = out;
        in_stride = out_stride;
        uint64_t* t = out;
        out = spare;
        spare = t;
    }
    const int64_t n_out = (int64_t)n_rows * kk;
    topk_decode_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(
        out, out_stride, kk, n_rows, (const float*)key, (int64_t)m,
        (float*)top_scores, (int32_t*)top_idx);
    ESK_RETURN_IF_ERROR();
    return 0;
}
