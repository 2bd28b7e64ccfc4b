// K3 masked_topk: top-k by (score desc, index asc) plus the eligible count.
//
// Replaces: the masked `jax.lax.top_k` + `jnp.sum(eligible)` of
// elasticsearch_tpu/ops/bm25_device.py `_execute_inner` (:741),
// `_sparse_bool_inner` (:865), `_sparse_lead_inner` (:940) and
// `_sparse_terms_inner` (:1031).
//
// Bound on an H100: bytes. The function must read each key (4 B) and
// eligible byte (1 B) once; for the k <= 10,000 of a search the output is
// negligible. The shared-memory bitonic sorts below do O(log^2 chunk)
// compare-exchanges per key, so this first kernel is compute-heavy next to
// that bound; it is kept because it is simple and exactly right.
//
// Design: lax.top_k's order is score descending, lower index first on
// ties. Each key becomes one 64-bit composite, the order-preserving bits of
// the score (with -0.0 canonicalised to +0.0) above the inverted index, so
// a plain descending sort of composites IS that order and needs no tie
// logic. Pass 1: each block sorts one chunk of composites in shared memory
// and keeps its top min(k, chunk). Further passes merge the survivors the
// same way until one block remains. torch.topk documents no tie order and
// is not used. The winning scores are gathered back from the input, so
// the output keeps the input's exact bits. `total` is an integer
// reduction over the eligible mask.
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

__global__ void topk_block_kernel(
    const float* __restrict__ key_f,
    const uint64_t* __restrict__ key_c,
    int n, int kk, int ch,
    uint64_t* __restrict__ out) {
    extern __shared__ uint64_t sm[];
    const int lo = blockIdx.x * ch;
    const int len = min(ch, n - lo);
    for (int i = threadIdx.x; i < ch; i += blockDim.x) {
        uint64_t v = 0;  // below every real composite (even -inf's)
        if (i < len) {
            const int g = lo + i;
            v = key_f != nullptr
                    ? (((uint64_t)f32_order(key_f[g]) << 32) |
                       (uint64_t)(~(uint32_t)g))
                    : key_c[g];
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
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
        out[(int64_t)blockIdx.x * kk + i] = sm[i];
    }
}

__global__ void topk_decode_kernel(
    const uint64_t* __restrict__ comp, int m, const float* __restrict__ key_f,
    float* __restrict__ top_scores, int32_t* __restrict__ top_idx) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= m) {
        return;
    }
    const uint32_t idx = ~(uint32_t)(comp[r] & 0xffffffffull);
    top_idx[r] = (int32_t)idx;
    top_scores[r] = key_f[idx];
}

__global__ void count_true_kernel(
    const uint8_t* __restrict__ mask, int n, int32_t* __restrict__ total) {
    __shared__ int warp_sums[CNT_THREADS / 32];
    int c = 0;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
        c += mask[i] != 0;
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
        atomicAdd(total, s);
    }
}

// key f32[m] (ineligible entries already -inf), eligible u8[m].
// ch: power-of-two chunk (1024..16384) with ch > k. buf_a/buf_b: u64
// scratch of ceil(m / ch) * k entries each. Outputs the first min(k, m)
// slots of top_scores/top_idx and total (i32[1]).
extern "C" int esk_masked_topk(
    const void* key,
    const void* eligible,
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
    cudaMemsetAsync(total, 0, sizeof(int32_t), s);
    ESK_RETURN_IF_ERROR();
    if (m > 0) {
        const int grid = esk_imin(esk_blocks(m, CNT_THREADS), 132 * 8);
        count_true_kernel<<<grid, CNT_THREADS, 0, s>>>(
            (const uint8_t*)eligible, m, (int32_t*)total);
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
    uint64_t* out = (uint64_t*)buf_a;
    uint64_t* spare = (uint64_t*)buf_b;
    int n = m;
    while (true) {
        const int nb = esk_blocks(n, ch);
        topk_block_kernel<<<nb, TK_THREADS, smem, s>>>(in_f, in_c, n, kk, ch,
                                                      out);
        ESK_RETURN_IF_ERROR();
        const int last = n - (nb - 1) * ch;
        n = (nb - 1) * kk + esk_imin(kk, last);
        if (nb == 1) {
            break;
        }
        in_f = nullptr;
        in_c = out;
        uint64_t* t = out;
        out = spare;
        spare = t;
    }
    topk_decode_kernel<<<esk_blocks(kk, 256), 256, 0, s>>>(
        out, kk, (const float*)key, (float*)top_scores, (int32_t*)top_idx);
    ESK_RETURN_IF_ERROR();
    return 0;
}
