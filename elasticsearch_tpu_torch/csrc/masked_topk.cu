// K3 masked_topk: top-k by (score desc, index asc) plus the eligible count,
// for Q rows at once; and its keyed mode K3k keyed_topk.
//
// Replaces: the masked `jax.lax.top_k` + `jnp.sum(eligible)` of
// elasticsearch_tpu/ops/bm25_device.py `_execute_inner` (:741),
// `_sparse_bool_inner` (:865), `_sparse_lead_inner` (:940) and
// `_sparse_terms_inner` (:1031) — solo, and under the vmaps of
// `execute_batch` (:1261) and `execute_batch_sparse` (:1050). A solo query
// is the row count Q = 1. K3k replaces the masked `lax.top_k` calls of the
// sorted and cursor programs: `execute_score_asc` (:1276),
// `execute_score_after` (:1313), `execute_sorted_after` (:1341) and
// `execute_sorted` (:1774) over `sort_key_plane` (:1758).
//
// Bound on an H100: bytes. The function must read each key (4 B) and
// eligible byte (1 B) once; for the k <= 10,000 of a search the output is
// negligible (K3k on one doc-values column at BASELINE config 4's
// 8,841,823 docs: 44,209,115 B, 0.0132 ms at 3.35 TB/s). The shared-memory
// bitonic sorts below do O(log^2 chunk) compare-exchanges per key, so this
// first kernel is compute-heavy next to that bound; it is kept because it
// is simple and exactly right.
//
// Design: lax.top_k's order is IEEE totalOrder descending (+NaN first,
// +0.0 above -0.0), lower index first on ties. Each key becomes one 64-bit
// composite, the total-order bits of the score above the inverted index
// within its row (common.cuh), so a plain descending sort of composites IS
// that order and needs no tie logic. Pass 1: each block (chunk, row) sorts
// one chunk of a row's composites in shared memory and keeps its top
// min(k, chunk). Further passes merge each row's survivors the same way
// until one block a row remains; rows never meet. torch.topk documents no
// tie order and is not used. The winning scores are gathered back from the
// input, so the output keeps the input's exact bits. `total` is an integer
// reduction over each row's eligible mask.
//
// K3k (keyed mode): pass 1 builds each doc's key in the kernel as the
// reference composes it, then forms the composite of the value lax.top_k
// sees; the merge passes are K3's. For a field sort the key is the
// doc-values column negated for desc, NaN (missing) pinned to -/+f32max
// for missing first/last; for a score order it is the score. A cursor
// (after_key, after_doc) keeps `key > after_key | (key == after_key & doc
// > after_doc)` (`<` for the descending score cursor); docs not kept are
// set to +inf (-inf for the descending score order), and the composite is
// of -masked (bottom-k and field sorts; a NaN keeps its sign, as the
// reference's jitted negation leaves it) or masked (descending score). The
// count kernel returns total = sum(eligible) and n_after = sum(keep); the
// decode returns the column's raw value (field sorts) or the masked score
// (score orders; a NaN of the bottom-k with its sign flipped) at each
// winner.
//
// Id mode (K3i; the merge of the IVF survivors in elasticsearch_tpu/ops/
// ann_device.py `_ivf_inner` :236-242, `lax.sort((-s, doc, s),
// num_keys=2)`): the composite takes its low 32 bits from an int32 id
// array (the doc ids) instead of the position, so one descending sort is
// (score desc, id asc). lax.sort's float keys are canonical: -0.0 equals
// +0.0 (the id decides) and every NaN sorts last; the id mode's high bits
// follow it (+0.0 for either zero, 0 for a NaN). The decode reads the
// score back from the high bits (+0.0 for a zero, the canonical NaN
// 0x7fc00000 for a NaN; the kNN similarities produce neither -0.0 nor a
// NaN that counts as a hit) and the id from the low bits. Its library
// call is two stable torch.sorts.
//
// Stacked mode (K3s; the per-shard top-k of `_shards_inner` :1137 under
// the vmap of `execute_shards_batch` :1161): row r is the pair (query
// r / S, shard r % S). Its keys are that pair's own candidates, so no
// shard plane is read and the row mode above serves it unchanged, over
// Q x S rows in one launch. The flat merge over [Q, S * k'] is the row
// mode over Q rows.
//
// Window mode (K3b window; the masked `lax.top_k` of `_execute_inner`
// (:729-742) with `bounds=` under `execute_batch_packed` :1724, the
// packed plane's dense lanes): row q reads only its tenant's window
// [lo[q], hi[q]) of the [Q, M] key and eligibility planes. The window is
// one contiguous slice, so its top-k in (score desc, index asc) is the
// reference's order over the masked plane; the composites carry the
// window-local index, which is the tenant-local id (id - lo). The blocks
// of every pass run over the widest window: a block past its row's
// window (or past its row's survivors in a merge pass) exits, so a row
// costs what its own window holds. The count reduces each row's window
// only. Slots past min(k, w) of a row are padding (-inf, 0). Bound:
// bytes, each row's window read once (5 B an entry).
#include <float.h>

#include "common.cuh"

#define TK_THREADS 1024
#define CNT_THREADS 256

#define KEYED_SCORE_DESC 0
#define KEYED_SCORE_ASC 1
#define KEYED_FIELD 2

struct KeyedArgs {
    const float* key;         // [Q, M] at row stride key_stride (0: one plane)
    const uint8_t* eligible;  // [Q, M]
    int64_t key_stride;
    int64_t m;
    int mode;
    int desc;
    int missing_first;
    const float* after_key;    // [Q], or null: no cursor
    const int32_t* after_doc;  // [Q]
};

// The value lax.top_k sees for doc i of row q (`*keep`: it passes the
// eligibility and the cursor), and the masked value it came from.
__device__ __forceinline__ float keyed_value(const KeyedArgs& a, int64_t q,
                                             int64_t i, bool* keep,
                                             float* masked) {
    const float raw = a.key[q * a.key_stride + i];
    float key = raw;
    if (a.mode == KEYED_FIELD) {
        const float k0 = a.desc ? -raw : raw;
        key = isnan(k0) ? (a.missing_first ? -FLT_MAX : FLT_MAX) : k0;
    }
    bool kp = a.eligible[q * a.m + i] != 0;
    if (a.after_key != nullptr) {
        const float ak = a.after_key[q];
        const bool past = a.mode == KEYED_SCORE_DESC ? key < ak : key > ak;
        kp = kp && (past || (key == ak && i > (int64_t)a.after_doc[q]));
    }
    const bool neg = a.mode != KEYED_SCORE_DESC;
    const float mk = kp ? key : (neg ? ESK_INF : -ESK_INF);
    *keep = kp;
    *masked = mk;
    // The negation keeps a NaN's sign, as the reference serves it.
    return (neg && !isnan(mk)) ? -mk : mk;
}

// Sort a block's `ch` composites and write its top min(kk, len).
__device__ __forceinline__ void sort_and_emit(uint64_t* sm, int ch, int kk,
                                              int len, uint64_t* dst) {
    esk_bitonic_desc(sm, ch);
    const int m = min(kk, len);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
        dst[i] = sm[i];
    }
}

// Survivors a pass keeps of a row's n entries: kk per full chunk, and
// min(kk, rest) of the last.
__device__ __host__ __forceinline__ int topk_survivors(int n, int kk, int ch) {
    if (n <= 0) {
        return 0;
    }
    const int nb = (n + ch - 1) / ch;
    return (nb - 1) * kk + (kk < n - (nb - 1) * ch ? kk : n - (nb - 1) * ch);
}

// Row q's input is key_f/key_c + q * in_stride, n entries long; its
// survivors go to out + q * out_stride, kk per block. Window mode
// (win_lo != null): row q's n is its window's hi - lo carried through
// `pass` merge passes, and pass 0 reads from the window's start.
__global__ void topk_block_kernel(
    const float* __restrict__ key_f,
    const int32_t* __restrict__ ids,
    const uint64_t* __restrict__ key_c,
    int n, int64_t in_stride, int kk, int ch, int64_t out_stride,
    uint64_t* __restrict__ out,
    const int32_t* __restrict__ win_lo,
    const int32_t* __restrict__ win_hi,
    int pass) {
    extern __shared__ uint64_t sm[];
    int64_t row_in = (int64_t)blockIdx.y * in_stride;
    if (win_lo != nullptr) {
        n = win_hi[blockIdx.y] - win_lo[blockIdx.y];
        for (int p = 0; p < pass; ++p) {
            n = topk_survivors(n, kk, ch);
        }
        if (pass == 0) {
            row_in += win_lo[blockIdx.y];
        }
    }
    const int lo = blockIdx.x * ch;
    if (lo >= n) {
        return;  // past this row's window: the whole block leaves
    }
    const int len = min(ch, n - lo);
    for (int i = threadIdx.x; i < ch; i += blockDim.x) {
        uint64_t v = 0;  // below every real composite (even -NaN's)
        if (i < len) {
            const int g = lo + i;
            if (key_f == nullptr) {
                v = key_c[row_in + g];
            } else {
                const float kf = key_f[row_in + g];
                if (ids != nullptr) {
                    // lax.sort's canonical keys: zeros equal, NaN last.
                    const uint32_t o =
                        isnan(kf) ? 0u : esk_f32_order(kf == 0.f ? 0.f : kf);
                    v = ((uint64_t)o << 32) | (uint64_t)(~(uint32_t)ids[row_in + g]);
                } else {
                    v = esk_composite(kf, (uint32_t)g);
                }
            }
        }
        sm[i] = v;
    }
    sort_and_emit(sm, ch, kk, len,
                  out + (int64_t)blockIdx.y * out_stride +
                      (int64_t)blockIdx.x * kk);
}

// K3k pass 1: the keyed composites of one chunk of a row.
__global__ void keyed_block_kernel(KeyedArgs a, int kk, int ch,
                                   int64_t out_stride,
                                   uint64_t* __restrict__ out) {
    extern __shared__ uint64_t sm[];
    const int64_t q = blockIdx.y;
    const int lo = blockIdx.x * ch;
    const int len = (int)min((int64_t)ch, a.m - lo);
    for (int i = threadIdx.x; i < ch; i += blockDim.x) {
        uint64_t v = 0;
        if (i < len) {
            bool keep;
            float masked;
            const int g = lo + i;
            v = esk_composite(keyed_value(a, q, g, &keep, &masked), (uint32_t)g);
        }
        sm[i] = v;
    }
    sort_and_emit(sm, ch, kk, len,
                  out + q * out_stride + (int64_t)blockIdx.x * kk);
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
    const uint32_t idx = esk_composite_index(comp[q * comp_stride + r]);
    top_idx[t] = (int32_t)idx;
    top_scores[t] = key_f[q * m + idx];
}

// The window mode's decode: row q's first min(kk, w) slots from its
// composites (window-local ids, scores read back from the window), the
// rest of its out_k slots padding (-inf, 0).
__global__ void topk_decode_window_kernel(
    const uint64_t* __restrict__ comp, int64_t comp_stride, int kk,
    int out_k, int n_rows, const float* __restrict__ key_f, int64_t m,
    const int32_t* __restrict__ win_lo, const int32_t* __restrict__ win_hi,
    float* __restrict__ top_scores, int32_t* __restrict__ top_idx) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (int64_t)n_rows * out_k) {
        return;
    }
    const int64_t q = t / out_k;
    const int r = (int)(t % out_k);
    const int lo = win_lo[q];
    if (r < min(kk, win_hi[q] - lo)) {
        const uint32_t idx = esk_composite_index(comp[q * comp_stride + r]);
        top_idx[t] = (int32_t)idx;
        top_scores[t] = key_f[q * m + lo + idx];
    } else {
        top_idx[t] = 0;
        top_scores[t] = -ESK_INF;
    }
}

// The id mode's decode: score and id both from the composite.
__global__ void topk_decode_ids_kernel(
    const uint64_t* __restrict__ comp, int64_t comp_stride, int kk,
    int n_rows, float* __restrict__ top_scores,
    int32_t* __restrict__ top_idx) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (int64_t)n_rows * kk) {
        return;
    }
    const int64_t q = t / kk;
    const int r = (int)(t % kk);
    const uint64_t c = comp[q * comp_stride + r];
    const uint32_t o = (uint32_t)(c >> 32);
    const uint32_t b =
        o == 0u ? 0x7fc00000u : ((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
    top_idx[t] = (int32_t)esk_composite_index(c);
    top_scores[t] = __uint_as_float(b);
}

__global__ void keyed_decode_kernel(
    KeyedArgs a, const uint64_t* __restrict__ comp, int64_t comp_stride,
    int kk, int n_rows, float* __restrict__ values,
    int32_t* __restrict__ top_idx) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (int64_t)n_rows * kk) {
        return;
    }
    const int64_t q = t / kk;
    const int r = (int)(t % kk);
    const uint32_t idx = esk_composite_index(comp[q * comp_stride + r]);
    bool keep;
    float masked;
    keyed_value(a, q, idx, &keep, &masked);
    top_idx[t] = (int32_t)idx;
    if (a.mode == KEYED_FIELD) {
        values[t] = a.key[q * a.key_stride + idx];
    } else if (a.mode == KEYED_SCORE_ASC && isnan(masked)) {
        // -top_k(-masked): the output negation flips a NaN's sign.
        values[t] = __uint_as_float(__float_as_uint(masked) ^ 0x80000000u);
    } else {
        values[t] = masked;
    }
}

__device__ __forceinline__ int block_sum(int c, int* warp_sums) {
    for (int off = 16; off > 0; off >>= 1) {
        c += __shfl_down_sync(0xffffffffu, c, off);
    }
    if ((threadIdx.x & 31) == 0) {
        warp_sums[threadIdx.x >> 5] = c;
    }
    __syncthreads();
    int s = 0;
    if (threadIdx.x == 0) {
        for (int w = 0; w < CNT_THREADS / 32; ++w) {
            s += warp_sums[w];
        }
    }
    return s;
}

// Window mode (win_lo != null): row q counts only its [lo, hi).
__global__ void count_true_kernel(
    const uint8_t* __restrict__ mask, int64_t n, int32_t* __restrict__ total,
    const int32_t* __restrict__ win_lo, const int32_t* __restrict__ win_hi) {
    __shared__ int warp_sums[CNT_THREADS / 32];
    const uint8_t* row = mask + (int64_t)blockIdx.y * n;
    if (win_lo != nullptr) {
        row += win_lo[blockIdx.y];
        n = win_hi[blockIdx.y] - win_lo[blockIdx.y];
    }
    int c = 0;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        c += row[i] != 0;
    }
    const int s = block_sum(c, warp_sums);
    if (threadIdx.x == 0) {
        atomicAdd(total + blockIdx.y, s);
    }
}

// K3k's counts: total = sum(eligible), n_after = sum(keep).
__global__ void keyed_count_kernel(KeyedArgs a, int32_t* __restrict__ total,
                                   int32_t* __restrict__ n_after) {
    __shared__ int warp_sums[CNT_THREADS / 32];
    const int64_t q = blockIdx.y;
    int c = 0;
    int kc = 0;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.m;
         i += (int64_t)gridDim.x * blockDim.x) {
        bool keep;
        float masked;
        keyed_value(a, q, i, &keep, &masked);
        c += a.eligible[q * a.m + i] != 0;
        kc += keep;
    }
    const int s = block_sum(c, warp_sums);
    __syncthreads();
    const int ks = block_sum(kc, warp_sums);
    if (threadIdx.x == 0) {
        atomicAdd(total + q, s);
        atomicAdd(n_after + q, ks);
    }
}

static int count_grid(int64_t m, int n_rows) {
    return esk_imin(esk_blocks(m, CNT_THREADS),
                    esk_imin(132 * 8, 1 + 132 * 64 / n_rows));
}

// The merge passes: from a first pass's survivors in `out` (row stride
// out_stride, n entries a row), merge each row down to one block. Returns
// the buffer holding the final kk composites a row. Window mode: m is the
// widest window, which bounds every row's survivors pass by pass.
static int merge_passes(int n_rows, int m, int kk, int ch, size_t smem,
                        uint64_t** out, uint64_t** spare, cudaStream_t s,
                        const int32_t* win_lo = nullptr,
                        const int32_t* win_hi = nullptr) {
    const int64_t out_stride = (int64_t)esk_blocks(m, ch) * kk;
    int nb = esk_blocks(m, ch);
    int n = topk_survivors(m, kk, ch);
    int pass = 1;
    while (nb > 1) {
        nb = esk_blocks(n, ch);
        topk_block_kernel<<<dim3(nb, n_rows), TK_THREADS, smem, s>>>(
            nullptr, nullptr, *out, n, out_stride, kk, ch, out_stride,
            *spare, win_lo, win_hi, pass);
        ESK_RETURN_IF_ERROR();
        n = topk_survivors(n, kk, ch);
        ++pass;
        uint64_t* t = *out;
        *out = *spare;
        *spare = t;
    }
    return 0;
}

// key f32[n_rows, m] (ineligible entries already -inf), ids i32[n_rows, m]
// (the id mode's tie-break ids) or null (the position), eligible
// u8[n_rows, m]. ch: power-of-two chunk (1024..16384) with ch > k.
// buf_a/buf_b: u64 scratch of n_rows * ceil(m / ch) * k entries each.
// Outputs top_scores/top_idx [n_rows, min(k, m)] and total i32[n_rows].
extern "C" int esk_masked_topk(
    const void* key,
    const void* ids,
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
        count_true_kernel<<<dim3(count_grid(m, n_rows), n_rows), CNT_THREADS,
                            0, s>>>((const uint8_t*)eligible, (int64_t)m,
                                    (int32_t*)total, nullptr, nullptr);
        ESK_RETURN_IF_ERROR();
    }
    const int kk = esk_imin(k, m);
    if (kk <= 0) {
        return 0;
    }
    const size_t smem = (size_t)ch * sizeof(uint64_t);
    ESK_SMEM_OPT_IN(topk_block_kernel, smem);
    uint64_t* out = (uint64_t*)buf_a;
    uint64_t* spare = (uint64_t*)buf_b;
    // Every pass writes a row's survivors at the first pass's row stride.
    const int64_t out_stride = (int64_t)esk_blocks(m, ch) * kk;
    topk_block_kernel<<<dim3(esk_blocks(m, ch), n_rows), TK_THREADS, smem,
                        s>>>((const float*)key, (const int32_t*)ids, nullptr,
                             m, m, kk, ch, out_stride, out, nullptr, nullptr,
                             0);
    ESK_RETURN_IF_ERROR();
    const int rc = merge_passes(n_rows, m, kk, ch, smem, &out, &spare, s);
    if (rc != 0) {
        return rc;
    }
    const int64_t n_out = (int64_t)n_rows * kk;
    if (ids != nullptr) {
        topk_decode_ids_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(
            out, out_stride, kk, n_rows, (float*)top_scores,
            (int32_t*)top_idx);
    } else {
        topk_decode_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(
            out, out_stride, kk, n_rows, (const float*)key, (int64_t)m,
            (float*)top_scores, (int32_t*)top_idx);
    }
    ESK_RETURN_IF_ERROR();
    return 0;
}

// K3b window mode. key f32[n_rows, m] (ineligible entries already -inf),
// eligible u8[n_rows, m], lo/hi i32[n_rows] with 0 <= lo <= hi <= m;
// wmax = max(hi - lo); kk = min(k, wmax) survivors a row; out_k = min(k,
// m) output slots a row. ch: power-of-two chunk (1024..16384), ch > kk.
// buf_a/buf_b: u64 scratch of n_rows * ceil(wmax / ch) * kk entries each.
// Outputs top_scores/top_idx [n_rows, out_k] (window-local ids) and total
// i32[n_rows].
extern "C" int esk_masked_topk_window(
    const void* key,
    const void* eligible,
    const void* lo,
    const void* hi,
    int n_rows,
    int m,
    int wmax,
    int kk,
    int out_k,
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
    const int32_t* wlo = (const int32_t*)lo;
    const int32_t* whi = (const int32_t*)hi;
    cudaMemsetAsync(total, 0, sizeof(int32_t) * (size_t)n_rows, s);
    ESK_RETURN_IF_ERROR();
    if (wmax > 0) {
        count_true_kernel<<<dim3(count_grid(wmax, n_rows), n_rows),
                            CNT_THREADS, 0, s>>>(
            (const uint8_t*)eligible, (int64_t)m, (int32_t*)total, wlo, whi);
        ESK_RETURN_IF_ERROR();
    }
    if (out_k <= 0) {
        return 0;
    }
    uint64_t* out = (uint64_t*)buf_a;
    uint64_t* spare = (uint64_t*)buf_b;
    const int64_t out_stride = (int64_t)esk_blocks(wmax, ch) * kk;
    if (kk > 0) {
        const size_t smem = (size_t)ch * sizeof(uint64_t);
        ESK_SMEM_OPT_IN(topk_block_kernel, smem);
        topk_block_kernel<<<dim3(esk_blocks(wmax, ch), n_rows), TK_THREADS,
                            smem, s>>>((const float*)key, nullptr, nullptr,
                                       wmax, m, kk, ch, out_stride, out, wlo,
                                       whi, 0);
        ESK_RETURN_IF_ERROR();
        const int rc = merge_passes(n_rows, wmax, kk, ch, smem, &out, &spare,
                                    s, wlo, whi);
        if (rc != 0) {
            return rc;
        }
    }
    const int64_t n_out = (int64_t)n_rows * out_k;
    topk_decode_window_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(
        out, out_stride, kk, out_k, n_rows, (const float*)key, (int64_t)m,
        wlo, whi, (float*)top_scores, (int32_t*)top_idx);
    ESK_RETURN_IF_ERROR();
    return 0;
}

// K3k. key f32[n_rows, m] at row stride key_stride (0: one plane shared
// by every row), eligible u8[n_rows, m]; mode KEYED_*; after_key f32[n_rows]
// and after_doc i32[n_rows], or null for no cursor. Scratch and chunk as
// esk_masked_topk. Outputs values/top_idx [n_rows, min(k, m)], total and
// n_after i32[n_rows].
extern "C" int esk_keyed_topk(
    const void* key,
    long long key_stride,
    const void* eligible,
    int n_rows,
    int m,
    int k,
    int ch,
    int mode,
    int desc,
    int missing_first,
    const void* after_key,
    const void* after_doc,
    void* buf_a,
    void* buf_b,
    void* values,
    void* top_idx,
    void* total,
    void* n_after,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_rows <= 0) {
        return 0;
    }
    KeyedArgs a;
    a.key = (const float*)key;
    a.eligible = (const uint8_t*)eligible;
    a.key_stride = key_stride;
    a.m = m;
    a.mode = mode;
    a.desc = desc;
    a.missing_first = missing_first;
    a.after_key = (const float*)after_key;
    a.after_doc = (const int32_t*)after_doc;
    cudaMemsetAsync(total, 0, sizeof(int32_t) * (size_t)n_rows, s);
    ESK_RETURN_IF_ERROR();
    cudaMemsetAsync(n_after, 0, sizeof(int32_t) * (size_t)n_rows, s);
    ESK_RETURN_IF_ERROR();
    if (m > 0) {
        keyed_count_kernel<<<dim3(count_grid(m, n_rows), n_rows), CNT_THREADS,
                             0, s>>>(a, (int32_t*)total, (int32_t*)n_after);
        ESK_RETURN_IF_ERROR();
    }
    const int kk = esk_imin(k, m);
    if (kk <= 0) {
        return 0;
    }
    const size_t smem = (size_t)ch * sizeof(uint64_t);
    ESK_SMEM_OPT_IN(topk_block_kernel, smem);
    ESK_SMEM_OPT_IN(keyed_block_kernel, smem);
    uint64_t* out = (uint64_t*)buf_a;
    uint64_t* spare = (uint64_t*)buf_b;
    const int64_t out_stride = (int64_t)esk_blocks(m, ch) * kk;
    keyed_block_kernel<<<dim3(esk_blocks(m, ch), n_rows), TK_THREADS, smem,
                         s>>>(a, kk, ch, out_stride, out);
    ESK_RETURN_IF_ERROR();
    const int rc = merge_passes(n_rows, m, kk, ch, smem, &out, &spare, s);
    if (rc != 0) {
        return rc;
    }
    const int64_t n_out = (int64_t)n_rows * kk;
    keyed_decode_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(
        a, out, out_stride, kk, n_rows, (float*)values, (int32_t*)top_idx);
    ESK_RETURN_IF_ERROR();
    return 0;
}
