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
// 8,841,823 docs: 44,209,115 B, 0.0132 ms at 3.35 TB/s; K3b on 6 rows of
// cfg3's shard 0, 1,105,228 docs: 33,157,344 B, 0.0099 ms). The
// shared-memory bitonic sorts below do O(log^2 chunk) compare-exchanges
// per key, so the modes that keep them (k > 256, the id, window and merge
// modes) are compute-heavy next to that bound; the threshold select
// (below), which the row, stacked and keyed modes take for k <= 256, reads
// each entry once instead.
//
// Design: lax.top_k's order is IEEE totalOrder descending (+NaN first,
// +0.0 above -0.0), lower index first on ties. Each key becomes one 64-bit
// composite, the total-order bits of the score above the inverted index
// within its row (common.cuh), so a plain descending sort of composites IS
// that order and needs no tie logic. For min(k, m) <= KS_MAX_K (256) and
// no ids, the row mode (K3, K3b and K3s alike) is the threshold select of
// K3k below with the raw key as its composite source (KEYED_RAW): no
// masking (the row-mode contract puts -inf at ineligible entries, and the
// plain version orders by the key alone, so the kernel must not mask even
// where a caller breaks that contract), total counted over the eligible
// bytes in the same pass, the winners' scores read back from the key:
// one memset and one launch a call. Otherwise the chunk sorts: pass 1,
// each block (chunk, row) sorts one chunk of a row's composites in shared
// memory and keeps its top min(k, chunk); further passes merge each row's
// survivors the same way until one block a row remains; rows never meet;
// a decode reads the winners back. torch.topk documents no tie order and
// is not used. The winning scores are gathered back from the input, so
// the output keeps the input's exact bits. `total` is an integer reduction
// over each row's eligible mask.
//
// K3k (keyed mode): each doc's key is built in the kernel as the
// reference composes it, then the composite of the value lax.top_k sees.
// For a field sort the key is the doc-values column negated for desc, NaN
// (missing) pinned to -/+f32max for missing first/last; for a score order
// it is the score. A cursor (after_key, after_doc) keeps `key > after_key
// | (key == after_key & doc > after_doc)` (`<` for the descending score
// cursor); docs not kept are set to +inf (-inf for the descending score
// order), and the composite is of -masked (bottom-k and field sorts; a NaN
// keeps its sign, as the reference's jitted negation leaves it) or masked
// (descending score). total = sum(eligible), n_after = sum(keep); the
// decode returns the column's raw value (field sorts) or the masked score
// (score orders; a NaN of the bottom-k with its sign flipped) at each
// winner. esk_keyed_topk switches on k between two designs, both exact:
//
// - k <= KS_MAX_K (256): the threshold select, one launch (after one
//   memset). Each row splits into stripes, about two blocks a
//   multiprocessor over all rows. A block reads each key and eligible byte
//   of its stripe once (float4 / 4-byte words where the planes align),
//   counts total and n_after in the same pass, and keeps a shared buffer
//   of the composites at or above a threshold T: T starts as the k-th
//   largest of 2,048 entries sampled in 64 runs of 32 (the last run the
//   stripe's final entries, so a monotone column, where every key in
//   stripe order beats a running k-th, is bounded from the start), and
//   after a round that leaves more than 4,096 candidates the buffer is cut
//   to its top k by a radix select and T becomes its k-th. Long runs of
//   equal keys, NaN of either sign, fewer eligible docs than k and a cursor
//   that keeps almost nothing are all plain composites to it. The row's
//   last block to finish (an arrival counter) merges the blocks' top-k
//   lists: only survivors at or above the largest block k-th can win, so
//   those few are cut to k, sorted and decoded. Bound: bytes, 5 B an entry
//   read once; the work per entry is a few dozen instructions.
// - k > KS_MAX_K: the chunk sorts, K3's passes with the keyed pass 1
//   (keyed_block_kernel, keyed_count_kernel, keyed_decode_kernel), whose
//   per-block sort cost is what the select avoids for small k.
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
// Q x S rows in one launch (the select for k <= 256). The flat merge over
// [Q, S * k'] is the row mode over Q rows.
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
//
// Merge mode (K3m; the `lax.top_k` merge of the all-gathered per-shard
// tops, elasticsearch_tpu/parallel/sharded.py :717, in the port's
// parallel/sharded.py `_merge_topk`): rows of at most MERGE_MAX_M (4,096)
// keys, S shards' kk tops each (80 at cfg3's S = 8, k = 10). No
// eligibility plane, no total, no scratch: one block of 32 W threads a
// row holds its P = 32 W E composites in registers (E a thread; P the
// power of two at or above M, at least 128, padding composites 0, below
// every real one) and runs the bitonic network on them: the stages of
// stride below E inside a thread, below 32 E by warp shuffles, and only
// the wider ones (W > 1, M above 256) through shared memory. At M = 80 a
// row is one warp with 4 keys a lane and 28 stages, against K3's row mode,
// which sorts a 1,024-entry shared chunk in 55 __syncthreads stages to
// rank 80 keys. Rank g ends in thread g / E, register g % E; the first
// min(k, M) ranks write the key read back from the input (exact bits),
// its index as int64 and, with an ids plane, the id at that index, so
// the caller's cast and gather go. Bound: bytes, the keys read once and
// the outputs written once; at M = 80 a launch is its wrapper's host time.
#include <float.h>

#include "common.cuh"

#define TK_THREADS 1024
#define CNT_THREADS 256

#define KEYED_SCORE_DESC 0
#define KEYED_SCORE_ASC 1
#define KEYED_FIELD 2
#define KEYED_RAW 3  // K3's row mode in the select: the key as it is

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

// The value lax.top_k sees for doc i, from its loaded key `raw` and
// eligible byte `elig` (`*keep`: it passes the eligibility and, where
// `cursor`, the cursor (ak, ad)), and the masked value it came from; MODE
// is a KEYED_* mode.
template <int MODE>
__device__ __forceinline__ float keyed_value_m(const KeyedArgs& a,
                                               bool cursor, float ak,
                                               int64_t ad, int64_t i,
                                               float raw, uint8_t elig,
                                               bool* keep, float* masked) {
    if (MODE == KEYED_RAW) {
        *keep = true;
        *masked = raw;
        return raw;
    }
    float key = raw;
    if (MODE == KEYED_FIELD) {
        const float k0 = a.desc ? -raw : raw;
        key = isnan(k0) ? (a.missing_first ? -FLT_MAX : FLT_MAX) : k0;
    }
    bool kp = elig != 0;
    if (cursor) {
        const bool past = MODE == KEYED_SCORE_DESC ? key < ak : key > ak;
        kp = kp && (past || (key == ak && i > ad));
    }
    constexpr bool neg = MODE != KEYED_SCORE_DESC;
    const float mk = kp ? key : (neg ? ESK_INF : -ESK_INF);
    *keep = kp;
    *masked = mk;
    // The negation keeps a NaN's sign, as the reference serves it.
    return (neg && !isnan(mk)) ? -mk : mk;
}

// keyed_value_m of row q with the mode and cursor read from `a`.
__device__ __forceinline__ float keyed_value_of(const KeyedArgs& a,
                                                int64_t q, int64_t i,
                                                float raw, uint8_t elig,
                                                bool* keep, float* masked) {
    const bool cursor = a.after_key != nullptr;
    const float ak = cursor ? a.after_key[q] : 0.f;
    const int64_t ad = cursor ? (int64_t)a.after_doc[q] : 0;
    if (a.mode == KEYED_SCORE_DESC) {
        return keyed_value_m<KEYED_SCORE_DESC>(a, cursor, ak, ad, i, raw, elig,
                                               keep, masked);
    }
    if (a.mode == KEYED_SCORE_ASC) {
        return keyed_value_m<KEYED_SCORE_ASC>(a, cursor, ak, ad, i, raw, elig,
                                              keep, masked);
    }
    return keyed_value_m<KEYED_FIELD>(a, cursor, ak, ad, i, raw, elig, keep,
                                      masked);
}

__device__ __forceinline__ float keyed_value(const KeyedArgs& a, int64_t q,
                                             int64_t i, bool* keep,
                                             float* masked) {
    return keyed_value_of(a, q, i, a.key[q * a.key_stride + i],
                          a.eligible[q * a.m + i], keep, masked);
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

// ---------------------------------------------------------------------------
// The threshold select (k <= KS_MAX_K): one pass over the keys, then one
// merge a row, in one launch. See the header. K3k's modes and K3's row
// mode (KEYED_RAW) give ks_select_kernel their composites through
// keyed_value_m; the window mode could take it the same way.
// ---------------------------------------------------------------------------

#define KS_MAX_K 256                         // largest k of this design
#define KS_THREADS 512
#define KS_ROUND (KS_THREADS * 8)            // entries a round: 8 a thread
#define KS_CAP (2 * KS_ROUND + 8)            // candidate buffer (u64)
#define KS_SAMPLE 2048                       // sampled entries a block

struct KsState {
    uint64_t tmp[KS_MAX_K];  // the kept candidates while compacting
    int hist[256];
    int count;               // candidates in the buffer
    int kept;
    int digit;
    int rank;
    int bucket;
    uint64_t result;
};

__device__ __forceinline__ uint64_t ks_shfl_xor(uint64_t v, int j) {
    const unsigned lo = __shfl_xor_sync(0xffffffffu, (unsigned)v, j);
    const unsigned hi = __shfl_xor_sync(0xffffffffu, (unsigned)(v >> 32), j);
    return ((uint64_t)hi << 32) | lo;
}

// The kk-th largest (1 <= kk <= n) of the n composites a[0, n) in shared
// memory (n <= KS_CAP, distinct at and above the answer). 8-bit radix
// passes from the top byte: each counts the entries that match the digits
// found so far, and warp 0 finds the digit whose bucket holds rank kk.
// Once that bucket has at most 32 entries, they are gathered and warp 0
// sorts them with a shuffle bitonic sort. Every thread returns the same
// value.
__device__ uint64_t ks_kth_largest(const uint64_t* a, int n, int kk,
                                   KsState& st) {
    uint64_t prefix = 0;
    uint64_t mask = 0;
    int rank = kk;
    int bucket = n;
    for (int shift = 56; shift >= 0 && bucket > 32; shift -= 8) {
        for (int i = threadIdx.x; i < 256; i += blockDim.x) {
            st.hist[i] = 0;
        }
        __syncthreads();
        for (int i0 = 0; i0 < n; i0 += blockDim.x) {
            // Lanes with the same digit add once (runs of equal keys
            // share their high bytes).
            const int i = i0 + threadIdx.x;
            int digit = 256;
            if (i < n) {
                const uint64_t v = a[i];
                if ((v & mask) == prefix) {
                    digit = (int)((v >> shift) & 255);
                }
            }
            const unsigned peers = __match_any_sync(0xffffffffu, digit);
            if (digit < 256 && (threadIdx.x & 31) == __ffs(peers) - 1) {
                atomicAdd(&st.hist[digit], __popc(peers));
            }
        }
        __syncthreads();
        if (threadIdx.x < 32) {
            // Lane l holds digits 255 - 8l down to 248 - 8l.
            const int lane = threadIdx.x;
            int c[8];
            int sum = 0;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                c[j] = st.hist[255 - lane * 8 - j];
                sum += c[j];
            }
            int incl = sum;
            for (int off = 1; off < 32; off <<= 1) {
                const int t = __shfl_up_sync(0xffffffffu, incl, off);
                if (lane >= off) {
                    incl += t;
                }
            }
            const int excl = incl - sum;
            if (excl < rank && rank <= incl) {
                int acc = excl;
                for (int j = 0; j < 8; ++j) {
                    if (acc + c[j] >= rank) {
                        st.digit = 255 - lane * 8 - j;
                        st.rank = rank - acc;
                        st.bucket = c[j];
                        break;
                    }
                    acc += c[j];
                }
            }
        }
        __syncthreads();
        prefix |= (uint64_t)st.digit << shift;
        mask |= (uint64_t)255 << shift;
        rank = st.rank;
        bucket = st.bucket;
    }
    if (bucket > 32) {  // all eight bytes fixed: prefix is the entry
        return prefix;
    }
    if (threadIdx.x == 0) {
        st.kept = 0;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const uint64_t v = a[i];
        if ((v & mask) == prefix) {
            st.tmp[atomicAdd(&st.kept, 1)] = v;
        }
    }
    __syncthreads();
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        uint64_t v = lane < st.kept ? st.tmp[lane] : 0ull;
        for (int k = 2; k <= 32; k <<= 1) {
            for (int j = k >> 1; j > 0; j >>= 1) {
                const uint64_t o = ks_shfl_xor(v, j);
                const bool desc = (lane & k) == 0;
                const bool lower = (lane & j) == 0;
                v = (lower == desc) ? (v > o ? v : o) : (v < o ? v : o);
            }
        }
        if (lane == rank - 1) {
            st.result = v;
        }
    }
    __syncthreads();
    return st.result;
}

// Keep the entries of a[0, n) at or above `kth` (kk of them, composites
// being distinct) at a[0, kk); returns kk.
__device__ int ks_keep_top(uint64_t* a, int n, uint64_t kth, KsState& st) {
    if (threadIdx.x == 0) {
        st.kept = 0;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const uint64_t v = a[i];
        if (v >= kth) {
            st.tmp[atomicAdd(&st.kept, 1)] = v;
        }
    }
    __syncthreads();
    const int kept = st.kept;
    for (int i = threadIdx.x; i < kept; i += blockDim.x) {
        a[i] = st.tmp[i];
    }
    __syncthreads();
    return kept;
}

// Row q's merge, by its last block: the top kp of its nb blocks'
// survivors (kp each, unordered; nb * kp <= KS_CAP). The true kp-th
// largest is at least every block's own kp-th (its smallest survivor), so
// only survivors at or above the largest of those can win: they are
// gathered into buf, cut to the top kp (radix select) and sorted
// (bitonic), then decoded as keyed_decode_kernel does.
__device__ void ks_merge_row(const KeyedArgs& a, int64_t q, int kp, int nb,
                             const uint64_t* __restrict__ surv,
                             float* __restrict__ values,
                             int32_t* __restrict__ top_idx, uint64_t* buf,
                             KsState& st) {
    const int n = nb * kp;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const uint64_t* src = surv + q * (int64_t)n;
    uint64_t fl = 0;  // the largest block floor this thread saw
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
        uint64_t mn = ~0ull;
        for (int i = 0; i < kp; ++i) {
            const uint64_t v = __ldcg(src + (int64_t)b * kp + i);
            mn = v < mn ? v : mn;
        }
        fl = mn > fl ? mn : fl;
    }
    for (int off = 16; off > 0; off >>= 1) {
        const uint64_t o = ks_shfl_xor(fl, off);
        fl = o > fl ? o : fl;
    }
    if (lane == 0) {
        st.tmp[warp] = fl;
    }
    if (threadIdx.x == 0) {
        st.count = 0;
    }
    __syncthreads();
    uint64_t fl_max = 0;
    for (int w = 0; w < KS_THREADS / 32; ++w) {
        fl_max = st.tmp[w] > fl_max ? st.tmp[w] : fl_max;
    }
    for (int i0 = 0; i0 < n; i0 += blockDim.x) {
        const int i = i0 + threadIdx.x;
        const uint64_t v = i < n ? __ldcg(src + i) : 0ull;
        const bool in = i < n && v >= fl_max;
        const unsigned bal = __ballot_sync(0xffffffffu, in);
        if (bal != 0u) {
            int base = 0;
            if (lane == 0) {
                base = atomicAdd(&st.count, __popc(bal));
            }
            base = __shfl_sync(0xffffffffu, base, 0);
            if (in) {
                buf[base + __popc(bal & ((1u << lane) - 1u))] = v;
            }
        }
    }
    __syncthreads();
    // At least kp of the gathered survivors are real (the floor's block
    // holds kp), so the kp-th largest is real and distinct.
    const int n2 = st.count;
    const int kept =
        n2 > kp ? ks_keep_top(buf, n2, ks_kth_largest(buf, n2, kp, st), st)
                : n2;
    int ch = 1;
    while (ch < kept) {
        ch <<= 1;
    }
    for (int i = kept + threadIdx.x; i < ch; i += blockDim.x) {
        buf[i] = 0ull;
    }
    esk_bitonic_desc(buf, ch);
    for (int r = threadIdx.x; r < kp; r += blockDim.x) {
        const uint32_t idx = esk_composite_index(buf[r]);
        const int64_t t = q * kp + r;
        top_idx[t] = (int32_t)idx;
        if (a.mode == KEYED_FIELD || a.mode == KEYED_RAW) {
            values[t] = a.key[q * a.key_stride + idx];  // the exact bits
            continue;
        }
        bool keep;
        float masked;
        keyed_value(a, q, idx, &keep, &masked);
        if (a.mode == KEYED_SCORE_ASC && isnan(masked)) {
            values[t] = __uint_as_float(__float_as_uint(masked) ^ 0x80000000u);
        } else {
            values[t] = masked;
        }
    }
}

// Row q's entries [b * stripe, (b + 1) * stripe): survivors (the block's
// top kp composites, unordered, 0-padded) to surv[(q * nb + b) * kp ...],
// its eligible and kept counts added to total[q] / n_after[q] (KEYED_RAW:
// total only, n_after is null), and a ticket
// from arrive[q]: the row's last block merges (ks_merge_row) into
// values / top_idx [q, kp]. MODE is the call's mode (the per-entry work is
// compiled for each).
//
// A threshold T filters the pass: only composites >= T enter the shared
// candidate buffer. T starts as the kp-th largest of KS_SAMPLE entries
// taken in 64 runs of 32 spread evenly over the stripe, the last run its
// final 32 entries (a subset's kp-th largest is at most the stripe's, so
// no winner is filtered; on a monotone column the last run bounds the
// winners, where every key in stripe order would beat a running kp-th).
// Rounds of KS_ROUND entries are block-synchronous, the next round's
// loads in flight while the current one is filtered (two register sets,
// alternating); an entry is tested against T in registers, and a warp
// appends to the buffer (a ballot, one atomic) only when one of its lanes
// holds a candidate; after a round that
// leaves more than KS_ROUND candidates, the buffer is cut to its top kp
// and T becomes its kp-th. Each key and eligible byte is read once, as
// float4 and 4-byte words where the row's two planes align (else 4-byte
// and 1-byte loads, coalesced).
template <int MODE>
__global__ void __launch_bounds__(KS_THREADS, 2)
ks_select_kernel(KeyedArgs a, int kp, int nb, int64_t stripe,
                 uint64_t* __restrict__ surv, float* __restrict__ values,
                 int32_t* __restrict__ top_idx, int32_t* __restrict__ total,
                 int32_t* __restrict__ n_after, int32_t* __restrict__ arrive) {
    extern __shared__ uint64_t buf[];
    __shared__ KsState st;
    const int64_t q = blockIdx.y;
    const int64_t lo = (int64_t)blockIdx.x * stripe;
    const int64_t hi = min(a.m, lo + stripe);
    const int64_t len = hi > lo ? hi - lo : 0;
    const float* krow = a.key + q * a.key_stride;
    const uint8_t* erow = a.eligible + q * a.m;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const bool cursor = a.after_key != nullptr;
    const float ak = cursor ? a.after_key[q] : 0.f;
    const int64_t ad = cursor ? (int64_t)a.after_doc[q] : 0;
    auto composite = [&](int64_t e, float raw, uint8_t el, bool* keep) {
        float masked;
        return esk_composite(
            keyed_value_m<MODE>(a, cursor, ak, ad, e, raw, el, keep, &masked),
            (uint32_t)e);
    };
    uint64_t t_min = 0;
    if (len >= 2 * KS_SAMPLE && kp <= KS_SAMPLE) {
        constexpr int RUNS = KS_SAMPLE / 32;
        const int64_t gap = (len - 32) / (RUNS - 1);
        constexpr int PER_WARP = RUNS / (KS_THREADS / 32);
        float raw[PER_WARP];
        uint8_t el[PER_WARP];
#pragma unroll
        for (int i = 0; i < PER_WARP; ++i) {  // every load in flight at once
            const int64_t e = lo + (warp + i * (KS_THREADS / 32)) * gap + lane;
            raw[i] = krow[e];
            el[i] = erow[e];
        }
#pragma unroll
        for (int i = 0; i < PER_WARP; ++i) {
            const int run = warp + i * (KS_THREADS / 32);
            bool keep;
            buf[run * 32 + lane] =
                composite(lo + run * gap + lane, raw[i], el[i], &keep);
        }
        __syncthreads();
        t_min = ks_kth_largest(buf, KS_SAMPLE, kp, st);
    }
    if (threadIdx.x == 0) {
        st.count = 0;
    }
    __syncthreads();
    uint32_t t_hi = (uint32_t)(t_min >> 32);
    uint32_t t_lo = (uint32_t)t_min;
    int n_elig = 0;
    int n_keep = 0;
    // Eight entries a thread (ok: a bit an entry): count them, test each
    // against T, and append the warp's candidates to the buffer only when
    // one of its lanes has any (a ballot an entry, then).
    auto process = [&](const float (&raw)[8], const uint8_t (&el)[8],
                       const int64_t (&idx)[8], unsigned ok) {
        uint32_t ord[8];
        unsigned cm = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            bool keep;
            float masked;
            ord[j] = esk_f32_order(keyed_value_m<MODE>(
                a, cursor, ak, ad, idx[j], raw[j], el[j], &keep, &masked));
            const bool in = (ok >> j) & 1u;
            n_keep += in && keep;
            const uint32_t inv = ~(uint32_t)idx[j];
            const bool cand =
                in && (ord[j] > t_hi || (ord[j] == t_hi && inv >= t_lo));
            cm |= (unsigned)cand << j;
        }
        if (__any_sync(0xffffffffu, cm != 0u)) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const bool cand = (cm >> j) & 1u;
                const unsigned bal = __ballot_sync(0xffffffffu, cand);
                if (bal != 0u) {
                    int base = 0;
                    if (lane == 0) {
                        base = atomicAdd(&st.count, __popc(bal));
                    }
                    base = __shfl_sync(0xffffffffu, base, 0);
                    if (cand) {
                        buf[base + __popc(bal & ((1u << lane) - 1u))] =
                            ((uint64_t)ord[j] << 32) | ~(uint32_t)idx[j];
                    }
                }
            }
        }
    };
    // After each round: cut the buffer to its top kp when it holds more
    // than a round's worth.
    auto settle = [&]() {
        __syncthreads();
        const int n = st.count;
        __syncthreads();  // every thread read n before the next appends
        if (n > KS_ROUND) {
            t_min = ks_kth_largest(buf, n, kp, st);
            ks_keep_top(buf, n, t_min, st);
            t_hi = (uint32_t)(t_min >> 32);
            t_lo = (uint32_t)t_min;
            if (threadIdx.x == 0) {
                st.count = kp;
            }
            __syncthreads();
        }
    };
    // Both planes align to 4 entries after a head of < 4, if they can.
    // The rounds alternate between two register sets, so round r + 1's
    // loads are in flight while round r is filtered.
    const uintptr_t ka = (uintptr_t)(krow + lo);
    const uintptr_t ea = (uintptr_t)(erow + lo);
    if (ka % 4 == 0 && ((ka / 4) - ea) % 4 == 0) {
        constexpr int GR = KS_ROUND / 4;  // 4-entry groups a round
        const int64_t head = min(len, (int64_t)((4 - ea % 4) % 4));
        const int64_t body = (len - head) / 4;
        const int64_t tail0 = lo + head + body * 4;
        const int64_t rounds = body > 0 ? (body + GR - 1) / GR : 1;
        auto load = [&](int64_t r, float4 (&k4)[2], uint32_t (&e4)[2]) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int64_t g = r * GR + threadIdx.x + j * KS_THREADS;
                if (g < body) {
                    const int64_t e = lo + head + g * 4;
                    k4[j] = *reinterpret_cast<const float4*>(krow + e);
                    e4[j] = *reinterpret_cast<const uint32_t*>(erow + e);
                }
            }
        };
        auto round = [&](int64_t r, const float4 (&k4)[2],
                         const uint32_t (&e4)[2]) {
            if (r == 0 && warp < 2) {
                // The head and the tail (< 4 entries each) in round 0.
                const int t = threadIdx.x;
                const bool in_head = t < head;
                const bool in_tail = t >= 32 && t < 32 + (hi - tail0);
                const int64_t e = in_head ? lo + t : tail0 + (t - 32);
                const bool in = in_head || in_tail;
                float raw[8] = {in ? krow[e] : 0.f};
                uint8_t el[8] = {in ? erow[e] : (uint8_t)0};
                int64_t idx[8] = {e};
                n_elig += in && el[0] != 0;
                process(raw, el, idx, in ? 1u : 0u);
            }
            float raw[8];
            uint8_t el[8];
            int64_t idx[8];
            unsigned ok = 0;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int64_t g = r * GR + threadIdx.x + j * KS_THREADS;
                const int64_t e = lo + head + g * 4;
                const float kf[4] = {k4[j].x, k4[j].y, k4[j].z, k4[j].w};
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                    raw[j * 4 + v] = kf[v];
                    el[j * 4 + v] = (uint8_t)(e4[j] >> (8 * v));
                    idx[j * 4 + v] = e + v;
                }
                if (g < body) {
                    ok |= 15u << (j * 4);
                    // Bytes of 0 / 1 (bool): one popc counts four.
                    uint32_t w = e4[j];
                    w |= w >> 4;
                    w |= w >> 2;
                    w |= w >> 1;
                    n_elig += __popc(w & 0x01010101u);
                }
            }
            process(raw, el, idx, ok);
            settle();
        };
        float4 ka4[2], kb4[2];
        uint32_t ea4[2], eb4[2];
        load(0, ka4, ea4);
        for (int64_t r = 0; r < rounds; r += 2) {
            if (r + 1 < rounds) {
                load(r + 1, kb4, eb4);
            }
            round(r, ka4, ea4);
            if (r + 1 < rounds) {
                if (r + 2 < rounds) {
                    load(r + 2, ka4, ea4);
                }
                round(r + 1, kb4, eb4);
            }
        }
    } else {
        const int64_t rounds = (len + KS_ROUND - 1) / KS_ROUND;
        auto load = [&](int64_t r, float (&k1)[8], uint8_t (&e1)[8]) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int64_t e = lo + r * KS_ROUND + threadIdx.x + j * KS_THREADS;
                if (e < hi) {
                    k1[j] = krow[e];
                    e1[j] = erow[e];
                }
            }
        };
        auto round = [&](int64_t r, const float (&k1)[8],
                         const uint8_t (&e1)[8]) {
            int64_t idx[8];
            unsigned ok = 0;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                idx[j] = lo + r * KS_ROUND + threadIdx.x + j * KS_THREADS;
                if (idx[j] < hi) {
                    ok |= 1u << j;
                    n_elig += e1[j] != 0;
                }
            }
            process(k1, e1, idx, ok);
            settle();
        };
        float ka1[8], kb1[8];
        uint8_t ea1[8], eb1[8];
        load(0, ka1, ea1);
        for (int64_t r = 0; r < rounds; r += 2) {
            if (r + 1 < rounds) {
                load(r + 1, kb1, eb1);
            }
            round(r, ka1, ea1);
            if (r + 1 < rounds) {
                if (r + 2 < rounds) {
                    load(r + 2, ka1, ea1);
                }
                round(r + 1, kb1, eb1);
            }
        }
    }
    // The block's top kp, and its counts into the row's.
    __syncthreads();
    int n = st.count;
    if (n > kp) {
        ks_keep_top(buf, n, ks_kth_largest(buf, n, kp, st), st);
        n = kp;
    }
    uint64_t* dst = surv + (q * nb + blockIdx.x) * (int64_t)kp;
    for (int i = threadIdx.x; i < kp; i += blockDim.x) {
        dst[i] = i < n ? buf[i] : 0ull;  // 0: below every real composite
    }
    if (MODE == KEYED_RAW) {
        n_keep = 0;  // no cursor: nothing to count past the eligibility
    }
    for (int off = 16; off > 0; off >>= 1) {
        n_elig += __shfl_down_sync(0xffffffffu, n_elig, off);
        n_keep += __shfl_down_sync(0xffffffffu, n_keep, off);
    }
    if (lane == 0 && n_elig != 0) {
        atomicAdd(total + q, n_elig);
    }
    if (MODE != KEYED_RAW && lane == 0 && n_keep != 0) {
        atomicAdd(n_after + q, n_keep);
    }
    // The row's last block to finish merges its survivors.
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        st.kept = atomicAdd(arrive + q, 1);
    }
    __syncthreads();
    if (st.kept != nb - 1) {
        return;
    }
    __threadfence();
    ks_merge_row(a, q, kp, nb, surv, values, top_idx, buf, st);
}

static int ks_sm_count() {
    static int sms = 0;
    if (sms <= 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms <= 0) {
            sms = 132;
        }
    }
    return sms;
}

template <int MODE>
static int ks_select(const KeyedArgs& a, int n_rows, int kk, int nb,
                     int64_t stripe, uint64_t* surv, float* values,
                     int32_t* top_idx, int32_t* total, int32_t* n_after,
                     int32_t* arrive, cudaStream_t s) {
    const size_t smem = (size_t)KS_CAP * sizeof(uint64_t);
    // The shared-memory opt-in once a device (it costs a driver call).
    static unsigned long long opted = 0;
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 64 || !((opted >> dev) & 1ull)) {
        ESK_SMEM_OPT_IN(ks_select_kernel<MODE>, smem);
        if (dev < 64) {
            opted |= 1ull << dev;
        }
    }
    ks_select_kernel<MODE><<<dim3(nb, n_rows), KS_THREADS, smem, s>>>(
        a, kk, nb, stripe, surv, values, top_idx, total, n_after, arrive);
    ESK_RETURN_IF_ERROR();
    return 0;
}

// The select path of esk_keyed_topk and of esk_masked_topk's row mode: nb
// blocks a row (about two a multiprocessor over all rows, but at least
// one: 1 to 65,535 rows, each its own grid row; at most KS_CAP / kk so the
// last block's merge fits its buffer, at most one a KS_ROUND entries, and
// at most the chunk path's block count so both paths share its scratch),
// stripes a multiple of 4 entries, one launch. total, n_after (null in
// KEYED_RAW) and arrive ([n_rows] each) are zeroed first, in one memset
// where they are consecutive planes: the blocks add their counts and
// tickets there.
static int ks_launch(const KeyedArgs& a, int n_rows, int m, int kk, int ch,
                     uint64_t* surv, float* values, int32_t* top_idx,
                     int32_t* total, int32_t* n_after, int32_t* arrive,
                     cudaStream_t s) {
    int nb = esk_blocks(m, KS_ROUND);
    nb = esk_imin(nb, KS_CAP / kk);
    nb = esk_imin(nb, 2 * ks_sm_count() / n_rows);
    nb = esk_imin(nb, esk_blocks(m, ch));
    nb = nb < 1 ? 1 : nb;
    const int64_t stripe = ((int64_t)esk_blocks(m, nb) + 3) / 4 * 4;
    nb = esk_blocks(m, (int)stripe);
    const size_t plane = sizeof(int32_t) * (size_t)n_rows;
    if (n_after == nullptr && arrive == total + n_rows) {
        cudaMemsetAsync(total, 0, 2 * plane, s);
    } else if (n_after == total + n_rows && arrive == n_after + n_rows) {
        cudaMemsetAsync(total, 0, 3 * plane, s);
    } else {
        cudaMemsetAsync(total, 0, plane, s);
        if (n_after != nullptr) {
            cudaMemsetAsync(n_after, 0, plane, s);
        }
        cudaMemsetAsync(arrive, 0, plane, s);
    }
    ESK_RETURN_IF_ERROR();
    if (a.mode == KEYED_RAW) {
        return ks_select<KEYED_RAW>(a, n_rows, kk, nb, stripe, surv, values,
                                    top_idx, total, nullptr, arrive, s);
    }
    if (a.mode == KEYED_SCORE_DESC) {
        return ks_select<KEYED_SCORE_DESC>(a, n_rows, kk, nb, stripe, surv,
                                           values, top_idx, total, n_after,
                                           arrive, s);
    }
    if (a.mode == KEYED_SCORE_ASC) {
        return ks_select<KEYED_SCORE_ASC>(a, n_rows, kk, nb, stripe, surv,
                                          values, top_idx, total, n_after,
                                          arrive, s);
    }
    return ks_select<KEYED_FIELD>(a, n_rows, kk, nb, stripe, surv, values,
                                  top_idx, total, n_after, arrive, s);
}

// key f32[n_rows, m] (ineligible entries already -inf), ids i32[n_rows, m]
// (the id mode's tie-break ids) or null (the position), eligible
// u8[n_rows, m]. ch: power-of-two chunk (1024..16384) with ch > k.
// buf_a/buf_b: u64 scratch of n_rows * ceil(m / ch) * k entries each
// (buf_b unused by the select). Outputs top_scores/top_idx [n_rows,
// min(k, m)] and total i32[n_rows]; arrive i32[n_rows], the select's
// arrival tickets, is scratch (one memset zeroes total and arrive where
// arrive = total + n_rows). With no ids and 1 <= min(k, m) <= KS_MAX_K the
// threshold select runs (one memset, one launch); otherwise the chunk
// sorts.
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
    void* arrive,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_rows <= 0) {
        return 0;
    }
    const int kk = esk_imin(k, m);
    if (ids == nullptr && kk > 0 && kk <= KS_MAX_K) {
        KeyedArgs a;
        a.key = (const float*)key;
        a.eligible = (const uint8_t*)eligible;
        a.key_stride = m;
        a.m = m;
        a.mode = KEYED_RAW;
        a.desc = 0;
        a.missing_first = 0;
        a.after_key = nullptr;
        a.after_doc = nullptr;
        return ks_launch(a, n_rows, m, kk, ch, (uint64_t*)buf_a,
                         (float*)top_scores, (int32_t*)top_idx,
                         (int32_t*)total, nullptr, (int32_t*)arrive, s);
    }
    cudaMemsetAsync(total, 0, sizeof(int32_t) * (size_t)n_rows, s);
    ESK_RETURN_IF_ERROR();
    if (m > 0) {
        count_true_kernel<<<dim3(count_grid(m, n_rows), n_rows), CNT_THREADS,
                            0, s>>>((const uint8_t*)eligible, (int64_t)m,
                                    (int32_t*)total, nullptr, nullptr);
        ESK_RETURN_IF_ERROR();
    }
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
    void* arrive,
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
    const int kk = esk_imin(k, m);
    if (kk > 0 && kk <= KS_MAX_K) {
        // k <= KS_MAX_K: the threshold select; larger k: the chunk sorts.
        return ks_launch(a, n_rows, m, kk, ch, (uint64_t*)buf_a,
                         (float*)values, (int32_t*)top_idx, (int32_t*)total,
                         (int32_t*)n_after, (int32_t*)arrive, s);
    }
    cudaMemsetAsync(total, 0, sizeof(int32_t) * (size_t)n_rows, s);
    ESK_RETURN_IF_ERROR();
    cudaMemsetAsync(n_after, 0, sizeof(int32_t) * (size_t)n_rows, s);
    ESK_RETURN_IF_ERROR();
    if (m > 0) {
        keyed_count_kernel<<<dim3(count_grid(m, n_rows), n_rows), CNT_THREADS,
                             0, s>>>(a, (int32_t*)total, (int32_t*)n_after);
        ESK_RETURN_IF_ERROR();
    }
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

// ---------------------------------------------------------------------------
// Merge mode (K3m)
// ---------------------------------------------------------------------------

#define MERGE_MAX_M 4096

__host__ __device__ constexpr int merge_log2(int x) {
    return x <= 1 ? 0 : 1 + merge_log2(x >> 1);
}

// One row a block: 32 * W threads, E composites a thread, P = 32 * W * E.
template <int E, int W>
__global__ void __launch_bounds__(32 * W) topk_merge_kernel(
    const float* __restrict__ key,
    const int32_t* __restrict__ ids,
    int m,
    int kp,
    float* __restrict__ top_key,
    int64_t* __restrict__ top_idx,
    int32_t* __restrict__ top_ids) {
    constexpr int T = 32 * W;
    constexpr int P = T * E;
    constexpr int LOG_P = merge_log2(P);
    __shared__ uint64_t sm[W > 1 ? P : 1];
    const int64_t q = blockIdx.x;
    const float* row = key + q * m;
    const int t = threadIdx.x;
    uint64_t v[E];
    // Coalesced loads: register e of thread t starts with entry e * T + t
    // (the composite carries the index, so the start order is free).
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = e * T + t;
        v[e] = i < m ? esk_composite(row[i], (uint32_t)i) : 0ull;
    }
    // The bitonic network over element g = t * E + e, descending: a pair
    // (g, g ^ j) of a block of `size` keeps the larger at the lower index
    // where (g & size) == 0 and the smaller there otherwise.
#pragma unroll
    for (int ls = 1; ls <= LOG_P; ++ls) {
        const int size = 1 << ls;
#pragma unroll
        for (int lj = ls - 1; lj >= 0; --lj) {
            const int j = 1 << lj;
            if (j < E) {
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    if ((e & j) == 0) {
                        const int g = t * E + e;
                        const bool desc = (g & size) == 0;
                        const uint64_t a = v[e];
                        const uint64_t b = v[e | j];
                        if (desc ? (a < b) : (a > b)) {
                            v[e] = b;
                            v[e | j] = a;
                        }
                    }
                }
            } else if (j < 32 * E) {
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const int g = t * E + e;
                    const uint64_t o = __shfl_xor_sync(0xffffffffu, v[e], j / E);
                    const bool keep_max = ((g & j) == 0) == ((g & size) == 0);
                    v[e] = keep_max ? (v[e] > o ? v[e] : o) : (v[e] < o ? v[e] : o);
                }
            } else {
                __syncthreads();
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    sm[t * E + e] = v[e];
                }
                __syncthreads();
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const int g = t * E + e;
                    const uint64_t o = sm[g ^ j];
                    const bool keep_max = ((g & j) == 0) == ((g & size) == 0);
                    v[e] = keep_max ? (v[e] > o ? v[e] : o) : (v[e] < o ? v[e] : o);
                }
            }
        }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int g = t * E + e;
        if (g < kp) {
            const uint32_t idx = esk_composite_index(v[e]);
            const int64_t at = q * kp + g;
            top_key[at] = row[idx];
            top_idx[at] = (int64_t)idx;
            if (ids != nullptr) {
                top_ids[at] = ids[q * m + idx];
            }
        }
    }
}

template <int E, int W>
static int launch_topk_merge(const void* key, const void* ids, int n_rows,
                             int m, int kp, void* top_key, void* top_idx,
                             void* top_ids, cudaStream_t s) {
    topk_merge_kernel<E, W><<<n_rows, 32 * W, 0, s>>>(
        (const float*)key, (const int32_t*)ids, m, kp, (float*)top_key,
        (int64_t*)top_idx, (int32_t*)top_ids);
    ESK_RETURN_IF_ERROR();
    return 0;
}

// key f32[n_rows, m] with 0 < m <= MERGE_MAX_M; ids i32[n_rows, m] or
// null. Outputs top_key f32, top_idx i64 and (with ids) top_ids i32, each
// [n_rows, kp], kp = min(k, m) > 0 ranks a row in lax.top_k's order.
extern "C" int esk_topk_merge(
    const void* key,
    const void* ids,
    int n_rows,
    int m,
    int kp,
    void* top_key,
    void* top_idx,
    void* top_ids,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_rows <= 0 || kp <= 0) {
        return 0;
    }
    if (m <= 0 || m > MERGE_MAX_M || kp > m) {
        return (int)cudaErrorInvalidValue;
    }
    if (m <= 128) {
        return launch_topk_merge<4, 1>(key, ids, n_rows, m, kp, top_key, top_idx, top_ids, s);
    }
    if (m <= 256) {
        return launch_topk_merge<8, 1>(key, ids, n_rows, m, kp, top_key, top_idx, top_ids, s);
    }
    if (m <= 512) {
        return launch_topk_merge<8, 2>(key, ids, n_rows, m, kp, top_key, top_idx, top_ids, s);
    }
    if (m <= 1024) {
        return launch_topk_merge<8, 4>(key, ids, n_rows, m, kp, top_key, top_idx, top_ids, s);
    }
    if (m <= 2048) {
        return launch_topk_merge<8, 8>(key, ids, n_rows, m, kp, top_key, top_idx, top_ids, s);
    }
    return launch_topk_merge<8, 16>(key, ids, n_rows, m, kp, top_key, top_idx, top_ids, s);
}
