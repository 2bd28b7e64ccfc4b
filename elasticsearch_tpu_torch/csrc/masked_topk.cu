// K3 masked_topk: top-k by (score desc, index asc) plus the eligible count,
// for Q rows at once; its keyed mode K3k keyed_topk, its id mode K3i, its
// window mode (K3b window) and its merge mode K3m.
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
// cfg3's shard 0, 1,105,228 docs: 33,157,344 B, 0.0099 ms).
//
// Order: lax.top_k's order is IEEE totalOrder descending (+NaN first, +0.0
// above -0.0), lower index first on ties. Each entry becomes one 64-bit
// composite, the total-order bits of the value it is ranked by above the
// inverted index within its row (common.cuh), so a plain descending order
// of composites IS that order and needs no tie logic. The composite
// sources (keyed_value_m / composite_m): KEYED_RAW, the row, stacked and
// window modes' key as it is (no masking: the row-mode contract puts -inf
// at ineligible entries, and the plain version orders by the key alone, so
// the kernel must not mask even where a caller breaks that contract);
// KEYED_SCORE_DESC / _ASC / KEYED_FIELD, K3k's keys (below); KEYED_IDS,
// K3i's. Every design below sorts or selects these composites and nothing
// else, so all three give the same bits: the winners' values are read back
// from the input (row and window modes, field sorts) or rebuilt as the
// reference composes them, `total` (and K3k's `n_after`) are counted in the
// pass that reads the eligible bytes. torch.topk documents no tie order and
// is not used. Each call takes one of three designs, on kk = min(k, M)
// (the window mode: on min(k, widest window) and the widest window):
//
// - The threshold select, 1 <= kk <= KS_MAX_K (256), every mode: one memset
//   and one launch (ks_select_kernel, below). Each row splits into
//   stripes, about two blocks a multiprocessor over all rows. A block reads
//   each key and eligible byte of its stripe once (float4 / 4-byte words
//   where the planes align), counts total and n_after in the same pass,
//   and keeps a shared buffer of the composites at or above a threshold T:
//   T starts as the k-th largest of 2,048 entries sampled in 64 runs of 32
//   (the last run the stripe's final entries, so a monotone column, where
//   every key in stripe order beats a running k-th, is bounded from the
//   start), and after a round that leaves more than 4,096 candidates the
//   buffer is cut to its top k by a radix select and T becomes its k-th.
//   The row's last block to finish (an arrival counter) merges the blocks'
//   top-k lists: only survivors at or above the largest block k-th can
//   win, so those few are cut to k, sorted and decoded. Bound: bytes, 5 B
//   an entry read once; the work per entry is a few dozen instructions.
// - The short-row sort, kk = 0 or kk > KS_MAX_K on rows of at most
//   LK_SHORT_MAX (16,384) entries: a memset and one launch (two for rows
//   longer than one run). Each block loads one run of LK_RUN (2,048) of its
//   row's composites into registers (four a thread), counting the eligible
//   bytes in the same load, and sorts it (a bitonic network of in-thread,
//   warp-shuffle and shared-memory stages); a row of one run writes and
//   decodes its top kk from there (the kNN per-partition ranks: rows of
//   1,504 at k = M). Longer rows (the mesh merge's long route, [1, 4,800])
//   merge their runs by rank (lk_rank_kernel): an entry's rank is its place
//   in its run plus the entries above it in every other run (binary
//   searches over the runs in shared memory; equal composites counted in
//   the runs before its own, so ranks never collide), and the entries
//   ranked below kk are decoded into their slots. No block sorts more than
//   a run, and every block of the row places its own entries at once.
// - The large-k select, kk > KS_MAX_K (or kk = 0) on longer rows: an
//   MSB-first radix select on the composite, a memset and LK_NDIG + 3
//   (nine) launches whatever M and k (the chunk sorts it replaces ran a
//   pass a factor ch / k of survivors, a dozen at k = 10,000). Pass 0
//   (lk_hist_kernel) reads every entry once, counts total and n_after and
//   builds each row's histogram of the composite's top LK_DIGIT (12) bits
//   (a block's in shared memory, a warp's equal digits added once, -inf's
//   bin, the padding, counted in a register; then added to the row's);
//   two blocks a multiprocessor over all rows; the row's last block finds the
//   bucket that holds rank k. Pass p = 1..5 (lk_pass_kernel) narrows the
//   bucket by digit p: the first pass whose bucket fits the row's S
//   (LK_BCAP_DIV: a quarter of the row, at least 16,384) reads the input a
//   second time and writes every composite above the bucket (fewer than
//   k: winners) to the front of F and the bucket's own to S, through each
//   warp's shared stage (one global atomic a flush, no block barrier);
//   later passes read S instead of the input. Once the bucket is stored
//   and the winners and bucket together fit F (LK_FINAL_CAP, 16,384), or
//   all six digits are fixed, the row is done and later passes return at
//   once. Long runs of equal keys (a mostly-missing column pinned to
//   +/-f32max, all-equal keys, -inf padding, the id mode's padding slots)
//   take further digits: the index or id bits below the key split the ties
//   in lax.top_k's order, so the digits always end, and equal composites
//   (the id mode's repeated ids) are interchangeable in the output. The
//   collect (lk_collect_kernel, every block of the row) writes S's
//   composites above the bucket after F's front and the bucket's own
//   after them, as many as F holds (more only when every digit is fixed
//   and they are equal; a row that never stored its bucket takes them
//   from its input); F's candidates are then ranked as the short-row sort
//   ranks a row (runs, merged by rank). On rows whose first bucket fits S
//   (keys spread over more than one twelve-bit bucket at rank k) each key
//   and eligible byte is read twice (the eligible bytes once where the
//   composite does not depend on them: the raw and id modes). Scratch:
//   LK_FINAL_CAP + S composites a row, and the row's state and histogram.
//
// K3k (keyed mode): each doc's key is built in the kernel as the reference
// composes it, then the composite of the value lax.top_k sees. For a field
// sort the key is the doc-values column negated for desc, NaN (missing)
// pinned to -/+f32max for missing first/last; for a score order it is the
// score. A cursor (after_key, after_doc) keeps `key > after_key | (key ==
// after_key & doc > after_doc)` (`<` for the descending score cursor); docs
// not kept are set to +inf (-inf for the descending score order), and the
// composite is of -masked (bottom-k and field sorts; a NaN keeps its sign,
// as the reference's jitted negation leaves it) or masked (descending
// score). total = sum(eligible), n_after = sum(keep); the decode returns the
// column's raw value (field sorts) or the masked score (score orders; a
// NaN of the bottom-k with its sign flipped) at each winner.
//
// Id mode (K3i; the merge of the IVF survivors in elasticsearch_tpu/ops/
// ann_device.py `_ivf_inner` :236-242, `lax.sort((-s, doc, s),
// num_keys=2)`; KEYED_IDS): the composite takes its low 32 bits from an
// int32 id array (the doc ids) instead of the position, so one descending
// order is (score desc, id asc). lax.sort's float keys are canonical: -0.0
// equals +0.0 (the id decides) and every NaN sorts last; the id mode's high
// bits follow it (+0.0 for either zero, 0 for a NaN). The decode reads the
// score back from the high bits (+0.0 for a zero, the canonical NaN
// 0x7fc00000 for a NaN; the kNN similarities produce neither -0.0 nor a NaN
// that counts as a hit) and the id from the low bits. Its library call is
// two stable torch.sorts.
//
// Stacked mode (K3s; the per-shard top-k of `_shards_inner` :1137 under
// the vmap of `execute_shards_batch` :1161): row r is the pair (query
// r / S, shard r % S). Its keys are that pair's own candidates, so no
// shard plane is read and the row mode above serves it unchanged, over
// Q x S rows in one call. The flat merge over [Q, S * k'] is the row mode
// over Q rows.
//
// Window mode (K3b window; the masked `lax.top_k` of `_execute_inner`
// (:729-742) with `bounds=` under `execute_batch_packed` :1724, the
// packed plane's dense lanes): row q reads only its tenant's window
// [lo[q], hi[q]) of the [Q, M] key and eligibility planes (KeyedArgs'
// win_lo / win_hi: every design above offsets its row by lo and takes its
// length as hi - lo). The window is one contiguous slice, so its top-k in
// (score desc, index asc) is the reference's order over the masked plane;
// the composites carry the window-local index, which is the tenant-local
// id (id - lo). The launch's blocks cover the widest window; a block past
// its row's window reads nothing. A row ranks min(k, w) of its w entries;
// its slots past that are padding (-inf, 0). Bound: bytes, each row's
// window read once (5 B an entry).
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
// row is one warp with 4 keys a lane and 28 stages. Rank g ends in thread
// g / E, register g % E; the first min(k, M) ranks write the key read back
// from the input (exact bits), its index as int64 and, with an ids plane,
// the id at that index, so the caller's cast and gather go. Bound: bytes,
// the keys read once and the outputs written once; at M = 80 a launch is
// its wrapper's host time.
#include <float.h>

#include "common.cuh"

#define KEYED_SCORE_DESC 0
#define KEYED_SCORE_ASC 1
#define KEYED_FIELD 2
#define KEYED_RAW 3  // K3's row, stacked and window modes: the key as it is
#define KEYED_IDS 4  // K3i: lax.sort's canonical score above the inverted id

#define FULL_MASK 0xffffffffu

struct KeyedArgs {
    const float* key;         // row q at key + q * key_stride (0: one plane)
    const uint8_t* eligible;  // [Q, m]
    const int32_t* ids;       // [Q, m] (KEYED_IDS), or null
    const int32_t* win_lo;    // [Q] window starts (window mode), or null
    const int32_t* win_hi;    // [Q] window ends
    int64_t key_stride;
    int64_t m;                // the planes' row length (and stride)
    int mode;
    int desc;
    int missing_first;
    const float* after_key;    // [Q], or null: no cursor
    const int32_t* after_doc;  // [Q]
};

// Row q as the kernels read it: its entries [0, len) start at these
// pointers (a window's lo already added), with its cursor.
struct RowView {
    const float* key;
    const uint8_t* elig;
    const int32_t* ids;
    int64_t len;
    bool cursor;
    float ak;
    int64_t ad;
};

__device__ __forceinline__ RowView row_view(const KeyedArgs& a, int64_t q) {
    RowView r;
    int64_t off = 0;
    r.len = a.m;
    if (a.win_lo != nullptr) {
        off = a.win_lo[q];
        r.len = a.win_hi[q] - off;
    }
    r.key = a.key + q * a.key_stride + off;
    r.elig = a.eligible + q * a.m + off;
    r.ids = a.ids == nullptr ? nullptr : a.ids + q * a.m + off;
    r.cursor = a.after_key != nullptr;
    r.ak = r.cursor ? a.after_key[q] : 0.f;
    r.ad = r.cursor ? (int64_t)a.after_doc[q] : 0;
    return r;
}

// The value lax.top_k sees for doc i, from its loaded key `raw` and
// eligible byte `elig` (`*keep`: it passes the eligibility and, where
// `cursor`, the cursor (ak, ad)), and the masked value it came from; MODE
// is a KEYED_* mode other than KEYED_IDS.
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

// Entry e's composite, as its high (order) and low (inverted index or id)
// words, from its loaded key, eligible byte and id (KEYED_IDS only).
template <int MODE>
__device__ __forceinline__ void composite_hl(const KeyedArgs& a,
                                             const RowView& r, int64_t e,
                                             float raw, uint8_t el,
                                             int32_t id, bool* keep,
                                             uint32_t* hi, uint32_t* lo) {
    if (MODE == KEYED_IDS) {
        // lax.sort's canonical keys: zeros equal, NaN last.
        *keep = true;
        *hi = isnan(raw) ? 0u : esk_f32_order(raw == 0.f ? 0.f : raw);
        *lo = ~(uint32_t)id;
        return;
    }
    float masked;
    *hi = esk_f32_order(keyed_value_m<MODE>(a, r.cursor, r.ak, r.ad, e, raw,
                                            el, keep, &masked));
    *lo = ~(uint32_t)e;
}

template <int MODE>
__device__ __forceinline__ uint64_t composite_m(const KeyedArgs& a,
                                                const RowView& r, int64_t e,
                                                float raw, uint8_t el,
                                                int32_t id, bool* keep) {
    uint32_t hi, lo;
    composite_hl<MODE>(a, r, e, raw, el, id, keep, &hi, &lo);
    return ((uint64_t)hi << 32) | lo;
}

// The output of winner composite c: its value and its index (window-local
// in the window mode) or id.
template <int MODE>
__device__ __forceinline__ void decode_m(const KeyedArgs& a,
                                         const RowView& r, uint64_t c,
                                         float* value, int32_t* idx) {
    const uint32_t e = esk_composite_index(c);
    *idx = (int32_t)e;
    if (MODE == KEYED_IDS) {
        const uint32_t o = (uint32_t)(c >> 32);
        *value = __uint_as_float(
            o == 0u ? 0x7fc00000u
                    : ((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o));
        return;
    }
    if (MODE == KEYED_FIELD || MODE == KEYED_RAW) {
        *value = r.key[e];  // the exact bits
        return;
    }
    bool keep;
    float masked;
    keyed_value_m<MODE>(a, r.cursor, r.ak, r.ad, e, r.key[e], r.elig[e],
                        &keep, &masked);
    // -top_k(-masked): the bottom-k's output negation flips a NaN's sign.
    *value = (MODE == KEYED_SCORE_ASC && isnan(masked))
                 ? __uint_as_float(__float_as_uint(masked) ^ 0x80000000u)
                 : masked;
}

__device__ __forceinline__ void pad_slot(float* value, int32_t* idx) {
    *value = -ESK_INF;
    *idx = 0;
}

static int sm_count() {
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

// The shared-memory opt-in of a kernel, once a device (it costs a driver
// call); `opted` is that kernel's own bitmask of devices.
template <typename Kernel>
static int smem_opt_in(Kernel kernel, size_t bytes, unsigned long long* opted) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 64 || !((*opted >> dev) & 1ull)) {
        ESK_SMEM_OPT_IN(kernel, bytes);
        if (dev < 64) {
            *opted |= 1ull << dev;
        }
    }
    return 0;
}

// A block's arrival ticket on `arrive`: true in the last of nb blocks to
// finish (after a fence, so it sees every block's global writes).
__device__ __forceinline__ bool last_block(int* arrive, int nb, int* ticket) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        *ticket = atomicAdd(arrive, 1);
    }
    __syncthreads();
    if (*ticket != nb - 1) {
        return false;
    }
    __threadfence();
    return true;
}

// ---------------------------------------------------------------------------
// The threshold select (1 <= kk <= KS_MAX_K): one pass over the keys, then
// one merge a row, in one launch. See the header.
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
    const unsigned lo = __shfl_xor_sync(FULL_MASK, (unsigned)v, j);
    const unsigned hi = __shfl_xor_sync(FULL_MASK, (unsigned)(v >> 32), j);
    return ((uint64_t)hi << 32) | lo;
}

// The kk-th largest (1 <= kk <= n) of the n composites a[0, n) in shared
// memory (n <= KS_CAP; equal composites count once each). 8-bit radix
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
            const unsigned peers = __match_any_sync(FULL_MASK, digit);
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
                const int t = __shfl_up_sync(FULL_MASK, incl, off);
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

// Keep the top kk of a[0, n) at a[0, kk), kth being their kk-th largest.
// Distinct composites: the entries at or above kth, one pass. TIES (the id
// mode, whose composites repeat): every entry above kth, then entries
// equal to it up to kk (equal composites are interchangeable). Returns kk.
template <bool TIES>
__device__ int ks_keep_top(uint64_t* a, int n, uint64_t kth, int kk,
                           KsState& st) {
    if (threadIdx.x == 0) {
        st.kept = 0;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const uint64_t v = a[i];
        if (TIES ? v > kth : v >= kth) {
            st.tmp[atomicAdd(&st.kept, 1)] = v;
        }
    }
    if (TIES) {
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            if (a[i] == kth) {
                const int slot = atomicAdd(&st.kept, 1);
                if (slot < kk) {
                    st.tmp[slot] = kth;
                }
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kk; i += blockDim.x) {
        a[i] = st.tmp[i];
    }
    __syncthreads();
    return kk;
}

// Row q's merge, by its last block: the top kq of its nb blocks'
// survivors (kq each at a stride of kp, unordered, 0-padded; nb * kp <=
// KS_CAP). The true kq-th largest is at least every block's own kq-th (its
// smallest survivor), so only survivors at or above the largest of those
// can win: they are gathered into buf, cut to the top kq (radix select)
// and sorted (bitonic), then decoded into the row's out_k slots (slots
// past kq: padding). Block 0 holds at least kq entries (a stripe is at
// least min(row, 2,048) entries), so that largest floor is a real
// composite and the 0 padding never passes it.
template <int MODE>
__device__ void ks_merge_row(const KeyedArgs& a, const RowView& r, int64_t q,
                             int kq, int kp, int out_k, int nb,
                             const uint64_t* __restrict__ surv,
                             float* __restrict__ values,
                             int32_t* __restrict__ top_idx, uint64_t* buf,
                             KsState& st) {
    const int n = nb * kp;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const uint64_t* src = surv + q * (int64_t)n;
    uint64_t fl = 0;  // the largest block floor this thread saw
    for (int b = threadIdx.x; b < nb && kq > 0; b += blockDim.x) {
        uint64_t mn = ~0ull;
        for (int i = 0; i < kq; ++i) {
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
    for (int i0 = 0; i0 < n && kq > 0; i0 += blockDim.x) {
        const int i = i0 + threadIdx.x;
        const uint64_t v = i < n ? __ldcg(src + i) : 0ull;
        const bool in = i < n && v >= fl_max;
        const unsigned bal = __ballot_sync(FULL_MASK, in);
        if (bal != 0u) {
            int base = 0;
            if (lane == 0) {
                base = atomicAdd(&st.count, __popc(bal));
            }
            base = __shfl_sync(FULL_MASK, base, 0);
            if (in) {
                buf[base + __popc(bal & ((1u << lane) - 1u))] = v;
            }
        }
    }
    __syncthreads();
    const int n2 = st.count;
    const int kept =
        n2 > kq ? ks_keep_top<MODE == KEYED_IDS>(
                      buf, n2, ks_kth_largest(buf, n2, kq, st), kq, st)
                : n2;
    int ch = 1;
    while (ch < kept) {
        ch <<= 1;
    }
    for (int i = kept + threadIdx.x; i < ch; i += blockDim.x) {
        buf[i] = 0ull;
    }
    esk_bitonic_desc(buf, ch);
    for (int s = threadIdx.x; s < out_k; s += blockDim.x) {
        const int64_t t = q * out_k + s;
        if (s < kq) {
            decode_m<MODE>(a, r, buf[s], values + t, top_idx + t);
        } else {
            pad_slot(values + t, top_idx + t);
        }
    }
}

// Row q's entries [b * stripe, (b + 1) * stripe) of its span (row_view):
// survivors (the block's top kq composites, unordered, 0-padded at a
// stride of kp) to surv[(q * nb + b) * kp ...], its eligible and kept
// counts added to total[q] / n_after[q] (K3k's modes; the others count
// total only), and a ticket from arrive[q]: the row's last block merges
// (ks_merge_row) into values / top_idx [q, out_k]. kq = min(kp, the row's
// length). MODE is the call's mode (the per-entry work is compiled for
// each).
//
// A threshold T filters the pass: only composites >= T enter the shared
// candidate buffer. T starts as the kq-th largest of KS_SAMPLE entries
// taken in 64 runs of 32 spread evenly over the stripe, the last run its
// final 32 entries (a subset's kq-th largest is at most the stripe's, so
// no winner is filtered; on a monotone column the last run bounds the
// winners, where every key in stripe order would beat a running kq-th).
// Rounds of KS_ROUND entries are block-synchronous, the next round's
// loads in flight while the current one is filtered (two register sets,
// alternating); an entry is tested against T in registers, and a warp
// appends to the buffer (a ballot, one atomic) only when one of its lanes
// holds a candidate; after a round that leaves more than KS_ROUND
// candidates, the buffer is cut to its top kq and T becomes its kq-th.
// Each key and eligible byte (and id) is read once, as float4 and 4-byte
// words (int4 ids) where the row's planes align, else 4-byte and 1-byte
// loads, coalesced.
template <int MODE>
__global__ void __launch_bounds__(KS_THREADS, 2)
ks_select_kernel(KeyedArgs a, int kp, int out_k, int nb, int64_t stripe,
                 uint64_t* __restrict__ surv, float* __restrict__ values,
                 int32_t* __restrict__ top_idx, int32_t* __restrict__ total,
                 int32_t* __restrict__ n_after, int32_t* __restrict__ arrive) {
    extern __shared__ uint64_t buf[];
    __shared__ KsState st;
    constexpr bool IDS = MODE == KEYED_IDS;
    const int64_t q = blockIdx.y;
    const RowView r = row_view(a, q);
    const int kq = (int)min((int64_t)kp, r.len);
    const int64_t lo = (int64_t)blockIdx.x * stripe;
    const int64_t hi = min(r.len, lo + stripe);
    const int64_t len = hi > lo ? hi - lo : 0;
    const float* krow = r.key;
    const uint8_t* erow = r.elig;
    const int32_t* irow = r.ids;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    uint64_t t_min = 0;
    if (len >= 2 * KS_SAMPLE && kq <= KS_SAMPLE) {
        constexpr int RUNS = KS_SAMPLE / 32;
        const int64_t gap = (len - 32) / (RUNS - 1);
        constexpr int PER_WARP = RUNS / (KS_THREADS / 32);
        float raw[PER_WARP];
        uint8_t el[PER_WARP];
        int32_t id[PER_WARP];
#pragma unroll
        for (int i = 0; i < PER_WARP; ++i) {  // every load in flight at once
            const int64_t e = lo + (warp + i * (KS_THREADS / 32)) * gap + lane;
            raw[i] = krow[e];
            el[i] = erow[e];
            id[i] = IDS ? irow[e] : 0;
        }
#pragma unroll
        for (int i = 0; i < PER_WARP; ++i) {
            const int run = warp + i * (KS_THREADS / 32);
            bool keep;
            buf[run * 32 + lane] = composite_m<MODE>(
                a, r, lo + run * gap + lane, raw[i], el[i], id[i], &keep);
        }
        __syncthreads();
        t_min = ks_kth_largest(buf, KS_SAMPLE, kq, st);
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
                       const int32_t (&id)[8], const int64_t (&idx)[8],
                       unsigned ok) {
        uint32_t ord[8];
        unsigned cm = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            bool keep;
            uint32_t inv;
            composite_hl<MODE>(a, r, idx[j], raw[j], el[j], id[j], &keep,
                               &ord[j], &inv);
            const bool in = (ok >> j) & 1u;
            n_keep += in && keep;
            const bool cand =
                in && (ord[j] > t_hi || (ord[j] == t_hi && inv >= t_lo));
            cm |= (unsigned)cand << j;
        }
        if (__any_sync(FULL_MASK, cm != 0u)) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const bool cand = (cm >> j) & 1u;
                const unsigned bal = __ballot_sync(FULL_MASK, cand);
                if (bal != 0u) {
                    int base = 0;
                    if (lane == 0) {
                        base = atomicAdd(&st.count, __popc(bal));
                    }
                    base = __shfl_sync(FULL_MASK, base, 0);
                    if (cand) {
                        const uint32_t inv =
                            IDS ? ~(uint32_t)id[j] : ~(uint32_t)idx[j];
                        buf[base + __popc(bal & ((1u << lane) - 1u))] =
                            ((uint64_t)ord[j] << 32) | inv;
                    }
                }
            }
        }
    };
    // After each round: cut the buffer to its top kq when it holds more
    // than a round's worth.
    auto settle = [&]() {
        __syncthreads();
        const int n = st.count;
        __syncthreads();  // every thread read n before the next appends
        if (n > KS_ROUND) {
            t_min = ks_kth_largest(buf, n, kq, st);
            ks_keep_top<IDS>(buf, n, t_min, kq, st);
            t_hi = (uint32_t)(t_min >> 32);
            t_lo = (uint32_t)t_min;
            if (threadIdx.x == 0) {
                st.count = kq;
            }
            __syncthreads();
        }
    };
    // The planes align to 4 entries after a head of < 4, if they can.
    // The rounds alternate between two register sets, so round r + 1's
    // loads are in flight while round r is filtered.
    const uintptr_t ka = (uintptr_t)(krow + lo);
    const uintptr_t ea = (uintptr_t)(erow + lo);
    const uintptr_t ia = IDS ? (uintptr_t)(irow + lo) : ka;
    if (ka % 4 == 0 && ((ka / 4) - ea) % 4 == 0 && ia % 16 == ka % 16) {
        constexpr int GR = KS_ROUND / 4;  // 4-entry groups a round
        const int64_t head = min(len, (int64_t)((4 - ea % 4) % 4));
        const int64_t body = (len - head) / 4;
        const int64_t tail0 = lo + head + body * 4;
        const int64_t rounds = body > 0 ? (body + GR - 1) / GR : 1;
        auto load = [&](int64_t rr, float4 (&k4)[2], uint32_t (&e4)[2],
                        int4 (&i4)[2]) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int64_t g = rr * GR + threadIdx.x + j * KS_THREADS;
                if (g < body) {
                    const int64_t e = lo + head + g * 4;
                    k4[j] = *reinterpret_cast<const float4*>(krow + e);
                    e4[j] = *reinterpret_cast<const uint32_t*>(erow + e);
                    if (IDS) {
                        i4[j] = *reinterpret_cast<const int4*>(irow + e);
                    }
                }
            }
        };
        auto round = [&](int64_t rr, const float4 (&k4)[2],
                         const uint32_t (&e4)[2], const int4 (&i4)[2]) {
            if (rr == 0 && warp < 2) {
                // The head and the tail (< 4 entries each) in round 0.
                const int t = threadIdx.x;
                const bool in_head = t < head;
                const bool in_tail = t >= 32 && t < 32 + (hi - tail0);
                const int64_t e = in_head ? lo + t : tail0 + (t - 32);
                const bool in = in_head || in_tail;
                float raw[8] = {in ? krow[e] : 0.f};
                uint8_t el[8] = {in ? erow[e] : (uint8_t)0};
                int32_t id[8] = {(IDS && in) ? irow[e] : 0};
                int64_t idx[8] = {e};
                n_elig += in && el[0] != 0;
                process(raw, el, id, idx, in ? 1u : 0u);
            }
            float raw[8];
            uint8_t el[8];
            int32_t id[8];
            int64_t idx[8];
            unsigned ok = 0;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int64_t g = rr * GR + threadIdx.x + j * KS_THREADS;
                const int64_t e = lo + head + g * 4;
                const float kf[4] = {k4[j].x, k4[j].y, k4[j].z, k4[j].w};
                const int32_t iv[4] = {i4[j].x, i4[j].y, i4[j].z, i4[j].w};
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                    raw[j * 4 + v] = kf[v];
                    el[j * 4 + v] = (uint8_t)(e4[j] >> (8 * v));
                    id[j * 4 + v] = iv[v];
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
            process(raw, el, id, idx, ok);
            settle();
        };
        float4 ka4[2], kb4[2];
        uint32_t ea4[2], eb4[2];
        int4 ia4[2] = {}, ib4[2] = {};
        load(0, ka4, ea4, ia4);
        for (int64_t rr = 0; rr < rounds; rr += 2) {
            if (rr + 1 < rounds) {
                load(rr + 1, kb4, eb4, ib4);
            }
            round(rr, ka4, ea4, ia4);
            if (rr + 1 < rounds) {
                if (rr + 2 < rounds) {
                    load(rr + 2, ka4, ea4, ia4);
                }
                round(rr + 1, kb4, eb4, ib4);
            }
        }
    } else {
        const int64_t rounds = (len + KS_ROUND - 1) / KS_ROUND;
        auto load = [&](int64_t rr, float (&k1)[8], uint8_t (&e1)[8],
                        int32_t (&i1)[8]) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int64_t e = lo + rr * KS_ROUND + threadIdx.x + j * KS_THREADS;
                if (e < hi) {
                    k1[j] = krow[e];
                    e1[j] = erow[e];
                    i1[j] = IDS ? irow[e] : 0;
                }
            }
        };
        auto round = [&](int64_t rr, const float (&k1)[8],
                         const uint8_t (&e1)[8], const int32_t (&i1)[8]) {
            int64_t idx[8];
            unsigned ok = 0;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                idx[j] = lo + rr * KS_ROUND + threadIdx.x + j * KS_THREADS;
                if (idx[j] < hi) {
                    ok |= 1u << j;
                    n_elig += e1[j] != 0;
                }
            }
            process(k1, e1, i1, idx, ok);
            settle();
        };
        float ka1[8], kb1[8];
        uint8_t ea1[8], eb1[8];
        int32_t ia1[8], ib1[8];
        load(0, ka1, ea1, ia1);
        for (int64_t rr = 0; rr < rounds; rr += 2) {
            if (rr + 1 < rounds) {
                load(rr + 1, kb1, eb1, ib1);
            }
            round(rr, ka1, ea1, ia1);
            if (rr + 1 < rounds) {
                if (rr + 2 < rounds) {
                    load(rr + 2, ka1, ea1, ia1);
                }
                round(rr + 1, kb1, eb1, ib1);
            }
        }
    }
    // The block's top kq, and its counts into the row's.
    __syncthreads();
    int n = st.count;
    if (n > kq) {
        ks_keep_top<IDS>(buf, n, ks_kth_largest(buf, n, kq, st), kq, st);
        n = kq;
    }
    uint64_t* dst = surv + (q * nb + blockIdx.x) * (int64_t)kp;
    for (int i = threadIdx.x; i < kp; i += blockDim.x) {
        dst[i] = i < n ? buf[i] : 0ull;  // 0: below every real composite
    }
    if (MODE >= KEYED_RAW) {
        n_keep = 0;  // no cursor: nothing to count past the eligibility
    }
    for (int off = 16; off > 0; off >>= 1) {
        n_elig += __shfl_down_sync(FULL_MASK, n_elig, off);
        n_keep += __shfl_down_sync(FULL_MASK, n_keep, off);
    }
    if (lane == 0 && n_elig != 0) {
        atomicAdd(total + q, n_elig);
    }
    if (MODE < KEYED_RAW && lane == 0 && n_keep != 0) {
        atomicAdd(n_after + q, n_keep);
    }
    // The row's last block to finish merges its survivors.
    if (!last_block(arrive + q, nb, &st.kept)) {
        return;
    }
    ks_merge_row<MODE>(a, r, q, kq, kp, out_k, nb, surv, values, top_idx,
                       buf, st);
}

// nb blocks a row: about two a multiprocessor over all rows, but at least
// one (1 to 65,535 rows, each its own grid row); at most one a KS_ROUND
// entries and at most the scratch's row capacity over kp (surv_row: the
// wrapper's min(ceil(width / KS_ROUND), KS_CAP / kp) * kp, so the last
// block's merge fits its buffer); stripes a multiple of 4 entries.
template <int MODE>
static int ks_launch(const KeyedArgs& a, int n_rows, int width, int kp,
                     int out_k, int64_t surv_row, uint64_t* surv,
                     float* values, int32_t* top_idx, int32_t* total,
                     int32_t* n_after, int32_t* arrive, cudaStream_t s) {
    int nb = esk_blocks(width, KS_ROUND);
    nb = esk_imin(nb, (int)(surv_row / kp));
    nb = esk_imin(nb, 2 * sm_count() / n_rows);
    nb = nb < 1 ? 1 : nb;
    const int64_t stripe = ((int64_t)esk_blocks(width, nb) + 3) / 4 * 4;
    nb = esk_blocks(width, (int)stripe);
    nb = nb < 1 ? 1 : nb;
    const size_t smem = (size_t)KS_CAP * sizeof(uint64_t);
    static unsigned long long opted = 0;
    const int rc = smem_opt_in(ks_select_kernel<MODE>, smem, &opted);
    if (rc != 0) {
        return rc;
    }
    ks_select_kernel<MODE><<<dim3(nb, n_rows), KS_THREADS, smem, s>>>(
        a, kp, out_k, nb, stripe, surv, values, top_idx, total, n_after,
        arrive);
    ESK_RETURN_IF_ERROR();
    return 0;
}

// ---------------------------------------------------------------------------
// Sorted runs and their merge by rank: the last step of the short-row sort
// and of the large-k select. A row's candidates (at most LK_FINAL_CAP) are
// cut into runs of LK_RUN, each sorted by its own block (bitonic_regs, in
// lk_runsort_kernel); an entry's rank is then its place in its run plus,
// in every other run, the entries above it (binary searches over the runs
// in shared memory: lk_rank_kernel), so every block of the row places its
// own entries in the output at once. A row of one run writes its outputs
// from the sort.
// ---------------------------------------------------------------------------

#define LK_SHORT_MAX 16384   // longest row sorted whole (the short-row sort)
#define LK_RUN_THREADS 512   // a run's block
#define LK_RUN_E 4           // composites a thread holds in registers
#define LK_RUN (LK_RUN_THREADS * LK_RUN_E)  // entries a sorted run: 2,048
#define LK_RANK_THREADS 1024
#define LK_RANK_PER LK_RANK_THREADS  // entries a rank block places
#define LK_FINAL_CAP 16384   // candidates the large-k select ranks at the end
#define LK_ROW_INTS 16       // a large-k row's state (LkRow) in ints

// Row q's candidates, as the run and rank kernels read them: from the
// input (the short-row sort: the row's composites, n = its length) or from
// F (the large-k select: n = LkRow::final_n, row stride LK_FINAL_CAP).
struct RunSource {
    const uint64_t* fbuf;  // null: the input
    const int* final_n;    // [Q] at a stride of LK_ROW_INTS ints, or null
    int64_t stride;        // F's row stride (composites)
};

template <int MODE>
__device__ __forceinline__ uint64_t input_composite(const KeyedArgs& a,
                                                    const RowView& r,
                                                    int64_t e, bool* keep,
                                                    uint8_t* el) {
    *el = r.elig[e];
    return composite_m<MODE>(a, r, e, r.key[e], *el,
                             MODE == KEYED_IDS ? r.ids[e] : 0, keep);
}

__host__ __device__ constexpr int lk_log2(int x) {
    return x <= 1 ? 0 : 1 + lk_log2(x >> 1);
}

// The descending bitonic network over a block's P = T * E composites,
// element g = t * E + e in register v[e] of thread t (K3m's network): the
// stages of stride below E inside a thread, below 32 E by warp shuffles,
// and the wider ones through shared memory sm[P].
template <int E, int T>
__device__ __forceinline__ void bitonic_regs(uint64_t (&v)[E], uint64_t* sm) {
    constexpr int LOG_P = lk_log2(T * E);
    const int t = threadIdx.x;
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
                        const bool desc = ((t * E + e) & size) == 0;
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
                    const uint64_t o = __shfl_xor_sync(FULL_MASK, v[e], j / E);
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
}

// Decode row q's ranked composite c into output slot s.
template <int MODE>
__device__ __forceinline__ void put_rank(const KeyedArgs& a,
                                         const RowView& r, int64_t q,
                                         int out_k, int s, uint64_t c,
                                         float* values, int32_t* top_idx) {
    const int64_t t = q * out_k + s;
    decode_m<MODE>(a, r, c, values + t, top_idx + t);
}

// Run blockIdx.x of row blockIdx.y: its entries [x * LK_RUN, ...) of the
// row's candidates sorted (bitonic_regs, 0-padded to LK_RUN) and written
// back to runs (row stride run_stride); from the input, the run's eligible
// (and kept) entries are counted into total / n_after. A row of one run (n
// <= LK_RUN) decodes its top kq into its out_k slots (past kq: padding).
template <int MODE>
__global__ void __launch_bounds__(LK_RUN_THREADS)
lk_runsort_kernel(KeyedArgs a, int kp, int out_k, RunSource src,
                  uint64_t* __restrict__ runs, int64_t run_stride,
                  float* __restrict__ values, int32_t* __restrict__ top_idx,
                  int32_t* __restrict__ total, int32_t* __restrict__ n_after) {
    __shared__ uint64_t sm[LK_RUN];
    const int64_t q = blockIdx.y;
    const RowView r = row_view(a, q);
    const int kq = (int)min((int64_t)kp, r.len);
    const int64_t n = src.fbuf == nullptr
                          ? r.len
                          : (int64_t)src.final_n[q * LK_ROW_INTS];
    const int64_t lo = (int64_t)blockIdx.x * LK_RUN;
    const bool alone = n <= LK_RUN;
    if (lo >= n && !(alone && blockIdx.x == 0)) {
        return;
    }
    const int len = (int)max((int64_t)0, min((int64_t)LK_RUN, n - lo));
    const int t = threadIdx.x;
    uint64_t v[LK_RUN_E];
    int ne = 0;
    int nk = 0;
    // Coalesced loads: register e of thread t starts with entry e * T + t
    // (the composite carries its index, so the start order is free).
#pragma unroll
    for (int e = 0; e < LK_RUN_E; ++e) {
        const int i = e * LK_RUN_THREADS + t;
        v[e] = 0;  // below every real composite
        if (i < len) {
            if (src.fbuf == nullptr) {
                bool keep;
                uint8_t el;
                v[e] = input_composite<MODE>(a, r, lo + i, &keep, &el);
                ne += el != 0;
                nk += keep;
            } else {
                v[e] = src.fbuf[q * src.stride + lo + i];
            }
        }
    }
    if (src.fbuf == nullptr) {
        for (int off = 16; off > 0; off >>= 1) {
            ne += __shfl_down_sync(FULL_MASK, ne, off);
            nk += __shfl_down_sync(FULL_MASK, nk, off);
        }
        if ((t & 31) == 0) {
            if (ne != 0) {
                atomicAdd(total + q, ne);
            }
            if (MODE < KEYED_RAW && nk != 0) {
                atomicAdd(n_after + q, nk);
            }
        }
    }
    bitonic_regs<LK_RUN_E, LK_RUN_THREADS>(v, sm);
#pragma unroll
    for (int e = 0; e < LK_RUN_E; ++e) {
        const int g = t * LK_RUN_E + e;
        if (alone) {
            if (g < kq) {
                put_rank<MODE>(a, r, q, out_k, g, v[e], values, top_idx);
            } else if (g < out_k) {
                const int64_t at = q * out_k + g;
                pad_slot(values + at, top_idx + at);
            }
        } else if (g < len) {
            runs[q * run_stride + lo + g] = v[e];
        }
    }
    if (alone) {  // out_k can pass the run (a window row of no entries)
        for (int s = LK_RUN + t; s < out_k; s += blockDim.x) {
            const int64_t at = q * out_k + s;
            pad_slot(values + at, top_idx + at);
        }
    }
}

// Entries of run sm[0, len) (descending) above c (strictly, or `ge`: at or
// above): the first position holding a smaller (or equal) composite.
__device__ __forceinline__ int run_count_above(const uint64_t* sm, int len,
                                               uint64_t c, bool ge) {
    int lo = 0;
    int hi = len;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const uint64_t v = sm[mid];
        if (v > c || (ge && v == c)) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// Row blockIdx.y's entries [x * LK_RANK_PER, ...) of its sorted runs (rows
// of more than one run): each entry's rank is its place in its run plus
// the entries above it in the other runs (at or above it in the runs
// before its own, so equal composites take distinct ranks); ranks below kq
// are decoded into the output. Block 0 pads the slots past kq.
template <int MODE>
__global__ void __launch_bounds__(LK_RANK_THREADS)
lk_rank_kernel(KeyedArgs a, int kp, int out_k, RunSource src,
               const uint64_t* __restrict__ runs, int64_t run_stride,
               float* __restrict__ values, int32_t* __restrict__ top_idx) {
    extern __shared__ uint64_t sm[];
    const int64_t q = blockIdx.y;
    const RowView r = row_view(a, q);
    const int kq = (int)min((int64_t)kp, r.len);
    const int n = src.fbuf == nullptr ? (int)r.len
                                      : src.final_n[q * LK_ROW_INTS];
    if (n <= LK_RUN) {
        return;  // one run: its sort wrote the outputs
    }
    const int lo = blockIdx.x * LK_RANK_PER;
    if (blockIdx.x == 0) {
        for (int s = kq + threadIdx.x; s < out_k; s += blockDim.x) {
            const int64_t t = q * out_k + s;
            pad_slot(values + t, top_idx + t);
        }
    }
    if (lo >= n) {
        return;
    }
    const uint64_t* row = runs + q * run_stride;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        sm[i] = row[i];
    }
    __syncthreads();
    const int nruns = (n + LK_RUN - 1) / LK_RUN;
    const int hi = min(n, lo + LK_RANK_PER);
    for (int e = lo + threadIdx.x; e < hi; e += blockDim.x) {
        const int own = e / LK_RUN;
        const int pos = e - own * LK_RUN;
        if (pos >= kq) {
            continue;  // its rank is at least its place in its run
        }
        const uint64_t c = sm[e];
        int rank = pos;
        for (int j = 0; j < nruns && rank < kq; ++j) {
            if (j != own) {
                const int len = min(LK_RUN, n - j * LK_RUN);
                rank += run_count_above(sm + j * LK_RUN, len, c, j < own);
            }
        }
        if (rank < kq) {
            put_rank<MODE>(a, r, q, out_k, rank, c, values, top_idx);
        }
    }
}

// ---------------------------------------------------------------------------
// The large-k select (kk = 0 or kk > KS_MAX_K, rows longer than
// LK_SHORT_MAX): an MSB-first radix select on the composite. See the
// header.
// ---------------------------------------------------------------------------

#define LK_THREADS 512
#define LK_PER 8                         // entries a thread a round
#define LK_ROUND (LK_THREADS * LK_PER)   // 4,096
#define LK_DIGIT 12                      // bits of a digit
#define LK_BINS (1 << LK_DIGIT)          // a row's histogram
#define LK_NDIG 6                        // five 12-bit digits, then 4 bits
#define LK_BCAP_DIV 4                    // S: a quarter of the row at most
#define LK_STAGE 512                     // a warp's staged appends
#define LK_NEG_INF_DIGIT 0x007           // -inf's top digit: the padding

// Digit p's shift and width: 52, 40, 28, 16, 4 (12 bits), then 0 (4 bits).
__host__ __device__ constexpr int lk_shift(int p) {
    return p < LK_NDIG - 1 ? 64 - LK_DIGIT * (p + 1) : 0;
}
__host__ __device__ constexpr int lk_bits(int p) {
    return p < LK_NDIG - 1 ? LK_DIGIT : 64 - LK_DIGIT * (LK_NDIG - 1);
}

// A row's state, zeroed by the call's memset. The bucket is the
// composites that match `prefix` on `mask` (the digits fixed so far):
// `above` composites lie above it (every one a winner) and `bucket` in it.
struct LkRow {
    int final_n;  // candidates in F once collected (read first: RunSource)
    int above;
    int bucket;
    int digits;   // digits fixed
    int has_s;    // S holds a stored bucket (a superset of the current)
    int s_len;    // entries in S
    int nw;       // winners in F's front: `above` when S was stored
    int done;     // the bucket is narrow enough (or every digit fixed)
    int arrive;   // the pass's arrival tickets
    int s_count;  // the storing pass's appends to S and F (the collect's)
    int w_count;
    int pad;
    unsigned long long prefix;
    unsigned long long mask;
};
static_assert(sizeof(LkRow) == LK_ROW_INTS * 4, "LkRow is LK_ROW_INTS ints");

// Add each lane's digit d (-1: none) to the shared histogram: the lanes
// of a warp with equal digits add once (runs of equal keys, the padding).
__device__ __forceinline__ void lk_hist_add(int* hist, int d) {
    if (__ballot_sync(FULL_MASK, d >= 0) == 0u) {
        return;
    }
    const unsigned peers = __match_any_sync(FULL_MASK, d);
    if (d >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
        atomicAdd(&hist[d], __popc(peers));
    }
}

struct LkFind {
    int digit;
    int above;  // entries in the bins above it
    int size;   // entries in it
};

// The bin of a row's global histogram h (nbins bins, from the top) that
// holds rank `need` (1 <= need <= the histogram's count); LK_THREADS
// threads, 8 bins a thread. The result lands in `out` for every thread.
__device__ void lk_find(const int* h, int nbins, int need, LkFind& out,
                        int* warp_tot) {
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    int c[8];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int b = nbins - 1 - (t * 8 + j);
        c[j] = b >= 0 ? __ldcg(h + b) : 0;
        sum += c[j];
    }
    int incl = sum;
    for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL_MASK, incl, off);
        if (lane >= off) {
            incl += v;
        }
    }
    if (lane == 31) {
        warp_tot[warp] = incl;
    }
    __syncthreads();
    for (int w = 0; w < warp; ++w) {
        incl += warp_tot[w];
    }
    const int excl = incl - sum;
    if (excl < need && need <= incl) {
        int acc = excl;
        for (int j = 0; j < 8; ++j) {
            if (acc + c[j] >= need) {
                out.digit = nbins - 1 - (t * 8 + j);
                out.above = acc;
                out.size = c[j];
                break;
            }
            acc += c[j];
        }
    }
    __syncthreads();
}

// Row r's entries [lo, hi) in block-synchronous rounds, LK_PER a thread:
// f(raw, el, id, idx, ok) a round (ok: a bit an entry in range). Where the
// planes align (after a head of < 4 entries, the key at 16 bytes, the
// eligible bytes at 4 and the ids as the key), a thread's entries are two
// runs of four, loaded as float4 / 4-byte words / int4, and the head and
// the tail (< 4 entries each) make one round of their own; else coalesced
// 4-byte and 1-byte loads. EL: the eligible bytes are needed.
template <int MODE, bool EL, typename F>
__device__ __forceinline__ void lk_stream(const RowView& r, int64_t lo,
                                          int64_t hi, F&& f) {
    constexpr bool IDS = MODE == KEYED_IDS;
    float raw[LK_PER];
    uint8_t el[LK_PER];
    int32_t id[LK_PER];
    int64_t idx[LK_PER];
    auto clear = [&]() {
#pragma unroll
        for (int j = 0; j < LK_PER; ++j) {
            raw[j] = 0.f;
            el[j] = 0;
            id[j] = 0;
            idx[j] = 0;
        }
    };
    if (hi <= lo) {
        return;
    }
    const int t = threadIdx.x;
    const uintptr_t ka = (uintptr_t)(r.key + lo);
    const uintptr_t ea = (uintptr_t)(r.elig + lo);
    const uintptr_t ia = IDS ? (uintptr_t)(r.ids + lo) : ka;
    if (((ka / 4) - ea) % 4 == 0 && ia % 16 == ka % 16) {
        const int64_t head = min(hi - lo, (int64_t)((4 - ea % 4) % 4));
        const int64_t groups = (hi - lo - head) / 4;
        const int64_t v0 = lo + head;
        const int64_t v1 = v0 + groups * 4;
        clear();
        unsigned ok = 0;
        const int64_t e = t < head ? lo + t
                          : (t >= 32 && t < 32 + (hi - v1)) ? v1 + (t - 32)
                                                            : -1;
        if (e >= 0) {
            ok = 1u;
            raw[0] = r.key[e];
            el[0] = EL ? r.elig[e] : (uint8_t)0;
            id[0] = IDS ? r.ids[e] : 0;
            idx[0] = e;
        }
        f(raw, el, id, idx, ok);
        for (int64_t g0 = 0; g0 < groups; g0 += 2 * LK_THREADS) {
            clear();
            ok = 0;
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                const int64_t g = g0 + t + jj * LK_THREADS;
                if (g < groups) {
                    const int64_t e4 = v0 + g * 4;
                    const float4 k4 = *reinterpret_cast<const float4*>(r.key + e4);
                    const uint32_t b4 =
                        EL ? *reinterpret_cast<const uint32_t*>(r.elig + e4) : 0u;
                    int4 i4 = {0, 0, 0, 0};
                    if (IDS) {
                        i4 = *reinterpret_cast<const int4*>(r.ids + e4);
                    }
                    const float kf[4] = {k4.x, k4.y, k4.z, k4.w};
                    const int32_t iv[4] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
                    for (int v = 0; v < 4; ++v) {
                        raw[jj * 4 + v] = kf[v];
                        el[jj * 4 + v] = (uint8_t)(b4 >> (8 * v));
                        id[jj * 4 + v] = iv[v];
                        idx[jj * 4 + v] = e4 + v;
                    }
                    ok |= 15u << (jj * 4);
                }
            }
            f(raw, el, id, idx, ok);
        }
        return;
    }
    for (int64_t base = lo; base < hi; base += LK_ROUND) {
        clear();
        unsigned ok = 0;
#pragma unroll
        for (int j = 0; j < LK_PER; ++j) {
            const int64_t e = base + t + j * LK_THREADS;
            if (e < hi) {
                ok |= 1u << j;
                raw[j] = r.key[e];
                if (EL) {
                    el[j] = r.elig[e];
                }
                if (IDS) {
                    id[j] = r.ids[e];
                }
                idx[j] = e;
            }
        }
        f(raw, el, id, idx, ok);
    }
}

// Pass 0: row q's entries [b * stripe, (b + 1) * stripe) of its span:
// total (and n_after) counted, the top digit of every composite in the
// row's histogram (-inf's, the padding, counted in a register); the row's
// last block finds the first bucket.
template <int MODE>
__global__ void __launch_bounds__(LK_THREADS, 2)
lk_hist_kernel(KeyedArgs a, int kp, int nb, int64_t stripe,
               LkRow* __restrict__ rows, int* __restrict__ ghist,
               int32_t* __restrict__ total, int32_t* __restrict__ n_after) {
    __shared__ int hist[LK_BINS];
    __shared__ int warp_tot[LK_THREADS / 32];
    __shared__ int ticket;
    __shared__ LkFind found;
    const int64_t q = blockIdx.y;
    const RowView r = row_view(a, q);
    for (int i = threadIdx.x; i < LK_BINS; i += blockDim.x) {
        hist[i] = 0;
    }
    __syncthreads();
    const int64_t lo = (int64_t)blockIdx.x * stripe;
    const int64_t hi = min(r.len, lo + stripe);
    int ne = 0;
    int nk = 0;
    int n_pad = 0;
    lk_stream<MODE, true>(r, lo, hi, [&](const float (&raw)[LK_PER],
                                         const uint8_t (&el)[LK_PER],
                                         const int32_t (&id)[LK_PER],
                                         const int64_t (&idx)[LK_PER],
                                         unsigned ok) {
#pragma unroll
        for (int j = 0; j < LK_PER; ++j) {
            const bool in = (ok >> j) & 1u;
            bool keep;
            const uint64_t c =
                composite_m<MODE>(a, r, idx[j], raw[j], el[j], id[j], &keep);
            ne += in && el[j] != 0;
            nk += in && keep;
            const int d = (int)(c >> lk_shift(0));
            const bool pad = in && d == LK_NEG_INF_DIGIT;
            n_pad += pad;
            lk_hist_add(hist, (in && !pad) ? d : -1);
        }
    });
    for (int off = 16; off > 0; off >>= 1) {
        ne += __shfl_down_sync(FULL_MASK, ne, off);
        nk += __shfl_down_sync(FULL_MASK, nk, off);
        n_pad += __shfl_down_sync(FULL_MASK, n_pad, off);
    }
    if ((threadIdx.x & 31) == 0) {
        if (n_pad != 0) {
            atomicAdd(&hist[LK_NEG_INF_DIGIT], n_pad);
        }
        if (ne != 0) {
            atomicAdd(total + q, ne);
        }
        if (MODE < KEYED_RAW && nk != 0) {
            atomicAdd(n_after + q, nk);
        }
    }
    __syncthreads();
    int* gh = ghist + q * LK_BINS;
    for (int i = threadIdx.x; i < LK_BINS; i += blockDim.x) {
        if (hist[i] != 0) {
            atomicAdd(gh + i, hist[i]);
        }
    }
    LkRow* row = rows + q;
    if (!last_block(&row->arrive, nb, &ticket)) {
        return;
    }
    const int kq = (int)min((int64_t)kp, r.len);
    if (kq > 0) {
        lk_find(gh, LK_BINS, kq, found, warp_tot);
        for (int i = threadIdx.x; i < LK_BINS; i += blockDim.x) {
            gh[i] = 0;
        }
    }
    if (threadIdx.x == 0) {
        if (kq > 0) {
            row->prefix = (unsigned long long)found.digit << lk_shift(0);
            row->mask = (unsigned long long)(LK_BINS - 1) << lk_shift(0);
            row->above = found.above;
            row->bucket = found.size;
            row->digits = 1;
        } else {
            row->done = 1;  // nothing to rank: the runs write padding
        }
        row->arrive = 0;
    }
}

// Pass p (1 <= p < LK_NDIG) of the rows not yet done: the bucket narrowed
// by digit p. A row whose bucket is stored reads S (its slice [b * chunk,
// ...) of the s_len entries); else it reads its input stripe again, and
// when the bucket fits S it stores the bucket's entries in S and those
// above it in F's front. The appends go through each warp's shared stage
// (one global atomic a flush, no block barrier). The row's last block
// finds digit p's bucket and decides whether the row is done.
template <int MODE>
__global__ void __launch_bounds__(LK_THREADS, 2)
lk_pass_kernel(KeyedArgs a, int kp, int nb, int64_t stripe, int pass,
               LkRow* __restrict__ rows, int* __restrict__ ghist,
               uint64_t* __restrict__ fbuf, uint64_t* __restrict__ sbuf,
               int64_t bcap) {
    extern __shared__ uint64_t stage[];  // LK_STAGE a warp
    __shared__ int hist[LK_BINS];
    __shared__ int warp_tot[LK_THREADS / 32];
    __shared__ int ticket;
    __shared__ LkFind found;
    __shared__ LkRow rs;
    const int64_t q = blockIdx.y;
    LkRow* row = rows + q;
    if (threadIdx.x == 0) {
        rs = *row;
    }
    __syncthreads();
    if (rs.done) {
        return;
    }
    const RowView r = row_view(a, q);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int shift = lk_shift(pass);
    const unsigned long long dmask = (1ull << lk_bits(pass)) - 1ull;
    const unsigned long long mask = rs.mask;
    const unsigned long long prefix = rs.prefix;
    for (int i = threadIdx.x; i < LK_BINS; i += blockDim.x) {
        hist[i] = 0;
    }
    __syncthreads();
    const bool store = !rs.has_s && rs.bucket <= bcap;
    if (rs.has_s) {
        const int64_t n = rs.s_len;
        const int64_t chunk = (n + nb - 1) / nb;
        const int64_t lo = (int64_t)blockIdx.x * chunk;
        const int64_t hi = min(n, lo + chunk);
        const uint64_t* src = sbuf + q * bcap;
        for (int64_t base = lo; base < hi; base += LK_ROUND) {
            uint64_t v[LK_PER];
#pragma unroll
            for (int j = 0; j < LK_PER; ++j) {
                const int64_t e = base + threadIdx.x + j * LK_THREADS;
                v[j] = e < hi ? src[e] : 0ull;
            }
#pragma unroll
            for (int j = 0; j < LK_PER; ++j) {
                const int64_t e = base + threadIdx.x + j * LK_THREADS;
                const bool in = e < hi && (v[j] & mask) == prefix;
                lk_hist_add(hist, in ? (int)((v[j] >> shift) & dmask) : -1);
            }
        }
    } else {
        const int64_t lo = (int64_t)blockIdx.x * stripe;
        const int64_t hi = min(r.len, lo + stripe);
        uint64_t* my = stage + warp * LK_STAGE;
        uint64_t* fdst = fbuf + q * (int64_t)LK_FINAL_CAP;
        uint64_t* sdst = sbuf + q * bcap;
        int staged = 0;  // warp-uniform
        // The warp's staged composites to F (above the bucket) and S (in
        // it), at one global atomic each.
        auto flush = [&]() {
            __syncwarp();
            int n_w = 0;
            int n_s = 0;
            for (int i = lane; i < staged; i += 32) {
                const bool w = (my[i] & mask) > prefix;
                n_w += w;
                n_s += !w;
            }
            int iw = n_w;
            int is = n_s;
            for (int off = 1; off < 32; off <<= 1) {
                const int tw = __shfl_up_sync(FULL_MASK, iw, off);
                const int ts = __shfl_up_sync(FULL_MASK, is, off);
                if (lane >= off) {
                    iw += tw;
                    is += ts;
                }
            }
            int bw = 0;
            int bs = 0;
            if (lane == 31) {
                bw = iw ? atomicAdd(&row->w_count, iw) : 0;
                bs = is ? atomicAdd(&row->s_count, is) : 0;
            }
            int64_t pw = __shfl_sync(FULL_MASK, bw, 31) + iw - n_w;
            int64_t ps = __shfl_sync(FULL_MASK, bs, 31) + is - n_s;
            for (int i = lane; i < staged; i += 32) {
                const uint64_t c = my[i];
                if ((c & mask) > prefix) {
                    if (pw < LK_FINAL_CAP) {
                        fdst[pw] = c;
                    }
                    ++pw;
                } else {
                    if (ps < bcap) {
                        sdst[ps] = c;
                    }
                    ++ps;
                }
            }
            __syncwarp();
            staged = 0;
        };
        // The raw and id modes' composites do not read the eligibility.
        lk_stream<MODE, (MODE < KEYED_RAW)>(
            r, lo, hi, [&](const float (&raw)[LK_PER],
                           const uint8_t (&el)[LK_PER],
                           const int32_t (&id)[LK_PER],
                           const int64_t (&idx)[LK_PER], unsigned ok) {
#pragma unroll
                for (int j = 0; j < LK_PER; ++j) {
                    bool keep;
                    const uint64_t v = composite_m<MODE>(a, r, idx[j], raw[j],
                                                         el[j], id[j], &keep);
                    const bool in = (ok >> j) & 1u;
                    const unsigned long long m = v & mask;
                    const bool b = in && m == prefix;
                    lk_hist_add(hist, b ? (int)((v >> shift) & dmask) : -1);
                    if (store) {
                        const bool put = b || (in && m > prefix);
                        const unsigned bal = __ballot_sync(FULL_MASK, put);
                        if (put) {
                            my[staged + __popc(bal & ((1u << lane) - 1u))] = v;
                        }
                        staged += __popc(bal);
                    }
                }
                if (store && staged > LK_STAGE - 32 * LK_PER) {
                    flush();
                }
            });
        if (store && staged > 0) {
            flush();
        }
    }
    __syncthreads();
    int* gh = ghist + q * LK_BINS;
    for (int i = threadIdx.x; i < LK_BINS; i += blockDim.x) {
        if (hist[i] != 0) {
            atomicAdd(gh + i, hist[i]);
        }
    }
    if (!last_block(&row->arrive, nb, &ticket)) {
        return;
    }
    const int kq = (int)min((int64_t)kp, r.len);
    lk_find(gh, 1 << lk_bits(pass), kq - rs.above, found, warp_tot);
    for (int i = threadIdx.x; i < LK_BINS; i += blockDim.x) {
        gh[i] = 0;
    }
    if (threadIdx.x == 0) {
        LkRow nr = rs;
        if (store) {
            nr.has_s = 1;
            nr.s_len = (int)min((int64_t)__ldcg(&row->s_count), bcap);
            nr.nw = __ldcg(&row->w_count);
        }
        nr.prefix |= (unsigned long long)found.digit << shift;
        nr.mask |= dmask << shift;
        nr.above += found.above;
        nr.bucket = found.size;
        nr.digits += 1;
        nr.done = (nr.has_s && nr.above + nr.bucket <= LK_FINAL_CAP) ||
                  nr.digits == LK_NDIG;
        nr.arrive = 0;
        nr.s_count = 0;
        nr.w_count = 0;
        *row = nr;
    }
}

// Exclusive block scan of two counts over LK_THREADS threads; returns the
// totals in tot[0..1] for every thread.
__device__ __forceinline__ void lk_scan2(int a, int b, int* ea, int* eb,
                                        int* sm, int* tot) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    constexpr int NW = LK_THREADS / 32;
    int ia = a;
    int ib = b;
    for (int off = 1; off < 32; off <<= 1) {
        const int ta = __shfl_up_sync(FULL_MASK, ia, off);
        const int tb = __shfl_up_sync(FULL_MASK, ib, off);
        if (lane >= off) {
            ia += ta;
            ib += tb;
        }
    }
    if (lane == 31) {
        sm[warp] = ia;
        sm[NW + warp] = ib;
    }
    __syncthreads();
    int ba = 0;
    int bb = 0;
    tot[0] = 0;
    tot[1] = 0;
    for (int w = 0; w < NW; ++w) {
        if (w < warp) {
            ba += sm[w];
            bb += sm[NW + w];
        }
        tot[0] += sm[w];
        tot[1] += sm[NW + w];
    }
    *ea = ba + ia - a;
    *eb = bb + ib - b;
    __syncthreads();
}

// The collect: every row is done (after the passes). Each block takes its
// slice of S (or, for a row that never stored its bucket, of its input)
// and writes the composites above the bucket after F's front winners (at
// nw) and the bucket's own from `above` on, as many as F holds (more only
// when every digit is fixed: equal composites); two passes over the
// slice, the first counting, one global atomic a block for each. The row's
// candidates are then F[0, final_n), final_n = above + min(bucket,
// LK_FINAL_CAP - above).
template <int MODE>
__global__ void __launch_bounds__(LK_THREADS, 2)
lk_collect_kernel(KeyedArgs a, int kp, int nb, int64_t stripe,
                  LkRow* __restrict__ rows, uint64_t* __restrict__ fbuf,
                  const uint64_t* __restrict__ sbuf, int64_t bcap) {
    __shared__ int scan[2 * (LK_THREADS / 32)];
    __shared__ int bases[2];
    const int64_t q = blockIdx.y;
    const RowView r = row_view(a, q);
    const int kq = (int)min((int64_t)kp, r.len);
    if (kq == 0) {
        return;
    }
    LkRow* row = rows + q;
    const LkRow rs = *row;
    const unsigned long long mask = rs.mask;
    const unsigned long long prefix = rs.prefix;
    int64_t lo;
    int64_t hi;
    if (rs.has_s) {
        const int64_t chunk = (rs.s_len + nb - 1) / nb;
        lo = (int64_t)blockIdx.x * chunk;
        hi = min((int64_t)rs.s_len, lo + chunk);
    } else {
        lo = (int64_t)blockIdx.x * stripe;
        hi = min(r.len, lo + stripe);
    }
    const uint64_t* s = sbuf + q * bcap;
    auto entry = [&](int64_t e) {
        if (rs.has_s) {
            return s[e];
        }
        bool keep;
        uint8_t el;
        return input_composite<MODE>(a, r, e, &keep, &el);
    };
    // Thread t takes entries lo + t + i * blockDim.x, in the same order in
    // both passes, so its writes fill the range its counts reserved.
    int n_w = 0;
    int n_b = 0;
    for (int64_t e = lo + threadIdx.x; e < hi; e += blockDim.x) {
        const unsigned long long m = entry(e) & mask;
        n_w += m > prefix;
        n_b += m == prefix;
    }
    int ew;
    int eb;
    int tot[2];
    lk_scan2(n_w, n_b, &ew, &eb, scan, tot);
    if (threadIdx.x == 0) {
        bases[0] = tot[0] ? atomicAdd(&row->w_count, tot[0]) : 0;
        bases[1] = tot[1] ? atomicAdd(&row->s_count, tot[1]) : 0;
    }
    __syncthreads();
    uint64_t* f = fbuf + q * (int64_t)LK_FINAL_CAP;
    int64_t pw = (rs.has_s ? rs.nw : 0) + (int64_t)bases[0] + ew;
    int64_t pb = (int64_t)rs.above + bases[1] + eb;
    for (int64_t e = lo + threadIdx.x; e < hi; e += blockDim.x) {
        const uint64_t c = entry(e);
        const unsigned long long m = c & mask;
        if (m > prefix) {
            f[pw++] = c;  // fewer than kq in all
        } else if (m == prefix) {
            if (pb < LK_FINAL_CAP) {
                f[pb] = c;
            }
            ++pb;
        }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        row->final_n = rs.above + min(rs.bucket, LK_FINAL_CAP - rs.above);
    }
}

// ---------------------------------------------------------------------------
// The dispatch, shared by every mode but the merge mode.
// ---------------------------------------------------------------------------

// The call's outputs and scratch (the wrappers' one allocation):
// counts i32[4 Q + (large-k: Q * (LK_ROW_INTS + LK_BINS))]: total, n_after,
// the select's tickets and a spare plane (so that the LkRows align to 8
// bytes), then the large-k rows' LkRow and histograms, zeroed by one
// memset; scratch u64: the select's survivors (scratch_row a row), the
// short-row sort's runs (scratch_row a row: the row in runs of LK_RUN,
// none for rows of one run), or the large-k select's F (LK_FINAL_CAP a
// row) then S (scratch_row a row). values f32 / top_idx i32 [Q, out_k].
struct TopkCall {
    int n_rows;
    int width;  // the longest row (the widest window)
    int kp;     // ranks a row at most: min(k, width)
    int out_k;  // output slots a row
    int32_t* counts;
    uint64_t* scratch;
    int64_t scratch_row;
    float* values;
    int32_t* top_idx;
};

template <int MODE>
static int lk_runs(const KeyedArgs& a, const TopkCall& c, RunSource src,
                   uint64_t* runs, int64_t run_stride, int max_n,
                   cudaStream_t s) {
    const int q = c.n_rows;
    const int nruns = esk_blocks(max_n, LK_RUN);
    lk_runsort_kernel<MODE><<<dim3(nruns < 1 ? 1 : nruns, q),
                              LK_RUN_THREADS, 0, s>>>(
        a, c.kp, c.out_k, src, runs, run_stride, c.values, c.top_idx,
        c.counts, c.counts + q);
    ESK_RETURN_IF_ERROR();
    if (max_n <= LK_RUN) {
        return 0;
    }
    static unsigned long long opted = 0;
    const int rc = smem_opt_in(lk_rank_kernel<MODE>,
                               (size_t)LK_FINAL_CAP * sizeof(uint64_t), &opted);
    if (rc != 0) {
        return rc;
    }
    lk_rank_kernel<MODE><<<dim3(esk_blocks(max_n, LK_RANK_PER), q),
                           LK_RANK_THREADS, (size_t)max_n * sizeof(uint64_t),
                           s>>>(a, c.kp, c.out_k, src, runs, run_stride,
                                c.values, c.top_idx);
    ESK_RETURN_IF_ERROR();
    return 0;
}

template <int MODE>
static int topk_run(const KeyedArgs& a, const TopkCall& c, cudaStream_t s) {
    const int q = c.n_rows;
    int32_t* total = c.counts;
    int32_t* n_after = c.counts + q;
    if (c.kp >= 1 && c.kp <= KS_MAX_K) {
        cudaMemsetAsync(c.counts, 0, sizeof(int32_t) * 3 * (size_t)q, s);
        ESK_RETURN_IF_ERROR();
        return ks_launch<MODE>(a, q, c.width, c.kp, c.out_k, c.scratch_row,
                               c.scratch, c.values, c.top_idx, total, n_after,
                               c.counts + 2 * q, s);
    }
    if (c.width <= LK_SHORT_MAX) {
        cudaMemsetAsync(c.counts, 0, sizeof(int32_t) * 2 * (size_t)q, s);
        ESK_RETURN_IF_ERROR();
        const RunSource src = {nullptr, nullptr, 0};
        return lk_runs<MODE>(a, c, src, c.scratch, c.scratch_row, c.width, s);
    }
    LkRow* rows = reinterpret_cast<LkRow*>(c.counts + 4 * q);
    int* ghist = c.counts + 4 * q + (int64_t)q * LK_ROW_INTS;
    cudaMemsetAsync(c.counts, 0,
                    sizeof(int32_t) * (size_t)q * (4 + LK_ROW_INTS + LK_BINS),
                    s);
    ESK_RETURN_IF_ERROR();
    // Stripes of a multiple of 4 entries, so that every block's planes
    // align as the row's do.
    int nb = esk_imin(esk_blocks(c.width, LK_ROUND), 2 * sm_count() / q);
    nb = nb < 1 ? 1 : nb;
    const int64_t stripe = ((int64_t)esk_blocks(c.width, nb) + 3) / 4 * 4;
    nb = esk_blocks(c.width, (int)stripe);
    uint64_t* fbuf = c.scratch;
    uint64_t* sbuf = c.scratch + (int64_t)q * LK_FINAL_CAP;
    lk_hist_kernel<MODE><<<dim3(nb, q), LK_THREADS, 0, s>>>(
        a, c.kp, nb, stripe, rows, ghist, total, n_after);
    ESK_RETURN_IF_ERROR();
    const size_t stage = (size_t)(LK_THREADS / 32) * LK_STAGE * sizeof(uint64_t);
    static unsigned long long opted = 0;
    const int rc = smem_opt_in(lk_pass_kernel<MODE>, stage, &opted);
    if (rc != 0) {
        return rc;
    }
    for (int p = 1; p < LK_NDIG; ++p) {
        lk_pass_kernel<MODE><<<dim3(nb, q), LK_THREADS, stage, s>>>(
            a, c.kp, nb, stripe, p, rows, ghist, fbuf, sbuf, c.scratch_row);
        ESK_RETURN_IF_ERROR();
    }
    lk_collect_kernel<MODE><<<dim3(nb, q), LK_THREADS, 0, s>>>(
        a, c.kp, nb, stripe, rows, fbuf, sbuf, c.scratch_row);
    ESK_RETURN_IF_ERROR();
    const RunSource src = {fbuf, &rows[0].final_n, LK_FINAL_CAP};
    return lk_runs<MODE>(a, c, src, fbuf, LK_FINAL_CAP, LK_FINAL_CAP, s);
}

static int topk_dispatch(const KeyedArgs& a, const TopkCall& c,
                         cudaStream_t s) {
    if (c.n_rows <= 0) {
        return 0;
    }
    switch (a.mode) {
        case KEYED_SCORE_DESC:
            return topk_run<KEYED_SCORE_DESC>(a, c, s);
        case KEYED_SCORE_ASC:
            return topk_run<KEYED_SCORE_ASC>(a, c, s);
        case KEYED_FIELD:
            return topk_run<KEYED_FIELD>(a, c, s);
        case KEYED_RAW:
            return topk_run<KEYED_RAW>(a, c, s);
        case KEYED_IDS:
            return topk_run<KEYED_IDS>(a, c, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

static KeyedArgs plain_args(const void* key, const void* eligible, int m) {
    KeyedArgs a;
    a.key = (const float*)key;
    a.eligible = (const uint8_t*)eligible;
    a.ids = nullptr;
    a.win_lo = nullptr;
    a.win_hi = nullptr;
    a.key_stride = m;
    a.m = m;
    a.mode = KEYED_RAW;
    a.desc = 0;
    a.missing_first = 0;
    a.after_key = nullptr;
    a.after_doc = nullptr;
    return a;
}

// K3 row and stacked modes (ids null) and K3i (ids i32[n_rows, m]). key
// f32[n_rows, m] (ineligible entries already -inf), eligible u8[n_rows, m];
// kp = min(k, m) ranks a row. counts / scratch / scratch_row as TopkCall.
// Outputs top_scores / top_idx [n_rows, kp] and total = counts[0, n_rows).
// 1 <= kp <= KS_MAX_K: the threshold select; else the short-row sort for
// m <= LK_SHORT_MAX, the large-k select above.
extern "C" int esk_masked_topk(
    const void* key,
    const void* ids,
    const void* eligible,
    int n_rows,
    int m,
    int kp,
    void* counts,
    void* scratch,
    long long scratch_row,
    void* top_scores,
    void* top_idx,
    void* stream) {
    KeyedArgs a = plain_args(key, eligible, m);
    if (ids != nullptr) {
        a.ids = (const int32_t*)ids;
        a.mode = KEYED_IDS;
    }
    const TopkCall c = {n_rows, m, kp, kp, (int32_t*)counts,
                        (uint64_t*)scratch, scratch_row, (float*)top_scores,
                        (int32_t*)top_idx};
    return topk_dispatch(a, c, (cudaStream_t)stream);
}

// K3b window mode. key f32[n_rows, m] (ineligible entries already -inf),
// eligible u8[n_rows, m], lo/hi i32[n_rows] with 0 <= lo <= hi <= m; wmax =
// max(hi - lo); kw = min(k, m, wmax) ranks a row at most (min(kw, hi - lo)
// in row q); out_k = min(k, m) output slots a row. Outputs top_scores /
// top_idx [n_rows, out_k] (window-local ids; slots past a row's ranks
// padding) and total = counts[0, n_rows). The design is chosen on kw and
// wmax as esk_masked_topk chooses it on kp and m.
extern "C" int esk_masked_topk_window(
    const void* key,
    const void* eligible,
    const void* lo,
    const void* hi,
    int n_rows,
    int m,
    int wmax,
    int kw,
    int out_k,
    void* counts,
    void* scratch,
    long long scratch_row,
    void* top_scores,
    void* top_idx,
    void* stream) {
    KeyedArgs a = plain_args(key, eligible, m);
    a.win_lo = (const int32_t*)lo;
    a.win_hi = (const int32_t*)hi;
    const TopkCall c = {n_rows, wmax, kw, out_k, (int32_t*)counts,
                        (uint64_t*)scratch, scratch_row, (float*)top_scores,
                        (int32_t*)top_idx};
    return topk_dispatch(a, c, (cudaStream_t)stream);
}

// K3k. key f32[n_rows, m] at row stride key_stride (0: one plane shared
// by every row), eligible u8[n_rows, m]; mode KEYED_SCORE_DESC / _ASC /
// KEYED_FIELD; after_key f32[n_rows] and after_doc i32[n_rows], or null for
// no cursor; kp = min(k, m). Outputs values / top_idx [n_rows, kp], total =
// counts[0, n_rows) and n_after = counts[n_rows, 2 n_rows). The design is
// chosen as in esk_masked_topk.
extern "C" int esk_keyed_topk(
    const void* key,
    long long key_stride,
    const void* eligible,
    int n_rows,
    int m,
    int kp,
    int mode,
    int desc,
    int missing_first,
    const void* after_key,
    const void* after_doc,
    void* counts,
    void* scratch,
    long long scratch_row,
    void* values,
    void* top_idx,
    void* stream) {
    if (mode < KEYED_SCORE_DESC || mode > KEYED_FIELD) {
        return (int)cudaErrorInvalidValue;
    }
    KeyedArgs a = plain_args(key, eligible, m);
    a.key_stride = key_stride;
    a.mode = mode;
    a.desc = desc;
    a.missing_first = missing_first;
    a.after_key = (const float*)after_key;
    a.after_doc = (const int32_t*)after_doc;
    const TopkCall c = {n_rows, m, kp, kp, (int32_t*)counts,
                        (uint64_t*)scratch, scratch_row, (float*)values,
                        (int32_t*)top_idx};
    return topk_dispatch(a, c, (cudaStream_t)stream);
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
