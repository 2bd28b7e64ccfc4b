// K10 bucket_fold: per-bucket count, and the sum, min and max of a value
// column, over rows cut into fixed chunks.
//
// Replaces: elasticsearch_tpu/ops/aggs_device.py `_bucket_metric_planes`
// (:91, the `.at[idx].add / .min / .max` scatters of a bucket's metric
// planes), the count scatters and doc_count sums of `_eval_agg` (:124):
// `terms` over a keyword field's postings (:165-190), `histogram`
// (:191-216) and every filter-family `doc_count` (:256-300, one bucket);
// and, in range mode, the [R, N] reductions of `range` (:217-250).
//
// The order is the contract. The fp32 sum is the only order-dependent
// output, and K10 fixes it so: the rows (postings or docs, in index order)
// are cut into chunks of CH consecutive rows; a chunk's partial sum for a
// bucket is 0.0 + v0 + v1 + ... over the chunk's counting rows of that
// bucket in row order; a bucket's sum is 0.0 + p0 + p1 + ... over the
// chunk partials in chunk order (a chunk without rows of the bucket adds
// +0.0, which changes no bit: no partial is ever -0.0). CH is 1,024 rows,
// doubled while the [C, nb] partials would exceed 2^22 entries and a
// chunk is shorter than the rows (ops/kernels.bucket_chunk_rows). The plain version in ops/kernels.py
// takes the same two left folds, so the two agree bit for bit. The
// reference's own order is XLA's (a scatter, or a tree reduce for range):
// against it the sums hold within rtol 1e-5. Counts are integer sums and
// min / max are order-free: IEEE 754-2019 minimum / maximum on non-NaN
// values (-0.0 < +0.0, XLA's rule), F32_MAX / -F32_MAX for an empty
// bucket. A NaN value is "no value": the row does not count.
//
// Scatter mode (esk_bucket_fold), P rows: row i counts in bucket b =
// bucket[i] (0 for every row when bucket is null) iff contrib[i], 0 <= b
// < nb and, with values, its value is not NaN; the value is
// values[docs[i]] (a doc-aligned column gathered at the postings' docs)
// or values[i]. Pass 1: one warp a chunk walks its rows 32 at a time;
// __match_any_sync groups the slab's rows by bucket and each group's
// lowest lane folds its peers' values in lane order into the chunk's
// accumulators (shared memory for nb <= 256, else the chunk's row of the
// partials in device memory), so distinct buckets fold in parallel and
// each bucket's rows stay in row order. Pass 2: one warp a bucket loads
// 32 chunk partials at a time and folds them in chunk order through
// shuffles; counts add and min / max reduce across the warp.
//
// Range mode (esk_range_fold), R ranges over N docs: doc i is a member of
// range r iff contrib[i] and lo[r] <= col[i] < hi[r] (ranges may overlap:
// each reduces alone); with a sub column, the members whose sub value is
// not NaN count, sum, min and max it. Pass 1: one warp a (chunk, group of
// 32 ranges), lane l holding range l's accumulators; for each 32-doc slab
// a ballot per range picks its members and the warp folds them in doc
// order through shuffles. Pass 2 is scatter mode's, over the [C, R]
// partials.
//
// Bound on an H100: bytes. Scatter mode reads bucket (4 B), contrib (1 B),
// docs (4 B, terms subs) and each counting row's value (4 B) once and
// writes 16 B a bucket; range mode reads col, contrib and sub (9 B) a doc
// once per group of 32 ranges (the R ranges of a group share the slab in
// registers). The [C, nb] partials are 16 B an entry, written once and
// read once. Pass 2 is a chain of C dependent adds a bucket (C = P / CH):
// at P = 8.8M that is 8,634 adds, tens of microseconds.
#include "common.cuh"

#include <float.h>

#define BF_WARPS 4
#define BF_THREADS (BF_WARPS * 32)
#define BF_SMEM_NB 256
#define BF_FULL 0xffffffffu

// IEEE 754-2019 minimum / maximum on non-NaN values: -0.0 < +0.0.
__device__ __forceinline__ float bf_min(float acc, float v) {
    return (v < acc || (v == acc && signbit(v))) ? v : acc;
}

__device__ __forceinline__ float bf_max(float acc, float v) {
    return (v > acc || (v == acc && signbit(acc))) ? v : acc;
}

// Pass 1 of scatter mode: one warp a chunk of `ch` rows.
template <bool VALUES>
__global__ void bf_chunk_kernel(
    const int32_t* __restrict__ bucket, const uint8_t* __restrict__ contrib,
    const float* __restrict__ values, const int32_t* __restrict__ docs,
    int64_t p, int nb, int64_t ch, int64_t n_chunks,
    int32_t* __restrict__ p_count, float* __restrict__ p_sum,
    float* __restrict__ p_min, float* __restrict__ p_max) {
    extern __shared__ float bf_smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t c = (int64_t)blockIdx.x * BF_WARPS + warp;
    if (c >= n_chunks) {
        return;  // the whole warp: no block-wide barrier follows
    }
    const bool in_smem = nb <= BF_SMEM_NB;
    const int per_warp = 32 + (in_smem ? 4 * nb : 0);
    float* stage = bf_smem + warp * per_warp;
    int32_t* acc_c;
    float* acc_s;
    float* acc_lo;
    float* acc_hi;
    if (in_smem) {
        acc_c = (int32_t*)(stage + 32);
        acc_s = stage + 32 + nb;
        acc_lo = stage + 32 + 2 * nb;
        acc_hi = stage + 32 + 3 * nb;
    } else {  // the chunk's own row of the partials
        acc_c = p_count + c * nb;
        acc_s = VALUES ? p_sum + c * nb : nullptr;
        acc_lo = VALUES ? p_min + c * nb : nullptr;
        acc_hi = VALUES ? p_max + c * nb : nullptr;
    }
    for (int b = lane; b < nb; b += 32) {
        acc_c[b] = 0;
        if (VALUES) {
            acc_s[b] = 0.0f;
            acc_lo[b] = FLT_MAX;
            acc_hi[b] = -FLT_MAX;
        }
    }
    __syncwarp();
    const int64_t lo = c * ch;
    const int64_t hi = min(p, lo + ch);
    for (int64_t base = lo; base < hi; base += 32) {
        const int64_t i = base + lane;
        bool ok = i < hi;
        int b = -1;
        float v = 0.0f;
        if (ok) {
            b = bucket != nullptr ? bucket[i] : 0;
            ok = contrib[i] != 0 && b >= 0 && b < nb;
        }
        if (VALUES && ok) {
            v = values[docs != nullptr ? (int64_t)docs[i] : i];
            ok = !isnan(v);
        }
        const int key = ok ? b : -1;
        const unsigned peers = __match_any_sync(BF_FULL, key);
        if (VALUES) {
            stage[lane] = v;
            __syncwarp();
        }
        if (ok && lane == __ffs(peers) - 1) {
            acc_c[b] += __popc(peers);
            if (VALUES) {
                float s = acc_s[b];
                float mn = acc_lo[b];
                float mx = acc_hi[b];
                for (unsigned m = peers; m != 0u; m &= m - 1u) {
                    const float x = stage[__ffs(m) - 1];
                    s = __fadd_rn(s, x);
                    mn = bf_min(mn, x);
                    mx = bf_max(mx, x);
                }
                acc_s[b] = s;
                acc_lo[b] = mn;
                acc_hi[b] = mx;
            }
        }
        __syncwarp();
    }
    if (in_smem) {
        for (int b = lane; b < nb; b += 32) {
            p_count[c * nb + b] = acc_c[b];
            if (VALUES) {
                p_sum[c * nb + b] = acc_s[b];
                p_min[c * nb + b] = acc_lo[b];
                p_max[c * nb + b] = acc_hi[b];
            }
        }
    }
}

// Pass 2 (both modes): one warp a bucket folds its [C] chunk partials in
// chunk order. p_count2 / count2 (range mode's member counts beside the
// sub counts) may be null; p_sum null means counts only.
__global__ void bf_combine_kernel(
    const int32_t* __restrict__ p_count, const int32_t* __restrict__ p_count2,
    const float* __restrict__ p_sum, const float* __restrict__ p_min,
    const float* __restrict__ p_max, int64_t n_chunks, int nb,
    int32_t* __restrict__ count, int32_t* __restrict__ count2,
    float* __restrict__ sum, float* __restrict__ vmin,
    float* __restrict__ vmax) {
    const int b = blockIdx.x * BF_WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (b >= nb) {
        return;
    }
    int cnt = 0;
    int cnt2 = 0;
    float s = 0.0f;
    float mn = FLT_MAX;
    float mx = -FLT_MAX;
    for (int64_t c0 = 0; c0 < n_chunks; c0 += 32) {
        const int64_t c = c0 + lane;
        const bool valid = c < n_chunks;
        const int64_t at = c * nb + b;
        if (valid) {
            cnt += p_count[at];
            if (p_count2 != nullptr) {
                cnt2 += p_count2[at];
            }
        }
        if (p_sum != nullptr) {
            const float ps = valid ? p_sum[at] : 0.0f;
            if (valid) {
                mn = bf_min(mn, p_min[at]);
                mx = bf_max(mx, p_max[at]);
            }
            const int n = (int)min((int64_t)32, n_chunks - c0);
            for (int k = 0; k < n; ++k) {
                s = __fadd_rn(s, __shfl_sync(BF_FULL, ps, k));
            }
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        cnt += __shfl_xor_sync(BF_FULL, cnt, off);
        cnt2 += __shfl_xor_sync(BF_FULL, cnt2, off);
        mn = bf_min(mn, __shfl_xor_sync(BF_FULL, mn, off));
        mx = bf_max(mx, __shfl_xor_sync(BF_FULL, mx, off));
    }
    if (lane == 0) {
        count[b] = cnt;
        if (count2 != nullptr) {
            count2[b] = cnt2;
        }
        if (p_sum != nullptr) {
            sum[b] = s;
            vmin[b] = mn;
            vmax[b] = mx;
        }
    }
}

static int bf_combine(const int32_t* p_count, const int32_t* p_count2,
                      const float* p_sum, const float* p_min,
                      const float* p_max, int64_t n_chunks, int nb,
                      int32_t* count, int32_t* count2, float* sum,
                      float* vmin, float* vmax, cudaStream_t s) {
    bf_combine_kernel<<<(unsigned)((nb + BF_WARPS - 1) / BF_WARPS),
                        BF_THREADS, 0, s>>>(
        p_count, p_count2, p_sum, p_min, p_max, n_chunks, nb, count, count2,
        sum, vmin, vmax);
    ESK_RETURN_IF_ERROR();
    return 0;
}

// Scatter mode. P rows; bucket i32[P] or null, contrib u8[P], values
// f32[*] or null, docs i32[P] or null; chunks of `ch` rows, n_chunks =
// ceil(P / ch); partials p_count i32[n_chunks * nb] and, with values,
// p_sum / p_min / p_max f32[n_chunks * nb]; outputs count i32[nb] and,
// with values, sum / vmin / vmax f32[nb].
extern "C" int esk_bucket_fold(
    const void* bucket, const void* contrib, const void* values,
    const void* docs, long long p, int nb, long long ch, void* p_count,
    void* p_sum, void* p_min, void* p_max, void* count, void* sum,
    void* vmin, void* vmax, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (nb <= 0) {
        return 0;
    }
    const int64_t n_chunks = (p + ch - 1) / ch;
    if (n_chunks > 0) {
        const unsigned blocks =
            (unsigned)((n_chunks + BF_WARPS - 1) / BF_WARPS);
        const size_t smem =
            (size_t)BF_WARPS * (32 + (nb <= BF_SMEM_NB ? 4 * nb : 0)) *
            sizeof(float);
        if (values != nullptr) {
            bf_chunk_kernel<true><<<blocks, BF_THREADS, smem, s>>>(
                (const int32_t*)bucket, (const uint8_t*)contrib,
                (const float*)values, (const int32_t*)docs, (int64_t)p, nb,
                (int64_t)ch, n_chunks, (int32_t*)p_count, (float*)p_sum,
                (float*)p_min, (float*)p_max);
        } else {
            bf_chunk_kernel<false><<<blocks, BF_THREADS, smem, s>>>(
                (const int32_t*)bucket, (const uint8_t*)contrib, nullptr,
                nullptr, (int64_t)p, nb, (int64_t)ch, n_chunks,
                (int32_t*)p_count, nullptr, nullptr, nullptr);
        }
        ESK_RETURN_IF_ERROR();
    }
    return bf_combine((const int32_t*)p_count, nullptr, (const float*)p_sum,
                      (const float*)p_min, (const float*)p_max, n_chunks, nb,
                      (int32_t*)count, nullptr, (float*)sum, (float*)vmin,
                      (float*)vmax, s);
}

// Pass 1 of range mode: one warp a (chunk, group of 32 ranges).
template <bool SUB>
__global__ void rf_chunk_kernel(
    const float* __restrict__ col, const uint8_t* __restrict__ contrib,
    const float* __restrict__ sub, const float* __restrict__ lo,
    const float* __restrict__ hi, int64_t n, int r_count, int64_t ch,
    int64_t n_chunks, int32_t* __restrict__ p_count,
    int32_t* __restrict__ p_scount, float* __restrict__ p_sum,
    float* __restrict__ p_min, float* __restrict__ p_max) {
    const int lane = threadIdx.x & 31;
    const int64_t c = (int64_t)blockIdx.x * BF_WARPS + (threadIdx.x >> 5);
    if (c >= n_chunks) {
        return;
    }
    const int r0 = blockIdx.y * 32;
    const int nr = min(32, r_count - r0);
    const bool own = lane < nr;
    const float my_lo = own ? lo[r0 + lane] : 0.0f;
    const float my_hi = own ? hi[r0 + lane] : 0.0f;
    int cnt = 0;
    int scnt = 0;
    float s = 0.0f;
    float mn = FLT_MAX;
    float mx = -FLT_MAX;
    const int64_t d_lo = c * ch;
    const int64_t d_hi = min(n, d_lo + ch);
    for (int64_t base = d_lo; base < d_hi; base += 32) {
        const int64_t i = base + lane;
        bool m = false;
        float x = 0.0f;
        float v = 0.0f;
        if (i < d_hi) {
            m = contrib[i] != 0;
            x = col[i];
            if (SUB) {
                v = sub[i];
            }
        }
        for (int j = 0; j < nr; ++j) {
            const float a = __shfl_sync(BF_FULL, my_lo, j);
            const float z = __shfl_sync(BF_FULL, my_hi, j);
            const bool member = m && x >= a && x < z;
            const int in = __popc(__ballot_sync(BF_FULL, member));
            if (lane == j) {
                cnt += in;
            }
            if (!SUB) {
                continue;
            }
            unsigned with = __ballot_sync(BF_FULL, member && !isnan(v));
            if (with == 0u) {
                continue;
            }
            float t = __shfl_sync(BF_FULL, s, j);
            float tl = __shfl_sync(BF_FULL, mn, j);
            float th = __shfl_sync(BF_FULL, mx, j);
            const int k_in = __popc(with);
            for (; with != 0u; with &= with - 1u) {
                const float y = __shfl_sync(BF_FULL, v, __ffs(with) - 1);
                t = __fadd_rn(t, y);
                tl = bf_min(tl, y);
                th = bf_max(th, y);
            }
            if (lane == j) {
                scnt += k_in;
                s = t;
                mn = tl;
                mx = th;
            }
        }
    }
    if (own) {
        const int64_t at = c * r_count + r0 + lane;
        p_count[at] = cnt;
        if (SUB) {
            p_scount[at] = scnt;
            p_sum[at] = s;
            p_min[at] = mn;
            p_max[at] = mx;
        }
    }
}

// Range mode. N docs; col f32[N], contrib u8[N], sub f32[N] or null,
// lo / hi f32[R]; chunks of `ch` docs; partials p_count i32[n_chunks * R]
// and, with sub, p_scount i32, p_sum / p_min / p_max f32[n_chunks * R];
// outputs counts i32[R] and, with sub, scount i32[R], sum / vmin / vmax
// f32[R].
extern "C" int esk_range_fold(
    const void* col, const void* contrib, const void* sub, const void* lo,
    const void* hi, long long n, int r_count, long long ch, void* p_count,
    void* p_scount, void* p_sum, void* p_min, void* p_max, void* counts,
    void* scount, void* sum, void* vmin, void* vmax, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (r_count <= 0) {
        return 0;
    }
    const int64_t n_chunks = (n + ch - 1) / ch;
    if (n_chunks > 0) {
        const dim3 grid((unsigned)((n_chunks + BF_WARPS - 1) / BF_WARPS),
                        (unsigned)((r_count + 31) / 32));
        if (sub != nullptr) {
            rf_chunk_kernel<true><<<grid, BF_THREADS, 0, s>>>(
                (const float*)col, (const uint8_t*)contrib, (const float*)sub,
                (const float*)lo, (const float*)hi, (int64_t)n, r_count,
                (int64_t)ch, n_chunks, (int32_t*)p_count, (int32_t*)p_scount,
                (float*)p_sum, (float*)p_min, (float*)p_max);
        } else {
            rf_chunk_kernel<false><<<grid, BF_THREADS, 0, s>>>(
                (const float*)col, (const uint8_t*)contrib, nullptr,
                (const float*)lo, (const float*)hi, (int64_t)n, r_count,
                (int64_t)ch, n_chunks, (int32_t*)p_count, nullptr, nullptr,
                nullptr, nullptr);
        }
        ESK_RETURN_IF_ERROR();
    }
    if (sub == nullptr) {
        return bf_combine((const int32_t*)p_count, nullptr, nullptr, nullptr,
                          nullptr, n_chunks, r_count, (int32_t*)counts,
                          nullptr, nullptr, nullptr, nullptr, s);
    }
    return bf_combine((const int32_t*)p_scount, (const int32_t*)p_count,
                      (const float*)p_sum, (const float*)p_min,
                      (const float*)p_max, n_chunks, r_count,
                      (int32_t*)scount, (int32_t*)counts, (float*)sum,
                      (float*)vmin, (float*)vmax, s);
}
