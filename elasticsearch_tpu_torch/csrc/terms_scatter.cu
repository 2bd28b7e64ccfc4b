// K1 terms_scatter: worklist tile gather + BM25 impact + ordered scatter,
// for Q worklists (rows) at once.
//
// Replaces: elasticsearch_tpu/ops/bm25_device.py `_gather_tiles` (:418),
// `_eval_terms` (:449), `_eval_terms_gather` (:458), `_scatter_scored`
// (:436) and, in matched-only mode (esk_terms_matched, below),
// `_terms_matched` (:667), `compute_filter_mask` (:1797) and
// `compute_filter_mask_stacked` (:1812) — solo, and under the vmap of
// `execute_batch` (:1261), whose rows are Q queries of one spec. A solo
// query is the row count Q = 1.
//
// Bound on an H100: bytes. Each valid posting reads its doc id (4 B) and
// impact (4 B) once and read-modify-writes one score (4 B + 4 B) and one
// matched byte; there is ~1 fp32 division per 20 bytes, far below the
// card's compute roofline.
//
// Design: one block of 256 threads per (worklist entry, row), so the tile
// read is one fully coalesced 1 KB load per plane. The reference's dense
// result equals the oracle's left fold in query-term order bit for bit,
// and float atomics would add in an undefined order. So each row's
// worklist is split on the host into GROUPS: consecutive entries of one
// term occurrence (same [start, end) span, strictly increasing tile ids).
// Inside a group every doc appears at most once, so a plain
// read-modify-write is race-free; groups are launched in order on one
// stream, which gives exactly the reference's per-doc accumulation order.
// Rows have different group counts and lengths: launch g runs group g of
// every row (grid.y = row), is as wide as the longest group g of any row,
// and a block past its row's group (or a row without a group g) returns.
// Rows write disjoint [num_docs + 1] planes, so they never race. A single
// row takes its group bounds as launch arguments, so a solo query uploads
// nothing.
//
// Matched-only mode (esk_terms_matched; a constant terms filter's bitmap
// on the dense path and every filter-cache plane): the bitmap is
// order-free and needs no grouping, no weights and no norm planes, so it
// has a C entry and a kernel of its own and is one host call: a
// cudaMemsetAsync clears the [Q, N + 1] bool plane, then one launch. A
// warp takes one worklist entry: lane 0 reads its tile id, start and end
// once and broadcasts them; a tile outside [start, end) leaves at once;
// each lane then loads four consecutive doc ids of the 1 KB tile with one
// 16-byte load (twice: 32 lanes x 4 x 2 = 256 ids) and sets the bytes of
// those inside [start, end). Bound: bytes, the valid postings' ids read
// once and the plane written once (cfg2's head-term filter: 8,493,047
// postings over 8,841,823 docs, 43 MB, 0.013 ms at 3.35 TB/s); the memset
// is the plane's write, the scattered byte stores land in it again in L2.
//
// Stacked mode (K1s; `_shards_inner` :1137 under the vmap of
// `execute_shards_batch` :1161): the planes are S shards' planes stacked
// to equal shapes, [S, NT, 256] and [S, N + 1], and row r is the pair
// (query r / S, shard r % S), reading shard r % S's planes at the shard
// strides. One launch serves all Q x S pairs; S = 1 is the mode above.
#include "common.cuh"

__global__ void terms_scatter_kernel(
    const int32_t* __restrict__ doc_tiles,
    const float* __restrict__ vals,
    const uint8_t* __restrict__ norm_bytes,
    const float* __restrict__ cache,
    const int32_t* __restrict__ tile_ids,
    const int32_t* __restrict__ starts,
    const int32_t* __restrict__ ends,
    const float* __restrict__ weights,
    const int32_t* __restrict__ bounds,
    int n_groups,
    int g,
    int e0,
    int e1,
    int nt,
    int64_t n1,
    float* __restrict__ scores,
    uint8_t* __restrict__ matched,
    int n_shards,
    int64_t tile_stride,
    int64_t norm_stride) {
    const int q = blockIdx.y;
    if (n_shards > 1) {
        const int64_t shard = q % n_shards;
        doc_tiles += shard * tile_stride;
        vals += shard * tile_stride;
        norm_bytes += shard * norm_stride;
    }
    if (bounds != nullptr) {
        const int32_t* b = bounds + ((int64_t)q * n_groups + g) * 2;
        e0 = b[0];
        e1 = b[1];
    }
    const int e = blockIdx.x + e0;
    if (e >= e1) {
        return;
    }
    const int64_t row_e = (int64_t)q * nt + e;
    const int64_t pos = (int64_t)tile_ids[row_e] * ESK_TILE + threadIdx.x;
    if (pos < (int64_t)starts[row_e] || pos >= (int64_t)ends[row_e]) {
        return;
    }
    const int32_t doc = doc_tiles[pos];
    matched[(int64_t)q * n1 + doc] = 1;
    const float w = weights[row_e];
    float x = vals[pos];
    if (cache != nullptr) {
        // Custom-params path: tf * normInverse[normByte], never an FMA.
        x = __fmul_rn(x, cache[q * 256 + norm_bytes[doc]]);
    }
    const float contrib = __fsub_rn(w, __fdiv_rn(w, __fadd_rn(1.0f, x)));
    float* s = scores + (int64_t)q * n1 + doc;
    *s = __fadd_rn(*s, contrib);
}

// Rows q in [0, n_rows), worklists tile_ids/starts/ends/weights [n_rows,
// nt], cache [n_rows, 256] or null, outputs scores/matched [n_rows, n1].
// groups: host int32 [n_rows, n_groups, 2], each row's group g as [e0, e1)
// (empty [0, 0) past the row's last group); bounds: the same on the
// device, needed (and read) only when n_rows > 1. group_len: host int32
// [n_groups], the longest group g of any row (null for one row: its own
// group lengths). n_shards > 1: the planes are [n_shards, ...] stacks,
// tile_stride and norm_stride elements apart, and row q reads shard
// q % n_shards. The caller zeroes scores and matched.
extern "C" int esk_terms_scatter(
    const void* doc_tiles,
    const void* vals,
    const void* norm_bytes,
    const void* cache,
    const void* tile_ids,
    const void* starts,
    const void* ends,
    const void* weights,
    const int* groups,
    const void* bounds,
    const int* group_len,
    int n_groups,
    int n_rows,
    int nt,
    long long n1,
    void* scores,
    void* matched,
    int n_shards,
    long long tile_stride,
    long long norm_stride,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_rows <= 0 || nt <= 0 || n_shards <= 0) {
        return 0;
    }
    const int32_t* dev_bounds = n_rows > 1 ? (const int32_t*)bounds : nullptr;
    for (int g = 0; g < n_groups; ++g) {
        const int len = group_len != nullptr
                            ? group_len[g]
                            : groups[2 * g + 1] - groups[2 * g];
        if (len <= 0) {
            continue;
        }
        terms_scatter_kernel<<<dim3(len, n_rows), ESK_TILE, 0, s>>>(
            (const int32_t*)doc_tiles, (const float*)vals,
            (const uint8_t*)norm_bytes, (const float*)cache,
            (const int32_t*)tile_ids, (const int32_t*)starts,
            (const int32_t*)ends, (const float*)weights, dev_bounds,
            n_groups, g, groups[2 * g], groups[2 * g + 1], nt, (int64_t)n1,
            (float*)scores, (uint8_t*)matched, n_shards,
            (int64_t)tile_stride, (int64_t)norm_stride);
        ESK_RETURN_IF_ERROR();
    }
    return 0;
}

#define TM_WARPS 8  // worklist entries a block, one a warp

__global__ void __launch_bounds__(32 * TM_WARPS) terms_matched_kernel(
    const int32_t* __restrict__ doc_tiles,
    const int32_t* __restrict__ tile_ids,
    const int32_t* __restrict__ starts,
    const int32_t* __restrict__ ends,
    int nt,
    int64_t n1,
    uint8_t* __restrict__ matched,
    int n_shards,
    int64_t tile_stride) {
    const int q = blockIdx.y;
    const int e = blockIdx.x * TM_WARPS + (threadIdx.x >> 5);
    if (e >= nt) {
        return;  // the warp's entry is past the worklist: the whole warp
    }
    const int lane = threadIdx.x & 31;
    const int64_t row_e = (int64_t)q * nt + e;
    int tile = 0;
    int start = 0;
    int end = 0;
    if (lane == 0) {
        tile = tile_ids[row_e];
        start = starts[row_e];
        end = ends[row_e];
    }
    tile = __shfl_sync(0xffffffffu, tile, 0);
    start = __shfl_sync(0xffffffffu, start, 0);
    end = __shfl_sync(0xffffffffu, end, 0);
    const int64_t base = (int64_t)tile * ESK_TILE;
    if (start >= end || base >= end || base + ESK_TILE <= start) {
        return;  // no posting of this tile lies in [start, end)
    }
    const int32_t* docs = doc_tiles + (int64_t)(q % n_shards) * tile_stride;
    uint8_t* row = matched + (int64_t)q * n1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int64_t pos = base + h * (ESK_TILE / 2) + lane * 4;
        if (pos + 4 <= start || pos >= end) {
            continue;
        }
        const int4 d = *reinterpret_cast<const int4*>(docs + pos);
        const int32_t ids[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (pos + j >= start && pos + j < end) {
                row[ids[j]] = 1;
            }
        }
    }
}

// K1's matched-only mode: rows q in [0, n_rows) of worklists tile_ids /
// starts / ends [n_rows, nt] over doc_tiles [n_shards, NT, 256] (shard
// stride tile_stride elements; row q reads shard q % n_shards; one
// segment is n_shards = 1), output matched bool[n_rows, n1], cleared here.
// doc_tiles must be 16-byte aligned (its tiles are 1 KB apart).
extern "C" int esk_terms_matched(
    const void* doc_tiles,
    const void* tile_ids,
    const void* starts,
    const void* ends,
    int n_rows,
    int nt,
    long long n1,
    void* matched,
    int n_shards,
    long long tile_stride,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_rows <= 0) {
        return 0;
    }
    cudaMemsetAsync(matched, 0, (size_t)n_rows * (size_t)n1, s);
    ESK_RETURN_IF_ERROR();
    if (nt <= 0) {
        return 0;
    }
    terms_matched_kernel<<<dim3((nt + TM_WARPS - 1) / TM_WARPS, n_rows),
                           32 * TM_WARPS, 0, s>>>(
        (const int32_t*)doc_tiles, (const int32_t*)tile_ids,
        (const int32_t*)starts, (const int32_t*)ends, nt, (int64_t)n1,
        (uint8_t*)matched, n_shards < 1 ? 1 : n_shards,
        (int64_t)tile_stride);
    ESK_RETURN_IF_ERROR();
    return 0;
}
