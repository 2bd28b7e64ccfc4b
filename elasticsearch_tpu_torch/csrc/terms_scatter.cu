// K1 terms_scatter: worklist tile gather + BM25 impact + ordered scatter.
//
// Replaces: elasticsearch_tpu/ops/bm25_device.py `_gather_tiles` (:418),
// `_eval_terms` (:449), `_eval_terms_gather` (:458), `_scatter_scored`
// (:436) and, in matched-only mode, `_terms_matched` (:667).
//
// Bound on an H100: bytes. Each valid posting reads its doc id (4 B) and
// impact (4 B) once and read-modify-writes one score (4 B + 4 B) and one
// matched byte; there is ~1 fp32 division per 20 bytes, far below the
// card's compute roofline.
//
// Design: one block of 256 threads per worklist entry (one posting tile),
// so the tile read is one fully coalesced 1 KB load per plane. The
// reference's dense result equals the oracle's left fold in query-term
// order bit for bit, and float atomics would add in an undefined order.
// So the worklist is split on the host into GROUPS: consecutive entries of
// one term occurrence (same [start, end) span, strictly increasing tile
// ids). Inside a group every doc appears at most once, so a plain
// read-modify-write is race-free; groups are launched in order on one
// stream, which gives exactly the reference's per-doc accumulation order.
// The matched bitmap is order-free and needs no grouping.
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
    int e0,
    float* __restrict__ scores,
    uint8_t* __restrict__ matched,
    int matched_only) {
    const int e = e0 + blockIdx.x;
    const int64_t pos = (int64_t)tile_ids[e] * ESK_TILE + threadIdx.x;
    if (pos < (int64_t)starts[e] || pos >= (int64_t)ends[e]) {
        return;
    }
    const int32_t doc = doc_tiles[pos];
    matched[doc] = 1;
    if (matched_only) {
        return;
    }
    const float w = weights[e];
    float x = vals[pos];
    if (cache != nullptr) {
        // Custom-params path: tf * normInverse[normByte], never an FMA.
        x = __fmul_rn(x, cache[norm_bytes[doc]]);
    }
    const float contrib = __fsub_rn(w, __fdiv_rn(w, __fadd_rn(1.0f, x)));
    scores[doc] = __fadd_rn(scores[doc], contrib);
}

// groups: host array of 2 * n_groups ints, [e0, e1) per group, in order.
// With matched_only the groups are ignored and all entries [0, n_entries)
// run in one launch.
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
    int n_groups,
    int n_entries,
    void* scores,
    void* matched,
    int matched_only,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (matched_only) {
        if (n_entries > 0) {
            terms_scatter_kernel<<<n_entries, ESK_TILE, 0, s>>>(
                (const int32_t*)doc_tiles, (const float*)vals,
                (const uint8_t*)norm_bytes, (const float*)cache,
                (const int32_t*)tile_ids, (const int32_t*)starts,
                (const int32_t*)ends, (const float*)weights, 0,
                (float*)scores, (uint8_t*)matched, 1);
            ESK_RETURN_IF_ERROR();
        }
        return 0;
    }
    for (int g = 0; g < n_groups; ++g) {
        const int e0 = groups[2 * g];
        const int e1 = groups[2 * g + 1];
        if (e1 <= e0) {
            continue;
        }
        terms_scatter_kernel<<<e1 - e0, ESK_TILE, 0, s>>>(
            (const int32_t*)doc_tiles, (const float*)vals,
            (const uint8_t*)norm_bytes, (const float*)cache,
            (const int32_t*)tile_ids, (const int32_t*)starts,
            (const int32_t*)ends, (const float*)weights, e0,
            (float*)scores, (uint8_t*)matched, 0);
        ESK_RETURN_IF_ERROR();
    }
    return 0;
}
