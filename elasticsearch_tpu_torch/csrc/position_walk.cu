// K12 position_walk: per-doc walks over K11's sorted position events,
// then the frequency -> BM25 tail, into each row's [N] planes.
//
// Replaces: elasticsearch_tpu/ops/bm25_device.py, the run count of
// `_eval_phrase` (:503-520), the chain DP of `_span_chain_ends` (:567)
// with `_segmented_cummax` (:529), the unordered relabel and `end_limit`
// cut of `_eval_span_near` (:616-635), the two scans of `_eval_span_not`
// (:641-666) and the freq -> BM25 tail of both (:521-526,
// `_span_freq_scores` :598).
//
// Bound on an H100: bytes. Each event key (8 B) is read once or, in a
// chain of n > 2 clauses, once a level; each doc with events writes its
// score and matched flag (the planes are zeroed beforehand).
//
// Design: one thread per event; the thread that holds a doc's first
// event walks that doc's events in key order, so a doc is one thread's
// short loop (docs hold tens of positions) and no two threads write one
// doc. Every value the reference compares is rebuilt with its rounding:
// positions become fp32 by round-to-nearest, the DP keeps fp32 maxima
// with the sentinel -(2^31), the stretch is (pf - dp) - (n - 1) with two
// rounded subtractions, and the BM25 tail uses the explicit
// round-to-nearest intrinsics (no FMA contraction; K1's expression).
//   phrase: an occurrence is a (doc, apos) group of >= n_slots events.
//   near:   the carry at level l of an event is the running max, over the
//           doc's EARLIER (doc, pos) groups, of the level-(l - 1) values
//           (a position for clause 0); an event of the last clause ends a
//           chain when its carry is set and its stretch <= slop; the
//           unordered two-clause form adds the relabelled chains (clause
//           1 - c) over the same order, which end at the other clause's
//           events; span_first cuts chain ends at pos + 1 <= end_limit.
//           Chains of more than two clauses keep each level's values in
//           `dp` (one fp32 per event).
//   not:    an include (clause 0) survives unless the nearest exclude
//           before it in key order is >= pf - pre, or the nearest exclude
//           at or after it is <= pf + post; an exclude at the include's
//           (doc, pos) sorts after it and is caught by the second test.
//
// Stacked mode (K12s; under the vmap of `execute_shards` /
// `execute_shards_batch` :1155-1168): norm_bytes is S shards' [N + 1]
// planes, [S, N + 1], and row r, the pair (query r / S, shard r % S),
// reads shard r % S's norms; its keys (K11s's, shard-local docs) and its
// output planes are its own. S = 1 is the mode above.
#include "common.cuh"

#define PW_PHRASE 0
#define PW_NEAR 1
#define PW_NOT 2
#define PW_NEG (-2147483648.0f)

struct WalkRow {
    const uint64_t* keys;
    int low;          // bits below the doc
    int clause_bits;  // bits below the position (span modes)
    uint64_t pos_mask;
    uint64_t clause_mask;

    __device__ __forceinline__ uint64_t doc(int64_t j) const {
        return keys[j] >> low;
    }
    __device__ __forceinline__ int pos(int64_t j) const {
        return (int)((keys[j] >> clause_bits) & pos_mask);
    }
    __device__ __forceinline__ float posf(int64_t j) const {
        return __int2float_rn(pos(j));
    }
    __device__ __forceinline__ int clause(int64_t j) const {
        return (int)(keys[j] & clause_mask);
    }
};

// Phrase occurrences of events [i, end) of one doc.
__device__ int walk_phrase(const WalkRow& r, int64_t i, int64_t end, int n) {
    int freq = 0;
    int64_t j = i;
    while (j < end) {
        const int a = r.pos(j);
        int64_t g = j + 1;
        while (g < end && r.pos(g) == a) {
            ++g;
        }
        if (g - j >= n) {
            ++freq;
        }
        j = g;
    }
    return freq;
}

// Level-l DP values of clause-l events: the running max over the doc's
// earlier position groups of clause (l - 1)'s values.
__device__ void near_level(const WalkRow& r, int64_t i, int64_t end, int l,
                           float* dp) {
    float running = PW_NEG;
    float group = PW_NEG;
    for (int64_t j = i; j < end; ++j) {
        if (j > i && r.pos(j) != r.pos(j - 1)) {
            running = fmaxf(running, group);
            group = PW_NEG;
        }
        const int c = r.clause(j);
        if (c == l) {
            dp[j] = running;
        } else if (c == l - 1) {
            group = fmaxf(group, l == 1 ? r.posf(j) : dp[j]);
        }
    }
}

__device__ __forceinline__ bool chain_end(float pf, float dpv, float nm1,
                                          float slop) {
    return dpv > PW_NEG && __fsub_rn(__fsub_rn(pf, dpv), nm1) <= slop;
}

// Chain ends of events [i, end) of one doc (the last level, after
// near_level has filled the levels below it when n > 2).
__device__ int walk_near(const WalkRow& r, int64_t i, int64_t end, int n,
                         float slop, bool ordered, int end_limit,
                         const float* dp) {
    const float nm1 = __int2float_rn(n - 1);
    const int last = n - 1;
    const bool relabel = !ordered && n == 2;
    // running[k]: max clause-k value over earlier groups (k = last - 1),
    // and of clause 1 for the relabelled chains.
    float run_a = PW_NEG, grp_a = PW_NEG;
    float run_b = PW_NEG, grp_b = PW_NEG;
    int freq = 0;
    for (int64_t j = i; j < end; ++j) {
        if (j > i && r.pos(j) != r.pos(j - 1)) {
            run_a = fmaxf(run_a, grp_a);
            grp_a = PW_NEG;
            run_b = fmaxf(run_b, grp_b);
            grp_b = PW_NEG;
        }
        const int c = r.clause(j);
        const float pf = r.posf(j);
        bool ok = false;
        if (c == last) {
            ok = chain_end(pf, last == 0 ? pf : run_a, nm1, slop);
        }
        if (relabel && c == 0) {
            ok = chain_end(pf, run_b, nm1, slop);
        }
        if (last > 0 && c == last - 1) {
            grp_a = fmaxf(grp_a, last == 1 ? pf : dp[j]);
        }
        if (relabel && c == 1) {
            grp_b = fmaxf(grp_b, pf);
        }
        if (ok && end_limit >= 0) {
            ok = r.pos(j) + 1 <= end_limit;
        }
        freq += ok ? 1 : 0;
    }
    return freq;
}

// Surviving includes of events [i, end) of one doc.
__device__ int walk_not(const WalkRow& r, int64_t i, int64_t end, float pre,
                        float post) {
    float before = PW_NEG;
    int64_t next = i;  // first exclude at or after the current event
    int freq = 0;
    for (int64_t j = i; j < end; ++j) {
        const float pf = r.posf(j);
        if (r.clause(j) == 1) {
            before = fmaxf(before, pf);
            continue;
        }
        if (next < j) {
            next = j;
        }
        while (next < end && r.clause(next) != 1) {
            ++next;
        }
        const float after = next < end ? r.posf(next) : -PW_NEG;
        const bool violated =
            before >= __fsub_rn(pf, pre) || after <= __fadd_rn(pf, post);
        freq += violated ? 0 : 1;
    }
    return freq;
}

__global__ void position_walk_kernel(
    const uint64_t* __restrict__ keys,
    const int32_t* __restrict__ count,
    const uint8_t* __restrict__ norm_bytes,
    const float* __restrict__ weight,
    const float* __restrict__ cache,
    int64_t p, int num_docs, int pos_bits, int clause_bits, int mode, int n,
    float slop, int ordered, int end_limit, float pre, float post,
    int n_shards, int64_t norm_stride, int row0,
    float* __restrict__ dp,
    float* __restrict__ scores,
    uint8_t* __restrict__ matched) {
    const int row = blockIdx.y;
    if (n_shards > 1) {
        norm_bytes += (int64_t)((row0 + row) % n_shards) * norm_stride;
    }
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t cnt = count[row];
    if (i >= cnt) {
        return;
    }
    WalkRow r;
    r.keys = keys + (int64_t)row * p;
    r.clause_bits = mode == PW_PHRASE ? 0 : clause_bits;
    r.low = pos_bits + r.clause_bits;
    r.pos_mask = (1ull << pos_bits) - 1ull;
    r.clause_mask = (1ull << r.clause_bits) - 1ull;
    const uint64_t d = r.doc(i);
    if (i > 0 && r.doc(i - 1) == d) {
        return;  // not the doc's first event
    }
    int64_t end = i + 1;
    while (end < cnt && r.doc(end) == d) {
        ++end;
    }
    int freq;
    if (mode == PW_PHRASE) {
        freq = walk_phrase(r, i, end, n);
    } else if (mode == PW_NEAR) {
        float* row_dp = dp == nullptr ? nullptr : dp + (int64_t)row * p;
        for (int l = 1; l < n - 1; ++l) {
            near_level(r, i, end, l, row_dp);
        }
        freq = walk_near(r, i, end, n, slop, ordered != 0, end_limit, row_dp);
    } else {
        freq = walk_not(r, i, end, pre, post);
    }
    if (freq > 0) {
        const float w = weight[row];
        const float ninv = cache[row * 256 + norm_bytes[d]];
        const float f = __int2float_rn(freq);
        const int64_t at = (int64_t)row * num_docs + (int64_t)d;
        scores[at] = __fsub_rn(
            w, __fdiv_rn(w, __fadd_rn(1.0f, __fmul_rn(f, ninv))));
        matched[at] = 1;
    }
}

// keys: [n_rows, p] sorted events (K11), count [n_rows]; norm_bytes
// [num_docs + 1]; weight [n_rows]; cache [n_rows, 256]; dp: [n_rows, p]
// fp32 scratch for chains of more than two clauses, else null; scores
// f32 / matched u8 [n_rows, num_docs], zeroed by the caller. Stacked:
// n_shards > 1 norm planes of norm_stride bytes each; the launch's first
// row is row row0 of the whole batch.
extern "C" int esk_position_walk(
    const void* keys,
    const void* count,
    const void* norm_bytes,
    const void* weight,
    const void* cache,
    int n_rows,
    int p,
    int num_docs,
    int pos_bits,
    int clause_bits,
    int mode,
    int n,
    float slop,
    int ordered,
    int end_limit,
    float pre,
    float post,
    int n_shards,
    long long norm_stride,
    int row0,
    void* dp,
    void* scores,
    void* matched,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_rows == 0 || p == 0) {
        return 0;
    }
    const int threads = 256;
    position_walk_kernel<<<dim3(esk_blocks(p, threads), n_rows), threads, 0,
                           s>>>(
        (const uint64_t*)keys, (const int32_t*)count,
        (const uint8_t*)norm_bytes, (const float*)weight,
        (const float*)cache, (int64_t)p, num_docs, pos_bits, clause_bits,
        mode, n, slop, ordered, end_limit, pre, post, n_shards,
        (int64_t)norm_stride, row0, (float*)dp,
        (float*)scores, (uint8_t*)matched);
    ESK_RETURN_IF_ERROR();
    return 0;
}
