// K7 vector_score: per-row dense_vector similarity in one fixed fp32
// reduction order, in three modes.
//
// Replaces: elasticsearch_tpu/ops/ann_device.py `_scored_rows` (:95) and
// `exact_scores` (:119), the scorer of `knn_exact` (:152) and
// `knn_exact_batch` (:162), the IVF re-rank of `_ivf_inner` (:189, over
// `part_vectors[probes]`) and its coarse scan `similarity_scores` (:62);
// and the per-doc dot / norm / distance of the script vector functions
// (elasticsearch_tpu/script/painless_lite.py:178-193 inside `_eval_script`,
// elasticsearch_tpu/ops/bm25_device.py:338).
//
// Modes (row i of query q; `v` the row's vector, `q` the query vector):
//   dense   rows of a [N, d] plane (or [S, N, d] stacked shards, row q
//           reading shard q % S): out0[q, i] = the ES similarity score
//           (cosine (1 + cos) / 2, dot_product (1 + dot) / 2, l2_norm
//           1 / (1 + |q - v|^2));
//   gather  the same score for slot s of partition probes[q, p] of an IVF
//           plane part_vectors [C, pmax, d], read in place (no gathered
//           copy): out0[q, p * pmax + s];
//   script  the raw planes of the script functions: out0 = dot(v, q),
//           out1 = |v|, out2 = |v - q|, and qnorm[q] = |q|.
//
// Bound on an H100: bytes. Each mode reads every row it scores once (d x 4
// B) and writes 4 B per row and output plane: BASELINE config 5's 1M x 100
// plane is 400 MB, 0.12 ms at 3.35 TB/s per query. The arithmetic is 2-3
// flops per element, far below the fp32 rate.
//
// Design: one warp per row, so the 32 lanes read consecutive floats of the
// row (coalesced). Lane l sums the elements j = l, l + 32, l + 64, ... in
// ascending j with __fmul_rn / __fadd_rn (no FMA contraction; elements
// past d count as +0.0 products, as the plain version pads with +0.0),
// then a fixed butterfly (lane l += lane l + 16, + 8, + 4, + 2, + 1) leaves
// the row's sum in lane 0. Every mode runs this one reduction, so a row's
// score does not depend on how many rows ride the launch or where they
// come from: dense mode and gather mode agree bit for bit (the port's form
// of the reference's IVF == brute-force parity law), and the plain
// PyTorch version (ops/kernels.py) spells the same order. The query vector
// sits in shared memory (padded with +0.0 to a multiple of 32), and every
// warp sums |q|^2 itself in the same order. After the sums the reference's
// expression order, with __fsqrt_rn and __fdiv_rn. This first kernel reads
// the plane once per query (one grid row a query); sharing a row's read
// across the queries of a batch is later work.
#include "common.cuh"

#define VS_THREADS 256
#define VS_WARPS (VS_THREADS / 32)

#define VS_DENSE 0
#define VS_GATHER 1
#define VS_SCRIPT 2

#define VS_COSINE 0
#define VS_DOT 1
#define VS_L2 2

__device__ __forceinline__ float vs_warp_sum(float acc) {
    for (int off = 16; off > 0; off >>= 1) {
        acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    }
    return __shfl_sync(0xffffffffu, acc, 0);
}

// The three lane-ordered sums of one row against q (qs: q in shared
// memory, padded to slabs * 32 with +0.0).
__device__ __forceinline__ void vs_row_sums(const float* __restrict__ row,
                                            const float* qs, int d,
                                            int slabs, int lane, bool want_vv,
                                            bool want_dd, float* dot,
                                            float* vv, float* dd) {
    float a_dot = 0.f, a_vv = 0.f, a_dd = 0.f;
    for (int s = 0; s < slabs; ++s) {
        const int j = s * 32 + lane;
        const float v = j < d ? row[j] : 0.f;
        const float qj = qs[j];
        const float p = __fmul_rn(v, qj);
        a_dot = s == 0 ? p : __fadd_rn(a_dot, p);
        if (want_vv) {
            const float pv = __fmul_rn(v, v);
            a_vv = s == 0 ? pv : __fadd_rn(a_vv, pv);
        }
        if (want_dd) {
            const float df = __fsub_rn(v, qj);
            const float pd = __fmul_rn(df, df);
            a_dd = s == 0 ? pd : __fadd_rn(a_dd, pd);
        }
    }
    *dot = vs_warp_sum(a_dot);
    *vv = want_vv ? vs_warp_sum(a_vv) : 0.f;
    *dd = want_dd ? vs_warp_sum(a_dd) : 0.f;
}

__device__ __forceinline__ float vs_score(int metric, float dot, float vv,
                                          float dd, float qnorm) {
    if (metric == VS_L2) {
        return __fdiv_rn(1.f, __fadd_rn(1.f, dd));
    }
    if (metric == VS_DOT) {
        return __fmul_rn(__fadd_rn(1.f, dot), 0.5f);
    }
    const float denom = __fmul_rn(__fsqrt_rn(vv), qnorm);
    const float cs = denom > 0.f ? __fdiv_rn(dot, denom) : 0.f;
    return __fmul_rn(__fadd_rn(1.f, cs), 0.5f);
}

struct VsArgs {
    const float* vecs;       // dense/script: [S, N, d]; gather: [C, pmax, d]
    const float* queries;    // [Q, d]
    const int32_t* probes;   // gather: [Q, kp]
    long long n_rows;        // rows a query scores (N, or kp * pmax)
    int d;
    int slabs;               // ceil(d / 32)
    int kp;
    int pmax;
    int mode;
    int metric;
    int n_shards;            // dense/script: row q reads shard q % S
    long long shard_stride;  // elements of one shard's plane
    float* out0;
    float* out1;
    float* out2;
    float* qnorm_out;
};

__global__ void vector_score_kernel(VsArgs a) {
    extern __shared__ float qs[];
    const int q = blockIdx.y;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int padded = a.slabs * 32;
    for (int j = threadIdx.x; j < padded; j += blockDim.x) {
        qs[j] = j < a.d ? a.queries[(long long)q * a.d + j] : 0.f;
    }
    __syncthreads();
    // |q|^2 in the rows' order: lane-strided partials, then the butterfly.
    float a_qq = 0.f;
    for (int s = 0; s < a.slabs; ++s) {
        const float qj = qs[s * 32 + lane];
        const float p = __fmul_rn(qj, qj);
        a_qq = s == 0 ? p : __fadd_rn(a_qq, p);
    }
    const float qnorm = __fsqrt_rn(vs_warp_sum(a_qq));
    if (a.mode == VS_SCRIPT && blockIdx.x == 0 && threadIdx.x == 0) {
        a.qnorm_out[q] = qnorm;
    }
    const long long i = (long long)blockIdx.x * VS_WARPS + warp;
    if (i >= a.n_rows) {
        return;
    }
    const float* row;
    if (a.mode == VS_GATHER) {
        const int p = (int)(i / a.pmax);
        const int s = (int)(i % a.pmax);
        const long long part = a.probes[(long long)q * a.kp + p];
        row = a.vecs + (part * a.pmax + s) * (long long)a.d;
    } else {
        row = a.vecs + (long long)(q % a.n_shards) * a.shard_stride +
              i * (long long)a.d;
    }
    const bool script = a.mode == VS_SCRIPT;
    const bool want_vv = script || a.metric == VS_COSINE;
    const bool want_dd = script || a.metric == VS_L2;
    float dot, vv, dd;
    vs_row_sums(row, qs, a.d, a.slabs, lane, want_vv, want_dd, &dot, &vv,
                &dd);
    if (lane != 0) {
        return;
    }
    const long long o = (long long)q * a.n_rows + i;
    if (script) {
        a.out0[o] = dot;
        a.out1[o] = __fsqrt_rn(vv);
        a.out2[o] = __fsqrt_rn(dd);
    } else {
        a.out0[o] = vs_score(a.metric, dot, vv, dd, qnorm);
    }
}

// vecs f32 (dense/script [S, N, d] with shard_stride = N * d; gather
// [C, pmax, d]), queries f32[n_q, d], probes i32[n_q, kp] (gather mode,
// else null). n_rows: rows a query scores (N in dense/script mode,
// kp * pmax in gather mode). Outputs [n_q, n_rows] planes (out1/out2 and
// qnorm_out only in script mode).
extern "C" int esk_vector_score(
    const void* vecs,
    long long n_rows,
    int d,
    const void* queries,
    int n_q,
    const void* probes,
    int kp,
    int pmax,
    int mode,
    int metric,
    int n_shards,
    long long shard_stride,
    void* out0,
    void* out1,
    void* out2,
    void* qnorm_out,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_q <= 0 || d <= 0) {
        return 0;
    }
    VsArgs a;
    a.vecs = (const float*)vecs;
    a.queries = (const float*)queries;
    a.probes = (const int32_t*)probes;
    a.n_rows = n_rows;
    a.d = d;
    a.slabs = (d + 31) / 32;
    a.kp = kp;
    a.pmax = pmax;
    a.mode = mode;
    a.metric = metric;
    a.n_shards = n_shards < 1 ? 1 : n_shards;
    a.shard_stride = shard_stride;
    a.out0 = (float*)out0;
    a.out1 = (float*)out1;
    a.out2 = (float*)out2;
    a.qnorm_out = (float*)qnorm_out;
    const size_t smem = (size_t)a.slabs * 32 * sizeof(float);
    ESK_SMEM_OPT_IN(vector_score_kernel, smem);
    const long long blocks = n_rows > 0 ? (n_rows + VS_WARPS - 1) / VS_WARPS : 1;
    vector_score_kernel<<<dim3((unsigned)blocks, n_q), VS_THREADS, smem, s>>>(a);
    ESK_RETURN_IF_ERROR();
    return 0;
}
