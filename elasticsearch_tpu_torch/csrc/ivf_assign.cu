// K9 ivf_assign: the nearest centroid (squared L2) of every row.
//
// Replaces: elasticsearch_tpu/ops/ann_device.py `assign_chunk` (:280),
// which `assign_all` (:291) drives over 8,192-row chunks during the IVF
// build (k-means assignment and the final labelling, index/ann.py).
//
// The function: argmin_c (|x|^2 - 2 x.c) + |c|^2 over M rows and C
// centroids of d floats, each sum in K7's fixed lane order (ops/kernels.py
// `lane_sum`): padded with +0.0 to a multiple of 32, lane l sums j = l,
// l + 32, ... in ascending j, then the lanes fold in halves (l += l + 16,
// + 8, + 4, + 2, + 1); ties go to the first index, and a NaN distance wins
// as torch.argmin / jnp.argmin let it (the first NaN).
//
// Bound on an H100: operations. Held to that order, a pair costs a
// multiply per padded element, an add per further slab of each lane (a
// padded slab adds +0.0, as the plain version does) and 31 fold adds: 255
// fp32 operations at d = 100 (128 + 96 + 31), none of them fusable. At the
// build's shapes (M = 8,192, C = 1,000) that is 2.09 G operations, 0.062
// ms at the card's 33.5 G fp32 instructions a ms, against (M + C) d x 4 B
// read. chip_smoke.py states the bound as 2 M C d flops (the matmul's)
// over the card's fp32 rate outside the tensor cores (0.024 ms). The
// reference computes x.c as a matmul; this kernel keeps fp32 CUDA cores
// and the port's fixed order instead (no tensor cores, no TF32: the plain
// version cannot reproduce their internal order).
//
// Design: a register-tiled fp32 kernel in the manner of an SGEMM, the
// argmin fused into its epilogue. A block takes 32 rows; each of its 8
// warps owns 4 rows and each lane 4 centroids of a 128-centroid tile, so a
// thread holds a 4 x 4 register tile of (row, centroid) pairs and reuses
// every element it loads from shared memory across 4 pairs. The lane order
// is reproduced inside the thread, with no shuffles: the 32 lane partials
// of a pair are the leaves of the fold tree, and taken in 5-bit
// bit-reversed lane order (l = 0, 16, 8, 24, 4, ...) each new leaf merges
// with the pairwise stack's top while the leaf position's low bits are set
// (left operand the older subtree), which is exactly lane_sum's
// association in 6 registers a pair (5 stack levels and the leaf being
// summed). Each leaf sums its slabs in ascending order with __fmul_rn /
// __fadd_rn (the build passes -fmad=false: no contraction). Padded columns
// are staged as +0.0 in both operands, so a padded product is +0.0 and the
// slab that holds it adds +0.0 exactly as lane_sum's padding does, with no
// branch in the unrolled loop. Shared memory holds the staged elements
// k-major ([slab x lane][row], strides padded to 4 mod 32 floats), which
// the unrolled loop visits in leaf order, so one float4 per operand feeds
// a thread's 16 products.
//
// Two kernels by width. d <= 128 (ivf_assign_narrow, NS = ceil(d / 32)
// slabs a template parameter): the 32 leaves and their slabs are unrolled;
// the block's rows are staged once and its |x|^2 summed from them; the
// centroid tiles stream through two buffers by cp.async, tile t + 1
// landing while tile t computes (153 KB of shared memory at NS = 4, one
// block a multiprocessor, 226 registers a thread, no spills). d > 128
// (ivf_assign_wide): a stage holds a group of G leaf positions x n slabs
// (G x n <= 128 floats a row, G a template parameter), both operands
// staged each stage; past 4,096 floats the slabs of one leaf are split
// over stages too (G = 1). A group's leaves and the stack levels below
// log2 G are unrolled; the groups are a loop (unrolling them made the
// build four times slower), a finished group's subtree merging into the
// higher levels by branches on the group index. Any d >= 1 runs. |c|^2 is summed by a first kernel into a [C]
// scratch plane (one warp a centroid, shuffles in lane_sum's order); d2 =
// (|x|^2 - 2 x.c) + |c|^2 in the reference's association. Each thread
// keeps a running (best d2, best index) per row that moves only on a
// strictly better d2 over ascending centroid indices; the warp's lanes
// then reduce with shuffles under the same total order (NaN first, then
// smaller, then lower index).
#include "common.cuh"

#define IA_THREADS 256
#define IA_BM 32            // rows a block: 8 warps x 4
#define IA_BN 128           // centroids a tile: 32 lanes x 4
#define IA_KS 128           // staged floats a row and stage (G x n)
#define IA_XP (IA_BM + 4)   // k-major row strides, padded (float4-aligned)
#define IA_CP (IA_BN + 4)

__device__ __forceinline__ float ia_warp_sum(float acc) {
    for (int off = 16; off > 0; off >>= 1) {
        acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    }
    return __shfl_sync(0xffffffffu, acc, 0);
}

// A lane_sum of one row of d floats by a warp (lane = the lane).
__device__ __forceinline__ float ia_row_sq(const float* __restrict__ row,
                                           bool valid, int d, int lane) {
    const int slabs = (d + 31) / 32;
    float acc = 0.f;
    for (int s = 0; s < slabs; ++s) {
        const int j = s * 32 + lane;
        const float v = (valid && j < d) ? row[j] : 0.f;
        const float p = __fmul_rn(v, v);
        acc = s == 0 ? p : __fadd_rn(acc, p);
    }
    return ia_warp_sum(acc);
}

// |c|^2 of each centroid: one warp per centroid.
__global__ void centroid_sq_kernel(const float* __restrict__ cent, int c_n,
                                   int d, float* __restrict__ cc) {
    const int lane = threadIdx.x & 31;
    const long long c = (long long)blockIdx.x * (IA_THREADS / 32) +
                        (threadIdx.x >> 5);
    if (c >= c_n) {
        return;
    }
    const float acc = ia_row_sq(cent + c * d, true, d, lane);
    if (lane == 0) {
        cc[c] = acc;
    }
}

__host__ __device__ constexpr int ia_brev5(int v) {
    return ((v & 1) << 4) | ((v & 2) << 2) | (v & 4) | ((v & 8) >> 2) |
           ((v & 16) >> 4);
}

// True when (da, ia) comes before (db, ib) in torch.argmin's order: a NaN
// first, then the smaller distance, then the lower index; ib < 0 is empty.
__device__ __forceinline__ bool ia_before(float da, int ia, float db, int ib) {
    if (ib < 0) {
        return ia >= 0;
    }
    if (ia < 0) {
        return false;
    }
    const bool na = isnan(da);
    const bool nb = isnan(db);
    if (na != nb) {
        return na;
    }
    if (!na && da != db) {
        return da < db;
    }
    return ia < ib;
}

// Stage slabs [s0, s0 + n) of the G lanes of leaf positions [g G, g G +
// G) for `count` rows of src (row r0 on; rows past `valid` and columns
// past d are +0.0): the group's lanes are l = u (32 / G) + brev5(g G), u <
// G, and element (row r, slab s0 + s, lane u) lands at dst[(s G + u) *
// stride + r]. A warp instruction moves 4 rows x 8 consecutive staged
// columns: 32-byte runs of each row from global memory, and with a stride
// of 4 mod 32 floats 32 distinct banks. count is a multiple of 32.
template <int G>
__device__ __forceinline__ void ia_stage(const float* __restrict__ src,
                                         long long r0, int valid, int count,
                                         int d, int g, int s0, int n,
                                         float* __restrict__ dst,
                                         int stride) {
    const int c = ia_brev5(g * G);
    const int n_k = G * n;
    const int lane = threadIdx.x & 31;
    for (int rq = threadIdx.x >> 5; rq < count / 4; rq += IA_THREADS / 32) {
        const int r = rq * 4 + (lane >> 3);
        const float* row = src + (r0 + r) * d;
        for (int k0 = 0; k0 < n_k; k0 += 8) {
            const int kk = k0 + (lane & 7);
            const int s = kk / G;
            const int j = (s0 + s) * 32 + (kk - s * G) * (32 / G) + c;
            if (kk < n_k) {
                dst[kk * stride + r] = (r < valid && j < d) ? row[j] : 0.f;
            }
        }
    }
}

// part = x * c (first) or part + x * c over a thread's 4 x 4 pairs.
template <bool FIRST>
__device__ __forceinline__ void ia_slab(const float* __restrict__ xk,
                                        const float* __restrict__ ck,
                                        float (&part)[16]) {
    const float4 x = *reinterpret_cast<const float4*>(xk);
    const float4 c = *reinterpret_cast<const float4*>(ck);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const float p = __fmul_rn(xv[a], cv[b]);
            part[a * 4 + b] = FIRST ? p : __fadd_rn(part[a * 4 + b], p);
        }
    }
}

__host__ __device__ constexpr int ia_log2(int g) {
    return g <= 1 ? 0 : 1 + ia_log2(g / 2);
}

// The pairwise stack, the leaves taken in groups of 2^A positions: push
// leaf i of its group (a compile-time constant once unrolled) at the
// levels below A, merging with the top while i's low bits are set (the
// older subtree the left operand). After the group's last leaf, part is
// the group's subtree.
template <int A>
__device__ __forceinline__ void ia_push_low(int i, float (&stk)[5][16],
                                            float (&part)[16]) {
#pragma unroll
    for (int lv = 0; lv < A; ++lv) {
        if ((i >> lv) & 1) {
#pragma unroll
            for (int e = 0; e < 16; ++e) {
                part[e] = __fadd_rn(stk[lv][e], part[e]);
            }
        } else {
#pragma unroll
            for (int e = 0; e < 16; ++e) {
                stk[lv][e] = part[e];
            }
            return;
        }
    }
}

// Push group g's subtree at the levels from A up, the same way (g is a
// runtime value; each level stays a fixed register set). After the last
// group, part is the whole sum.
template <int A>
__device__ __forceinline__ void ia_push_high(int g, float (&stk)[5][16],
                                             float (&part)[16]) {
    // No early exit: the loop unrolls and stk stays in registers.
    bool carry = true;
#pragma unroll
    for (int lv = A; lv < 5; ++lv) {
        if (carry) {
            if ((g >> (lv - A)) & 1) {
#pragma unroll
                for (int e = 0; e < 16; ++e) {
                    part[e] = __fadd_rn(stk[lv][e], part[e]);
                }
            } else {
#pragma unroll
                for (int e = 0; e < 16; ++e) {
                    stk[lv][e] = part[e];
                }
                carry = false;
            }
        }
    }
}

// d2 = (|x|^2 - 2 x.c) + |c|^2 of a thread's 16 pairs into its running
// (best, best_i) per row, over ascending centroid indices.
__device__ __forceinline__ void ia_epilogue(const float (&xc)[16],
                                            const float* xxs, int warp,
                                            int lane, int c0, int c_n,
                                            const float* __restrict__ cc,
                                            float (&best)[4],
                                            int (&best_i)[4]) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        const int col = c0 + lane * 4 + b;
        if (col < c_n) {
            const float ccol = cc[col];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const float d2 = __fadd_rn(
                    __fsub_rn(xxs[warp * 4 + a], __fmul_rn(2.f, xc[a * 4 + b])),
                    ccol);
                if (ia_before(d2, col, best[a], best_i[a])) {
                    best[a] = d2;
                    best_i[a] = col;
                }
            }
        }
    }
}

// The warp's lanes hold the same 4 rows: reduce them, lane 0 writes.
__device__ __forceinline__ void ia_finish(float (&best)[4], int (&best_i)[4],
                                          int warp, int lane, long long r0,
                                          int valid, int32_t* __restrict__ out) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        float bd = best[a];
        int bi = best_i[a];
        for (int off = 16; off > 0; off >>= 1) {
            const float od = __shfl_xor_sync(0xffffffffu, bd, off);
            const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
            if (ia_before(od, oi, bd, bi)) {
                bd = od;
                bi = oi;
            }
        }
        const int r = warp * 4 + a;
        if (lane == 0 && r < valid) {
            out[r0 + r] = bi < 0 ? 0 : bi;
        }
    }
}

// |x|^2 of the block's rows into xxs: warp w sums rows 4w .. 4w + 3.
__device__ __forceinline__ void ia_row_norms(const float* __restrict__ rows,
                                             long long r0, int valid, int d,
                                             int warp, int lane, float* xxs) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int r = warp * 4 + a;
        const float xx = ia_row_sq(rows + (r0 + r) * d, r < valid, d, lane);
        if (lane == 0) {
            xxs[r] = xx;
        }
    }
}

// 4-byte asynchronous copy global -> shared; a zero fill where !valid.
__device__ __forceinline__ void ia_cp_async(float* dst, const float* src,
                                            bool valid) {
    const unsigned addr = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void ia_cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void ia_cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d <= 128 (NS = ceil(d / 32) slabs, every lane in one stage): the rows
// are staged once, k-major ([j][row], j the column), and |x|^2 is summed
// from them; the centroid tiles ([j][centroid]) stream through two
// buffers by cp.async, tile t + 1 landing while tile t computes. The 32 leaves and their slabs are
// unrolled: leaf position p reads column s * 32 + brev5(p).
template <int NS>
__global__ void __launch_bounds__(IA_THREADS, 1)
ivf_assign_narrow(const float* __restrict__ rows, int m,
                  const float* __restrict__ cent, int c_n, int d,
                  const float* __restrict__ cc, int32_t* __restrict__ out) {
    constexpr int KW = NS * 32;  // staged columns
    extern __shared__ float4 sm4[];
    float* xs = reinterpret_cast<float*>(sm4);
    float* cs0 = xs + KW * IA_XP;
    __shared__ float xxs[IA_BM];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long r0 = (long long)blockIdx.x * IA_BM;
    const int valid = (int)min((long long)IA_BM, m - r0);
    // Rows [g0, g0 + count) of src (`avail` of them real) into dst[j][r]:
    // a warp instruction moves 4 rows x 8 consecutive columns.
    auto stage = [&](const float* src, long long g0, int avail, int count,
                     float* dst, int stride) {
        for (int rq = warp; rq < count / 4; rq += IA_THREADS / 32) {
            const int r = rq * 4 + (lane >> 3);
            const float* row = src + (g0 + (r < avail ? r : 0)) * d;
#pragma unroll
            for (int k0 = 0; k0 < KW; k0 += 8) {
                const int j = k0 + (lane & 7);
                const bool ok = r < avail && j < d;
                ia_cp_async(dst + j * stride + r, ok ? row + j : src, ok);
            }
        }
    };
    auto prefetch = [&](int c0, int b) {
        stage(cent, c0, min(IA_BN, c_n - c0), IA_BN, cs0 + b * (KW * IA_CP),
              IA_CP);
        ia_cp_commit();
    };
    stage(rows, r0, valid, IA_BM, xs, IA_XP);
    prefetch(0, 0);
    ia_cp_wait<0>();
    __syncthreads();
    // |x|^2 from the staged rows, in lane_sum's order (padding is +0.0).
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int r = warp * 4 + a;
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            const float v = xs[(s * 32 + lane) * IA_XP + r];
            const float p = __fmul_rn(v, v);
            acc = s == 0 ? p : __fadd_rn(acc, p);
        }
        acc = ia_warp_sum(acc);
        if (lane == 0) {
            xxs[r] = acc;
        }
    }
    float best[4];
    int best_i[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        best[a] = 0.f;
        best_i[a] = -1;
    }
    int buf = 0;
    for (int c0 = 0; c0 < c_n; c0 += IA_BN) {
        if (c0 + IA_BN < c_n) {
            prefetch(c0 + IA_BN, buf ^ 1);
            ia_cp_wait<1>();
        } else {
            ia_cp_wait<0>();
        }
        __syncthreads();  // tile c0 (and, the first time, xxs) visible
        const float* cs = cs0 + buf * (KW * IA_CP);
        float stk[5][16];
        float part[16];
        // All 32 leaf positions unrolled: p reads lane brev5(p).
#pragma unroll
        for (int p = 0; p < 32; ++p) {
            const int l = ia_brev5(p);
            const float* xk = xs + l * IA_XP + warp * 4;
            const float* ck = cs + l * IA_CP + lane * 4;
            // A padded column is staged as +0.0 in both operands, so its
            // product is +0.0: the first slab starts at +0.0 and a later
            // one adds +0.0, as lane_sum's padding does, with no branch.
            ia_slab<true>(xk, ck, part);
#pragma unroll
            for (int s = 1; s < NS; ++s) {
                ia_slab<false>(xk + s * 32 * IA_XP, ck + s * 32 * IA_CP, part);
            }
            ia_push_low<5>(p, stk, part);
        }
        ia_epilogue(part, xxs, warp, lane, c0, c_n, cc, best, best_i);
        __syncthreads();  // the next prefetch overwrites this buffer
        buf ^= 1;
    }
    ia_finish(best, best_i, warp, lane, r0, valid, out);
}

// d > 128: G leaf positions a stage (G x n_st <= IA_KS), both operands
// staged each stage; the slabs of a leaf run in a loop (split over stages
// when G = 1 and a row is wider than IA_KS slabs). Padded columns are
// staged as +0.0, so their products add +0.0 as in the narrow kernel.
template <int G>
__global__ void __launch_bounds__(IA_THREADS, 1)
ivf_assign_wide(const float* __restrict__ rows, int m,
                const float* __restrict__ cent, int c_n, int d,
                const float* __restrict__ cc, int n_st,
                int32_t* __restrict__ out) {
    extern __shared__ float4 sm4[];
    float* xs = reinterpret_cast<float*>(sm4);
    float* cs = xs + IA_KS * IA_XP;
    __shared__ float xxs[IA_BM];
    const int slabs = (d + 31) / 32;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long r0 = (long long)blockIdx.x * IA_BM;
    const int valid = (int)min((long long)IA_BM, m - r0);
    ia_row_norms(rows, r0, valid, d, warp, lane, xxs);
    float best[4];
    int best_i[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        best[a] = 0.f;
        best_i[a] = -1;
    }
    for (int c0 = 0; c0 < c_n; c0 += IA_BN) {
        const int c_valid = min(IA_BN, c_n - c0);
        float stk[5][16];
        float part[16];
        constexpr int A = ia_log2(G);
#pragma unroll 1
        for (int g = 0; g < 32 / G; ++g) {
            for (int s0 = 0; s0 < slabs; s0 += n_st) {
                const int n = min(n_st, slabs - s0);
                __syncthreads();
                ia_stage<G>(rows, r0, valid, IA_BM, d, g, s0, n, xs, IA_XP);
                ia_stage<G>(cent, c0, c_valid, IA_BN, d, g, s0, n, cs, IA_CP);
                __syncthreads();
#pragma unroll
                for (int i = 0; i < G; ++i) {
                    // Leaf position g G + i reads lane u (32 / G) + brev5(g G)
                    // with u = brev5(i) / (32 / G), staged at column u.
                    const int u = ia_brev5(i) / (32 / G);
                    const float* xk = xs + u * IA_XP + warp * 4;
                    const float* ck = cs + u * IA_CP + lane * 4;
                    int s = 0;
                    if (s0 == 0) {
                        ia_slab<true>(xk, ck, part);
                        s = 1;
                    }
                    for (; s < n; ++s) {  // padded columns add +0.0
                        ia_slab<false>(xk + s * G * IA_XP, ck + s * G * IA_CP,
                                       part);
                    }
                    if (s0 + n == slabs) {
                        ia_push_low<A>(i, stk, part);
                    }
                }
                if (s0 + n == slabs) {
                    ia_push_high<A>(g, stk, part);
                }
            }
        }
        ia_epilogue(part, xxs, warp, lane, c0, c_n, cc, best, best_i);
    }
    ia_finish(best, best_i, warp, lane, r0, valid, out);
}

template <int NS>
static int ia_narrow(const float* rows, int m, const float* cent, int c_n,
                     int d, const float* cc, int32_t* out, cudaStream_t s) {
    const size_t smem = (size_t)NS * 32 * (IA_XP + 2 * IA_CP) * sizeof(float);
    ESK_SMEM_OPT_IN(ivf_assign_narrow<NS>, smem);
    ivf_assign_narrow<NS><<<esk_blocks(m, IA_BM), IA_THREADS, smem, s>>>(
        rows, m, cent, c_n, d, cc, out);
    ESK_RETURN_IF_ERROR();
    return 0;
}

template <int G>
static int ia_wide(const float* rows, int m, const float* cent, int c_n,
                   int d, const float* cc, int n_st, int32_t* out,
                   cudaStream_t s) {
    const size_t smem = (size_t)IA_KS * (IA_XP + IA_CP) * sizeof(float);
    ESK_SMEM_OPT_IN(ivf_assign_wide<G>, smem);
    ivf_assign_wide<G><<<esk_blocks(m, IA_BM), IA_THREADS, smem, s>>>(
        rows, m, cent, c_n, d, cc, n_st, out);
    ESK_RETURN_IF_ERROR();
    return 0;
}

// rows f32[m, d], cent f32[c_n, d], cc f32[c_n] scratch, out i32[m].
extern "C" int esk_ivf_assign(
    const void* rows,
    int m,
    const void* cent,
    int c_n,
    int d,
    void* cc,
    void* out,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (m <= 0 || c_n <= 0 || d <= 0) {
        return 0;
    }
    centroid_sq_kernel<<<esk_blocks(c_n, IA_THREADS / 32), IA_THREADS, 0,
                         s>>>((const float*)cent, c_n, d, (float*)cc);
    ESK_RETURN_IF_ERROR();
    const float* r = (const float*)rows;
    const float* c = (const float*)cent;
    const float* q = (const float*)cc;
    int32_t* o = (int32_t*)out;
    const int slabs = (d + 31) / 32;
    switch (slabs) {
        case 1: return ia_narrow<1>(r, m, c, c_n, d, q, o, s);
        case 2: return ia_narrow<2>(r, m, c, c_n, d, q, o, s);
        case 3: return ia_narrow<3>(r, m, c, c_n, d, q, o, s);
        case 4: return ia_narrow<4>(r, m, c, c_n, d, q, o, s);
        default: break;
    }
    // G leaf positions a stage: the most (a power of two) whose slabs fit.
    int g = 16;
    while (g > 1 && g * slabs > IA_KS) {
        g >>= 1;
    }
    const int n_st = slabs < IA_KS / g ? slabs : IA_KS / g;
    switch (g) {
        case 16: return ia_wide<16>(r, m, c, c_n, d, q, n_st, o, s);
        case 8: return ia_wide<8>(r, m, c, c_n, d, q, n_st, o, s);
        case 4: return ia_wide<4>(r, m, c, c_n, d, q, n_st, o, s);
        case 2: return ia_wide<2>(r, m, c, c_n, d, q, n_st, o, s);
        default: return ia_wide<1>(r, m, c, c_n, d, q, n_st, o, s);
    }
}
