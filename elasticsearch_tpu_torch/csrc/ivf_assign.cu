// K9 ivf_assign: the nearest centroid (squared L2) of every row.
//
// Replaces: elasticsearch_tpu/ops/ann_device.py `assign_chunk` (:280),
// which `assign_all` (:291) drives over 8,192-row chunks during the IVF
// build (k-means assignment and the final labelling, index/ann.py).
//
// Bound on an H100: operations. The function is argmin_c (|x|^2 - 2 x.c)
// + |c|^2 over M rows and C centroids of d floats: 2 M C d flops (the
// x.c products) against (M + C) d x 4 B read. At the build's shapes
// (M = 8,192, C = 1,000, d = 100: 1.64 GFLOP, 3.7 MB) that is 0.024 ms at
// the card's 67 TFLOP/s fp32 rate outside the tensor cores, against
// 0.001 ms for the bytes. The reference computes x.c as a matmul; this
// kernel keeps fp32 CUDA cores and the port's fixed reduction order
// instead (no tensor cores, no TF32), so its time is a multiple of that
// bound.
//
// Design: one warp per row, the lanes across d as in K7 (vector_score.cu):
// lane l sums j = l, l + 32, ... in ascending j with __fmul_rn /
// __fadd_rn, then the fixed butterfly; |x|^2, x.c and |c|^2 are each
// summed in that order, and d2 = (|x|^2 - 2 x.c) + |c|^2 in the
// reference's association. A block's 8 warps share tiles of centroids
// streamed through shared memory (padded with +0.0 to a multiple of 32
// floats). The centroids' |c|^2 are summed once by a first pass into a
// [C] scratch plane. Each warp keeps its row's running (best d2, best
// index) and moves only on a strictly smaller d2, walking the centroids
// in ascending order, so ties go to the lowest index as jnp.argmin
// breaks them.
#include "common.cuh"

#define IA_THREADS 256
#define IA_WARPS (IA_THREADS / 32)

__device__ __forceinline__ float ia_warp_sum(float acc) {
    for (int off = 16; off > 0; off >>= 1) {
        acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    }
    return __shfl_sync(0xffffffffu, acc, 0);
}

// |c|^2 of each centroid: one warp per centroid.
__global__ void centroid_sq_kernel(const float* __restrict__ cent, int c_n,
                                   int d, float* __restrict__ cc) {
    const int lane = threadIdx.x & 31;
    const long long c = (long long)blockIdx.x * IA_WARPS + (threadIdx.x >> 5);
    if (c >= c_n) {
        return;
    }
    const float* row = cent + c * d;
    const int slabs = (d + 31) / 32;
    float acc = 0.f;
    for (int s = 0; s < slabs; ++s) {
        const int j = s * 32 + lane;
        const float v = j < d ? row[j] : 0.f;
        const float p = __fmul_rn(v, v);
        acc = s == 0 ? p : __fadd_rn(acc, p);
    }
    acc = ia_warp_sum(acc);
    if (lane == 0) {
        cc[c] = acc;
    }
}

// smem: the block's 8 rows, then a tile of `tile` centroids, each padded
// to slabs * 32 floats.
__global__ void ivf_assign_kernel(const float* __restrict__ rows, int m,
                                  const float* __restrict__ cent, int c_n,
                                  int d, const float* __restrict__ cc,
                                  int tile, int32_t* __restrict__ out) {
    extern __shared__ float sm[];
    const int slabs = (d + 31) / 32;
    const int width = slabs * 32;
    float* xs = sm;
    float* cs = sm + IA_WARPS * width;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long r0 = (long long)blockIdx.x * IA_WARPS;
    for (int t = threadIdx.x; t < IA_WARPS * width; t += blockDim.x) {
        const int w = t / width;
        const int j = t % width;
        const long long r = r0 + w;
        xs[t] = (r < m && j < d) ? rows[r * d + j] : 0.f;
    }
    __syncthreads();
    const float* x = xs + warp * width;
    float a_xx = 0.f;
    for (int s = 0; s < slabs; ++s) {
        const float v = x[s * 32 + lane];
        const float p = __fmul_rn(v, v);
        a_xx = s == 0 ? p : __fadd_rn(a_xx, p);
    }
    const float xx = ia_warp_sum(a_xx);
    float best = 0.f;
    int best_i = -1;
    for (int c0 = 0; c0 < c_n; c0 += tile) {
        const int n_tile = min(tile, c_n - c0);
        __syncthreads();
        for (int t = threadIdx.x; t < n_tile * width; t += blockDim.x) {
            const int c = t / width;
            const int j = t % width;
            cs[t] = j < d ? cent[(long long)(c0 + c) * d + j] : 0.f;
        }
        __syncthreads();
        for (int c = 0; c < n_tile; ++c) {
            const float* cr = cs + c * width;
            float acc = 0.f;
            for (int s = 0; s < slabs; ++s) {
                const int j = s * 32 + lane;
                const float p = __fmul_rn(x[j], cr[j]);
                acc = s == 0 ? p : __fadd_rn(acc, p);
            }
            const float xc = ia_warp_sum(acc);
            const float d2 =
                __fadd_rn(__fsub_rn(xx, __fmul_rn(2.f, xc)), cc[c0 + c]);
            if (best_i < 0 || d2 < best) {
                best = d2;
                best_i = c0 + c;
            }
        }
    }
    const long long r = r0 + warp;
    if (lane == 0 && r < m) {
        out[r] = best_i < 0 ? 0 : best_i;
    }
}

// rows f32[m, d], cent f32[c_n, d], cc f32[c_n] scratch, out i32[m].
// tile: centroids per shared-memory tile; smem_bytes = (8 + tile) *
// ceil(d / 32) * 32 * 4.
extern "C" int esk_ivf_assign(
    const void* rows,
    int m,
    const void* cent,
    int c_n,
    int d,
    void* cc,
    int tile,
    long long smem_bytes,
    void* out,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (m <= 0 || c_n <= 0 || d <= 0) {
        return 0;
    }
    centroid_sq_kernel<<<esk_blocks(c_n, IA_WARPS), IA_THREADS, 0, s>>>(
        (const float*)cent, c_n, d, (float*)cc);
    ESK_RETURN_IF_ERROR();
    ESK_SMEM_OPT_IN(ivf_assign_kernel, (size_t)smem_bytes);
    ivf_assign_kernel<<<esk_blocks(m, IA_WARPS), IA_THREADS,
                        (size_t)smem_bytes, s>>>(
        (const float*)rows, m, (const float*)cent, c_n, d,
        (const float*)cc, tile, (int32_t*)out);
    ESK_RETURN_IF_ERROR();
    return 0;
}
