// Shared definitions for the hand-written Hopper kernels of the port.
//
// Every C entry point launches on the stream it is given, never
// synchronises, allocates nothing, and returns cudaGetLastError() (0 on
// success); the Python wrappers in ops/kernels.py raise on anything else.
// Built without --use_fast_math and with -prec-div=true -ftz=false
// -fmad=false, and the BM25 arithmetic uses the explicit round-to-nearest
// intrinsics, so every fp32 result is bit-identical to the plain PyTorch
// version and to the JAX reference.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define ESK_TILE 256
#define ESK_INF __int_as_float(0x7f800000)

#define ESK_RETURN_IF_ERROR()                 \
    do {                                      \
        cudaError_t err_ = cudaGetLastError(); \
        if (err_ != cudaSuccess) {            \
            return (int)err_;                 \
        }                                     \
    } while (0)

__device__ __forceinline__ int64_t esk_clamp64(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

static inline int esk_imin(int a, int b) { return a < b ? a : b; }

static inline int esk_blocks(int64_t n, int threads) {
    return (int)((n + threads - 1) / threads);
}

// Order-preserving bits of an fp32 key under IEEE totalOrder, the order
// jax.lax.top_k ranks by: -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf
// < +NaN. The top-k kernels sort 64-bit composites of these bits above
// the inverted index of the entry, so that one descending sort IS
// lax.top_k's order (score descending, lower index first on ties).
__device__ __forceinline__ uint32_t esk_f32_order(float f) {
    const uint32_t b = __float_as_uint(f);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ uint64_t esk_composite(float key, uint32_t idx) {
    return ((uint64_t)esk_f32_order(key) << 32) | (uint64_t)(~idx);
}

__device__ __forceinline__ uint32_t esk_composite_index(uint64_t c) {
    return ~(uint32_t)(c & 0xffffffffull);
}

// A block's descending bitonic sort of `ch` (a power of two) composites
// in shared memory; every thread of the block takes part.
__device__ __forceinline__ void esk_bitonic_desc(uint64_t* sm, int ch) {
    __syncthreads();
    for (int k = 2; k <= ch; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < ch; i += blockDim.x) {
                const int ixj = i ^ j;
                if (ixj > i) {
                    const uint64_t a = sm[i];
                    const uint64_t b = sm[ixj];
                    const bool desc = (i & k) == 0;
                    if (desc ? (a < b) : (a > b)) {
                        sm[i] = b;
                        sm[ixj] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
#define ESK_SMEM_OPT_IN(kernel, bytes)                                       \
    do {                                                                     \
        if ((bytes) > 48 * 1024) {                                           \
            cudaFuncSetAttribute((kernel),                                   \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                 (int)(bytes));                              \
            ESK_RETURN_IF_ERROR();                                           \
        }                                                                    \
    } while (0)
