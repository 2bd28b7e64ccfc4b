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
