// Shared helpers of the port's Hopper kernels (plain C interface, bound
// with ctypes by kernels/build.py). Every launch function returns the
// cudaError_t of its launch as an int; the Python wrapper raises unless 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with kernels/build.py (DTYPE_CODES, OPERAND_CODES)
enum DTypeCode : int { DTYPE_F32 = 0, DTYPE_BF16 = 1, DTYPE_I8 = 2, DTYPE_F8E4M3 = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
// round to nearest even, as torch's and XLA's f32 -> bf16 casts do
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

#define EXPORT_ERROR_STRING                                   \
  extern "C" const char* error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
