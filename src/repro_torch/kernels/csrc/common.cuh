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

// Sum of `v` over the whole block, returned to every thread. `scratch`
// holds one float per warp. Deterministic: warp butterflies, then every
// thread adds the warp partials in the same order.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // an earlier call's readers are done with scratch
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  const int n_warps = blockDim.x >> 5;
  for (int i = 0; i < n_warps; ++i) total += scratch[i];
  return total;
}

#define EXPORT_ERROR_STRING                                   \
  extern "C" const char* error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
