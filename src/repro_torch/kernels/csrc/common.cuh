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

// One 2-16 byte access of a row, and the raw words it loads into.
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = unsigned short; };

// VEC consecutive elements of a row, held as the raw 32-bit words of one
// 2-16 byte access (a 2-byte access keeps its bf16 in the low half).
template <typename T, int VEC>
struct Chunk {
  static constexpr int BYTES = VEC * static_cast<int>(sizeof(T));
  static constexpr int WORDS = BYTES >= 4 ? BYTES / 4 : 1;
  uint32_t w[WORDS];

  __device__ __forceinline__ void load(const T* p) {
    const auto v = *reinterpret_cast<const typename Raw<BYTES>::type*>(p);
    if constexpr (BYTES == 16) {
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (BYTES == 8) {
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = v;
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) w[i] = 0u;
  }
  // the same bytes back, as one access
  __device__ __forceinline__ void store(T* p) const {
    using R = typename Raw<BYTES>::type;
    if constexpr (BYTES == 16) {
      *reinterpret_cast<R*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (BYTES == 8) {
      *reinterpret_cast<R*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<R*>(p) = static_cast<R>(w[0]);
    }
  }
  // element i as fp32 (bf16 widens exactly by a shift)
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[i]);
    } else {
      return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
    }
  }
};

__device__ __forceinline__ uint32_t bf16_bits(float v) {  // round to nearest even
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Store VEC fp32 values as one access of T (each rounded to T).
template <typename T, int VEC>
__device__ __forceinline__ void store_chunk(T* p, const float (&f)[VEC]) {
  Chunk<T, VEC> c;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) c.w[i] = __float_as_uint(f[i]);
  } else if constexpr (VEC == 1) {
    c.w[0] = bf16_bits(f[0]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) c.w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
  }
  c.store(p);
}

// v rounded to T and widened back (the identity for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

#define EXPORT_ERROR_STRING                                   \
  extern "C" const char* error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
