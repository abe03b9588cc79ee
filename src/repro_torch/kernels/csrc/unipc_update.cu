// Fused UniPC state update: out[b, :] = sum_k w[k(, b)] * terms[k, b, :].
//
// Replaces the TPU kernel repro/kernels/unipc_update/kernel.py:
// fused_combine_batched (and fused_combine_flat, which wraps it).
//
// Bound on the H100: bytes. K term reads and one write of a (B, N) state,
// a few flops per byte. On the main path (B = 8, N = 256 * 32 = 8192, fp32,
// K <= 5) that is under 2 MB, about half a microsecond of HBM time, so one
// launch costs more than the traffic: the kernel is launch-bound.
//
// Design: one pass, no intermediate state in device memory. Grid (x: N
// chunks, y: batch row b); each thread walks its column i grid-stride,
// reads the K terms at i (neighbouring threads on neighbouring addresses)
// and writes the fp32 sum once, cast to the terms' dtype. The K weights of
// row b (shared (K,) or the per-slot column of (K, B)) sit in registers.
// Arbitrary N needs no padding: the loop bound masks the ragged tail.
#include "common.cuh"

constexpr int MAX_TERMS = 8;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS_X = 1024;

template <typename T>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const T* __restrict__ terms, const float* __restrict__ w,
               T* __restrict__ out, int K, int B, long long N, int per_slot) {
  const int b = blockIdx.y;
  float wk[MAX_TERMS];
#pragma unroll
  for (int k = 0; k < MAX_TERMS; ++k)
    wk[k] = k < K ? w[per_slot ? (long long)k * B + b : k] : 0.f;
  const long long term_stride = (long long)B * N;
  const T* row = terms + (long long)b * N;
  T* dst = out + (long long)b * N;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < N;
       i += (long long)gridDim.x * THREADS) {
    float acc = wk[0] * to_f32(row[i]);
#pragma unroll
    for (int k = 1; k < MAX_TERMS; ++k)
      if (k < K) acc += wk[k] * to_f32(row[k * term_stride + i]);
    dst[i] = from_f32<T>(acc);
  }
}

extern "C" int unipc_combine(const void* terms, const void* w, void* out, int K,
                             int B, long long N, int per_slot, int dtype,
                             void* stream) {
  if (K < 1 || K > MAX_TERMS || B < 1 || B > 65535 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  long long blocks_x = (N + THREADS - 1) / THREADS;
  if (blocks_x > MAX_BLOCKS_X) blocks_x = MAX_BLOCKS_X;
  const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    combine_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(terms), static_cast<const float*>(w),
        static_cast<float*>(out), K, B, N, per_slot);
  } else if (dtype == DTYPE_BF16) {
    combine_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(terms), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(out), K, B, N, per_slot);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

EXPORT_ERROR_STRING
