// Fused adaLN-zero modulation: layernorm without affine, then scale/shift;
// and the gated residual re-entry resid + gate * y.
//
// Replaces the TPU kernels repro/kernels/adaln_modulate/kernel.py:
// adaln_modulate and gate_residual.
//
// Bound on the H100: bytes. Both are one pass over a (B, T, D) activation
// with a handful of flops per element. At the dit-i256 serving shape (net
// batch 16 = 8 requests x CFG, T = 256, D = 1152, bf16) modulate reads x
// and writes the output (about 19 MB, 5.6 us at 3.35 TB/s) and
// gate_residual reads two activations and writes one (about 28 MB, 8.5 us;
// the (B, D) gate is 37 KB).
//
// Design:
// * modulate — one block per (b, t) row; the row lives in registers
//   (VPT values a thread, threads on neighbouring columns), so x is read
//   once. Mean, then the mean of the centred squares, both fp32 block
//   reductions over the true D (two passes over registers, not
//   E[x^2] - mu^2), exactly the reference's jnp.mean / jnp.var. No lane
//   padding: columns past D are masked by the loop bound.
// * gate_residual — grid (x: T*D chunks, y: b), grid-stride elementwise;
//   the per-row gate is indexed, not broadcast in memory.
// shift/scale/gate are (B, D) rows with a row stride, so the six chunks of
// the DiT's modulation vector are read in place.
#include "common.cuh"

constexpr int VPT = 8;              // values of a row per thread
constexpr int MAX_ROW_THREADS = 1024;
constexpr int EW_THREADS = 256;
constexpr int MAX_EW_BLOCKS_X = 2048;

template <typename T>
__global__ void __launch_bounds__(MAX_ROW_THREADS)
modulate_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                const T* __restrict__ scale, T* __restrict__ out, int T_, int D,
                long long cond_stride, float eps) {
  __shared__ float scratch[32];
  const long long row = blockIdx.x;  // b * T + t
  const long long b = row / T_;
  const T* xr = x + row * D;
  float v[VPT];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int d = threadIdx.x + j * blockDim.x;
    v[j] = d < D ? to_f32(xr[d]) : 0.f;
    s += v[j];
  }
  const float mu = block_sum(s, scratch) / D;
  float s2 = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int d = threadIdx.x + j * blockDim.x;
    if (d < D) {
      v[j] -= mu;
      s2 += v[j] * v[j];
    }
  }
  const float var = block_sum(s2, scratch) / D;
  const float r = rsqrtf(var + eps);
  const T* sh = shift + b * cond_stride;
  const T* sc = scale + b * cond_stride;
  T* o = out + row * D;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int d = threadIdx.x + j * blockDim.x;
    if (d < D) o[d] = from_f32<T>(v[j] * r * (1.f + to_f32(sc[d])) + to_f32(sh[d]));
  }
}

template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
gate_residual_kernel(const T* __restrict__ resid, const T* __restrict__ gate,
                     const T* __restrict__ y, T* __restrict__ out, int TD, int D,
                     long long gate_stride) {
  const long long base = (long long)blockIdx.y * TD;
  const T* g = gate + blockIdx.y * gate_stride;
  for (int i = blockIdx.x * EW_THREADS + threadIdx.x; i < TD;
       i += gridDim.x * EW_THREADS) {
    const long long e = base + i;
    out[e] = from_f32<T>(to_f32(resid[e]) + to_f32(g[i % D]) * to_f32(y[e]));
  }
}

extern "C" int adaln_modulate(const void* x, const void* shift, const void* scale,
                              void* out, int B, int T_, int D,
                              long long cond_stride, float eps, int dtype,
                              void* stream) {
  if (B < 1 || T_ < 1 || D < 1 || D > VPT * MAX_ROW_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = (D + VPT - 1) / VPT;
  threads = (threads + 31) / 32 * 32;
  const unsigned rows = static_cast<unsigned>((long long)B * T_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    modulate_kernel<float><<<rows, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(shift),
        static_cast<const float*>(scale), static_cast<float*>(out), T_, D,
        cond_stride, eps);
  } else if (dtype == DTYPE_BF16) {
    modulate_kernel<__nv_bfloat16><<<rows, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(shift),
        static_cast<const __nv_bfloat16*>(scale),
        static_cast<__nv_bfloat16*>(out), T_, D, cond_stride, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gate_residual(const void* resid, const void* gate, const void* y,
                             void* out, int B, int T_, int D,
                             long long gate_stride, int dtype, void* stream) {
  const long long td = (long long)T_ * D;
  if (B < 1 || B > 65535 || T_ < 1 || D < 1 || td > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  long long blocks_x = (td + EW_THREADS - 1) / EW_THREADS;
  if (blocks_x > MAX_EW_BLOCKS_X) blocks_x = MAX_EW_BLOCKS_X;
  const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    gate_residual_kernel<float><<<grid, EW_THREADS, 0, s>>>(
        static_cast<const float*>(resid), static_cast<const float*>(gate),
        static_cast<const float*>(y), static_cast<float*>(out),
        static_cast<int>(td), D, gate_stride);
  } else if (dtype == DTYPE_BF16) {
    gate_residual_kernel<__nv_bfloat16><<<grid, EW_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(resid),
        static_cast<const __nv_bfloat16*>(gate),
        static_cast<const __nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(out),
        static_cast<int>(td), D, gate_stride);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

EXPORT_ERROR_STRING
