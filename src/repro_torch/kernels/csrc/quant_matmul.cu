// Quantized matmul: out (M, N) = (x (M, K) @ widen(qw (K, N))) * scale (N,),
// fp32 accumulation, the per-column scale applied once after the K sweep,
// the result written in the caller's dtype (fp32 or bf16).
//
// Replaces the TPU kernel repro/kernels/quant_matmul/kernel.py:quant_matmul.
//
// Operands: x is bf16 or fp32 activations (W8A16), or int8 activations
// quantized upstream with a static scale that the caller has folded into
// `scale` (W8A8); qw is int8 (8-bit, or 4-bit values in an int8
// container) or fp8 e4m3. The weight crosses device memory at its stored
// width, one byte per weight, and is widened on chip.
//
// Bound on the H100: at the dit-i256 serving shapes (net batch 16 x 256
// tokens = M 4096, d_model 1152, d_ff 4608) the attention and MLP sites do
// 11-44 GFLOP per call on 14-58 MB: the operations bound them (11-44 us at
// 989 TFLOP/s bf16). The two adaLN sites have M = 16 and are bound by
// their weight bytes (8.3 MB and 2.8 MB: 2.5 and 0.8 us at 3.35 TB/s).
//
// Two bodies:
// * tensor cores (bf16 or int8 x): every widening is exact in bf16 (int8
//   and int4 values have at most 8 significant bits, e4m3 values a 3-bit
//   mantissa inside bf16's exponent range), and a bf16 x bf16 product is
//   exact in fp32, so WMMA bf16 16x16x16 with fp32 accumulators computes
//   the reference's arithmetic up to fp32 summation order. A block keeps a
//   ring of 4 raw tiles (x: BM x BK, qw: BK x BN, as stored) filled by
//   16-byte cp.async copies two K steps ahead of the products, and widens
//   each qw tile (and an int8 x tile) into one of two bf16 tiles a step
//   ahead; bf16 x is multiplied from the ring itself. One barrier per K
//   step. Shared-memory row strides are padded off multiples of 128 bytes,
//   so the rows a WMMA load touches fall in different banks. The epilogue
//   stages each warp's accumulators in shared memory and writes rows of
//   neighbouring column pairs, each scaled once. The tile is chosen by M:
//   128 x 128 x 32 (8 warps, each 32 x 64, two blocks an SM) for the token
//   sites, 16 x 32 x 128 (2 warps) for M <= 64, the skinny adaLN sites,
//   where a 128-row tile would be almost all padding.
// * CUDA cores (fp32 x): a 64 x 64 tile, BK 16, 4 x 4 outputs per thread,
//   the weight tile widened to fp32 in shared memory, so fp32 activations
//   are never rounded to bf16.
// Ragged M, N and K are masked in the loads (zero-filled past the edge)
// and in the stores; the 16-byte copies are used where the rows allow them
// (K, N and the row strides whole 16-byte chunks, 16-byte-aligned bases),
// element copies elsewhere. wgmma, TMA, int8 mma and a fused activation
// quantize are later work.
#include <cuda_fp8.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using bf16 = __nv_bfloat16;
using fp8 = __nv_fp8_e4m3;
namespace wmma = nvcuda::wmma;

// ---- exact widening of a stored operand -----------------------------------

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float widen(fp8 v) { return static_cast<float>(v); }

struct Args {
  const void* x;
  const void* w;
  const float* scale;
  void* out;
  int M, N, K;
  long long ldx, ldw, ldo;
};

// ---- tensor-core body ------------------------------------------------------

// two neighbouring outputs in one store (p is 2-element aligned)
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_, int MIN_BLOCKS_>
struct TcTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WM = WM_, WN = WN_;          // warps along M and N
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int FM = BM / WM / 16, FN = BN / WN / 16;  // fragments per warp
  static constexpr int A_LD = BK + 8, B_LD = BN + 8;        // bf16 strides
  static constexpr int B_RAW_LD = BN + 16;                  // bytes
  static_assert(BM % (16 * WM) == 0 && BN % (16 * WN) == 0 && BK % 16 == 0,
                "warp tiles are whole 16 x 16 fragments");
  static_assert(STAGES >= 3, "the ring keeps two tiles ahead of the products");
};
// the token sites: 8 warps, each 32 x 64, two blocks an SM (<= 128 registers)
using BigTile = TcTile<128, 128, 32, 4, 2, 4, 2>;
// M <= 64 (the adaLN sites, M = 16): 2 warps, each 16 x 16
using SkinnyTile = TcTile<16, 32, 128, 1, 2, 4, 1>;
constexpr int SKINNY_MAX_M = 64;

// Shared-memory plan of one block: a ring of STAGES raw tiles as stored
// (x: BM x BK, qw: BK x BN), and two bf16 tiles of qw (and of x when it is
// int8) widened from the ring. bf16 x is multiplied from the ring itself.
template <class C, typename XT>
struct Smem {
  static constexpr bool WIDEN_X = sizeof(XT) == 1;
  static constexpr int A_RAW_LD = WIDEN_X ? C::BK + 16 : C::A_LD * 2;  // bytes
  static constexpr int A_RAW = C::BM * A_RAW_LD, B_RAW = C::BK * C::B_RAW_LD;
  static constexpr int A_BF = C::BM * C::A_LD, B_BF = C::BK * C::B_LD;  // elems
  static constexpr int B_RAW_OFF = C::STAGES * A_RAW;
  static constexpr int B_BF_OFF = B_RAW_OFF + C::STAGES * B_RAW;
  static constexpr int A_BF_OFF = B_BF_OFF + 2 * B_BF * 2;
  static constexpr int BYTES = A_BF_OFF + (WIDEN_X ? 2 * A_BF * 2 : 0);
  static_assert(A_RAW % 128 == 0 && B_RAW % 128 == 0 && (B_BF * 2) % 128 == 0 &&
                    (A_BF * 2) % 128 == 0,
                "every buffer starts on a 128-byte boundary");
  static_assert(C::BM * C::WN * (C::BN / C::WN + 4) * 4 <= BYTES,
                "the epilogue's warp tiles fit in the buffers");
};

// Issue the copy of a ROWS x COLS tile (rows r0.., columns c0.. of an
// (nrows, ncols) matrix of row stride ld) into shared memory of row stride
// ld_s bytes: 16-byte cp.async chunks, zero-filled past either edge, when
// vec (whole chunks in or out, 16-byte aligned); element copies otherwise.
template <typename T, int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(unsigned char* dst, int ld_s,
                                          const T* __restrict__ src, long long ld,
                                          int r0, int c0, int nrows, int ncols,
                                          bool vec) {
  constexpr int CE = 16 / sizeof(T);  // elements per chunk
  constexpr int CPR = COLS / CE;      // chunks per row
  static_assert(COLS % CE == 0 && (ROWS * CPR) % THREADS == 0,
                "the tile divides into whole chunks per thread");
  using Raw = std::conditional_t<sizeof(T) == 1, uint8_t, uint16_t>;
#pragma unroll
  for (int i = 0; i < ROWS * CPR / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / CPR, c = (e - r * CPR) * CE;
    const int gr = r0 + r, gc = c0 + c;
    unsigned char* d = dst + r * ld_s + c * static_cast<int>(sizeof(T));
    if (vec) {
      const bool in = gr < nrows && gc < ncols;
      cp_async16(d, in ? static_cast<const void*>(src + gr * ld + gc) : src, in);
    } else {
      const Raw* row = reinterpret_cast<const Raw*>(src) + gr * ld;
      Raw* v = reinterpret_cast<Raw*>(d);
#pragma unroll
      for (int j = 0; j < CE; ++j)
        v[j] = (gr < nrows && gc + j < ncols) ? row[gc + j] : Raw(0);
    }
  }
}

// Widen a ROWS x COLS tile of one-byte T (row stride ld_raw bytes) to bf16
// (row stride ld elements), eight values per thread and step: an 8-byte
// read and a 16-byte write, conflict-free across each quarter warp.
template <typename T, int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void widen_tile(const unsigned char* raw, int ld_raw,
                                           bf16* dst, int ld) {
  constexpr int UPR = COLS / 8;
  static_assert(sizeof(T) == 1 && COLS % 8 == 0 && (ROWS * UPR) % THREADS == 0,
                "whole 8-value units per thread");
#pragma unroll
  for (int i = 0; i < ROWS * UPR / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / UPR, c = (e - r * UPR) * 8;
    const uint2 v = *reinterpret_cast<const uint2*>(raw + r * ld_raw + c);
    const T* q = reinterpret_cast<const T*>(&v);
    uint4 packed;
    bf16* p = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int u = 0; u < 8; ++u) p[u] = __float2bfloat16_rn(widen(q[u]));
    *reinterpret_cast<uint4*>(dst + r * ld + c) = packed;
  }
}

// Pipeline per K step kt (one barrier): wait until tile kt + 1 has landed,
// barrier, issue the copy of tile kt + STAGES - 1 into the ring slot that
// tile kt - 1 has left, multiply tile kt, widen tile kt + 1 into the other
// bf16 buffer. The copies run STAGES - 2 tiles ahead of the products.
template <class C, typename XT, typename WT, typename OT>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
qmm_tc_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
              const float* __restrict__ scale, OT* __restrict__ out, int M,
              int N, int K, long long ldx, long long ldw, long long ldo,
              int vec_x, int vec_w) {
  using S = Smem<C, XT>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* a_raw = smem;
  unsigned char* b_raw = smem + S::B_RAW_OFF;
  bf16* b_bf = reinterpret_cast<bf16*>(smem + S::B_BF_OFF);
  bf16* a_bf = reinterpret_cast<bf16*>(smem + S::A_BF_OFF);
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int nk = (K + C::BK - 1) / C::BK;

  auto issue = [&](int t) {  // tile t into its ring slot; one group per call
    if (t < nk) {
      const int s = t % C::STAGES;
      load_tile<XT, C::BM, C::BK, C::THREADS>(a_raw + s * S::A_RAW, S::A_RAW_LD, x,
                                              ldx, m0, t * C::BK, M, K, vec_x);
      load_tile<WT, C::BK, C::BN, C::THREADS>(b_raw + s * S::B_RAW, C::B_RAW_LD, w,
                                              ldw, t * C::BK, n0, K, N, vec_w);
    }
    cp_async_commit();
  };
  auto widen_step = [&](int t) {  // ring slot of tile t -> bf16 buffers t & 1
    const int s = t % C::STAGES;
    widen_tile<WT, C::BK, C::BN, C::THREADS>(b_raw + s * S::B_RAW, C::B_RAW_LD,
                                             b_bf + (t & 1) * S::B_BF, C::B_LD);
    if constexpr (S::WIDEN_X)
      widen_tile<XT, C::BM, C::BK, C::THREADS>(a_raw + s * S::A_RAW, S::A_RAW_LD,
                                               a_bf + (t & 1) * S::A_BF, C::A_LD);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::FM][C::FN];
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int t = 0; t < C::STAGES - 1; ++t) issue(t);
  cp_async_wait<C::STAGES - 2>();  // tile 0 has landed
  __syncthreads();
  widen_step(0);

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<C::STAGES - 3>();  // tile kt + 1 has landed
    __syncthreads();
    issue(kt + C::STAGES - 1);
    const bf16* a_t =
        S::WIDEN_X ? a_bf + (kt & 1) * S::A_BF
                   : reinterpret_cast<const bf16*>(a_raw + (kt % C::STAGES) * S::A_RAW);
    a_t += wm * C::FM * 16 * C::A_LD;
    const bf16* b_t = b_bf + (kt & 1) * S::B_BF + wn * C::FN * 16;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[C::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf[C::FN];
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
        wmma::load_matrix_sync(af[i], a_t + i * 16 * C::A_LD + kk, C::A_LD);
#pragma unroll
      for (int j = 0; j < C::FN; ++j)
        wmma::load_matrix_sync(bf[j], b_t + kk * C::B_LD + j * 16, C::B_LD);
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
#pragma unroll
        for (int j = 0; j < C::FN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    if (kt + 1 < nk) widen_step(kt + 1);
  }
  cp_async_wait<0>();
  __syncthreads();  // every buffer is dead: the epilogue reuses them

  // epilogue: the warp's accumulators through shared memory (every
  // buffer is dead), then written row by row, two neighbouring columns per
  // lane and store, each scaled once and cast
  constexpr int TM = C::FM * 16, TN = C::FN * 16, T_LD = TN + 4;
  float* c_w = reinterpret_cast<float*>(smem) + warp * TM * T_LD;
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j)
      wmma::store_matrix_sync(c_w + i * 16 * T_LD + j * 16, acc[i][j], T_LD,
                              wmma::mem_row_major);
  __syncwarp();
  constexpr int LANES_PER_ROW = TN / 2 < 32 ? TN / 2 : 32;
  constexpr int ROWS_PER_PASS = 32 / LANES_PER_ROW;
  const int col = (lane % LANES_PER_ROW) * 2;
  const int gn = n0 + wn * TN + col;
  const float s0 = gn < N ? scale[gn] : 0.f, s1 = gn + 1 < N ? scale[gn + 1] : 0.f;
#pragma unroll
  for (int r = lane / LANES_PER_ROW; r < TM; r += ROWS_PER_PASS) {
    const int gm = m0 + wm * TM + r;
    if (gm >= M || gn >= N) continue;
    const float2 v = *reinterpret_cast<const float2*>(c_w + r * T_LD + col);
    OT* o = out + gm * ldo + gn;
    if (gn + 1 < N && (gm * ldo + gn) % 2 == 0) {
      store_pair(o, v.x * s0, v.y * s1);
    } else {
      o[0] = from_f32<OT>(v.x * s0);
      if (gn + 1 < N) o[1] = from_f32<OT>(v.y * s1);
    }
  }
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <class C, typename XT, typename WT, typename OT>
static int launch_tc(const Args& a, cudaStream_t s) {
  constexpr int bytes = Smem<C, XT>::BYTES;
  static bool sized = false;  // once per instantiation
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmm_tc_kernel<C, XT, WT, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  constexpr int cx = 16 / sizeof(XT);
  const bool vec_x = a.K % cx == 0 && a.ldx % cx == 0 && aligned16(a.x);
  const bool vec_w = a.N % 16 == 0 && a.ldw % 16 == 0 && aligned16(a.w);
  const dim3 grid(static_cast<unsigned>((a.N + C::BN - 1) / C::BN),
                  static_cast<unsigned>((a.M + C::BM - 1) / C::BM));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  qmm_tc_kernel<C, XT, WT, OT><<<grid, C::THREADS, bytes, s>>>(
      static_cast<const XT*>(a.x), static_cast<const WT*>(a.w), a.scale,
      static_cast<OT*>(a.out), a.M, a.N, a.K, a.ldx, a.ldw, a.ldo,
      static_cast<int>(vec_x), static_cast<int>(vec_w));
  return static_cast<int>(cudaGetLastError());
}

// ---- CUDA-core body (fp32 x) -----------------------------------------------

constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;

template <typename WT, typename OT>
__global__ void __launch_bounds__(F_THREADS)
qmm_f32_kernel(const float* __restrict__ x, const WT* __restrict__ w,
               const float* __restrict__ scale, OT* __restrict__ out, int M,
               int N, int K, long long ldx, long long ldw, long long ldo) {
  __shared__ float a_s[F_BK][F_BM + 4];  // x tile, transposed: [k][m]
  __shared__ float b_s[F_BK][F_BN + 4];  // weight tile widened to fp32
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += F_BK) {
    {  // x: 64 rows x 16, four consecutive columns per thread
      const int r = tid >> 2, c = (tid & 3) * 4, gm = m0 + r;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int gk = k0 + c + u;
        a_s[c + u][r] = (gm < M && gk < K) ? x[gm * ldx + gk] : 0.f;
      }
    }
    {  // qw: 16 rows x 64, four consecutive columns per thread
      const int r = tid >> 4, c = (tid & 15) * 4, gk = k0 + r;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int gn = n0 + c + u;
        b_s[r][c + u] = (gk < K && gn < N) ? widen(w[gk * ldw + gn]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[gm * ldo + gn] = from_f32<OT>(acc[i][j] * scale[gn]);
    }
  }
}

template <typename WT, typename OT>
static int launch_f32(const Args& a, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a.N + F_BN - 1) / F_BN),
                  static_cast<unsigned>((a.M + F_BM - 1) / F_BM));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  qmm_f32_kernel<WT, OT><<<grid, F_THREADS, 0, s>>>(
      static_cast<const float*>(a.x), static_cast<const WT*>(a.w), a.scale,
      static_cast<OT*>(a.out), a.M, a.N, a.K, a.ldx, a.ldw, a.ldo);
  return static_cast<int>(cudaGetLastError());
}

// ---- dispatch on the operand codes ----------------------------------------

constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);

template <class C, typename XT, typename WT>
static int tc_by_out(const Args& a, int out_code, cudaStream_t s) {
  if (out_code == DTYPE_F32) return launch_tc<C, XT, WT, float>(a, s);
  if (out_code == DTYPE_BF16) return launch_tc<C, XT, WT, bf16>(a, s);
  return BAD;
}

template <class C, typename XT>
static int tc_by_w(const Args& a, int w_code, int out_code, cudaStream_t s) {
  if (w_code == DTYPE_I8) return tc_by_out<C, XT, int8_t>(a, out_code, s);
  if (w_code == DTYPE_F8E4M3) return tc_by_out<C, XT, fp8>(a, out_code, s);
  return BAD;
}

template <class C>
static int tc_by_x(const Args& a, int x_code, int w_code, int out_code,
                   cudaStream_t s) {
  if (x_code == DTYPE_BF16) return tc_by_w<C, bf16>(a, w_code, out_code, s);
  if (x_code == DTYPE_I8) return tc_by_w<C, int8_t>(a, w_code, out_code, s);
  return BAD;
}

template <typename WT>
static int f32_by_out(const Args& a, int out_code, cudaStream_t s) {
  if (out_code == DTYPE_F32) return launch_f32<WT, float>(a, s);
  if (out_code == DTYPE_BF16) return launch_f32<WT, bf16>(a, s);
  return BAD;
}

// x (M, K) of row stride ldx, qw (K, N) of row stride ldw, scale (N,) fp32,
// out (M, N) of row stride ldo; codes as DTypeCode. Returns the launch's
// cudaError_t.
extern "C" int quant_matmul(const void* x, const void* w, const float* scale,
                            void* out, int M, int N, int K, long long ldx,
                            long long ldw, long long ldo, int x_code,
                            int w_code, int out_code, void* stream) {
  if (M < 1 || N < 1 || K < 1 || ldx < K || ldw < N || ldo < N) return BAD;
  const Args a{x, w, scale, out, M, N, K, ldx, ldw, ldo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_code == DTYPE_F32) {
    if (w_code == DTYPE_I8) return f32_by_out<int8_t>(a, out_code, s);
    if (w_code == DTYPE_F8E4M3) return f32_by_out<fp8>(a, out_code, s);
    return BAD;
  }
  if (M <= SKINNY_MAX_M) return tc_by_x<SkinnyTile>(a, x_code, w_code, out_code, s);
  return tc_by_x<BigTile>(a, x_code, w_code, out_code, s);
}

EXPORT_ERROR_STRING
