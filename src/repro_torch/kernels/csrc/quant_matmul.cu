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
// Every widening is exact in bf16 (int8 and int4 values have at most 8
// significant bits, e4m3 values a 3-bit mantissa inside bf16's exponent
// range), and a bf16 x bf16 product is exact in fp32, so the tensor-core
// bodies compute the reference's arithmetic up to fp32 summation order.
// The wrapper (kernels/quant_matmul/kernel.py:plan) picks the body by
// dtype and shape:
// * wgmma (bf16 or int8 x, M > 64, x and qw rows 16-byte aligned: the
//   token sites). A persistent warp-specialized block (qmm_wg_kernel): a
//   producer warp keeps TMA loads of raw x and qw tiles four K steps ahead
//   in an mbarrier ring; two consumer warpgroups compute out^T = W^T x^T
//   with wgmma m64n144k16, the weight as the register operand A: each
//   warp reads its raw bytes with ldmatrix.trans and widens them in
//   registers on the integer and fp32 pipes (no conversion instructions,
//   no widened copy in shared memory), x is operand B as TMA lands it
//   (K-major, 128-byte swizzle). Tiles of 144 rows x 128 columns fit the
//   waves (1.98 at N = 1152). See the note at the kernel.
// * wmma (bf16 or int8 x, M > 64, rows TMA cannot take). WMMA bf16
//   16x16x16: a ring of 4 raw tiles (x: BM x BK, qw: BK x BN, as stored)
//   filled by 16-byte cp.async copies two K steps ahead of the products,
//   each qw tile (and an int8 x tile) widened into one of two bf16 tiles a
//   step ahead; bf16 x is multiplied from the ring itself. One barrier per
//   K step; shared-memory row strides padded off multiples of 128 bytes.
//   The epilogue stages each warp's accumulators in shared memory and
//   writes rows of neighbouring column pairs, each scaled once. Tile 128 x
//   128 x 32 (8 warps, each 32 x 64, two blocks an SM).
// * skinny (bf16 or int8 x, M <= 64: the adaLN sites, M = 16). A GEMV
//   more than a GEMM: the weight's bytes bound it, and each is used M
//   times. A block owns a strip of 64 columns (32 where 64-column strips
//   would leave a quarter of the SMs idle, or M > 32) and all of M; its 8
//   warps split K and load their weight bytes and x straight into
//   registers, every group of the warp at once, so the whole weight is in
//   flight on the card. mma.sync m16n8k16 computes out^T = W^T x^T with
//   the k order of each product chosen so that a lane's own loaded bytes
//   are its A fragment, widened exactly in registers; the warps' sums
//   meet in shared memory in a fixed order (no atomics). 108 blocks at
//   ada (N = 6912), one wave. See the note at the kernel.
// * cuda_cores (fp32 x): a 64 x 64 tile, BK 16, 4 x 4 outputs per thread,
//   the weight tile widened to fp32 in shared memory, so fp32 activations
//   are never rounded to bf16.
// Ragged M, N and K are zero-filled past the edge (by TMA, or masked in
// the loads) and masked in the stores; the WMMA bodies' 16-byte copies are
// used where the rows allow them, element copies elsewhere. Int8 x int8
// tensor cores and a fused activation quantize are later work.
#include <cuda_fp8.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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
constexpr int SKINNY_MAX_M = 64;  // and fewer rows take the skinny body

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

// ---- wgmma body (the token sites, M > 64) ----------------------------------

constexpr int WG_BM = 144;  // rows of x and out a tile: the wgmma N
constexpr int WG_BN = 128;  // columns of out a tile: two warpgroups x 64
constexpr int WG_BK = 64;
constexpr int WG_CONSUMERS = 256;             // two warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 32;  // and the producer warp
constexpr int WG_STAGES = 4;                  // raw tiles in flight
constexpr int WG_XBUFS = 3;                   // widened int8 x tiles

// Shared-memory plan: a ring of raw tiles as TMA lands them (x: BM x BK,
// with the 128-byte swizzle when bf16, wgmma's K-major layout; dense when
// int8; qw: BK x BN bytes, 128-byte swizzle), widened bf16 tiles of x when
// it is int8, and the ring's mbarriers.
template <typename XT>
struct WgSmem {
  static constexpr bool WIDEN_X = sizeof(XT) == 1;
  static constexpr int X_RAW = WG_BM * WG_BK * static_cast<int>(sizeof(XT));
  static constexpr int W_RAW = WG_BK * WG_BN;
  static constexpr int X_BF = WG_BM * WG_BK * 2;
  static constexpr int W_RAW_OFF = WG_STAGES * X_RAW;
  static constexpr int X_BF_OFF = W_RAW_OFF + WG_STAGES * W_RAW;
  static constexpr int BAR_OFF = X_BF_OFF + (WIDEN_X ? WG_XBUFS * X_BF : 0);
  static constexpr int BYTES = BAR_OFF + 2 * WG_STAGES * 8;
  static constexpr int ALLOC = BYTES + 1024;  // the base is aligned up to 1 KB
  static_assert(X_RAW % 1024 == 0 && W_RAW % 1024 == 0 && X_BF % 1024 == 0,
                "swizzled tiles start on 1 KB");
  static_assert(ALLOC <= 232448, "one block fits an SM's shared memory");
};

__device__ __forceinline__ void consumers_sync() {  // the two consumer warpgroups
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned a, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

// Four stored one-byte values (the bytes of r, lowest first) widened
// exactly to fp32 on the integer and fp32 pipes: the conversion
// instructions run at a sixteenth of their rate and would set the pace.
template <typename T>
__device__ __forceinline__ void widen4(uint32_t r, float (&f)[4]);
// int8: the biased byte v + 128 as the low mantissa bits of 2^23, minus
// 2^23 + 128
template <>
__device__ __forceinline__ void widen4<int8_t>(uint32_t r, float (&f)[4]) {
  const uint32_t u = r ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + b)) - 8388736.0f;
}
// e4m3: exponent and mantissa bits placed under fp32's (subnormals
// included), scaled by 2^(127 - 7), the sign put back
template <>
__device__ __forceinline__ void widen4<fp8>(uint32_t r, float (&f)[4]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t v = (r >> (8 * b)) & 0xFFu;
    f[b] = __uint_as_float(
        __float_as_uint(__uint_as_float((v & 0x7Fu) << 20) * __uint_as_float(0x7B800000u)) |
        ((v & 0x80u) << 24));
  }
}
// a bf16 pair from two fp32 that bf16 holds exactly (their top halves)
__device__ __forceinline__ uint32_t bf16x2_of(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
// eight stored one-byte values, widened to eight bf16 in order
template <typename T>
__device__ __forceinline__ uint4 widen8(uint2 raw) {
  float f[4], h[4];
  widen4<T>(raw.x, f);
  widen4<T>(raw.y, h);
  return make_uint4(bf16x2_of(f[0], f[1]), bf16x2_of(f[2], f[3]), bf16x2_of(h[0], h[1]),
                    bf16x2_of(h[2], h[3]));
}
// The m16n8k16 A fragment (rows g and g + 8, k 2t, 2t + 1 and 2t + 8,
// 2t + 9) of W^T from two ldmatrix.trans registers of raw weight bytes,
// taken as 16-bit pairs of neighbouring columns: `lo` holds k rows 2t and
// 2t + 1 of columns 2g and 2g + 1, `hi` the same 8 rows further. So
// fragment row g is weight column 2g and row g + 8 is column 2g + 1.
template <typename WT>
__device__ __forceinline__ void a_fragment(uint32_t lo, uint32_t hi, uint32_t (&a)[4]) {
  float f[4];
  widen4<WT>(lo, f);  // (k 2t, col 2g), (k 2t, 2g + 1), (k 2t + 1, 2g), (k 2t + 1, 2g + 1)
  a[0] = bf16x2_of(f[0], f[2]);
  a[1] = bf16x2_of(f[1], f[3]);
  widen4<WT>(hi, f);
  a[2] = bf16x2_of(f[0], f[2]);
  a[3] = bf16x2_of(f[1], f[3]);
}

// d (64 x 144, fp32, the m64nNk16 accumulator layout) += A (64 x 16, bf16,
// registers: the m16n8k16 A fragment of each warp's 16 rows) * B (16 x 144,
// bf16, K-major, descriptor b)
__device__ __forceinline__ void wgmma_n144_rs(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71}, {%72, %73, %74, %75}, %76, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Persistent blocks of 288 threads, one an SM; block b takes the output
// tiles b, b + gridDim.x, ... of 144 rows x 128 columns (columns fastest).
// The product is computed transposed, out^T = W^T x^T, so that the weight
// is wgmma's register operand A and is widened in registers, never stored
// wide:
// * the producer (thread 256): TMA loads of the raw x and qw tiles of each
//   K step g (counted across tiles, so the ring rolls on from one tile
//   into the next) into ring slot g % 4 once both consumer warpgroups have
//   released it; `full` counts the transaction bytes.
// * the consumers (threads 0 .. 255): warpgroup c owns columns 64c .. 64c
//   + 63 of the tile, each warp 16 of them, as the 64 rows of its m64n144
//   accumulator (72 fp32 registers a thread; the tile's 144 rows of x are
//   wgmma's N). Per k16 step a warp reads its 16 x 16 raw weight bytes
//   with one half of an ldmatrix.x4.trans (16-bit pairs of neighbouring
//   columns, so the swizzled rows are read without bank conflicts), widens
//   them exactly in registers into the A fragment, and issues one wgmma
//   against the x tile in shared memory (K-major). Each k16 product is its
//   own commit group, so widening the next fragment overlaps the products
//   in flight; a slot is released once the products of its step are done.
//   int8 x is first widened into a bf16 tile of the same layout (three of
//   them, one consumer barrier a step). At a tile's end each column is
//   scaled once and stored from registers, column pairs at a time, while
//   the producer already fills the next tile's slots.
// The tile is 144 x 128 for the waves: 29 x 9 = 261 tiles at N = 1152
// (1.98 waves over 132 SMs) and 29 x 36 = 1044 at N = 4608 (7.9 waves);
// a wider tile than 64 columns a warpgroup needs more registers than a
// block of this size gets (ptxas held a 384-thread block to 168 a thread).
template <typename XT, typename WT, typename OT>
__global__ void __launch_bounds__(WG_THREADS, 1)
qmm_wg_kernel(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap w_map, const float* __restrict__ scale,
              OT* __restrict__ out, int M, int N, int K, long long ldo, int pairs) {
  using S = WgSmem<XT>;
  constexpr int STAGES = WG_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw_u = smem_u32(smem_raw);
  const unsigned base = (raw_u + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_u);
  const unsigned full = base + S::BAR_OFF, empty = full + 8 * STAGES;

  const int tiles_n = (N + WG_BN - 1) / WG_BN;
  const int tiles = (M + WG_BM - 1) / WG_BM * tiles_n;
  const int nk = (K + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WG_CONSUMERS) {  // the producer warp
    if (threadIdx.x != WG_CONSUMERS) return;
    int g = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * WG_BM, n0 = tile % tiles_n * WG_BN;
      for (int kt = 0; kt < nk; ++kt, ++g) {
        const int s = g % STAGES;
        if (g >= STAGES) mbar_wait(empty + 8 * s, (g / STAGES - 1) & 1);
        mbar_expect_tx(full + 8 * s, S::X_RAW + S::W_RAW);
        tma_load_2d(base + s * S::X_RAW, &x_map, full + 8 * s, kt * WG_BK, m0);
        tma_load_2d(base + S::W_RAW_OFF + s * S::W_RAW, &w_map, full + 8 * s, n0,
                    kt * WG_BK);
      }
    }
    return;
  }

  // the consumers
  const int cwg = threadIdx.x / 128, warp = (threadIdx.x & 127) >> 5;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int chunk = cwg * 4 + warp;  // this warp's 16 columns, a 16-byte chunk of a raw row
  const bool leader = (threadIdx.x & 127) == 0;
  auto release = [&](int step) {  // the products of `step` are done
    if (leader) mbar_arrive(empty + 8 * (step % STAGES));
  };
  int g = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * WG_BM, n0 = tile % tiles_n * WG_BN;
    float acc[WG_BM / 2];
#pragma unroll
    for (int j = 0; j < WG_BM / 2; ++j) acc[j] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++g) {
      const int s = g % STAGES;
      mbar_wait(full + 8 * s, (g / STAGES) & 1);
      unsigned x_u = base + s * S::X_RAW;
      if constexpr (S::WIDEN_X) {  // int8 x -> bf16 tile g % 3, swizzled as TMA would
        const unsigned char* xr = smem + s * S::X_RAW;
        const int xb = S::X_BF_OFF + g % WG_XBUFS * S::X_BF;
#pragma unroll
        for (int i = 0; i < (WG_BM * WG_BK / 8 + WG_CONSUMERS - 1) / WG_CONSUMERS; ++i) {
          const int e = threadIdx.x + WG_CONSUMERS * i;
          if (e >= WG_BM * WG_BK / 8) break;
          const int r = e >> 3, c = e & 7;  // 8 values c of row r (dense rows)
          const uint2 raw = *reinterpret_cast<const uint2*>(xr + r * WG_BK + c * 8);
          *reinterpret_cast<uint4*>(smem + xb + r * 128 + ((c ^ (r & 7)) << 4)) =
              widen8<XT>(raw);
        }
        fence_proxy_async();
        consumers_sync();  // tile g % 3 is whole; tile (g - 3) % 3's products are done
        x_u = base + xb;
      }
      const unsigned w_u = base + S::W_RAW_OFF + s * S::W_RAW;
      uint32_t r[4], a[WG_BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        if ((kk & 1) == 0) {  // raw rows 16kk .. 16kk + 31 of this warp's columns
          const int k = kk * 16 + lane;
          ldsm_x4_t(w_u + k * WG_BN + ((chunk ^ (k & 7)) << 4), r[0], r[1], r[2], r[3]);
        }
        wgmma_wait<3>();  // the product that last read a[kk] (a step ago) is done
        if (kk == WG_BK / 16 - 1 && kt > 0) release(g - 1);
        a_fragment<WT>(r[(kk & 1) * 2], r[(kk & 1) * 2 + 1], a[kk]);
        fence_acc(acc);
        wgmma_fence();
        wgmma_n144_rs(acc, a[kk], smem_desc(x_u + kk * 32, 16, 1024, 1));
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    release(g - 1);

    // epilogue: accumulator row g8 (g8 + 8) of the warp is column n (n + 1),
    // its columns 8j + 2t4 (+ 1) are rows of out
    const int n = n0 + chunk * 16 + 2 * g8;
    if (n >= N) continue;
    const bool two = n + 1 < N;
    const float s0 = scale[n], s1 = two ? scale[n + 1] : 0.f;
#pragma unroll
    for (int j = 0; j < WG_BM / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 8 * j + 2 * t4 + h;
        if (row >= M) continue;
        OT* p = out + row * ldo + n;
        const float v0 = acc[4 * j + h] * s0, v1 = acc[4 * j + 2 + h] * s1;
        if (two && pairs) {
          store_pair(p, v0, v1);
        } else {
          p[0] = from_f32<OT>(v0);
          if (two) p[1] = from_f32<OT>(v1);
        }
      }
    }
  }
}

// map of a row-major (rows, cols) matrix of bf16 (wide) or bytes, row
// stride ld elements, in boxes of box_rows x box_cols; out-of-bounds
// elements of a box land as zeros
static bool encode_2d(CUtensorMap* map, const void* ptr, bool wide, long long rows,
                      long long cols, long long ld, int box_cols, int box_rows,
                      bool swizzle128) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld * (wide ? 2 : 1))};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, wide ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
            const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename XT, typename WT, typename OT>
static int launch_wg(const Args& a, cudaStream_t s) {
  using S = WgSmem<XT>;
  constexpr bool wide_x = sizeof(XT) == 2;
  if (!aligned16(a.x) || (a.ldx * static_cast<long long>(sizeof(XT))) % 16 ||
      !aligned16(a.w) || a.ldw % 16)
    return static_cast<int>(cudaErrorInvalidValue);  // TMA needs 16-byte rows
  static bool sized = false;  // once per instantiation
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(qmm_wg_kernel<XT, WT, OT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, S::ALLOC);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  CUtensorMap x_map, w_map;
  if (!encode_2d(&x_map, a.x, wide_x, a.M, a.K, a.ldx, WG_BK, WG_BM, wide_x) ||
      !encode_2d(&w_map, a.w, false, a.K, a.N, a.ldw, WG_BN, WG_BK, true))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((a.M + WG_BM - 1) / WG_BM) *
                          ((a.N + WG_BN - 1) / WG_BN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);  // persistent
  const bool pairs = a.ldo % 2 == 0 && reinterpret_cast<uintptr_t>(a.out) % (2 * sizeof(OT)) == 0;
  qmm_wg_kernel<XT, WT, OT><<<blocks, WG_THREADS, S::ALLOC, s>>>(
      x_map, w_map, a.scale, static_cast<OT*>(a.out), a.M, a.N, a.K, a.ldo,
      static_cast<int>(pairs));
  return static_cast<int>(cudaGetLastError());
}

// ---- skinny body (M <= 64: the adaLN sites) ---------------------------------

constexpr int SK_MAX_SPLIT = 8;   // warps a block
constexpr int SK_SMEM = 65536;    // the partial-sum buffer of a block, at most

// 16-row groups of K a warp loads at once: up to 9 (the adaLN sites' K =
// 1152 over 8 warps) while the loads and the accumulators fit a thread's
// 255 registers
__host__ __device__ constexpr int sk_batch(int m_tiles) {
  return m_tiles == 2 ? 9 : m_tiles == 4 ? 5 : 3;
}
// dynamic shared memory of a block of `split` warps: their partial sums
__host__ __device__ constexpr int sk_smem(int m_tiles, int vw, int split) {
  return split * (vw / 2) * m_tiles * 32 * 16;
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// BYTES bytes from global memory into words, lowest first: one load where
// the operand allows it, else byte loads of the first `bytes` and zeros
template <int BYTES>
__device__ __forceinline__ void sk_load(uint32_t (&v)[BYTES / 4], const unsigned char* p,
                                        bool whole, int bytes) {
  if (whole) {
    if constexpr (BYTES == 8) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = u.x;
      v[1] = u.y;
    } else {
      v[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    }
  } else {
#pragma unroll
    for (int q = 0; q < BYTES / 4; ++q) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * q + j < bytes) word |= static_cast<uint32_t>(p[4 * q + j]) << (8 * j);
      v[q] = word;
    }
  }
}

// two int8 values (the low half of v, lowest first) as a bf16 pair
__device__ __forceinline__ uint32_t widen2_i8(uint32_t v) {
  float f[4];
  widen4<int8_t>(v, f);
  return bf16x2_of(f[0], f[1]);
}

// A block owns strips of 8 * VW output columns (strip blockIdx.x, then +
// gridDim.x, ...) and every row of x (M <= 8 * MT), and sweeps all of K.
// The product is computed transposed, out^T = W^T x^T: the weight is
// operand A of mma.sync m16n8k16, x^T operand B (MT n8 tiles of x rows).
// Both go from global memory straight to registers: no shared memory
// until the sums, one barrier a strip.
// * Lane (g, t) of a warp loads VW bytes (columns VW g ..) of the four k
//   rows 4t .. 4t + 3 of a 16-row group; eight lanes read 8 VW contiguous
//   bytes of a row. Warp w takes groups w, w + split, ... and issues the
//   loads of up to sk_batch of them before it uses any: at the adaLN
//   sites that is every group it has, so each block asks for its whole
//   strip (72 KB at VW = 8) at once, and the card for the whole weight.
// * The k order inside an m16n8k16 product is free as long as A and B
//   agree: the fragment's k slots 2t, 2t + 1, 2t + 8, 2t + 9 are taken to
//   be rows 4t .. 4t + 3, which the lane already holds. So a lane widens
//   its own bytes exactly in registers (the byte-permute widening of the
//   wgmma body) into the A fragments of VW / 2 products, fragment rows g
//   and g + 8 being its columns 2j and 2j + 1: no shuffle, no ldmatrix.
//   B is x rows 8mt + g at k 4t .. 4t + 3, one load a row (x is a few KB,
//   read from L2), widened pairwise when it is int8.
// * The warps' partial sums meet in shared memory, added in warp order
//   (no atomics: the same sum on every run); each output is scaled once
//   (the scales of a thread's first output are loaded before the sweep)
//   and stored, neighbouring columns in pairs.
// What bounds it on the H100 (ablate_kernels.py, PERF.md): the SM's
// load requests in flight, not HBM; staging x in shared memory, or
// splitting K over a cluster to read 128-byte rows, cost more in barriers
// than they saved.
template <int MT, int VW, typename XT, typename WT, typename OT>
__global__ void __launch_bounds__(SK_MAX_SPLIT * 32, 1)
qmm_skinny_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                  const float* __restrict__ scale, OT* __restrict__ out, int M, int N, int K,
                  long long ldx, long long ldw, long long ldo, int vec_x, int vec_w,
                  int pairs) {
  constexpr int NJ = VW / 2;              // products a lane a group (column pairs)
  constexpr int BN = 8 * VW;              // columns a strip
  constexpr int B = sk_batch(MT);
  constexpr int GROUPS = NJ * MT * 32;    // float4 partial sums a warp
  constexpr int XS = static_cast<int>(sizeof(XT));
  constexpr int XB = 4 * XS;              // bytes of x a lane a row and group
  extern __shared__ __align__(128) unsigned char smem[];
  float4* red = reinterpret_cast<float4*>(smem);
  const int split = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int groups = (K + 15) / 16;
  const int mine = warp < groups ? (groups - warp - 1) / split + 1 : 0;
  const int strips = (N + BN - 1) / BN;
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(w);
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  // output item e of a strip: partial sums (j, mt) of lane e % 32: rows
  // 8mt + 2t (+ 1), columns VW g + 2j (+ 1) of the strip
  auto item_col = [&](int strip, int e) {
    return strip * BN + VW * ((e & 31) >> 2) + 2 * ((e >> 5) / MT);
  };

  for (int strip = blockIdx.x; strip < strips; strip += gridDim.x) {
    const int n = strip * BN + VW * g8;  // this lane's first column
    float s_first[2] = {0.f, 0.f};       // the scales of this thread's first item
    if (threadIdx.x < GROUPS) {
      const int col = item_col(strip, threadIdx.x);
      if (col < N) s_first[0] = __ldg(scale + col);
      if (col + 1 < N) s_first[1] = __ldg(scale + col + 1);
    }
    float acc[NJ][MT][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][mt][q] = 0.f;

    for (int b0 = 0; b0 < mine; b0 += B) {
      uint32_t v[B][4][VW / 4];   // weight: rows 4t + r of group, columns n ..
      uint32_t xv[B][MT][XB / 4]; // x: rows 8mt + g, k 4t .. 4t + 3 of group
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const int k0 = 16 * (warp + (b0 + u) * split) + 4 * t4;
        const bool live = b0 + u < mine;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const bool in = live && k0 + r < K;
          sk_load<VW>(v[u][r], wb + (k0 + r) * ldw + n, in && vec_w && n + VW <= N,
                      in ? N - n : 0);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int m = 8 * mt + g8;
          const bool in = live && m < M;
          sk_load<XB>(xv[u][mt], xb + (m * ldx + k0) * XS, in && vec_x && k0 + 4 <= K,
                      in ? (K - k0) * XS : 0);
        }
      }
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (b0 + u >= mine) break;
        uint32_t bx[MT][2];  // the x^T fragments, bf16 pairs
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (XS == 2) {
            bx[mt][0] = xv[u][mt][0];
            bx[mt][1] = xv[u][mt][XB / 4 - 1];
          } else {
            bx[mt][0] = widen2_i8(xv[u][mt][0]);
            bx[mt][1] = widen2_i8(xv[u][mt][0] >> 16);
          }
        }
#pragma unroll
        for (int q = 0; q < VW / 4; ++q) {
          float f[4][4];  // rows 4t + r, columns 4q .. 4q + 3 of this lane's
#pragma unroll
          for (int r = 0; r < 4; ++r) widen4<WT>(v[u][r][q], f[r]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t a[4];  // fragment rows g / g + 8: columns 4q + 2h / + 1
            a[0] = bf16x2_of(f[0][2 * h], f[1][2 * h]);
            a[1] = bf16x2_of(f[0][2 * h + 1], f[1][2 * h + 1]);
            a[2] = bf16x2_of(f[2][2 * h], f[3][2 * h]);
            a[3] = bf16x2_of(f[2][2 * h + 1], f[3][2 * h + 1]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_16816(acc[2 * q + h][mt], a, bx[mt][0], bx[mt][1]);
          }
        }
      }
    }

    // accumulator (j, mt): rows g / g + 8 are columns VW g + 2j / + 1 of
    // the strip, its columns 2t / 2t + 1 rows 8mt + 2t (+ 1) of x
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        red[warp * GROUPS + (j * MT + mt) * 32 + lane] =
            make_float4(acc[j][mt][0], acc[j][mt][1], acc[j][mt][2], acc[j][mt][3]);
    __syncthreads();
    for (int e = threadIdx.x; e < GROUPS; e += blockDim.x) {
      float4 s4 = red[e];
      for (int q = 1; q < split; ++q) {  // warp order
        const float4 o = red[q * GROUPS + e];
        s4.x += o.x;
        s4.y += o.y;
        s4.z += o.z;
        s4.w += o.w;
      }
      const int m = 8 * ((e >> 5) % MT) + 2 * (e & 3), col = item_col(strip, e);
      if (col >= N) continue;
      const bool two = col + 1 < N;
      const bool first = e == static_cast<int>(threadIdx.x);
      const float s0 = first ? s_first[0] : scale[col];
      const float s1 = first ? s_first[1] : two ? scale[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (m + h >= M) break;
        OT* o = out + (m + h) * ldo + col;
        const float v0 = (h ? s4.y : s4.x) * s0, v1 = (h ? s4.w : s4.z) * s1;
        if (two && pairs) {
          store_pair(o, v0, v1);
        } else {
          o[0] = from_f32<OT>(v0);
          if (two) o[1] = from_f32<OT>(v1);
        }
      }
    }
    __syncthreads();  // the buffer is the next strip's
  }
}

// The plan (m_tiles, the weight bytes a lane loads from a row, split,
// grid, whole loads of x and of the weight) comes from the wrapper's
// plan(); one the operands cannot take is refused.
template <int MT, int VW, typename XT, typename WT, typename OT>
static int launch_skinny(const Args& a, int split, int grid, int vec_x, int vec_w,
                         cudaStream_t s) {
  if (split < 1 || split > SK_MAX_SPLIT || grid > (a.N + 8 * VW - 1) / (8 * VW))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec_w && (reinterpret_cast<uintptr_t>(a.w) % VW || a.ldw % VW))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool sized = false;  // once per instantiation
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmm_skinny_kernel<MT, VW, XT, WT, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SK_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const int pairs =
      a.ldo % 2 == 0 && reinterpret_cast<uintptr_t>(a.out) % (2 * sizeof(OT)) == 0;
  qmm_skinny_kernel<MT, VW, XT, WT, OT><<<grid, split * 32, sk_smem(MT, VW, split), s>>>(
      static_cast<const XT*>(a.x), static_cast<const WT*>(a.w), a.scale,
      static_cast<OT*>(a.out), a.M, a.N, a.K, a.ldx, a.ldw, a.ldo, vec_x, vec_w, pairs);
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

// the tensor-core bodies, each a launcher over (x, w, out) element types
// and the body's own plan arguments, if any
struct WmmaBody {
  template <typename XT, typename WT, typename OT>
  static int run(const Args& a, cudaStream_t s) { return launch_tc<BigTile, XT, WT, OT>(a, s); }
};
struct WgmmaBody {
  template <typename XT, typename WT, typename OT>
  static int run(const Args& a, cudaStream_t s) { return launch_wg<XT, WT, OT>(a, s); }
};
struct SkinnyPlan {
  int m_tiles, vw, split, grid, vec_x, vec_w;
};
// the compiled (x-row tiles, weight bytes a lane loads from a row): each
// keeps 64 accumulator registers or fewer
struct SkinnyBody {
  template <typename XT, typename WT, typename OT>
  static int run(const Args& a, cudaStream_t s, const SkinnyPlan& p) {
    switch (p.m_tiles * 100 + p.vw) {
      case 208: return launch_skinny<2, 8, XT, WT, OT>(a, p.split, p.grid, p.vec_x, p.vec_w, s);
      case 204: return launch_skinny<2, 4, XT, WT, OT>(a, p.split, p.grid, p.vec_x, p.vec_w, s);
      case 408: return launch_skinny<4, 8, XT, WT, OT>(a, p.split, p.grid, p.vec_x, p.vec_w, s);
      case 404: return launch_skinny<4, 4, XT, WT, OT>(a, p.split, p.grid, p.vec_x, p.vec_w, s);
      case 804: return launch_skinny<8, 4, XT, WT, OT>(a, p.split, p.grid, p.vec_x, p.vec_w, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
};

template <class Body, typename XT, typename WT, class... P>
static int tc_by_out(const Args& a, int out_code, cudaStream_t s, const P&... p) {
  if (out_code == DTYPE_F32) return Body::template run<XT, WT, float>(a, s, p...);
  if (out_code == DTYPE_BF16) return Body::template run<XT, WT, bf16>(a, s, p...);
  return BAD;
}

template <class Body, typename XT, class... P>
static int tc_by_w(const Args& a, int w_code, int out_code, cudaStream_t s, const P&... p) {
  if (w_code == DTYPE_I8) return tc_by_out<Body, XT, int8_t>(a, out_code, s, p...);
  if (w_code == DTYPE_F8E4M3) return tc_by_out<Body, XT, fp8>(a, out_code, s, p...);
  return BAD;
}

template <class Body, class... P>
static int tc_by_x(const Args& a, int x_code, int w_code, int out_code, cudaStream_t s,
                   const P&... p) {
  if (x_code == DTYPE_BF16) return tc_by_w<Body, bf16>(a, w_code, out_code, s, p...);
  if (x_code == DTYPE_I8) return tc_by_w<Body, int8_t>(a, w_code, out_code, s, p...);
  return BAD;
}

template <typename WT>
static int f32_by_out(const Args& a, int out_code, cudaStream_t s) {
  if (out_code == DTYPE_F32) return launch_f32<WT, float>(a, s);
  if (out_code == DTYPE_BF16) return launch_f32<WT, bf16>(a, s);
  return BAD;
}

// body codes shared with kernels/quant_matmul/kernel.py (BODIES)
enum BodyCode : int { BODY_CUDA_CORES = 0, BODY_WMMA = 1, BODY_SKINNY = 2, BODY_WGMMA = 3 };

// x (M, K) of row stride ldx, qw (K, N) of row stride ldw, scale (N,) fp32,
// out (M, N) of row stride ldo; codes as DTypeCode; `body` as chosen by the
// wrapper (fp32 x: CUDA cores; wgmma where x and qw rows are 16-byte
// aligned, as TMA needs; WMMA otherwise; M <= 64 takes the skinny body
// through quant_matmul_skinny). Returns the launch's cudaError_t; a body
// that cannot take the operands returns cudaErrorInvalidValue.
extern "C" int quant_matmul(const void* x, const void* w, const float* scale,
                            void* out, int M, int N, int K, long long ldx,
                            long long ldw, long long ldo, int x_code,
                            int w_code, int out_code, int body, void* stream) {
  if (M < 1 || N < 1 || K < 1 || ldx < K || ldw < N || ldo < N) return BAD;
  if ((body == BODY_CUDA_CORES) != (x_code == DTYPE_F32)) return BAD;
  if (M <= SKINNY_MAX_M && body != BODY_CUDA_CORES) return BAD;
  const Args a{x, w, scale, out, M, N, K, ldx, ldw, ldo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case BODY_CUDA_CORES:
      if (w_code == DTYPE_I8) return f32_by_out<int8_t>(a, out_code, s);
      if (w_code == DTYPE_F8E4M3) return f32_by_out<fp8>(a, out_code, s);
      return BAD;
    case BODY_WMMA: return tc_by_x<WmmaBody>(a, x_code, w_code, out_code, s);
    case BODY_WGMMA: return tc_by_x<WgmmaBody>(a, x_code, w_code, out_code, s);
    default: return BAD;
  }
}

// The skinny body (bf16 or int8 x, 1 <= M <= 64) on the wrapper's plan:
// m_tiles the n8 tiles of x rows (2 up to M = 16, 4 up to 32, 8 up to 64),
// vw the weight bytes a lane loads from a row (8 or 4; 4 with 8 x-row
// tiles), split the warps a block (1-8), grid the blocks (at most one a
// strip of 8 vw columns), vec_x / vec_w whole loads of x / the weight
// (start and row stride aligned to 4 values of x, to vw bytes of the
// weight), else element loads. A plan the operands cannot take returns
// cudaErrorInvalidValue.
extern "C" int quant_matmul_skinny(const void* x, const void* w, const float* scale,
                                   void* out, int M, int N, int K, long long ldx,
                                   long long ldw, long long ldo, int x_code, int w_code,
                                   int out_code, int m_tiles, int vw, int split, int grid,
                                   int vec_x, int vec_w, void* stream) {
  if (M < 1 || M > SKINNY_MAX_M || N < 1 || K < 1 || ldx < K || ldw < N || ldo < N)
    return BAD;
  if (m_tiles != (M <= 16 ? 2 : M <= 32 ? 4 : 8) || grid < 1) return BAD;
  const int xs = x_code == DTYPE_BF16 ? 2 : x_code == DTYPE_I8 ? 1 : 0;
  if (!xs) return BAD;
  if (vec_x && (reinterpret_cast<uintptr_t>(x) % (4 * xs) || (ldx * xs) % (4 * xs)))
    return BAD;
  const Args a{x, w, scale, out, M, N, K, ldx, ldw, ldo};
  const SkinnyPlan p{m_tiles, vw, split, grid, vec_x != 0, vec_w != 0};
  return tc_by_x<SkinnyBody>(a, x_code, w_code, out_code, static_cast<cudaStream_t>(stream), p);
}

EXPORT_ERROR_STRING
