// Blockwise online-softmax attention (non-causal, causal or sliding window),
// GQA through the kv head index.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention.
//
// Bound on the H100: at the dit-i256 serving shape (net batch 16, 16 heads,
// S = 256, head dim 72, bf16) the call does 4 * B * H * S^2 * D = 4.8 GFLOP
// (4.9 us at 989 TFLOP/s) on 38 MB of q/k/v/o (11.3 us at 3.35 TB/s): the
// bytes bound it, not the operations.
//
// Two bodies, one online softmax:
// * bf16 (the main path) — attn_tc_kernel: tensor cores through WMMA
//   (16x16x16 bf16 tiles, fp32 accumulation). One block of 4 warps per
//   (b * Hq + h, 64-query tile); each warp owns 16 query rows. Q, and K/V
//   tiles of 64 keys, sit in shared memory as bf16 with the head dim
//   zero-padded to a multiple of 16 there only (72 -> 80; global memory is
//   read at the true D). S = Q K^T per warp goes through shared memory,
//   where two lanes per row apply the scale, the masks and the running
//   max/sum in fp32; P is rounded to bf16 for the P V product, whose fp32
//   accumulator rows live in shared memory so each row can be rescaled.
//   Tiles are filled with 16-byte loads all issued before the first store
//   (D % 8 == 0; 2-byte loads otherwise). Shared-memory strides are padded
//   and the softmax visits its columns in a lane-skewed order, so no
//   access is bank-conflicted more than 2-way.
//   wgmma/TMA pipelining is later work.
// * fp32 (the reference-precision serving path) — attn_kernel: fp32 CUDA
//   cores, so fp32 inputs keep fp32 products. One block per (b * Hq + h,
//   64-query tile), 256 threads: four threads share a query row and each
//   owns every fourth of its D columns (the true D, no padding lanes); K/V
//   tiles of 32 keys in shared memory; the four partial dot products meet
//   by two warp shuffles; max, denominator and accumulator in registers.
// Scores are scaled by 1/sqrt(D) after the dot product and masked with
// -1e30 like the reference; keys past Skv add exactly zero. q/k/v/o are
// addressed through (b, h, s) strides with unit column stride, so the
// model's (B, S, H, D) projections are read and written in place.
#include <math.h>
#include <mma.h>

#include "common.cuh"

constexpr int BQ = 64;                 // query rows per block
constexpr int GROUP = 4;               // threads per query row
constexpr int THREADS = BQ * GROUP;    // 256
constexpr int BK = 32;                 // key rows per shared-memory tile
constexpr int MAX_D = 128;
constexpr float MASKED = -1e30f;

struct Strides {
  long long b, h, s;
};

template <int DPT>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, int Hq, int Hkv, int Sq,
            int Skv, int D, Strides qs, Strides ks, Strides vs, Strides os,
            int causal, int window, float scale) {
  __shared__ float k_tile[BK * MAX_D];
  __shared__ float v_tile[BK * MAX_D];
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int sub = threadIdx.x % GROUP;
  const int qi = blockIdx.y * BQ + threadIdx.x / GROUP;
  const bool q_ok = qi < Sq;

  float qv[DPT], acc[DPT];
  const float* qp = q + b * qs.b + h * qs.h + (long long)(q_ok ? qi : 0) * qs.s;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = sub + GROUP * j;
    qv[j] = (q_ok && d < D) ? qp[d] : 0.f;
    acc[j] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  for (int k0 = 0; k0 < Skv; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int r = e / D, d = e - r * D;
      const int key = k0 + r;
      const bool ok = key < Skv;
      k_tile[e] = ok ? kb[key * ks.s + d] : 0.f;
      v_tile[e] = ok ? vb[key * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int r = 0; r < BK; ++r) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = sub + GROUP * j;
        if (d < D) part += qv[j] * k_tile[r * D + d];
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int key = k0 + r;
      bool ok = true;
      if (causal) ok = ok && key <= qi;
      if (window > 0) ok = ok && key > qi - window;
      float sc = ok ? part * scale : MASKED;
      if (key >= Skv) sc = -INFINITY;  // past the end: contributes exactly 0
      s[r] = sc;
      tile_max = fmaxf(tile_max, sc);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] *= alpha;
#pragma unroll
    for (int r = 0; r < BK; ++r) {
      const float p = expf(s[r] - m_new);
      l += p;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = sub + GROUP * j;
        if (d < D) acc[j] += p * v_tile[r * D + d];
      }
    }
    m = m_new;
  }

  if (q_ok) {
    float* op = o + b * os.b + h * os.h + (long long)qi * os.s;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = sub + GROUP * j;
      if (d < D) op[d] = acc[j] / denom;
    }
  }
}

// ---- bf16: tensor cores through WMMA -------------------------------------

constexpr int TC_BQ = 64;               // query rows per block
constexpr int TC_WARPS = TC_BQ / 16;    // each warp owns 16 query rows
constexpr int TC_BK = 64;               // key rows per shared-memory tile
// Shared-memory row strides are padded off multiples of 128 bytes so the
// 16 rows a WMMA load or store touches fall in different banks.
constexpr int S_LD = TC_BK + 4;         // fp32 scores
constexpr int P_LD = TC_BK + 8;         // bf16 probabilities

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// bf16 tile stride (elements) for a head dim padded to dp, and the fp32
// accumulator stride
__host__ __device__ inline int tile_ld(int dp) { return dp + 8; }
__host__ __device__ inline int acc_ld(int dp) { return dp + 4; }

// Copies rows r0 .. r0+TC_BK-1 of one head (row stride ld_g, true width D)
// into a bf16 shared tile of stride ld, zero-filling columns D..dp-1 and
// rows at or past `limit`. vec: 16-byte loads (D % 8 == 0 and aligned),
// all issued before the first store so their latencies overlap.
__device__ __forceinline__ void fill_tile(bf16* tile, const bf16* src,
                                          long long ld_g, int r0, int limit,
                                          int D, int dp, int ld, bool vec) {
  if (vec) {
    constexpr int MAXC = TC_BK * MAX_D / 8 / (TC_WARPS * 32);  // per thread
    const int cpr = dp / 8;  // 16-byte chunks per tile row
    uint4 buf[MAXC];
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int e = threadIdx.x + i * TC_WARPS * 32;
      const int r = e / cpr, c = e - r * cpr;
      buf[i] = make_uint4(0u, 0u, 0u, 0u);
      if (r < TC_BK && r0 + r < limit && c * 8 < D)
        buf[i] = *reinterpret_cast<const uint4*>(
            src + (long long)(r0 + r) * ld_g + c * 8);
    }
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int e = threadIdx.x + i * TC_WARPS * 32;
      const int r = e / cpr, c = e - r * cpr;
      if (r < TC_BK) *reinterpret_cast<uint4*>(tile + r * ld + c * 8) = buf[i];
    }
    return;
  }
  const bf16 zero = __float2bfloat16_rn(0.f);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < TC_BK; r += TC_WARPS) {
    const bool row_ok = r0 + r < limit;
    for (int d = lane; d < dp; d += 32)
      tile[r * ld + d] =
          (row_ok && d < D) ? src[(long long)(r0 + r) * ld_g + d] : zero;
  }
}

static size_t tc_smem_bytes(int dp) {
  return sizeof(bf16) * (size_t)(TC_BQ + 2 * TC_BK) * tile_ld(dp)  // Q, K, V
         + sizeof(float) * TC_WARPS * 16 * S_LD                    // S
         + sizeof(bf16) * TC_WARPS * 16 * P_LD                     // P
         + sizeof(float) * (size_t)TC_WARPS * 16 * acc_ld(dp)      // O
         + sizeof(float) * TC_WARPS * 16 * 3;                      // m, l, alpha
}

__global__ void __launch_bounds__(TC_WARPS * 32)
attn_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int Hq,
               int Hkv, int Sq, int Skv, int D, int DP, Strides qs,
               Strides ks, Strides vs, Strides os, int causal, int window,
               float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LD = tile_ld(DP), OLD = acc_ld(DP);
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + TC_BQ * LD;
  bf16* v_s = k_s + TC_BK * LD;
  float* s_all = reinterpret_cast<float*>(v_s + TC_BK * LD);
  bf16* p_all = reinterpret_cast<bf16*>(s_all + TC_WARPS * 16 * S_LD);
  float* o_all = reinterpret_cast<float*>(p_all + TC_WARPS * 16 * P_LD);
  float* stat_all = o_all + TC_WARPS * 16 * OLD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * TC_BQ;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  static_assert(TC_BQ == TC_BK, "fill_tile serves the Q and K/V tiles");
  fill_tile(q_s, qb, qs.s, q0, Sq, D, DP, LD, vec);
  float* s_w = s_all + warp * 16 * S_LD;
  bf16* p_w = p_all + warp * 16 * P_LD;
  float* o_w = o_all + warp * 16 * OLD;
  float* m_w = stat_all + warp * 48;
  float* l_w = m_w + 16;
  float* a_w = m_w + 32;
  for (int r = 0; r < 16; ++r)
    for (int d = lane; d < DP; d += 32) o_w[r * OLD + d] = 0.f;
  if (lane < 16) {
    m_w[lane] = -INFINITY;
    l_w[lane] = 0.f;
  }
  // softmax: two lanes per row, each over half the tile's keys, visiting
  // its columns in a lane-skewed order so the 32 lanes hit 32 banks
  const int row = lane >> 1;
  const int c0 = (lane & 1) * (TC_BK / 2);
  const int qi = q0 + warp * 16 + row;

  for (int k0 = 0; k0 < Skv; k0 += TC_BK) {
    __syncthreads();  // the previous K/V tile is consumed
    fill_tile(k_s, kb, ks.s, k0, Skv, D, DP, LD, vec);
    fill_tile(v_s, vb, vs.s, k0, Skv, D, DP, LD, vec);
    __syncthreads();

    // S = Q_w K^T: 16 x 64 scores of this warp's rows
    for (int n = 0; n < TC_BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(a, q_s + warp * 16 * LD + kk, LD);
        wmma::load_matrix_sync(bm, k_s + n * 16 * LD + kk, LD);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(s_w + n * 16, acc, S_LD, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile, fp32
    float* s_row = s_w + row * S_LD + c0;
    float mx = -INFINITY;
    for (int c = 0; c < TC_BK / 2; ++c) {
      const int j = (c + lane) & (TC_BK / 2 - 1);
      const int key = k0 + c0 + j;
      bool ok = true;
      if (causal) ok = ok && key <= qi;
      if (window > 0) ok = ok && key > qi - window;
      float sc = ok ? s_row[j] * scale : MASKED;
      if (key >= Skv) sc = -INFINITY;
      s_row[j] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_old = m_w[row];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    bf16* p_row = p_w + row * P_LD + c0;
    for (int c = 0; c < TC_BK / 2; ++c) {
      const int j = (c + lane) & (TC_BK / 2 - 1);
      const float p = expf(s_row[j] - m_new);
      sum += p;
      p_row[j] = __float2bfloat16_rn(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    __syncwarp();  // both lanes of a row have read m_w
    if ((lane & 1) == 0) {
      const float alpha = expf(m_old - m_new);
      m_w[row] = m_new;
      l_w[row] = l_w[row] * alpha + sum;
      a_w[row] = alpha;
    }
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const float alpha = a_w[r];
      for (int d = lane; d < DP; d += 32) o_w[r * OLD + d] *= alpha;
    }
    __syncwarp();

    // O_w += P V
    for (int n = 0; n < DP / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, o_w + n * 16, OLD, wmma::mem_row_major);
      for (int kk = 0; kk < TC_BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, p_w + kk, P_LD);
        wmma::load_matrix_sync(bm, v_s + kk * LD + n * 16, LD);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(o_w + n * 16, acc, OLD, wmma::mem_row_major);
    }
    __syncwarp();
  }

  bf16* ob = o + b * os.b + h * os.h;
  for (int r = 0; r < 16; ++r) {
    const int qr = q0 + warp * 16 + r;
    if (qr >= Sq) break;
    const float denom = fmaxf(l_w[r], 1e-30f);
    for (int d = lane; d < D; d += 32)
      ob[(long long)qr * os.s + d] = __float2bfloat16_rn(o_w[r * OLD + d] / denom);
  }
}

static int launch_cuda_cores(const void* q, const void* k, const void* v,
                             void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                             int D, const long long* st, int causal, int window,
                             float scale, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(B * Hq),
                  static_cast<unsigned>((Sq + BQ - 1) / BQ));
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  if (D <= 32) {
    attn_kernel<8><<<grid, THREADS, 0, s>>>(qp, kp, vp, op, Hq, Hkv, Sq, Skv,
                                               D, qs, ks, vs, os, causal, window,
                                               scale);
  } else if (D <= 72) {
    attn_kernel<18><<<grid, THREADS, 0, s>>>(qp, kp, vp, op, Hq, Hkv, Sq, Skv,
                                                D, qs, ks, vs, os, causal,
                                                window, scale);
  } else {
    attn_kernel<32><<<grid, THREADS, 0, s>>>(qp, kp, vp, op, Hq, Hkv, Sq, Skv,
                                                D, qs, ks, vs, os, causal,
                                                window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// strides: 12 values, (b, h, s) strides of q, k, v, o in elements.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                               int D, const long long* strides, int causal,
                               int window, float scale, int dtype, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 1 || D < 1 ||
      D > MAX_D || (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return launch_cuda_cores(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides,
                             causal, window, scale, s);
  if (dtype != DTYPE_BF16) return static_cast<int>(cudaErrorInvalidValue);
  const int DP = (D + 15) / 16 * 16;
  const size_t smem = tc_smem_bytes(DP);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * Hq),
                  static_cast<unsigned>((Sq + TC_BQ - 1) / TC_BQ));
  const long long* st = strides;
  // 16-byte tile loads need whole 8-element chunks at 16-byte addresses
  bool vec = D % 8 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
  vec = vec && (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  attn_tc_kernel<<<grid, TC_WARPS * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Hq, Hkv, Sq, Skv, D,
      DP, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, causal,
      window, scale, static_cast<int>(vec));
  return static_cast<int>(cudaGetLastError());
}

EXPORT_ERROR_STRING
