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
// * bf16 (the main path) — attn_mma_kernel, FlashAttention-2's layout on
//   mma.sync m16n8k16 tensor cores. A block of 8 warps takes 128 queries of
//   one (b, h); each warp owns 16 query rows. At the main shape that is 512
//   blocks of 256 threads, two per SM (<= 128 registers, 72 KB of shared
//   memory each), so 1.94 waves over 132 SMs with every block reading its
//   head's K and V once: 2 reads of each K/V byte in all. What the design
//   does about the bytes bound:
//   - S, P and O never leave registers. The fp32 accumulator fragment of
//     S = Q K^T gives P = exp2(S - m), split into two bf16 A fragments of
//     P V: hi = P rounded to bf16 and lo = (P - hi) rounded to bf16 (the
//     difference is exact in fp32). Each V fragment is loaded once and
//     feeds hi, then lo, into the same fp32 accumulator, so P carries 16
//     significant bits into the product and every product of bf16 halves
//     is exact: the TPU kernel's fp32 p @ v (it widens v), up to the
//     order of the sums. The split doubles P V's products (at D = 72, 72
//     mma a warp a key tile in place of 36, beside Q K^T's 40); its time
//     at each shape is in PERF.md §6. Row max and sum take two quad
//     shuffles, the sum over the unsplit fp32 P; exp2f with scale *
//     log2(e) folded into the scores; O is rescaled in registers and
//     divided by l once at the end.
//   - K/V tiles of 64 keys arrive by 16-byte cp.async into a ring of 3
//     stages, two tiles ahead of the products, one barrier per tile.
//   - Shared-memory rows hold an odd number of 16-byte chunks (D = 72:
//     144 bytes, unpadded), so the 8 rows an ldmatrix reads fall in 8
//     distinct 4-bank groups: no bank conflicts, no swizzle.
//   - D = 72 contracts as 4 k16 steps and one m16n8k8 step (Q K^T), and
//     P V has N = 72 = 9 n8 tiles: no padding work at the main shape. The
//     head dim is compiled in 8-column chunks ND in {4, 8, 9, 16}; another
//     D <= 128 runs in the next larger ND, its extra columns zero-filled in
//     shared memory only.
//   - Q is read into registers once; the epilogue stages each warp's rows
//     in its own dead Q rows and writes 16-byte stores.
//   - Tiles whose every key is masked for every query of the block
//     (causal, sliding window) are skipped, as the reference does, unless
//     a query of the block has no unmasked key at all: its row is then the
//     mean over all keys, as in the reference's softmax of equal scores.
//   Rows of D % 8 == 0 at 16-byte-aligned addresses and strides load by
//   cp.async; any other shape fills the same tiles with 2-byte loads (the
//   wrapper decides by shape and reports which).
// * bf16, multi-head latent attention (DeepSeek-V2's MLA) — attn_mla_kernel:
//   the same body with scores Dk = 192 deep and values Dv = 128 wide, each
//   in its own chunk count (24, 16) and shared-memory pitch (400, 272
//   bytes), so no column of either is padding. At DeepSeek-V2-Lite's
//   sampling shape (16 sequences, 16 heads, S = 1024) a call does
//   2 * B * H * S^2 * (192 + 128) = 172 GFLOP (174 us at 989 TFLOP/s) on
//   335 MB of q/k/v/o (100 us at 3.35 TB/s): the operations bound it. Q's
//   24 chunks and O's 16 would not both fit in registers, so Q's fragments
//   are read from shared memory at each key tile, two k16 steps at a time
//   over the tile's 8 key groups (each accumulator takes its steps in
//   order, as the register path does). One block of 176 KB per SM.
// * fp32 (the reference-precision serving path) — attn_kernel: fp32 CUDA
//   cores, so fp32 inputs keep fp32 products. One block per (b * Hq + h,
//   64-query tile), 256 threads: four threads share a query row and each
//   owns every fourth of its D columns (the true D, no padding lanes); K/V
//   tiles of 32 keys in shared memory; the four partial dot products meet
//   by two warp shuffles; max, denominator and accumulator in registers.
// Scores are masked with -1e30 like the reference; keys past Skv add
// exactly zero. q/k/v/o are addressed through (b, h, s) strides with unit
// column stride, so the model's (B, S, H, D) projections are read and
// written in place.
#include <math.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

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
            const float* __restrict__ v, float* __restrict__ o,
            float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv, int D,
            Strides qs, Strides ks, Strides vs, Strides os, int causal, int window,
            float scale) {
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
    if (lse != nullptr && sub == 0) lse[(long long)bh * Sq + qi] = m + logf(l);
  }
}

// ---- bf16: mma.sync with register-resident S, P and O ---------------------

using bf16 = __nv_bfloat16;

constexpr int MMA_WARPS = 8;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int MMA_BQ = 16 * MMA_WARPS;  // 128 query rows per block
constexpr int MMA_BK = 64;              // keys per tile
constexpr int MMA_STAGES = 3;           // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ND: the head dim in 8-column (16-byte) chunks as compiled; NDV, the
// value width's, where it differs from the score depth's (MLA: 24 and 16)
template <int ND, int NDV = ND>
struct FaTile {
  static constexpr int PITCH = (ND | 1) * 16;  // bytes; an odd chunk count
  static constexpr int PITCH_V = (NDV | 1) * 16;
  static constexpr int Q_BYTES = MMA_BQ * PITCH;
  static constexpr int KV_BYTES = MMA_BK * PITCH;  // one K tile
  static constexpr int V_BYTES = MMA_BK * PITCH_V;
  static constexpr int STAGE = KV_BYTES + V_BYTES;
  static constexpr int SMEM = Q_BYTES + MMA_STAGES * STAGE;
  static constexpr int MIN_BLOCKS = ND <= 9 ? 2 : 1;
  // Q's fragments stay in registers over the key tiles up to 16 chunks;
  // deeper scores (MLA's 24) reload them from shared memory each tile
  static constexpr bool Q_REGS = ND <= 16;
};

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned a, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(unsigned a, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x1(unsigned a, uint32_t& r0) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(r0)
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned a, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_t(unsigned a, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_k16(float* c, const uint32_t* a, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c (16 x 8) += a (16 x 8) * b (8 x 8): the odd 8 columns of D
__device__ __forceinline__ void mma_k8(float* c, uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// what pack_bf16(lo, hi) = `packed` left out, rounded to bf16 in turn: the
// differences are exact in fp32, so packed + residual carries 16 bits (the
// split P of the forward's P V and the backward's split operands)
__device__ __forceinline__ uint32_t pack_bf16_residual(float lo, float hi,
                                                       uint32_t packed) {
  const float2 r = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&packed));
  return pack_bf16(lo - r.x, hi - r.y);
}

// Issue the fill of `rows` tile rows (rows r0.. of one head, row stride ld
// elements) into shared memory at `dst` (row pitch PITCH bytes, ND chunks
// a row): zeros past `limit` rows and past D columns. vec: 16-byte
// cp.async chunks (D % 8 == 0, aligned rows); else 2-byte loads and
// stores, complete before the caller's next barrier.
template <int ND, int NT = MMA_THREADS>
__device__ __forceinline__ void fill_rows(unsigned char* dst, const bf16* __restrict__ src,
                                          long long ld, int r0, int limit, int rows,
                                          int D, bool vec) {
  constexpr int PITCH = FaTile<ND>::PITCH;
  if (vec) {
    const unsigned base = smem_u32(dst);
    for (int e = threadIdx.x; e < rows * ND; e += NT) {
      const int r = e / ND, c = e - r * ND;
      const bool ok = r0 + r < limit && c * 8 < D;
      const bf16* g = ok ? src + (long long)(r0 + r) * ld + c * 8 : src;
      cp_async16(base + r * PITCH + c * 16, g, ok);
    }
    return;
  }
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int e = threadIdx.x; e < rows * ND * 8; e += NT) {
    const int r = e / (ND * 8), d = e - r * (ND * 8);
    *reinterpret_cast<bf16*>(dst + r * PITCH + d * 2) =
        (r0 + r < limit && d < D) ? src[(long long)(r0 + r) * ld + d] : zero;
  }
}

// The bf16 forward's body: scores D deep in ND chunks, values Dv wide in
// NDV chunks (equal but for MLA's kernel below).
template <int ND, int NDV>
__device__ __forceinline__ void attn_mma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, float* __restrict__ o32, int Hq,
    int Hkv, int Sq, int Skv, int D, int Dv, Strides qs, Strides ks, Strides vs,
    Strides os, int causal, int window, float scale_log2, int vec_in, int vec_out) {
  using T = FaTile<ND, NDV>;
  constexpr int PITCH = T::PITCH;
  constexpr int PITCH_V = T::PITCH_V;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* kv_s = smem + T::Q_BYTES;  // stage s: K, then V
  const unsigned q_u = smem_u32(q_s), kv_u = smem_u32(kv_s);

  const int nq = (Sq + MMA_BQ - 1) / MMA_BQ;
  const int bh = blockIdx.x / nq, q0 = (blockIdx.x - bh * nq) * MMA_BQ;
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  // key tiles this block needs: skip those masked for all of its queries,
  // unless its last query has no unmasked key (then every tile counts)
  const int n_kt = (Skv + MMA_BK - 1) / MMA_BK;
  int kt_lo = 0, kt_hi = n_kt;
  const int q_last = min(q0 + MMA_BQ, Sq) - 1;
  const int key_hi = causal ? min(q_last, Skv - 1) : Skv - 1;
  const int key_lo = window > 0 ? max(0, q_last - window + 1) : 0;
  if (key_lo <= key_hi) {
    if (causal) kt_hi = min(q_last, Skv - 1) / MMA_BK + 1;
    if (window > 0) kt_lo = max(0, q0 - window + 1) / MMA_BK;
  }
  const int n_tiles = kt_hi - kt_lo;

  auto issue = [&](int i) {  // tile kt_lo + i into stage i % STAGES
    if (i < n_tiles) {
      unsigned char* st = kv_s + (i % MMA_STAGES) * T::STAGE;
      const int key0 = (kt_lo + i) * MMA_BK;
      fill_rows<ND>(st, kb, ks.s, key0, Skv, MMA_BK, D, vec_in);
      fill_rows<NDV>(st + T::KV_BYTES, vb, vs.s, key0, Skv, MMA_BK, Dv, vec_in);
    }
    cp_async_commit();
  };
  fill_rows<ND>(q_s, qb, qs.s, q0, Sq, MMA_BQ, D, vec_in);  // in group 0
  for (int i = 0; i < MMA_STAGES - 1; ++i) issue(i);

  // per thread: rows g and g + 8 of the warp's 16, columns 2t, 2t + 1 of
  // every n8 tile (the m16n8 accumulator layout)
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;
  constexpr int NQF = T::Q_REGS ? (ND / 2 > 0 ? ND / 2 : 1) : 1;
  uint32_t qf[NQF][4];
  uint32_t qf8[2];
  float oacc[NDV][4];
#pragma unroll
  for (int n = 0; n < NDV; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const unsigned q_row = q_u + (warp * 16 + (lane & 15)) * PITCH;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<MMA_STAGES - 2>();  // tile i (and Q) landed
    __syncthreads();                   // ... for every thread; tile i-1 consumed
    if constexpr (T::Q_REGS) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < ND / 2; ++kk)
          ldsm_x4(q_row + (2 * kk + (lane >> 4)) * 16, qf[kk][0], qf[kk][1], qf[kk][2],
                  qf[kk][3]);
        if (ND & 1) ldsm_x2(q_row + (ND - 1) * 16, qf8[0], qf8[1]);
      }
    }
    issue(i + MMA_STAGES - 1);  // into the stage tile i-1 left
    const unsigned k_u = kv_u + (i % MMA_STAGES) * T::STAGE;
    const unsigned v_u = k_u + T::KV_BYTES;

    // S = Q K^T: 16 x 64 per warp, 8 n8 tiles of keys
    float s[MMA_BK / 8][4];
    if constexpr (!T::Q_REGS) {
      // two 16-column steps of Q at a time from shared memory, each over
      // all 8 key tiles: every accumulator takes its steps in the same
      // order as below
      static_assert(ND % 4 == 0, "the shared-memory Q path takes ND % 4 == 0");
#pragma unroll
      for (int n = 0; n < MMA_BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ND / 2; kk += 2) {
        uint32_t qa[4], qb[4];
        ldsm_x4(q_row + (2 * kk + (lane >> 4)) * 16, qa[0], qa[1], qa[2], qa[3]);
        ldsm_x4(q_row + (2 * kk + 2 + (lane >> 4)) * 16, qb[0], qb[1], qb[2], qb[3]);
#pragma unroll
        for (int n = 0; n < MMA_BK / 8; ++n) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(k_u + (n * 8 + (lane & 7)) * PITCH + (2 * kk + (lane >> 3)) * 16, b0,
                  b1, b2, b3);
          mma_k16(s[n], qa, b0, b1);
          mma_k16(s[n], qb, b2, b3);
        }
      }
    }
    if constexpr (T::Q_REGS) {
#pragma unroll
    for (int n = 0; n < MMA_BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const unsigned k_row = k_u + (n * 8 + (lane & 7)) * PITCH;
      int kk = 0;
#pragma unroll
      for (; kk + 1 < ND / 2; kk += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(k_row + (2 * kk + (lane >> 3)) * 16, b0, b1, b2, b3);
        mma_k16(s[n], qf[kk], b0, b1);
        mma_k16(s[n], qf[kk + 1], b2, b3);
      }
#pragma unroll
      for (; kk < ND / 2; ++kk) {
        uint32_t b0, b1;
        ldsm_x2(k_row + (2 * kk + ((lane >> 3) & 1)) * 16, b0, b1);
        mma_k16(s[n], qf[kk], b0, b1);
      }
      if (ND & 1) {
        uint32_t b0;
        ldsm_x1(k_row + (ND - 1) * 16, b0);
        mma_k8(s[n], qf8[0], qf8[1], b0);
      }
    }
    }

    // scale (log2 domain), mask, running max
    const int key0 = (kt_lo + i) * MMA_BK;
    const bool masking = causal || window > 0 || key0 + MMA_BK > Skv;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < MMA_BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (masking) {
          const int key = key0 + n * 8 + 2 * t4 + (e & 1);
          const int qi = row0 + (e >> 1) * 8;
          bool ok = true;
          if (causal) ok = ok && key <= qi;
          if (window > 0) ok = ok && key > qi - window;
          if (!ok) x = MASKED;
          if (key >= Skv) x = -INFINITY;  // past the end: adds exactly 0
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);  // finite: key0 < Skv
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NDV; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // O += P V, 16 keys a step: P's bf16 hi and lo A fragments straight
    // from S's accumulators (n8 tiles 2kk and 2kk + 1); each V fragment
    // feeds both products into the same accumulator, hi first
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      uint32_t pa[4], pl[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* sv = s[2 * kk + half];
        const float p0 = exp2f(sv[0] - m_r[0]), p1 = exp2f(sv[1] - m_r[0]);
        const float p2 = exp2f(sv[2] - m_r[1]), p3 = exp2f(sv[3] - m_r[1]);
        l_r[0] += p0 + p1;
        l_r[1] += p2 + p3;
        pa[2 * half] = pack_bf16(p0, p1);
        pa[2 * half + 1] = pack_bf16(p2, p3);
        pl[2 * half] = pack_bf16_residual(p0, p1, pa[2 * half]);
        pl[2 * half + 1] = pack_bf16_residual(p2, p3, pa[2 * half + 1]);
      }
      const unsigned v_row = v_u + (kk * 16 + (lane & 15)) * PITCH_V;
#pragma unroll
      for (int n = 0; n + 1 < NDV; n += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(v_row + (n + (lane >> 4)) * 16, b0, b1, b2, b3);
        mma_k16(oacc[n], pa, b0, b1);
        mma_k16(oacc[n + 1], pa, b2, b3);
        mma_k16(oacc[n], pl, b0, b1);
        mma_k16(oacc[n + 1], pl, b2, b3);
      }
      if (NDV & 1) {
        uint32_t b0, b1;
        ldsm_x2_t(v_row + (NDV - 1) * 16, b0, b1);
        mma_k16(oacc[NDV - 1], pa, b0, b1);
        mma_k16(oacc[NDV - 1], pl, b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: O / l in bf16, staged in this warp's own (dead) Q rows, then
  // written as 16-byte chunks of the true D
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    denom[r] = fmaxf(l_r[r], 1e-30f);
  }
  if (lse != nullptr && t4 == 0) {  // natural log: m_r and l_r are base 2
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = row0 + r * 8;
      if (qr < Sq) lse[(long long)bh * Sq + qr] = (m_r[r] + log2f(l_r[r])) * LN2;
    }
  }
  if (o32 != nullptr) {  // O / l before its rounding: the backward's Delta
    float* ob32 = o32 + (long long)bh * Sq * Dv;
#pragma unroll
    for (int n = 0; n < NDV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = row0 + (e >> 1) * 8, c = n * 8 + 2 * t4 + (e & 1);
        if (qr < Sq && c < Dv) ob32[(long long)qr * Dv + c] = oacc[n][e] / denom[e >> 1];
      }
  }
  unsigned char* stage = q_s + warp * 16 * PITCH;
#pragma unroll
  for (int n = 0; n < NDV; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * PITCH + n * 16 + t4 * 4) =
        pack_bf16(oacc[n][0] / denom[0], oacc[n][1] / denom[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * PITCH + n * 16 + t4 * 4) =
        pack_bf16(oacc[n][2] / denom[1], oacc[n][3] / denom[1]);
  }
  __syncwarp();
  bf16* ob = o + b * os.b + h * os.h;
  for (int e = lane; e < 16 * NDV; e += 32) {
    const int r = e / NDV, c = e - r * NDV;
    const int qr = q0 + warp * 16 + r;
    if (qr >= Sq || c * 8 >= Dv) continue;
    bf16* dst = ob + (long long)qr * os.s + c * 8;
    const unsigned char* src = stage + r * PITCH + c * 16;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int d = 0; d < 8 && c * 8 + d < Dv; ++d)
        dst[d] = reinterpret_cast<const bf16*>(src)[d];
    }
  }
}

template <int ND>
__global__ void __launch_bounds__(MMA_THREADS, FaTile<ND>::MIN_BLOCKS)
attn_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, float* __restrict__ o32, int Hq, int Hkv,
                int Sq, int Skv, int D,
                Strides qs, Strides ks, Strides vs, Strides os, int causal, int window,
                float scale_log2, int vec_in, int vec_out) {
  attn_mma_body<ND, ND>(q, k, v, o, lse, o32, Hq, Hkv, Sq, Skv, D, D, qs, ks, vs, os,
                        causal, window, scale_log2, vec_in, vec_out);
}

// Multi-head latent attention's form (DeepSeek-V2): scores Dk = 192 deep
// (128 of the latent's keys + 64 of rope), values Dv = 128 wide, each in
// its own chunk count and shared-memory pitch, so neither is padded to
// the other. Q's 24 chunks are read from shared memory each key tile: in
// registers with O's 16 they would not fit.
template <int NDK, int NDV>
__global__ void __launch_bounds__(MMA_THREADS, FaTile<NDK>::MIN_BLOCKS)
attn_mla_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, float* __restrict__ o32, int Hq, int Hkv,
                int Sq, int Skv, int Dk, int Dv,
                Strides qs, Strides ks, Strides vs, Strides os, int causal, int window,
                float scale_log2, int vec_in, int vec_out) {
  attn_mma_body<NDK, NDV>(q, k, v, o, lse, o32, Hq, Hkv, Sq, Skv, Dk, Dv, qs, ks, vs, os,
                          causal, window, scale_log2, vec_in, vec_out);
}

template <int ND>
static int launch_mma(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                      float* o32, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                      const long long* st,
                      int causal, int window, float scale, int vec_in, int vec_out,
                      cudaStream_t s) {
  static bool sized = false;  // once per instantiation
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_mma_kernel<ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FaTile<ND>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const long long blocks = (long long)B * Hq * ((Sq + MMA_BQ - 1) / MMA_BQ);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  attn_mma_kernel<ND><<<static_cast<unsigned>(blocks), MMA_THREADS, FaTile<ND>::SMEM, s>>>(
      q, k, v, o, lse, o32, Hq, Hkv, Sq, Skv, D, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, causal, window, scale * LOG2E, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <int NDK, int NDV>
static int launch_mla(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                      float* o32, int B, int Hq, int Hkv, int Sq, int Skv, int Dk, int Dv,
                      const long long* st, int causal, int window, float scale,
                      int vec_in, int vec_out, cudaStream_t s) {
  static bool sized = false;  // once per instantiation
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_mla_kernel<NDK, NDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FaTile<NDK, NDV>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const long long blocks = (long long)B * Hq * ((Sq + MMA_BQ - 1) / MMA_BQ);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  attn_mla_kernel<NDK, NDV>
      <<<static_cast<unsigned>(blocks), MMA_THREADS, FaTile<NDK, NDV>::SMEM, s>>>(
          q, k, v, o, lse, o32, Hq, Hkv, Sq, Skv, Dk, Dv, Strides{st[0], st[1], st[2]},
          Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
          Strides{st[9], st[10], st[11]}, causal, window, scale * LOG2E, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

static int launch_cuda_cores(const void* q, const void* k, const void* v,
                             void* o, float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
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
    attn_kernel<8><<<grid, THREADS, 0, s>>>(qp, kp, vp, op, lse, Hq, Hkv, Sq, Skv,
                                               D, qs, ks, vs, os, causal, window,
                                               scale);
  } else if (D <= 72) {
    attn_kernel<18><<<grid, THREADS, 0, s>>>(qp, kp, vp, op, lse, Hq, Hkv, Sq, Skv,
                                                D, qs, ks, vs, os, causal,
                                                window, scale);
  } else {
    attn_kernel<32><<<grid, THREADS, 0, s>>>(qp, kp, vp, op, lse, Hq, Hkv, Sq, Skv,
                                                D, qs, ks, vs, os, causal,
                                                window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// strides: 12 values, (b, h, s) strides of q, k, v, o in elements. lse_out:
// nullptr, or the fp32 (B, Hq, Sq) log-sum-exp of each query's scaled
// scores, written beside o for the backward (nothing else changes). o32_out
// (bf16 only): nullptr, or a contiguous fp32 (B, Hq, Sq, D) copy of the
// output before its rounding to bf16, which the backward's Delta reads. fp32
// runs on CUDA cores. bf16 runs the mma body compiled for nd 8-column
// chunks (4, 8, 9 or 16; nd * 8 >= D); vec_in: q/k/v rows load as 16-byte
// chunks, vec_out: o rows store so (both need D % 8 == 0 and 16-byte
// aligned rows, which is checked here too).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* lse_out, void* o32_out, int B, int Hq, int Hkv,
                               int Sq, int Skv,
                               int D, const long long* strides, int causal,
                               int window, float scale, int dtype, int nd,
                               int vec_in, int vec_out, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 1 || D < 1 ||
      D > MAX_D || (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (dtype == DTYPE_F32)
    return launch_cuda_cores(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, strides,
                             causal, window, scale, s);
  if (dtype != DTYPE_BF16 || nd * 8 < D) return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = strides;
  auto rows16 = [&](const void* p, int first) {
    bool ok = D % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    for (int i = first; i < first + 3; ++i) ok = ok && st[i] % 8 == 0;
    return ok;
  };
  if (vec_in && !(rows16(q, 0) && rows16(k, 3) && rows16(v, 6)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec_out && !rows16(o, 9)) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
#define FA_MMA(ND)                                                                \
  launch_mma<ND>(qp, kp, vp, op, lse, static_cast<float*>(o32_out), B, Hq, Hkv, Sq, Skv, D, \
                 st, causal, window, scale,                                              \
                 vec_in, vec_out, s)
  switch (nd) {
    case 4: return FA_MMA(4);
    case 8: return FA_MMA(8);
    case 9: return FA_MMA(9);
    case 16: return FA_MMA(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_MMA
}

// Multi-head latent attention's forward (bf16 only): q, k (B, H, S, Dk) and
// v, o (B, H, S, Dv) with Dk = 8 nd_k and Dv = 8 nd_v as compiled (the one
// instantiation: Dk 192, Dv 128); the rest as `flash_attention`, whose
// strides, flags and outputs it takes (o32 is (B, Hq, Sq, Dv)).
extern "C" int flash_attention_mla(const void* q, const void* k, const void* v, void* o,
                                   void* lse_out, void* o32_out, int B, int Hq, int Hkv,
                                   int Sq, int Skv, int Dk, int Dv,
                                   const long long* strides, int causal, int window,
                                   float scale, int nd_k, int nd_v, int vec_in,
                                   int vec_out, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 1 || nd_k != 24 ||
      nd_v != 16 || Dk != 8 * nd_k || Dv != 8 * nd_v)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = strides;
  auto rows16 = [&](const void* p, int first) {
    bool ok = reinterpret_cast<uintptr_t>(p) % 16 == 0;
    for (int i = first; i < first + 3; ++i) ok = ok && st[i] % 8 == 0;
    return ok;
  };
  if (vec_in && !(rows16(q, 0) && rows16(k, 3) && rows16(v, 6)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec_out && !rows16(o, 9)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_mla<24, 16>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), static_cast<bf16*>(o),
                            static_cast<float*>(lse_out), static_cast<float*>(o32_out), B,
                            Hq, Hkv, Sq, Skv, Dk, Dv, st, causal, window, scale, vec_in,
                            vec_out, static_cast<cudaStream_t>(stream));
}

// ---- backward: causal, sliding window, GQA (the training path) --------------
//
// The reference defines no backward of its own: jax.value_and_grad
// differentiates the TPU kernel's forward through XLA. Here the forward is a
// hand-written kernel, so its gradient is one too: FlashAttention-2's
// backward in two passes, neither with atomics, so a step repeats bit for bit.
// * dq pass — a block per (b, q head, 64-query tile). Delta = rowsum(do * o)
//   of its rows (fp32, written per q head for the second pass; o is the
//   forward's output before its rounding to bf16, o32: from the rounded
//   output, Delta carries its 2^-8 error into every dS = P (dP - Delta), and
//   where dS nearly cancels, a cross-attention over 1500 frames, dq and dk
//   came out 4x farther from the fp32 gradients than plain's), then over the
//   key tiles of kv head h / (Hq / Hkv) that its queries can see (the
//   forward's tile skipping): P = exp(scale q k^T - lse) from the forward's
//   saved log-sum-exp, 0 where masked, dP = do v^T, dS = P (dP - Delta),
//   dq += dS k; dq * scale at the end.
// * dk/dv pass — a block per (b, kv head, 64-key tile), launched after the dq
//   pass on the same stream. Over the q heads of the kv head's group in
//   order, and for each over the query tiles that can see this key tile
//   (causal skips those before it, the window those past its last key +
//   window), the same P^T and dS^T with the queries as columns: dv += P^T do,
//   dk += dS^T q. The group's sums stay in registers and are stored once.
// Masks are the forward's: key <= query (causal), key > query - window. A
// query whose every key is masked (a window with Sq > Skv + window - 1) took
// the mean of V in the forward (the reference's softmax of equal scores): its
// dq and its share of dk are 0, and dv of every key gains its do / Skv, added
// after the loop from the column sums of those rows' do.
// Bound on the H100 at qwen2-0.5b's training shape (batch 8, 14 q / 2 kv
// heads, S = 512, head dim 64, causal, bf16): the five products (S, dP, dq,
// dk, dv) over a head's 131328 unmasked pairs are 9.41 GFLOP, 9.5 us at 989
// TFLOP/s, against q, o, do read and dq written (4 x 7.34 MB), k, v read and
// dk, dv written (4 x 1.05 MB) and the statistics, about 34 MB, 10.1 us at
// 3.35 TB/s: the bytes bound it, barely. This design computes S and dP in
// both passes (7 products), and the dq pass reads a kv head's K/V tiles once
// for each q head of its group.
// bf16 runs on mma.sync m16n8k16 as the forward does: each warp owns 16 rows
// of its block's tile; S/dP accumulate in registers and P, dS become the
// split (hi + lo) bf16 A fragments of the next products without leaving
// them, so dq, dk and dv cost two products each (10 in all); the streamed tiles
// arrive by cp.async into a ring of two stages. The operands that the wgmma
// body further down takes (16-byte rows, D from 64 to 128, every path's)
// run there instead; this body serves the rest. fp32 runs on CUDA cores
// with the forward's layout (4 threads a row).

constexpr int BW_WARPS = 4;
constexpr int BW_THREADS = BW_WARPS * 32;
constexpr int BW_ROWS = 16 * BW_WARPS;  // rows of a block's own tile
constexpr int BW_TILE = 64;             // rows of a streamed tile

template <int ND>
struct BwTile {
  static constexpr int PITCH = (ND | 1) * 16;
  static constexpr int TILE = BW_TILE * PITCH;  // bytes of one 64-row tile
  // two own tiles, two stages of two streamed tiles, two stages of 2 x 64
  // fp32 row statistics
  static constexpr int SMEM = 6 * TILE + 2 * 2 * BW_TILE * 4;
};

// The A fragments (16 rows x ND chunks, bf16) of the rows at `row_u`
// (this lane's row: the warp's first row + (lane & 15)).
template <int ND>
__device__ __forceinline__ void load_a(unsigned row_u, uint32_t (&f)[ND / 2 > 0 ? ND / 2 : 1][4],
                                       uint32_t (&f8)[2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < ND / 2; ++kk)
    ldsm_x4(row_u + (2 * kk + (lane >> 4)) * 16, f[kk][0], f[kk][1], f[kk][2], f[kk][3]);
  if (ND & 1) ldsm_x2(row_u + (ND - 1) * 16, f8[0], f8[1]);
}

// acc (16 x 64, fp32) = A (16 x D) B^T, B the 64-row tile at b_u
// (contraction over the head dim, as the forward's Q K^T).
template <int ND>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const uint32_t (&f)[ND / 2 > 0 ? ND / 2 : 1][4],
                                        const uint32_t (&f8)[2], unsigned b_u) {
  constexpr int PITCH = BwTile<ND>::PITCH;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const unsigned row = b_u + (n * 8 + (lane & 7)) * PITCH;
    int kk = 0;
#pragma unroll
    for (; kk + 1 < ND / 2; kk += 2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(row + (2 * kk + (lane >> 3)) * 16, b0, b1, b2, b3);
      mma_k16(acc[n], f[kk], b0, b1);
      mma_k16(acc[n], f[kk + 1], b2, b3);
    }
#pragma unroll
    for (; kk < ND / 2; ++kk) {
      uint32_t b0, b1;
      ldsm_x2(row + (2 * kk + ((lane >> 3) & 1)) * 16, b0, b1);
      mma_k16(acc[n], f[kk], b0, b1);
    }
    if (ND & 1) {
      uint32_t b0;
      ldsm_x1(row + (ND - 1) * 16, b0);
      mma_k8(acc[n], f8[0], f8[1], b0);
    }
  }
}

// acc (16 x D, fp32) += P (16 x 64, fp32 in the accumulator layout) B, B
// the 64-row tile at b_u (contraction over its rows, as the forward's P V).
// P (here P, P^T or dS, dS^T) is split into bf16 halves, hi = bf16(P) and
// lo = bf16(P - hi), two products into the same accumulators: 16 bits of
// it, so the gradients are the fp32 products of the bf16 inputs before
// their one rounding (with one bf16 dS, a gradient that nearly cancels in
// its sum over keys, rope's key bias, strayed past plain's).
template <int ND>
__device__ __forceinline__ void mma_pb(float (&acc)[ND][4], const float (&p)[8][4],
                                       unsigned b_u) {
  constexpr int PITCH = BwTile<ND>::PITCH;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < BW_TILE / 16; ++kk) {
    uint32_t pf[4], pl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* pr = p[2 * kk + (j >> 1)] + 2 * (j & 1);
      pf[j] = pack_bf16(pr[0], pr[1]);
      pl[j] = pack_bf16_residual(pr[0], pr[1], pf[j]);
    }
    const unsigned row = b_u + (kk * 16 + (lane & 15)) * PITCH;
#pragma unroll
    for (int n = 0; n + 1 < ND; n += 2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(row + (n + (lane >> 4)) * 16, b0, b1, b2, b3);
      mma_k16(acc[n], pf, b0, b1);
      mma_k16(acc[n], pl, b0, b1);
      mma_k16(acc[n + 1], pf, b2, b3);
      mma_k16(acc[n + 1], pl, b2, b3);
    }
    if (ND & 1) {
      uint32_t b0, b1;
      ldsm_x2_t(row + (ND - 1) * 16, b0, b1);
      mma_k16(acc[ND - 1], pf, b0, b1);
      mma_k16(acc[ND - 1], pl, b0, b1);
    }
  }
}

// Store a warp's 16 x D fp32 accumulator times `mul` as bf16 rows r0.. of
// a head (row stride ld), skipping rows >= limit and columns >= D.
template <int ND>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, long long ld, int r0,
                                           int limit, int D, const float (&acc)[ND][4],
                                           float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= limit) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = n * 8 + 2 * t4 + c;
        if (d < D) dst[(long long)row * ld + d] = __float2bfloat16_rn(acc[n][2 * r + c] * mul);
      }
  }
}

struct BwStrides {
  Strides q, k, v, o, dout, dq, dk, dv;
};

// The mask of the forward for (key, query), given that the key is < Skv and
// the query < Sq. The backward kernels take MASK = causal || window as a
// template flag: without a mask they compile to the non-causal bodies as
// they were before masks were added (the same registers and occupancy),
// with the group loop kept.
__device__ __forceinline__ bool visible(int key, int qi, int causal, int window) {
  bool ok = true;
  if (causal) ok = ok && key <= qi;
  if (window > 0) ok = ok && key > qi - window;
  return ok;
}

// The first query whose every key is masked: Skv + window - 1 under a
// window, none (Sq) otherwise; causal alone always leaves key 0.
__device__ __forceinline__ int first_dead_query(int Sq, int Skv, int window) {
  return window > 0 ? min(Sq, Skv + window - 1) : Sq;
}

template <int ND, bool MASK>
__global__ void __launch_bounds__(BW_THREADS)
attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ o,
                   const bf16* __restrict__ dout, const float* __restrict__ lse,
                   float* __restrict__ delta, bf16* __restrict__ dq, int Hq, int Hkv, int Sq,
                   int Skv, int D, BwStrides st, float scale, int causal, int window,
                   int vec_in) {
  using T = BwTile<ND>;
  constexpr int PITCH = T::PITCH;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned q_u = smem_u32(smem), do_u = q_u + T::TILE;
  unsigned char* kv_s = smem + 2 * T::TILE;  // stage s: K at 2s, V at 2s + 1
  const unsigned kv_u = smem_u32(kv_s);

  const int nq = (Sq + BW_ROWS - 1) / BW_ROWS;
  const int bh = blockIdx.x / nq, q0 = (blockIdx.x - bh * nq) * BW_ROWS;
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qb = q + b * st.q.b + h * st.q.h;
  const bf16* kb = k + b * st.k.b + hk * st.k.h;
  const bf16* vb = v + b * st.v.b + hk * st.v.h;
  const float* ob = o + b * st.o.b + h * st.o.h;
  const bf16* db = dout + b * st.dout.b + h * st.dout.h;

  // the key tiles any query of the block sees: from the first query's
  // window start to the last query's causal end (a query whose every key
  // is masked adds nothing to dq, so no tile is visited for it)
  const int q_last = min(q0 + BW_ROWS, Sq) - 1;
  int kt_lo = 0, kt_hi = (Skv + BW_TILE - 1) / BW_TILE;
  if (MASK && causal) kt_hi = min(q_last, Skv - 1) / BW_TILE + 1;
  if (MASK && window > 0) kt_lo = max(0, q0 - window + 1) / BW_TILE;
  const int n_tiles = max(0, kt_hi - kt_lo);

  auto issue = [&](int i) {  // key tile kt_lo + i into stage i & 1
    if (i < n_tiles) {
      unsigned char* buf = kv_s + (i & 1) * 2 * T::TILE;
      const int key0 = (kt_lo + i) * BW_TILE;
      fill_rows<ND, BW_THREADS>(buf, kb, st.k.s, key0, Skv, BW_TILE, D, vec_in);
      fill_rows<ND, BW_THREADS>(buf + T::TILE, vb, st.v.s, key0, Skv, BW_TILE, D, vec_in);
    }
    cp_async_commit();
  };
  fill_rows<ND, BW_THREADS>(smem, qb, st.q.s, q0, Sq, BW_ROWS, D, vec_in);
  fill_rows<ND, BW_THREADS>(smem + T::TILE, db, st.dout.s, q0, Sq, BW_ROWS, D, vec_in);
  issue(0);

  // this thread's rows g and g + 8 of the warp's 16: Delta (a quad's four
  // lanes split the head dim) and the log-sum-exp in base 2
  float dlt[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    float acc = 0.f;
    if (qi < Sq)
      for (int d = t4; d < D; d += 4)
        acc += to_f32(ob[(long long)qi * st.o.s + d]) * to_f32(db[(long long)qi * st.dout.s + d]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dlt[r] = acc;
    lse2[r] = qi < Sq ? lse[(long long)bh * Sq + qi] * LOG2E : 0.f;
    if (qi < Sq && t4 == 0) delta[(long long)bh * Sq + qi] = acc;
  }

  const float scale_log2 = scale * LOG2E;
  const unsigned arow = (warp * 16 + (lane & 15)) * PITCH;
  float dqacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dqacc[n][0] = dqacc[n][1] = dqacc[n][2] = dqacc[n][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();  // tile i (and Q, dO) landed
    __syncthreads();     // ... for every thread; tile i - 1 consumed
    issue(i + 1);        // into the stage tile i - 1 left
    const unsigned k_u = kv_u + (i & 1) * 2 * T::TILE, v_u = k_u + T::TILE;
    float sc[8][4], dp[8][4];
    {
      uint32_t f[ND / 2 > 0 ? ND / 2 : 1][4], f8[2];
      load_a<ND>(q_u + arow, f, f8);
      mma_abt<ND>(sc, f, f8, k_u);
      load_a<ND>(do_u + arow, f, f8);
      mma_abt<ND>(dp, f, f8, v_u);
    }
    const int key0 = (kt_lo + i) * BW_TILE;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + n * 8 + 2 * t4 + (e & 1);
        const int qi = q0 + warp * 16 + g + 8 * (e >> 1);
        const bool ok = key < Skv && (!MASK || visible(key, qi, causal, window));
        const float pv = ok ? exp2f(sc[n][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        sc[n][e] = pv * (dp[n][e] - dlt[e >> 1]);  // dS
      }
    mma_pb<ND>(dqacc, sc, k_u);
  }
  cp_async_wait<0>();
  store_rows<ND>(dq + b * st.dq.b + h * st.dq.h, st.dq.s, q0 + warp * 16, Sq, D, dqacc,
                 scale);
}

template <int ND, bool MASK>
__global__ void __launch_bounds__(BW_THREADS)
attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq, int Hkv, int Sq,
                     int Skv, int D, BwStrides st, float scale, int causal, int window,
                     int vec_in) {
  using T = BwTile<ND>;
  constexpr int PITCH = T::PITCH;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned k_u = smem_u32(smem), v_u = k_u + T::TILE;
  unsigned char* qd_s = smem + 2 * T::TILE;  // stage s: Q at 2s, dO at 2s + 1
  const unsigned qd_u = smem_u32(qd_s);
  float* stats = reinterpret_cast<float*>(smem + 6 * T::TILE);  // [stage][lse2 | delta]

  const int nk = (Skv + BW_ROWS - 1) / BW_ROWS;
  const int bh = blockIdx.x / nk, k0 = (blockIdx.x - bh * nk) * BW_ROWS;
  const int b = bh / Hkv, hk = bh - b * Hkv;
  const int group = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* kb = k + b * st.k.b + hk * st.k.h;
  const bf16* vb = v + b * st.v.b + hk * st.v.h;

  // the query tiles that see any key of the block: causal from the tile of
  // its first key, the window up to its last key + window - 1
  const int k_last = min(k0 + BW_ROWS, Skv) - 1;
  int qt_lo = 0, qt_hi = (Sq + BW_TILE - 1) / BW_TILE;
  if (MASK && causal) qt_lo = min(k0 / BW_TILE, qt_hi);
  if (MASK && window > 0) qt_hi = min(qt_hi, min(Sq - 1, k_last + window - 1) / BW_TILE + 1);
  const int n_qt = max(0, qt_hi - qt_lo);
  const int n_tiles = group * n_qt;  // the group's q heads in order, each over its tiles

  auto issue = [&](int i) {  // (q head hk * group + i / n_qt, query tile) into stage i & 1
    if (i < n_tiles) {
      const int h = hk * group + i / n_qt;
      const int qbase = (qt_lo + i % n_qt) * BW_TILE;
      unsigned char* buf = qd_s + (i & 1) * 2 * T::TILE;
      fill_rows<ND, BW_THREADS>(buf, q + b * st.q.b + h * st.q.h, st.q.s, qbase, Sq, BW_TILE,
                                D, vec_in);
      fill_rows<ND, BW_THREADS>(buf + T::TILE, dout + b * st.dout.b + h * st.dout.h,
                                st.dout.s, qbase, Sq, BW_TILE, D, vec_in);
      const long long row0 = ((long long)b * Hq + h) * Sq;
      float* sst = stats + (i & 1) * 2 * BW_TILE;
      for (int e = threadIdx.x; e < BW_TILE; e += BW_THREADS) {
        const int qi = qbase + e;
        sst[e] = qi < Sq ? lse[row0 + qi] * LOG2E : 0.f;
        sst[BW_TILE + e] = qi < Sq ? delta[row0 + qi] : 0.f;
      }
    }
    cp_async_commit();
  };
  fill_rows<ND, BW_THREADS>(smem, kb, st.k.s, k0, Skv, BW_ROWS, D, vec_in);
  fill_rows<ND, BW_THREADS>(smem + T::TILE, vb, st.v.s, k0, Skv, BW_ROWS, D, vec_in);
  issue(0);

  const float scale_log2 = scale * LOG2E;
  const unsigned arow = (warp * 16 + (lane & 15)) * PITCH;
  float dkacc[ND][4], dvacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[n][e] = dvacc[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    issue(i + 1);
    const unsigned q_u = qd_u + (i & 1) * 2 * T::TILE, do_u = q_u + T::TILE;
    const float* sst = stats + (i & 1) * 2 * BW_TILE;
    float pt[8][4], dst[8][4];
    {
      uint32_t f[ND / 2 > 0 ? ND / 2 : 1][4], f8[2];
      load_a<ND>(k_u + arow, f, f8);
      mma_abt<ND>(pt, f, f8, q_u);  // S^T: keys x queries
      load_a<ND>(v_u + arow, f, f8);
      mma_abt<ND>(dst, f, f8, do_u);  // dP^T
    }
    const int qbase = (qt_lo + i % n_qt) * BW_TILE;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);
        const int key = k0 + warp * 16 + g + 8 * (e >> 1);
        const bool ok =
            qbase + col < Sq && (!MASK || visible(key, qbase + col, causal, window));
        const float pv = ok ? exp2f(pt[n][e] * scale_log2 - sst[col]) : 0.f;
        pt[n][e] = pv;
        dst[n][e] = pv * (dst[n][e] - sst[BW_TILE + col]);  // dS^T
      }
    mma_pb<ND>(dvacc, pt, do_u);
    mma_pb<ND>(dkacc, dst, q_u);
  }
  cp_async_wait<0>();
  const int dead0 = first_dead_query(Sq, Skv, window);
  if (MASK && dead0 < Sq) {  // the queries with every key masked: do / Skv into each dv
    __syncthreads();  // every warp is done with the last tile's statistics
    for (int d = threadIdx.x; d < D; d += BW_THREADS) {
      float acc = 0.f;
      for (int j = 0; j < group; ++j) {
        const bf16* dj = dout + b * st.dout.b + (hk * group + j) * st.dout.h;
        for (int qi = dead0; qi < Sq; ++qi) acc += to_f32(dj[(long long)qi * st.dout.s + d]);
      }
      stats[d] = acc / Skv;
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = n * 8 + 2 * t4 + (e & 1);
        if (d < D) dvacc[n][e] += stats[d];
      }
  }
  store_rows<ND>(dk + b * st.dk.b + hk * st.dk.h, st.dk.s, k0 + warp * 16, Skv, D, dkacc,
                 scale);
  store_rows<ND>(dv + b * st.dv.b + hk * st.dv.h, st.dv.s, k0 + warp * 16, Skv, D, dvacc,
                 1.f);
}

// ---- backward, wgmma body (sm_90a): the bf16 training path -----------------
//
// The same two passes, masks, statistics and hi + lo splits as the mma body
// above, redesigned for this card's tensor-core path:
// * Every product is a wgmma of one consumer warpgroup (64 rows of the
//   block's own tile). S = Q K^T and dP = dO V^T (S^T, dP^T in the dk/dv
//   pass) take both operands from shared memory, K-major, contracting D
//   padded to a multiple of 16 (D 72 -> 80: TMA zero-fills the columns
//   past D, so D 112 and 128 do no padding work); dQ += dS K, dV += P^T
//   dO and dK += dS^T Q take P^T, dS and dS^T as the register operand A
//   (the S accumulator fragments rounded to bf16 hi + lo halves, two
//   products each, as the mma body) and the streamed tile as B, MN-major.
// * Tiles arrive from a producer warp: TMA loads of whole tiles (4-D tensor
//   maps of the strided head-major views, boxes of 64 columns x rows with
//   the 128-byte swizzle, one or two a tile: wgmma's swizzled layout) into
//   a ring of two stages on mbarriers, so the next tile lands while the
//   consumers compute; a stage is released once its products are done.
//   (Boxes of 16-byte rows, the no-swizzle layout, held TMA to about 10
//   bytes a cycle an SM: both passes waited on their loads.)
// * Delta = rowsum(dO o32) is computed once, by the dq pass, with 16-byte
//   loads (two threads a row), and written beside each query's log-sum-exp
//   (base 2) as an (lse2, Delta) pair in the padded workspace that the
//   dk/dv pass bulk-copies with each query tile.
// * The GQA group is split across blocks: the dk/dv pass runs one block per
//   (q head of the group, b and kv head, 64-key tile), the group's blocks
//   one thread block cluster. Each block keeps its head's dK, dV in
//   registers; at the end they meet in shared memory and each block sums
//   its share of the 64 rows over the cluster's blocks in head order
//   (distributed shared memory), so the sum's order is fixed: no atomics,
//   a step repeats bit for bit. MHA (a group of one) stores directly.
// * Grid order puts the heaviest tiles first under a causal mask (the last
//   query tiles in the dq pass, the first key tiles in the dk/dv pass).
// What bounds it on the card (ablate_kernels.py): each pass's products and
// the softmax between them, one warpgroup's steps in turn (two or three
// blocks an SM overlap them only in part); the loads hide behind them.
// The fully masked queries' dv term is the mma body's: do / Skv of those
// rows of the group's heads, added to each key's dv before its rounding.
// Rows of q, k, v and dO must be 16-byte aligned with D % 8 == 0 and D >=
// 64, and o32 rows 16-byte aligned; the group at most WB_MAX_GROUP (the
// portable cluster size); plan_bwd() picks this body then, the mma body
// otherwise.

constexpr int WB_ROWS = 64;                      // a block's own rows: one consumer warpgroup
constexpr int WB_BK = 64;                        // keys a streamed tile (dq pass)
constexpr int WB_STAGES = 2;                     // ring depth of both passes
constexpr int WB_CONSUMERS = 128;
constexpr int WB_THREADS = WB_CONSUMERS + 32;    // and the producer warp
constexpr int WB_MAX_GROUP = 8;

// ND: the head dim as compiled, in 8-column chunks (8, 9, 14, 16). A tile
// of R rows is [atom][row][128 bytes]: each row's 64-column atoms, the
// 128-byte swizzle within every 8 rows, the columns past D zero-filled.
template <int ND>
struct WbShape {
  static constexpr int KS = (ND + 1) / 2;        // k16 steps over D (padded to 16)
  static constexpr int DN = 8 * ND;              // N of the dq, dk and dv products
  static constexpr int ATOMS = DN > 64 ? 2 : 1;
  static constexpr int BQ = 32;                  // queries a streamed tile (dk/dv pass)
  static constexpr int TILE64 = ATOMS * 64 * 128;  // bytes of a 64-row tile
  static constexpr int TILEQ = ATOMS * BQ * 128;
  // dq pass: Q, dO, the ring of (K, V), each row's (lse2, Delta), barriers
  static constexpr int DQ_RING = 2 * TILE64;
  static constexpr int DQ_STAT = DQ_RING + WB_STAGES * 2 * TILE64;
  static constexpr int DQ_BAR = DQ_STAT + WB_ROWS * 8;
  static constexpr int DQ_ALLOC = DQ_BAR + (2 * WB_STAGES + 1) * 8 + 1024;
  // dk/dv pass: K, V, the ring of (Q, dO), the ring's (lse2, Delta) rows;
  // after the loop the same bytes hold the block's fp32 dK and dV for the
  // group sum
  static constexpr int KV_RING = 2 * TILE64;
  static constexpr int KV_STATS = KV_RING + WB_STAGES * 2 * TILEQ;
  static constexpr int KV_MAIN = KV_STATS + WB_STAGES * BQ * 8;
  static constexpr int SUM_PITCH = DN + 4;       // floats a row of the sum buffers
  static constexpr int KV_SUM = 2 * WB_ROWS * SUM_PITCH * 4;
  static constexpr int KV_DEAD = KV_MAIN > KV_SUM ? KV_MAIN : KV_SUM;
  static constexpr int KV_BAR = KV_DEAD + MAX_D * 4;
  static constexpr int KV_ALLOC = KV_BAR + (2 * WB_STAGES + 1) * 8 + 1024;
  static_assert(TILE64 % 1024 == 0 && TILEQ % 1024 == 0, "swizzled boxes land 1 KB aligned");
  static_assert(DQ_ALLOC <= 232448 && KV_ALLOC <= 232448, "a block fits an SM");
};

__device__ __forceinline__ void consumers_sync() {  // the consumer warpgroup
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// K-major operand (rows x 16 columns) of k16 step kk of a tile of `rows`
// rows: 32 bytes into the 128-byte rows of atom kk / 4
__device__ __forceinline__ uint64_t desc_k(unsigned tile, int rows, int kk) {
  return smem_desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024, 1);
}
// MN-major operand (rows 16kk .. 16kk + 15 x the atoms' columns)
__device__ __forceinline__ uint64_t desc_mn(unsigned tile, int rows, int kk) {
  return smem_desc(tile + kk * 2048, rows * 128, 1024, 1);
}

// acc (64 x DN) += A B, A the register fragment, B MN-major: k16 step kk of
// a tile of `rows` rows, one product over both 64-column atoms (the atom
// stride is the descriptor's leading byte offset; a product an atom ran no
// faster on the card)
template <int ND>
__device__ __forceinline__ void wgmma_dn(float (&acc)[WbShape<ND>::DN / 2],
                                         const uint32_t (&a)[4], unsigned tile, int rows,
                                         int kk) {
  wgmma_rs_mn<WbShape<ND>::DN>(acc, a, desc_mn(tile, rows, kk), 1);
}
// rows r0 .. r0 + rows - 1 of head (h, b) into a tile: a box of 64 columns
// an atom, counted on bar
template <int ATOMS>
__device__ __forceinline__ void load_tile(unsigned dst, const CUtensorMap* map, unsigned bar,
                                          int r0, int h, int b, int rows) {
#pragma unroll
  for (int a = 0; a < ATOMS; ++a) tma_load_4d(dst + a * rows * 128, map, bar, 64 * a, r0, h, b);
}
// The bf16 hi + lo A fragments of k16 step kk from fp32 accumulators in the
// m64nN layout (column tiles 2kk and 2kk + 1)
__device__ __forceinline__ void split_a(const float* acc, int kk, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* pr = acc + 4 * (2 * kk + (j >> 1)) + 2 * (j & 1);
    hi[j] = pack_bf16(pr[0], pr[1]);
    lo[j] = pack_bf16_residual(pr[0], pr[1], hi[j]);
  }
}

__device__ __forceinline__ float dot_bf16x2(uint32_t d, float o0, float o1) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&d));
  return f.x * o0 + f.y * o1;
}

template <int ND, bool MASK>
__global__ void __launch_bounds__(WB_THREADS, ND <= 9 ? 2 : 1)
attn_bwd_dq_wg(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap do_map, const float* __restrict__ o,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ ws, bf16* __restrict__ dq, int Hq, int Hkv, int Sq,
               int Skv, int D, int sq_pad, BwStrides st, float scale, int causal,
               int window) {
  using W = WbShape<ND>;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw_u = smem_u32(smem_raw);
  const unsigned base = (raw_u + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_u);
  const unsigned q_u = base, do_u = base + W::TILE64, ring_u = base + W::DQ_RING;
  float2* stat = reinterpret_cast<float2*>(smem + W::DQ_STAT);
  const unsigned full = base + W::DQ_BAR, empty = full + 8 * WB_STAGES;
  const unsigned qbar = empty + 8 * WB_STAGES;

  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * WB_ROWS;
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q_last = min(q0 + WB_ROWS, Sq) - 1;
  int kt_lo = 0, kt_hi = (Skv + WB_BK - 1) / WB_BK;
  if (MASK && causal) kt_hi = min(q_last, Skv - 1) / WB_BK + 1;
  if (MASK && window > 0) kt_lo = max(0, q0 - window + 1) / WB_BK;
  const int n_tiles = max(0, kt_hi - kt_lo);

  if (threadIdx.x == 0) {
    for (int s = 0; s < WB_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WB_CONSUMERS) {  // the producer warp
    if (threadIdx.x != WB_CONSUMERS) return;
    mbar_expect_tx(qbar, 2 * W::TILE64);
    load_tile<W::ATOMS>(q_u, &q_map, qbar, q0, h, b, WB_ROWS);
    load_tile<W::ATOMS>(do_u, &do_map, qbar, q0, h, b, WB_ROWS);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % WB_STAGES;
      if (i >= WB_STAGES) mbar_wait(empty + 8 * s, (i / WB_STAGES - 1) & 1);
      const unsigned k_u = ring_u + s * 2 * W::TILE64;
      const int key0 = (kt_lo + i) * WB_BK;
      mbar_expect_tx(full + 8 * s, 2 * W::TILE64);
      load_tile<W::ATOMS>(k_u, &k_map, full + 8 * s, key0, hk, b, WB_ROWS);
      load_tile<W::ATOMS>(k_u + W::TILE64, &v_map, full + 8 * s, key0, hk, b, WB_ROWS);
    }
    return;
  }

  // Delta of the block's rows, once: two threads a row, 16-byte loads of
  // o32 (fp32) and dO (bf16); written with the row's lse2 to the workspace
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, qi = q0 + r;
    float acc = 0.f;
    if (qi < Sq) {
      const float* orow = o + b * st.o.b + h * st.o.h + (long long)qi * st.o.s;
      const bf16* drow = dout + b * st.dout.b + h * st.dout.h + (long long)qi * st.dout.s;
      for (int c = half; c < D / 8; c += 2) {
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + 8 * c);
        const float4 o0 = *reinterpret_cast<const float4*>(orow + 8 * c);
        const float4 o1 = *reinterpret_cast<const float4*>(orow + 8 * c + 4);
        acc += dot_bf16x2(dv.x, o0.x, o0.y) + dot_bf16x2(dv.y, o0.z, o0.w) +
               dot_bf16x2(dv.z, o1.x, o1.y) + dot_bf16x2(dv.w, o1.z, o1.w);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const float2 v = make_float2(qi < Sq ? lse[(long long)bh * Sq + qi] * LOG2E : 0.f, acc);
      stat[r] = v;
      reinterpret_cast<float2*>(ws)[(long long)bh * sq_pad + qi] = v;
    }
  }
  consumers_sync();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float2 v = stat[warp * 16 + g + 8 * r];
    lse2[r] = v.x;
    dlt[r] = v.y;
  }

  const float scale_log2 = scale * LOG2E;
  float dqa[W::DN / 2], sc[WB_BK / 2], dp[WB_BK / 2];
#pragma unroll
  for (int i = 0; i < W::DN / 2; ++i) dqa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < WB_BK / 2; ++i) sc[i] = dp[i] = 0.f;
  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % WB_STAGES;
    mbar_wait(full + 8 * s, (i / WB_STAGES) & 1);
    const unsigned k_u = ring_u + s * 2 * W::TILE64, v_u = k_u + W::TILE64;
    fence_acc(sc);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W::KS; ++kk)
      wgmma_ss<WB_BK>(sc, desc_k(q_u, 64, kk), desc_k(k_u, 64, kk), kk);
#pragma unroll
    for (int kk = 0; kk < W::KS; ++kk)
      wgmma_ss<WB_BK>(dp, desc_k(do_u, 64, kk), desc_k(v_u, 64, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);

    const int key0 = (kt_lo + i) * WB_BK;
    // unmasked, a tile inside the keys takes no bounds check (a second
    // loop for the masked bodies' whole tiles made the causal cases slower
    // on the card)
    const bool whole = !MASK && key0 + WB_BK <= Skv;
    if (whole) {
#pragma unroll
      for (int j = 0; j < WB_BK / 2; ++j)
        sc[j] = exp2f(sc[j] * scale_log2 - lse2[(j >> 1) & 1]) * (dp[j] - dlt[(j >> 1) & 1]);
    } else {
#pragma unroll
      for (int n = 0; n < WB_BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + n * 8 + 2 * t4 + (e & 1);
          const int qi = q0 + warp * 16 + g + 8 * (e >> 1);
          const bool ok = key < Skv && (!MASK || visible(key, qi, causal, window));
          const float pv = ok ? exp2f(sc[4 * n + e] * scale_log2 - lse2[e >> 1]) : 0.f;
          sc[4 * n + e] = pv * (dp[4 * n + e] - dlt[e >> 1]);  // dS
        }
    }
    uint32_t hi[WB_BK / 16][4], lo[WB_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < WB_BK / 16; ++kk) split_a(sc, kk, hi[kk], lo[kk]);
    fence_acc(dqa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WB_BK / 16; ++kk) {
      wgmma_dn<ND>(dqa, hi[kk], k_u, 64, kk);
      wgmma_dn<ND>(dqa, lo[kk], k_u, 64, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dqa);
    if (threadIdx.x == 0) mbar_arrive(empty + 8 * s);
  }

  bf16* dqh = dq + b * st.dq.b + h * st.dq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= Sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + 2 * t4;
      const float* v = dqa + 4 * n + 2 * r;
      if (c < D)
        *reinterpret_cast<uint32_t*>(dqh + (long long)qi * st.dq.s + c) =
            pack_bf16(v[0] * scale, v[1] * scale);
    }
  }
}

template <int ND, bool MASK>
__global__ void __launch_bounds__(WB_THREADS, ND <= 9 ? 2 : 1)
attn_bwd_dkdv_wg(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap do_map, const bf16* __restrict__ dout,
                 const float* __restrict__ ws, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int Hq, int Hkv, int Sq, int Skv, int D, int sq_pad, BwStrides st,
                 float scale, int causal, int window) {
  using W = WbShape<ND>;
  constexpr int BQ = W::BQ;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw_u = smem_u32(smem_raw);
  const unsigned base = (raw_u + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_u);
  const unsigned k_u = base, v_u = base + W::TILE64, ring_u = base + W::KV_RING;
  const unsigned full = base + W::KV_BAR, empty = full + 8 * WB_STAGES;
  const unsigned kvbar = empty + 8 * WB_STAGES;
  float* dead_s = reinterpret_cast<float*>(smem + W::KV_DEAD);

  const int group = gridDim.x, j = blockIdx.x;  // j: the block's rank in its cluster
  const int b = blockIdx.y / Hkv, hk = blockIdx.y - b * Hkv, h = hk * group + j;
  const int k0 = blockIdx.z * WB_ROWS;
  const int k_last = min(k0 + WB_ROWS, Skv) - 1;
  int qt_lo = 0, qt_hi = (Sq + BQ - 1) / BQ;
  if (MASK && causal) qt_lo = min(k0 / BQ, qt_hi);
  if (MASK && window > 0) qt_hi = min(qt_hi, min(Sq - 1, k_last + window - 1) / BQ + 1);
  const int n_tiles = max(0, qt_hi - qt_lo);

  if (threadIdx.x == 0) {
    for (int s = 0; s < WB_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float dka[W::DN / 2], dva[W::DN / 2];
#pragma unroll
  for (int i = 0; i < W::DN / 2; ++i) dka[i] = dva[i] = 0.f;

  if (threadIdx.x >= WB_CONSUMERS) {  // the producer warp (stays for the group sum)
    if (threadIdx.x == WB_CONSUMERS) {
      mbar_expect_tx(kvbar, 2 * W::TILE64);
      load_tile<W::ATOMS>(k_u, &k_map, kvbar, k0, hk, b, WB_ROWS);
      load_tile<W::ATOMS>(v_u, &v_map, kvbar, k0, hk, b, WB_ROWS);
      const float2* wsb = reinterpret_cast<const float2*>(ws) + (long long)(b * Hq + h) * sq_pad;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % WB_STAGES;
        if (i >= WB_STAGES) mbar_wait(empty + 8 * s, (i / WB_STAGES - 1) & 1);
        const unsigned st_u = ring_u + s * 2 * W::TILEQ;
        const int q0 = (qt_lo + i) * BQ;
        mbar_expect_tx(full + 8 * s, 2 * W::TILEQ + BQ * 8);
        load_tile<W::ATOMS>(st_u, &q_map, full + 8 * s, q0, h, b, BQ);
        load_tile<W::ATOMS>(st_u + W::TILEQ, &do_map, full + 8 * s, q0, h, b, BQ);
        bulk_load(base + W::KV_STATS + s * BQ * 8, wsb + q0, BQ * 8, full + 8 * s);
      }
    }
  } else {  // the consumer warpgroup: this head's dK, dV over the query tiles
    const float scale_log2 = scale * LOG2E;
    float pt[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) pt[i] = dpt[i] = 0.f;
    mbar_wait(kvbar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % WB_STAGES;
      mbar_wait(full + 8 * s, (i / WB_STAGES) & 1);
      const unsigned q_u = ring_u + s * 2 * W::TILEQ, do_u = q_u + W::TILEQ;
      const float2* sst = reinterpret_cast<const float2*>(smem + W::KV_STATS + s * BQ * 8);
      fence_acc(pt);
      fence_acc(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W::KS; ++kk)
        wgmma_ss<BQ>(pt, desc_k(k_u, 64, kk), desc_k(q_u, BQ, kk), kk);  // S^T
#pragma unroll
      for (int kk = 0; kk < W::KS; ++kk)
        wgmma_ss<BQ>(dpt, desc_k(v_u, 64, kk), desc_k(do_u, BQ, kk), kk);  // dP^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(pt);
      fence_acc(dpt);

      const int qb = (qt_lo + i) * BQ;
      // unmasked, a tile inside the queries takes no bounds check
      const bool whole = !MASK && qb + BQ <= Sq;
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t4 + (e & 1);
          const int key = k0 + warp * 16 + g + 8 * (e >> 1);
          const float2 ls = sst[col];
          const bool ok =
              whole || (qb + col < Sq && (!MASK || visible(key, qb + col, causal, window)));
          const float pv = ok ? exp2f(pt[4 * n + e] * scale_log2 - ls.x) : 0.f;
          pt[4 * n + e] = pv;
          dpt[4 * n + e] = pv * (dpt[4 * n + e] - ls.y);  // dS^T
        }
      uint32_t hi[BQ / 16][4], lo[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) split_a(pt, kk, hi[kk], lo[kk]);
      fence_acc(dva);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {  // dV += P^T dO
        wgmma_dn<ND>(dva, hi[kk], do_u, BQ, kk);
        wgmma_dn<ND>(dva, lo[kk], do_u, BQ, kk);
      }
      wgmma_commit();
      uint32_t shi[BQ / 16][4], slo[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) split_a(dpt, kk, shi[kk], slo[kk]);
      fence_acc(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {  // dK += dS^T Q
        wgmma_dn<ND>(dka, shi[kk], q_u, BQ, kk);
        wgmma_dn<ND>(dka, slo[kk], q_u, BQ, kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dka);
      fence_acc(dva);
      if (threadIdx.x == 0) mbar_arrive(empty + 8 * s);
    }
  }

  // the queries with every key masked: do / Skv of the group's heads into
  // each dv (the mma body's term)
  const int dead0 = first_dead_query(Sq, Skv, window);
  const bool dead = MASK && dead0 < Sq;
  if (dead) {
    for (int d = threadIdx.x; d < D; d += WB_THREADS) {
      float acc = 0.f;
      for (int jj = 0; jj < group; ++jj) {
        const bf16* dj = dout + b * st.dout.b + (hk * group + jj) * st.dout.h;
        for (int qi = dead0; qi < Sq; ++qi) acc += to_f32(dj[(long long)qi * st.dout.s + d]);
      }
      dead_s[d] = acc / Skv;
    }
    __syncthreads();
  }

  if (group == 1) {
    if (threadIdx.x >= WB_CONSUMERS) return;
    bf16* dkh = dk + b * st.dk.b + hk * st.dk.h;
    bf16* dvh = dv + b * st.dv.b + hk * st.dv.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + warp * 16 + g + 8 * r;
      if (key >= Skv) continue;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = n * 8 + 2 * t4;
        if (c >= D) continue;
        const float e0 = dead ? dead_s[c] : 0.f, e1 = dead ? dead_s[c + 1] : 0.f;
        const float* kv = dka + 4 * n + 2 * r;
        const float* vv = dva + 4 * n + 2 * r;
        *reinterpret_cast<uint32_t*>(dkh + (long long)key * st.dk.s + c) =
            pack_bf16(kv[0] * scale, kv[1] * scale);
        *reinterpret_cast<uint32_t*>(dvh + (long long)key * st.dv.s + c) =
            pack_bf16(vv[0] + e0, vv[1] + e1);
      }
    }
    return;
  }

  // the group's sum: each block's fp32 dK, dV into its own shared memory
  // (over the ring, whose products are done), then block j sums its share
  // of the 64 rows over the cluster's blocks in head order
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float* sum_k = reinterpret_cast<float*>(smem);
  float* sum_v = sum_k + WB_ROWS * W::SUM_PITCH;
  if (threadIdx.x < WB_CONSUMERS) {
    consumers_sync();  // every warp's products are done before the ring is overwritten
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = n * 8 + 2 * t4;
        const float* kv = dka + 4 * n + 2 * r;
        const float* vv = dva + 4 * n + 2 * r;
        *reinterpret_cast<float2*>(sum_k + row * W::SUM_PITCH + c) = make_float2(kv[0], kv[1]);
        *reinterpret_cast<float2*>(sum_v + row * W::SUM_PITCH + c) = make_float2(vv[0], vv[1]);
      }
    }
  }
  cluster.sync();
  const int share = (WB_ROWS + group - 1) / group;
  const int r_lo = j * share, r_hi = min(WB_ROWS, r_lo + share);
  bf16* dkh = dk + b * st.dk.b + hk * st.dk.h;
  bf16* dvh = dv + b * st.dv.b + hk * st.dv.h;
  for (int e = threadIdx.x; e < (r_hi - r_lo) * (W::DN / 4); e += WB_THREADS) {
    const int row = r_lo + e / (W::DN / 4), c = 4 * (e % (W::DN / 4));
    const int key = k0 + row;
    if (key >= Skv || c >= D) continue;
    float4 ak = make_float4(0.f, 0.f, 0.f, 0.f), av = ak;
    for (int rank = 0; rank < group; ++rank) {
      const float4 pk = *cluster.map_shared_rank(
          reinterpret_cast<float4*>(sum_k + row * W::SUM_PITCH + c), rank);
      const float4 pv = *cluster.map_shared_rank(
          reinterpret_cast<float4*>(sum_v + row * W::SUM_PITCH + c), rank);
      ak.x += pk.x; ak.y += pk.y; ak.z += pk.z; ak.w += pk.w;
      av.x += pv.x; av.y += pv.y; av.z += pv.z; av.w += pv.w;
    }
    if (dead) {
      av.x += dead_s[c]; av.y += dead_s[c + 1]; av.z += dead_s[c + 2]; av.w += dead_s[c + 3];
    }
    *reinterpret_cast<uint2*>(dkh + (long long)key * st.dk.s + c) =
        make_uint2(pack_bf16(ak.x * scale, ak.y * scale), pack_bf16(ak.z * scale, ak.w * scale));
    *reinterpret_cast<uint2*>(dvh + (long long)key * st.dv.s + c) =
        make_uint2(pack_bf16(av.x, av.y), pack_bf16(av.z, av.w));
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// fp32 on CUDA cores: the forward's layout, GROUP threads a row, each owning
// every GROUP-th column; the streamed tiles (BK rows) in static shared memory.
template <int DPT, bool MASK>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ o,
                const float* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ delta, float* __restrict__ dq, int Hq, int Hkv, int Sq,
                int Skv, int D, BwStrides st, float scale, int causal, int window) {
  __shared__ float k_tile[BK * MAX_D];
  __shared__ float v_tile[BK * MAX_D];
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int sub = threadIdx.x % GROUP;
  const int qi = blockIdx.y * BQ + threadIdx.x / GROUP;
  const bool q_ok = qi < Sq;
  const long long row = q_ok ? qi : 0;
  const float* qp = q + b * st.q.b + h * st.q.h + row * st.q.s;
  const float* op = o + b * st.o.b + h * st.o.h + row * st.o.s;
  const float* dp_ = dout + b * st.dout.b + h * st.dout.h + row * st.dout.s;
  float qv[DPT], dov[DPT], acc[DPT];
  float dl = 0.f;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = sub + GROUP * j;
    const bool ok = q_ok && d < D;
    qv[j] = ok ? qp[d] : 0.f;
    dov[j] = ok ? dp_[d] : 0.f;
    dl += ok ? dov[j] * op[d] : 0.f;
    acc[j] = 0.f;
  }
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  dl += __shfl_xor_sync(0xffffffffu, dl, 2);
  if (q_ok && sub == 0) delta[(long long)bh * Sq + qi] = dl;
  const float ls = q_ok ? lse[(long long)bh * Sq + qi] : 0.f;
  const float* kb = k + b * st.k.b + hk * st.k.h;
  const float* vb = v + b * st.v.b + hk * st.v.h;

  // the keys any query of the block sees (as the bf16 pass's tiles)
  const int q0 = blockIdx.y * BQ, q_last = min(q0 + BQ, Sq) - 1;
  const int k_lo = MASK && window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = MASK && causal ? min(q_last + 1, Skv) : Skv;
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int r = e / D, d = e - r * D;
      const bool ok = k0 + r < k_hi;
      k_tile[e] = ok ? kb[(long long)(k0 + r) * st.k.s + d] : 0.f;
      v_tile[e] = ok ? vb[(long long)(k0 + r) * st.v.s + d] : 0.f;
    }
    __syncthreads();
    const int n = min(BK, k_hi - k0);
    for (int r = 0; r < n; ++r) {
      float ps = 0.f, pd = 0.f;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = sub + GROUP * j;
        if (d < D) {
          ps += qv[j] * k_tile[r * D + d];
          pd += dov[j] * v_tile[r * D + d];
        }
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      pd += __shfl_xor_sync(0xffffffffu, pd, 1);
      pd += __shfl_xor_sync(0xffffffffu, pd, 2);
      const float ds = !MASK || visible(k0 + r, qi, causal, window)
                           ? expf(ps * scale - ls) * (pd - dl)
                           : 0.f;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = sub + GROUP * j;
        if (d < D) acc[j] += ds * k_tile[r * D + d];
      }
    }
  }
  if (q_ok) {
    float* out = dq + b * st.dq.b + h * st.dq.h + (long long)qi * st.dq.s;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = sub + GROUP * j;
      if (d < D) out[d] = acc[j] * scale;
    }
  }
}

template <int DPT, bool MASK>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hkv, int Sq,
                  int Skv, int D, BwStrides st, float scale, int causal, int window) {
  __shared__ float q_tile[BK * MAX_D];
  __shared__ float d_tile[BK * MAX_D];
  __shared__ float ls_t[BK], dl_t[BK];
  const int bh = blockIdx.x;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int group = Hq / Hkv;
  const int sub = threadIdx.x % GROUP;
  const int ki = blockIdx.y * BQ + threadIdx.x / GROUP;
  const bool k_ok = ki < Skv;
  const long long row = k_ok ? ki : 0;
  const float* kp = k + b * st.k.b + hk * st.k.h + row * st.k.s;
  const float* vp = v + b * st.v.b + hk * st.v.h + row * st.v.s;
  float kv[DPT], vv[DPT], dka[DPT], dva[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = sub + GROUP * j;
    const bool ok = k_ok && d < D;
    kv[j] = ok ? kp[d] : 0.f;
    vv[j] = ok ? vp[d] : 0.f;
    dka[j] = dva[j] = 0.f;
  }
  // the queries that see any key of the block (as the bf16 pass's tiles)
  const int k0 = blockIdx.y * BQ, k_last = min(k0 + BQ, Skv) - 1;
  const int q_lo = MASK && causal ? min(k0, Sq) : 0;
  const int q_hi = MASK && window > 0 ? min(Sq, k_last + window) : Sq;

  for (int hg = 0; hg < group; ++hg) {  // the group's q heads in order
    const int h = hk * group + hg;
    const float* qb = q + b * st.q.b + h * st.q.h;
    const float* db = dout + b * st.dout.b + h * st.dout.h;
    const long long row0 = ((long long)b * Hq + h) * Sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += BK) {
      __syncthreads();
      for (int e = threadIdx.x; e < BK * D; e += THREADS) {
        const int r = e / D, d = e - r * D;
        const bool ok = q0 + r < q_hi;
        q_tile[e] = ok ? qb[(long long)(q0 + r) * st.q.s + d] : 0.f;
        d_tile[e] = ok ? db[(long long)(q0 + r) * st.dout.s + d] : 0.f;
      }
      for (int e = threadIdx.x; e < BK; e += THREADS) {
        const bool ok = q0 + e < q_hi;
        ls_t[e] = ok ? lse[row0 + q0 + e] : 0.f;
        dl_t[e] = ok ? delta[row0 + q0 + e] : 0.f;
      }
      __syncthreads();
      const int n = min(BK, q_hi - q0);
      for (int r = 0; r < n; ++r) {
        float ps = 0.f, pd = 0.f;
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const int d = sub + GROUP * j;
          if (d < D) {
            ps += kv[j] * q_tile[r * D + d];
            pd += vv[j] * d_tile[r * D + d];
          }
        }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        pd += __shfl_xor_sync(0xffffffffu, pd, 1);
        pd += __shfl_xor_sync(0xffffffffu, pd, 2);
        const float p =
            !MASK || visible(ki, q0 + r, causal, window) ? expf(ps * scale - ls_t[r]) : 0.f;
        const float ds = p * (pd - dl_t[r]);
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const int d = sub + GROUP * j;
          if (d < D) {
            dva[j] += p * d_tile[r * D + d];
            dka[j] += ds * q_tile[r * D + d];
          }
        }
      }
    }
  }
  if (!k_ok) return;
  const int dead0 = first_dead_query(Sq, Skv, window);
  if (MASK && dead0 < Sq) {  // the queries with every key masked: do / Skv into each dv
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = sub + GROUP * j;
      if (d >= D) continue;
      float acc = 0.f;
      for (int hg = 0; hg < group; ++hg) {
        const float* db = dout + b * st.dout.b + (hk * group + hg) * st.dout.h;
        for (int qi = dead0; qi < Sq; ++qi) acc += db[(long long)qi * st.dout.s + d];
      }
      dva[j] += acc / Skv;
    }
  }
  float* ko = dk + b * st.dk.b + hk * st.dk.h + (long long)ki * st.dk.s;
  float* vo = dv + b * st.dv.b + hk * st.dv.h + (long long)ki * st.dv.s;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = sub + GROUP * j;
    if (d < D) {
      ko[d] = dka[j] * scale;
      vo[d] = dva[j];
    }
  }
}

struct BwShape {
  int B, Hq, Hkv, Sq, Skv, D, causal, window;
};

template <int ND, bool MASK>
static int launch_bwd_mma(const bf16* q, const bf16* k, const bf16* v, const float* o,
                          const bf16* dout, const float* lse, float* delta, bf16* dq,
                          bf16* dk, bf16* dv, const BwShape& sh, const BwStrides& st,
                          float scale, int vec_in, cudaStream_t s) {
  static bool sized = false;  // once per instantiation
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_dq_kernel<ND, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        BwTile<ND>::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<ND, MASK>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 BwTile<ND>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const long long bq = (long long)sh.B * sh.Hq * ((sh.Sq + BW_ROWS - 1) / BW_ROWS);
  const long long bk = (long long)sh.B * sh.Hkv * ((sh.Skv + BW_ROWS - 1) / BW_ROWS);
  if (bq > 0x7fffffffLL || bk > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_dq_kernel<ND, MASK><<<static_cast<unsigned>(bq), BW_THREADS, BwTile<ND>::SMEM, s>>>(
      q, k, v, o, dout, lse, delta, dq, sh.Hq, sh.Hkv, sh.Sq, sh.Skv, sh.D, st, scale,
      sh.causal, sh.window, vec_in);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_kernel<ND, MASK><<<static_cast<unsigned>(bk), BW_THREADS, BwTile<ND>::SMEM,
                                 s>>>(
      q, k, v, dout, lse, delta, dk, dv, sh.Hq, sh.Hkv, sh.Sq, sh.Skv, sh.D, st, scale,
      sh.causal, sh.window, vec_in);
  return static_cast<int>(cudaGetLastError());
}

// The 4-D tensor map of a bf16 (B, H, S, D) operand with (b, h, s) strides
// `st` in elements and unit column stride, in boxes of 64 columns x `rows`
// rows with the 128-byte swizzle (the columns past D and the rows past S
// land as zeros)
static bool encode_heads(CUtensorMap* map, const void* ptr, int B, int H, int S, int D,
                         const Strides& st, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  auto bytes = [](long long stride, int n) {  // a dim of one element takes any stride
    return static_cast<cuuint64_t>(n > 1 ? stride * 2 : 16);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(st.s, S), bytes(st.h, H), bytes(st.b, B)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int ND, bool MASK>
static int launch_bwd_wg(const bf16* q, const bf16* k, const bf16* v, const float* o,
                         const bf16* dout, const float* lse, float* ws, bf16* dq, bf16* dk,
                         bf16* dv, const BwShape& sh, const BwStrides& st, float scale,
                         cudaStream_t s) {
  using W = WbShape<ND>;
  static bool sized = false;  // once per instantiation
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_dq_wg<ND, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize, W::DQ_ALLOC);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dkdv_wg<ND, MASK>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, W::KV_ALLOC);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  CUtensorMap qm, km, vm, dm, qt, dt;
  if (!encode_heads(&qm, q, sh.B, sh.Hq, sh.Sq, sh.D, st.q, WB_ROWS) ||
      !encode_heads(&dm, dout, sh.B, sh.Hq, sh.Sq, sh.D, st.dout, WB_ROWS) ||
      !encode_heads(&km, k, sh.B, sh.Hkv, sh.Skv, sh.D, st.k, WB_ROWS) ||
      !encode_heads(&vm, v, sh.B, sh.Hkv, sh.Skv, sh.D, st.v, WB_ROWS))
    return static_cast<int>(cudaErrorInvalidValue);
  qt = qm;
  dt = dm;
  if (W::BQ != WB_ROWS &&
      (!encode_heads(&qt, q, sh.B, sh.Hq, sh.Sq, sh.D, st.q, W::BQ) ||
       !encode_heads(&dt, dout, sh.B, sh.Hq, sh.Sq, sh.D, st.dout, W::BQ)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nq = (sh.Sq + WB_ROWS - 1) / WB_ROWS, nk = (sh.Skv + WB_ROWS - 1) / WB_ROWS;
  const int group = sh.Hq / sh.Hkv;
  attn_bwd_dq_wg<ND, MASK><<<dim3(sh.B * sh.Hq, nq), WB_THREADS, W::DQ_ALLOC, s>>>(
      qm, km, vm, dm, o, dout, lse, ws, dq, sh.Hq, sh.Hkv, sh.Sq, sh.Skv, sh.D, nq * WB_ROWS,
      st, scale, sh.causal, sh.window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a cluster of the group's q heads for each (b, kv head, key tile)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(group, sh.B * sh.Hkv, nk);
  cfg.blockDim = dim3(WB_THREADS);
  cfg.dynamicSmemBytes = W::KV_ALLOC;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = group;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = group > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, attn_bwd_dkdv_wg<ND, MASK>, qt, km, vm, dt, dout,
                           static_cast<const float*>(ws), dk, dv, sh.Hq, sh.Hkv, sh.Sq, sh.Skv,
                           sh.D, nq * WB_ROWS, st, scale, sh.causal, sh.window);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int DPT, bool MASK>
static int launch_bwd_f32(const float* q, const float* k, const float* v, const float* o,
                          const float* dout, const float* lse, float* delta, float* dq,
                          float* dk, float* dv, const BwShape& sh, const BwStrides& st,
                          float scale, cudaStream_t s) {
  attn_bwd_dq_f32<DPT, MASK><<<dim3(sh.B * sh.Hq, (sh.Sq + BQ - 1) / BQ), THREADS, 0, s>>>(
      q, k, v, o, dout, lse, delta, dq, sh.Hq, sh.Hkv, sh.Sq, sh.Skv, sh.D, st, scale,
      sh.causal, sh.window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_f32<DPT, MASK><<<dim3(sh.B * sh.Hkv, (sh.Skv + BQ - 1) / BQ), THREADS, 0,
                                  s>>>(
      q, k, v, dout, lse, delta, dk, dv, sh.Hq, sh.Hkv, sh.Sq, sh.Skv, sh.D, st, scale,
      sh.causal, sh.window);
  return static_cast<int>(cudaGetLastError());
}

// The backward of flash_attention(q, k, v, causal, window): q, o, dout, dq
// (B, Hq, Sq, D), o in fp32 for bf16 q too (the forward's o32_out); k, v,
// dk, dv (B, Hkv, Skv, D), Hq % Hkv == 0; window 0 for
// none. strides: 24 values, (b, h, s) strides of q, k, v, o, dout, dq, dk,
// dv in elements (unit column stride); lse: the forward's (B, Hq, Sq)
// log-sum-exp; delta: an fp32 workspace, (B, Hq, Sq) for the mma body and
// (B, Hq, ceil(Sq / 64) * 64, 2) for the wgmma body (each query's lse2 and
// Delta). fp32 runs on CUDA cores (body 0). bf16 runs body 0, the mma
// bodies compiled for nd 8-column chunks (4, 8, 9 or 16; nd * 8 >= D),
// vec_in loading q, k, v and dout rows as 16-byte chunks (D % 8 == 0 and
// 16-byte aligned rows, checked here too), or body 1, the wgmma bodies
// compiled for nd 8, 9, 14 or 16, which need vec_in, D >= 64, o rows
// 16-byte aligned and a group of at most WB_MAX_GROUP (refused otherwise).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, int B, int Hq,
                                   int Hkv, int Sq, int Skv, int D, const long long* strides,
                                   int causal, int window, float scale, int dtype, int nd,
                                   int vec_in, int body, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 1 || D < 1 || D > MAX_D ||
      window < 0 || (Sq + BQ - 1) / BQ > 65535 || (Skv + BQ - 1) / BQ > 65535 ||
      (long long)B * Hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* x = strides;
  const BwStrides st{{x[0], x[1], x[2]},    {x[3], x[4], x[5]},    {x[6], x[7], x[8]},
                     {x[9], x[10], x[11]},  {x[12], x[13], x[14]}, {x[15], x[16], x[17]},
                     {x[18], x[19], x[20]}, {x[21], x[22], x[23]}};
  const BwShape sh{B, Hq, Hkv, Sq, Skv, D, causal ? 1 : 0, window};
  const bool mask = causal || window > 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == DTYPE_F32) {
    if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
    const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k),
                *vp = static_cast<const float*>(v), *op = static_cast<const float*>(o),
                *dp = static_cast<const float*>(dout);
    float *gq = static_cast<float*>(dq), *gk = static_cast<float*>(dk),
          *gv = static_cast<float*>(dv);
#define FA_BWD_F32(DPT)                                                                  \
  (mask ? launch_bwd_f32<DPT, true>(qp, kp, vp, op, dp, ls, dl, gq, gk, gv, sh, st, scale, s) \
        : launch_bwd_f32<DPT, false>(qp, kp, vp, op, dp, ls, dl, gq, gk, gv, sh, st, scale, s))
    if (D <= 32) return FA_BWD_F32(8);
    if (D <= 72) return FA_BWD_F32(18);
    return FA_BWD_F32(32);
#undef FA_BWD_F32
  }
  if (dtype != DTYPE_BF16 || nd * 8 < D) return static_cast<int>(cudaErrorInvalidValue);
  if (vec_in) {
    const void* ptrs[] = {q, k, v, dout};
    const int firsts[] = {0, 3, 6, 12};
    for (int i = 0; i < 4; ++i) {
      bool ok = D % 8 == 0 && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
      for (int j = firsts[i]; j < firsts[i] + 3; ++j) ok = ok && x[j] % 8 == 0;
      if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *dp = static_cast<const bf16*>(dout);
  const float* op = static_cast<const float*>(o);  // the forward's o32
  bf16 *gq = static_cast<bf16*>(dq), *gk = static_cast<bf16*>(dk), *gv = static_cast<bf16*>(dv);
  if (body == 1) {
    bool ok = vec_in && D >= 64 && Hq / Hkv <= WB_MAX_GROUP && (long long)B * Hkv <= 65535 &&
              reinterpret_cast<uintptr_t>(o) % 16 == 0;
    for (int j = 9; j < 12; ++j) ok = ok && x[j] % 4 == 0;  // o32 rows: 16-byte loads
    // q, k, v, o, dout: the (b, h, s) extents, whose strides the tensor maps
    // take, positive wherever the extent exceeds one
    const int ext[5][3] = {{B, Hq, Sq}, {B, Hkv, Skv}, {B, Hkv, Skv}, {B, Hq, Sq}, {B, Hq, Sq}};
    for (int i = 0; i < 5; ++i)
      for (int j = 0; j < 3; ++j) ok = ok && (ext[i][j] == 1 || x[3 * i + j] > 0);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
#define FA_BWD_WG(ND)                                                                       \
  (mask ? launch_bwd_wg<ND, true>(qp, kp, vp, op, dp, ls, dl, gq, gk, gv, sh, st, scale, s) \
        : launch_bwd_wg<ND, false>(qp, kp, vp, op, dp, ls, dl, gq, gk, gv, sh, st, scale, s))
    switch (nd) {
      case 8: return FA_BWD_WG(8);
      case 9: return FA_BWD_WG(9);
      case 14: return FA_BWD_WG(14);
      case 16: return FA_BWD_WG(16);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FA_BWD_WG
  }
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
#define FA_BWD(ND)                                                                        \
  (mask ? launch_bwd_mma<ND, true>(qp, kp, vp, op, dp, ls, dl, gq, gk, gv, sh, st, scale,  \
                                   vec_in, s)                                            \
        : launch_bwd_mma<ND, false>(qp, kp, vp, op, dp, ls, dl, gq, gk, gv, sh, st, scale, \
                                    vec_in, s))
  switch (nd) {
    case 4: return FA_BWD(4);
    case 8: return FA_BWD(8);
    case 9: return FA_BWD(9);
    case 16: return FA_BWD(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_BWD
}

EXPORT_ERROR_STRING
