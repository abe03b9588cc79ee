// Fused UniPC update: the predictor and the corrector of one sampler row,
// and the TPU kernel's own weighted combine, as one body.
//
// Replaces the TPU kernel repro/kernels/unipc_update/kernel.py:
// fused_combine_batched (and fused_combine_flat, which wraps it), with the
// work that jit fused around it on the TPU: the differences, the weight
// columns, the blend and the ring rotation of repro/core/unipc.py's row.
//
// Bound on the H100: bytes, and below the bytes the launch. At the main
// path's state (B = 8 requests, N = 256 x 32 = 8192, fp32, an eval ring of
// K + 1 = 3 slots) the predictor moves 5 arrays of 262 KB and the corrector
// 10: 0.4 and 0.8 us of HBM time, less than one launch costs. So a row pays
// for its launches and host calls, not for its bytes, and the design makes
// each combine one pass over the state with no launch around it.
//
// Design. One body (unipc_row_kernel), three ways of getting operands:
// * COMBINE: weighted_combine's K terms, slices of one (K, B, N) tensor,
//   with explicit (K,) or per-slot (K, B) fp32 weights.
// * PREDICT: x_pred = sum over [x, m0, E[k] - m0] (m0 = E[0], k = 1..K)
//   with the row's weight column [base_x, base_m0, sign * out_scale *
//   w_pred[k - 1]].
// * CORRECT: x_corr over the same terms and d_new = e_new - m0, with
//   [base_x_c, base_m0_c, sign * out_scale * w_corr_prev[k - 1],
//   sign * out_scale * w_corr_new]; then x_next = x_pred + use_c * (x_corr
//   - x_pred) and the rotated ring E_next = [e_new, E[0..K-1]], written in
//   the same pass from the slots it has just read.
// Operands are read where they lie: each is a base pointer and a row
// stride in a by-value RowArgs, so no terms array is ever assembled. The
// row is an int64 index on the device (0-d for the whole batch, or (B,) per
// slot), clipped to the table here; a CUDA graph therefore replays whatever
// row its index tensor holds, and no row copies an index from the host.
// Each thread issues its first loads, then builds the <= 8 weights of its
// block's row in registers from the packed (n_rows, 7 + 2K) fp32 table
// (columns RowColumn, then w_pred and w_corr_prev; kernels/unipc_update/
// ref.py:ROW_FIXED), so the table's dependent loads overlap the data's. The
// rounding is the plain version's: differences rounded to the ring's type,
// each product and each sum rounded to fp32 (__fmul_rn / __fadd_rn, never a
// fused multiply-add), the blend's difference, product and sum each rounded
// to the state's type. fp32 results are therefore bit-equal to ref.py.
// Grid (blocks a row, B), one wave sized from the SM count by the wrapper's
// plan(); each thread takes one access a turn (grid-stride). Accesses are
// 2-16 bytes, the widest that every pointer and row stride allow (the plan
// picks it, this entry refuses what the operands cannot take), and single
// elements for the ragged end of a row.
#include "common.cuh"

constexpr int MAX_TERMS = 8;
constexpr int MAX_THREADS = 256;

enum Mode : int { COMBINE = 0, PREDICT = 1, CORRECT = 2 };

// the packed row table's columns (ref.ROW_FIXED), then w_pred's K columns
// from C_W, then w_corr_prev's K
enum RowColumn : int {
  C_BASE_X = 0, C_BASE_M0, C_BASE_X_C, C_BASE_M0_C, C_USE_C, C_OUT_SCALE, C_W_CORR_NEW, C_W
};

// kernels/unipc_update/kernel.py:RowArgs, field for field
struct RowArgs {
  const void* ring[MAX_TERMS];  // COMBINE: the K terms; else the K + 1 ring slots
  const void* x;                // the state (PREDICT, CORRECT)
  const void* e_new;            // the row's eval (CORRECT)
  const void* x_pred;           // the predictor's output (CORRECT)
  void* out;                    // (B, N) contiguous: the combine, x_pred or x_next
  void* ring_out;               // (K + 1, B, N) contiguous: E_next (CORRECT)
  const float* weights;         // (K,) or per-slot (K, B) (COMBINE)
  const float* rows;            // (n_rows, cols) fp32 row table
  const long long* idx;         // 0-d or per-slot (B,) row index
  long long N;                  // elements of a batch row
  long long rs_ring, rs_x, rs_e, rs_xp;  // row strides in elements
  int K, B, per_slot, n_rows, cols;
  float sign;
};

// The block's weights: w[k] for the k-th term read from memory (COMBINE:
// ring[k]; else x, m0, then the K differences), w[MAX_TERMS - 1] for d_new
// (CORRECT, where K + 2 < MAX_TERMS), and use_c.
template <int MODE>
__device__ __forceinline__ void build_weights(const RowArgs& a, int b, float (&w)[MAX_TERMS],
                                              float& use_c) {
  if constexpr (MODE == COMBINE) {
#pragma unroll
    for (int k = 0; k < MAX_TERMS; ++k)
      w[k] = k < a.K ? __ldg(a.weights + (a.per_slot ? (long long)k * a.B + b : k)) : 0.f;
  } else {
    long long r = __ldg(a.idx + (a.per_slot ? b : 0));
    r = r < 0 ? 0 : (r >= a.n_rows ? a.n_rows - 1 : r);
    const float* row = a.rows + r * a.cols;
    const float s = __fmul_rn(a.sign, __ldg(row + C_OUT_SCALE));
    const float* wcol = row + (MODE == PREDICT ? C_W : C_W + a.K);
    w[0] = __ldg(row + (MODE == PREDICT ? C_BASE_X : C_BASE_X_C));
    w[1] = __ldg(row + (MODE == PREDICT ? C_BASE_M0 : C_BASE_M0_C));
#pragma unroll
    for (int k = 0; k < MAX_TERMS - 2; ++k) w[2 + k] = k < a.K ? __fmul_rn(s, __ldg(wcol + k)) : 0.f;
    if constexpr (MODE == CORRECT) {
      w[MAX_TERMS - 1] = __fmul_rn(s, __ldg(row + C_W_CORR_NEW));
      use_c = __ldg(row + C_USE_C);
    }
  }
}

// One access of V elements at column i of batch row b.
template <typename T, int V, int MODE>
__device__ __forceinline__ void row_access(const RowArgs& a, int b, long long i,
                                           float (&w)[MAX_TERMS], float& use_c, bool& ready) {
  using C = Chunk<T, V>;
  const int K = a.K;
  const int n = MODE == COMBINE ? K : K + 2;  // terms read from ch[]
  C ch[MAX_TERMS], en, xp;
  if constexpr (MODE == COMBINE) {
#pragma unroll
    for (int k = 0; k < MAX_TERMS; ++k)
      if (k < n) ch[k].load(static_cast<const T*>(a.ring[k]) + b * a.rs_ring + i);
  } else {
    ch[0].load(static_cast<const T*>(a.x) + b * a.rs_x + i);
#pragma unroll
    for (int k = 0; k < MAX_TERMS - 1; ++k)
      if (k <= K) ch[1 + k].load(static_cast<const T*>(a.ring[k]) + b * a.rs_ring + i);
    if constexpr (MODE == CORRECT) {
      en.load(static_cast<const T*>(a.e_new) + b * a.rs_e + i);
      xp.load(static_cast<const T*>(a.x_pred) + b * a.rs_xp + i);
    }
  }
  if (!ready) {
    build_weights<MODE>(a, b, w, use_c);
    ready = true;
  }
  float f[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float m0 = MODE == COMBINE ? 0.f : ch[1].get(e);
    float acc = __fmul_rn(w[0], ch[0].get(e));
#pragma unroll
    for (int k = 1; k < MAX_TERMS; ++k) {
      if (k < n) {
        float t = ch[k].get(e);
        if (MODE != COMBINE && k >= 2) t = round_to<T>(__fsub_rn(t, m0));
        acc = __fadd_rn(acc, __fmul_rn(w[k], t));
      }
    }
    if constexpr (MODE == CORRECT) {
      const float d_new = round_to<T>(__fsub_rn(en.get(e), m0));
      const float x_corr = round_to<T>(__fadd_rn(acc, __fmul_rn(w[MAX_TERMS - 1], d_new)));
      const float x_pred = xp.get(e);
      acc = __fadd_rn(x_pred, round_to<T>(__fmul_rn(use_c, round_to<T>(__fsub_rn(x_corr, x_pred)))));
    }
    f[e] = acc;
  }
  const long long row = static_cast<long long>(b) * a.N + i;
  store_chunk<T, V>(static_cast<T*>(a.out) + row, f);
  if constexpr (MODE == CORRECT) {
    T* ring_out = static_cast<T*>(a.ring_out);
    const long long slot = static_cast<long long>(a.B) * a.N;
    en.store(ring_out + row);
#pragma unroll
    for (int k = 0; k < MAX_TERMS - 2; ++k)
      if (k < K) ch[1 + k].store(ring_out + (k + 1) * slot + row);
  }
}

// grid (blocks a row, B); each thread takes accesses c = its index, + the
// grid's width, ...: whole VEC accesses, then the row's N % VEC elements
template <typename T, int VEC, int MODE>
__global__ void __launch_bounds__(MAX_THREADS) unipc_row_kernel(const RowArgs a) {
  const int b = blockIdx.y;
  const long long nvec = a.N / VEC;
  const long long total = nvec + (a.N - nvec * VEC);
  float w[MAX_TERMS], use_c = 0.f;
  bool ready = false;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; c < total;
       c += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (c < nvec) {
      row_access<T, VEC, MODE>(a, b, c * VEC, w, use_c, ready);
    } else {
      row_access<T, 1, MODE>(a, b, nvec * VEC + (c - nvec), w, use_c, ready);
    }
  }
}

template <typename T, int MODE>
static cudaError_t launch_width(const RowArgs& a, int vec, dim3 grid, int threads, cudaStream_t s) {
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2) {
        unipc_row_kernel<T, 8, MODE><<<grid, threads, 0, s>>>(a);
        break;
      }
      return cudaErrorInvalidValue;
    case 4: unipc_row_kernel<T, 4, MODE><<<grid, threads, 0, s>>>(a); break;
    case 2: unipc_row_kernel<T, 2, MODE><<<grid, threads, 0, s>>>(a); break;
    case 1: unipc_row_kernel<T, 1, MODE><<<grid, threads, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_mode(const RowArgs& a, int mode, int vec, dim3 grid, int threads,
                               cudaStream_t s) {
  if (mode == COMBINE) return launch_width<T, COMBINE>(a, vec, grid, threads, s);
  if (mode == PREDICT) return launch_width<T, PREDICT>(a, vec, grid, threads, s);
  return launch_width<T, CORRECT>(a, vec, grid, threads, s);
}

// Launch one mode on the wrapper's plan (access bytes, blocks a row,
// threads a block). Refuses (cudaErrorInvalidValue) a mode, size, table or
// plan the operands cannot take: more than MAX_TERMS terms, a table whose
// width is not 7 + 2K, an access width that some pointer or row stride is
// not aligned to.
extern "C" int unipc_row(RowArgs a, int mode, int dtype, int access_bytes, int blocks_per_row,
                         int threads, void* stream) {
  const long long esize = dtype == DTYPE_F32 ? 4 : dtype == DTYPE_BF16 ? 2 : 0;
  const int terms = mode == COMBINE ? a.K : mode == PREDICT ? a.K + 2 : a.K + 3;
  bool ok = esize && mode >= COMBINE && mode <= CORRECT && a.K >= 1 && terms <= MAX_TERMS &&
            a.B >= 1 && a.B <= 65535 && a.N >= 1 && blocks_per_row >= 1 &&
            blocks_per_row <= (1 << 24) && threads >= 32 && threads <= MAX_THREADS &&
            threads % 32 == 0 && access_bytes >= esize && access_bytes <= 16 &&
            (access_bytes & (access_bytes - 1)) == 0 && a.out;
  uintptr_t bits = reinterpret_cast<uintptr_t>(a.out) | static_cast<uintptr_t>(a.N * esize) |
                   static_cast<uintptr_t>(a.rs_ring * esize);
  for (int k = 0; k < (mode == COMBINE ? a.K : a.K + 1) && k < MAX_TERMS; ++k) {
    ok = ok && a.ring[k];
    bits |= reinterpret_cast<uintptr_t>(a.ring[k]);
  }
  if (mode == COMBINE) {
    ok = ok && a.weights;
  } else {
    ok = ok && a.x && a.rows && a.idx && a.n_rows >= 1 && a.cols == C_W + 2 * a.K;
    bits |= reinterpret_cast<uintptr_t>(a.x) | static_cast<uintptr_t>(a.rs_x * esize);
  }
  if (mode == CORRECT) {
    ok = ok && a.e_new && a.x_pred && a.ring_out;
    bits |= reinterpret_cast<uintptr_t>(a.e_new) | reinterpret_cast<uintptr_t>(a.x_pred) |
            reinterpret_cast<uintptr_t>(a.ring_out) | static_cast<uintptr_t>(a.rs_e * esize) |
            static_cast<uintptr_t>(a.rs_xp * esize);
  }
  if (!ok || bits % static_cast<uintptr_t>(access_bytes)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks_per_row), static_cast<unsigned>(a.B));
  const int vec = access_bytes / static_cast<int>(esize);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == DTYPE_F32 ? launch_mode<float>(a, mode, vec, grid, threads, s)
                                             : launch_mode<__nv_bfloat16>(a, mode, vec, grid, threads, s);
  return static_cast<int>(err);
}

EXPORT_ERROR_STRING
