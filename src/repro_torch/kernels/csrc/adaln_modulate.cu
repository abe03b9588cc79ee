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
// * modulate — a group of LANES lanes (a warp, or 16 lanes for narrow
//   rows) owns a row. The row lives in the group's registers as raw
//   2-16 byte chunks, lane l holding chunks l, l + LANES, ..., so every
//   access of the group is one coalesced span. Mean, then the mean of the
//   centred squares, both fp32 __shfl_xor_sync butterflies over the true
//   D (two passes over registers, not E[x^2] - mu^2), exactly the
//   reference's jnp.mean / jnp.var: no shared memory, no block barrier.
//   A block is a few warps on rows of one b (grid y); each group loads the
//   shift/scale chunks of its columns once, before its first row's x, and
//   keeps them for every row it takes (grid-stride over t). Every x load
//   of a row is issued before its first reduction. The chunk count per
//   lane is compiled for the configs' widths (register bodies); any other
//   D <= MOD_MAX_D runs the generic body of the same kernel (NCHUNK = 0),
//   which walks the row three times from memory (the later passes hit
//   L1/L2). The access width is the widest that every pointer, the rows
//   and the conditioning stride allow; the wrapper's plan() chooses it and
//   the body, and this entry point refuses a plan the operands cannot take.
// * gate_residual — the same plan, groups and compiled bodies as
//   modulate: a group owns a row, resid and y cross in 2-16 byte chunks
//   (16 at the DiT's shapes), and the group's gate chunks are loaded once
//   and held in registers for every row it takes. No element index is
//   divided by D. The grid is one wave of resident blocks, each warp taking
//   rows in turn (grid-stride over t). The sum is fp32: the product and
//   the sum are each rounded, as in the plain version, then rounded once
//   to the output type.
// shift/scale/gate are (B, D) rows with a row stride, so the six chunks of
// the DiT's modulation vector are read in place.
#include "common.cuh"

constexpr int MOD_MAX_D = 8 * 1024;
constexpr int MOD_MAX_THREADS = 256;

// Sum over each aligned group of LANES lanes, returned to all of them.
// Deterministic: a xor butterfly gives every lane the same sum.
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float modulated(float v, float mu, float r, float sc, float sh) {
  return (v - mu) * r * (1.f + sc) + sh;
}

// grid (blocks per b, B); blockDim.x a multiple of 32, at most
// MOD_MAX_THREADS. Each group of LANES lanes takes rows t = g, g + step,
// ... of its b, where g is its index among the groups of b's blocks.
template <typename T, int VEC, int LANES, int NCHUNK>
__global__ void __launch_bounds__(MOD_MAX_THREADS)
modulate_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                const T* __restrict__ scale, T* __restrict__ out, int T_, int D,
                long long cond_stride, float eps) {
  using C = Chunk<T, VEC>;
  constexpr int GROUPS = 32 / LANES;  // rows a warp holds at once
  const int lane = threadIdx.x & 31, sub = lane % LANES;
  const int warps = blockDim.x >> 5;
  const int nvec = D / VEC;
  const long long b = blockIdx.y;
  const T* sh = shift + b * cond_stride;
  const T* sc = scale + b * cond_stride;
  const int step = gridDim.x * warps * GROUPS;
  // the warp's first row; the loop bound is uniform across the warp, so
  // every lane reaches every shuffle
  int t = (blockIdx.x * warps + (threadIdx.x >> 5)) * GROUPS;
  if constexpr (NCHUNK > 0) {
    C csh[NCHUNK], csc[NCHUNK];
#pragma unroll
    for (int j = 0; j < NCHUNK; ++j) {
      const int c = j * LANES + sub;
      csh[j].zero();
      csc[j].zero();
      if (c < nvec) {
        csh[j].load(sh + c * VEC);
        csc[j].load(sc + c * VEC);
      }
    }
    for (; t < T_; t += step) {
      const int tr = t + lane / LANES;
      const bool valid = tr < T_;
      const long long row = b * T_ + tr;
      C xv[NCHUNK];
#pragma unroll
      for (int j = 0; j < NCHUNK; ++j) {
        const int c = j * LANES + sub;
        xv[j].zero();
        if (valid && c < nvec) xv[j].load(x + row * D + c * VEC);
      }
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NCHUNK; ++j)
#pragma unroll
        for (int i = 0; i < VEC; ++i) s += xv[j].get(i);
      const float mu = group_sum<LANES>(s) / D;
      float s2 = 0.f;
#pragma unroll
      for (int j = 0; j < NCHUNK; ++j) {
        if (j * LANES + sub < nvec) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float d = xv[j].get(i) - mu;
            s2 += d * d;
          }
        }
      }
      const float r = rsqrtf(group_sum<LANES>(s2) / D + eps);
      if (!valid) continue;
#pragma unroll
      for (int j = 0; j < NCHUNK; ++j) {
        const int c = j * LANES + sub;
        if (c < nvec) {
          float f[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            f[i] = modulated(xv[j].get(i), mu, r, csc[j].get(i), csh[j].get(i));
          store_chunk<T, VEC>(out + row * D + c * VEC, f);
        }
      }
    }
  } else {  // generic body: LANES == 32, any D
    for (; t < T_; t += step) {
      const T* xr = x + (b * T_ + t) * D;
      float s = 0.f;
      for (int c = sub; c < nvec; c += LANES) {
        C v;
        v.load(xr + c * VEC);
#pragma unroll
        for (int i = 0; i < VEC; ++i) s += v.get(i);
      }
      const float mu = group_sum<LANES>(s) / D;
      float s2 = 0.f;
      for (int c = sub; c < nvec; c += LANES) {
        C v;
        v.load(xr + c * VEC);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = v.get(i) - mu;
          s2 += d * d;
        }
      }
      const float r = rsqrtf(group_sum<LANES>(s2) / D + eps);
      for (int c = sub; c < nvec; c += LANES) {
        C v, a, m;
        v.load(xr + c * VEC);
        a.load(sc + c * VEC);
        m.load(sh + c * VEC);
        float f[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) f[i] = modulated(v.get(i), mu, r, a.get(i), m.get(i));
        store_chunk<T, VEC>(out + (b * T_ + t) * D + c * VEC, f);
      }
    }
  }
}

// resid + gate * y in fp32, rounded once: a product then a sum, each
// rounded to fp32 (no fused multiply-add), exactly as the plain version
// computes it
__device__ __forceinline__ float gated(float r, float g, float y) {
  return __fadd_rn(r, __fmul_rn(g, y));
}

// The same grid and groups as modulate_kernel: a group of LANES lanes owns
// a row of one b (grid y), lane l holding chunks l, l + LANES, ... of it.
// The register bodies (NCHUNK > 0) load the gate chunks of the group's
// columns once and keep them for every row the group takes; all resid and
// y loads of a row are issued before its first store. The generic body
// (NCHUNK = 0) walks the row a chunk at a time, gate included. No lane
// waits on another, so each group runs its own rows.
template <typename T, int VEC, int LANES, int NCHUNK>
__global__ void __launch_bounds__(MOD_MAX_THREADS)
gate_kernel(const T* __restrict__ resid, const T* __restrict__ gate,
            const T* __restrict__ y, T* __restrict__ out, int T_, int D,
            long long gate_stride) {
  using C = Chunk<T, VEC>;
  constexpr int GROUPS = 32 / LANES;
  const int sub = (threadIdx.x & 31) % LANES;
  const int warps = blockDim.x >> 5;
  const int nvec = D / VEC;
  const long long b = blockIdx.y;
  const T* g = gate + b * gate_stride;
  const int step = gridDim.x * warps * GROUPS;
  int t = (blockIdx.x * warps + (threadIdx.x >> 5)) * GROUPS + (threadIdx.x & 31) / LANES;
  if constexpr (NCHUNK > 0) {
    C cg[NCHUNK];
#pragma unroll
    for (int j = 0; j < NCHUNK; ++j) {
      const int c = j * LANES + sub;
      cg[j].zero();
      if (c < nvec) cg[j].load(g + c * VEC);
    }
    for (; t < T_; t += step) {
      const long long row = (b * T_ + t) * D;
      C rv[NCHUNK], yv[NCHUNK];
#pragma unroll
      for (int j = 0; j < NCHUNK; ++j) {
        const int c = j * LANES + sub;
        if (c < nvec) {
          rv[j].load(resid + row + c * VEC);
          yv[j].load(y + row + c * VEC);
        }
      }
#pragma unroll
      for (int j = 0; j < NCHUNK; ++j) {
        const int c = j * LANES + sub;
        if (c < nvec) {
          float f[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) f[i] = gated(rv[j].get(i), cg[j].get(i), yv[j].get(i));
          store_chunk<T, VEC>(out + row + c * VEC, f);
        }
      }
    }
  } else {  // generic body: any D
    for (; t < T_; t += step) {
      const long long row = (b * T_ + t) * D;
      for (int c = sub; c < nvec; c += LANES) {
        C rv, gv, yv;
        rv.load(resid + row + c * VEC);
        gv.load(g + c * VEC);
        yv.load(y + row + c * VEC);
        float f[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) f[i] = gated(rv.get(i), gv.get(i), yv.get(i));
        store_chunk<T, VEC>(out + row + c * VEC, f);
      }
    }
  }
}

using RowLaunch = void (*)(const void*, const void*, const void*, void*, dim3,
                           int, int, int, long long, float, cudaStream_t);

template <typename T, int VEC, int LANES, int NCHUNK>
void launch_modulate(const void* x, const void* shift, const void* scale, void* out,
                     dim3 grid, int threads, int T_, int D, long long cond_stride,
                     float eps, cudaStream_t s) {
  modulate_kernel<T, VEC, LANES, NCHUNK><<<grid, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(shift),
      static_cast<const T*>(scale), static_cast<T*>(out), T_, D, cond_stride, eps);
}

// (resid, gate, y, out): the same arguments in modulate's places; eps unused
template <typename T, int VEC, int LANES, int NCHUNK>
void launch_gate(const void* resid, const void* gate, const void* y, void* out,
                 dim3 grid, int threads, int T_, int D, long long gate_stride, float,
                 cudaStream_t s) {
  gate_kernel<T, VEC, LANES, NCHUNK><<<grid, threads, 0, s>>>(
      static_cast<const T*>(resid), static_cast<const T*>(gate),
      static_cast<const T*>(y), static_cast<T*>(out), T_, D, gate_stride);
}

// The compiled bodies of both kernels: (dtype, access bytes, lanes per
// row, chunks per lane). Mirrored by kernels/adaln_modulate/kernel.py
// (REGISTER_BODIES).
struct RowBody {
  int dtype, bytes, lanes, chunks;
  RowLaunch modulate, gate;
};
using bf16 = __nv_bfloat16;
#define ROW_BODY(DT, T, BYTES, LANES, CHUNKS)                              \
  {DT, BYTES, LANES, CHUNKS, launch_modulate<T, BYTES / sizeof(T), LANES, CHUNKS>, \
   launch_gate<T, BYTES / sizeof(T), LANES, CHUNKS>}
static const RowBody ROW_BODIES[] = {
    // register bodies, D = 1152 / 384 / 128
    ROW_BODY(DTYPE_BF16, bf16, 16, 32, 5),
    ROW_BODY(DTYPE_BF16, bf16, 16, 16, 3),
    ROW_BODY(DTYPE_BF16, bf16, 16, 16, 1),
    ROW_BODY(DTYPE_F32, float, 16, 32, 9),
    ROW_BODY(DTYPE_F32, float, 16, 32, 3),
    ROW_BODY(DTYPE_F32, float, 16, 16, 2),
    // generic bodies, any D, by access width
    ROW_BODY(DTYPE_BF16, bf16, 16, 32, 0),
    ROW_BODY(DTYPE_BF16, bf16, 8, 32, 0),
    ROW_BODY(DTYPE_BF16, bf16, 4, 32, 0),
    ROW_BODY(DTYPE_BF16, bf16, 2, 32, 0),
    ROW_BODY(DTYPE_F32, float, 16, 32, 0),
    ROW_BODY(DTYPE_F32, float, 8, 32, 0),
    ROW_BODY(DTYPE_F32, float, 4, 32, 0),
};
#undef ROW_BODY

// Check a plan (access bytes, lanes, chunks, warps per block, blocks per
// b) against the operands (the row tensor a, the conditioning rows c0/c1
// of row stride cond_stride, the output) and find its compiled body:
// nullptr where the operands cannot take the plan or no body serves it.
static const RowBody* row_body(const void* a, const void* c0, const void* c1,
                               const void* out, int B, int T_, int D,
                               long long cond_stride, int dtype, int bytes, int lanes,
                               int chunks, int warps, int blocks_per_b) {
  const int size = dtype == DTYPE_F32 ? 4 : dtype == DTYPE_BF16 ? 2 : 0;
  if (!size || B < 1 || B > 65535 || T_ < 1 || D < 1 || D > MOD_MAX_D ||
      (lanes != 8 && lanes != 16 && lanes != 32) || warps < 1 ||
      warps * 32 > MOD_MAX_THREADS || blocks_per_b < 1 ||
      (long long)blocks_per_b * warps * 32 > 0x7fffffffLL || cond_stride < 0)
    return nullptr;
  if (bytes < size || bytes % size || (D * size) % bytes || (cond_stride * size) % bytes)
    return nullptr;
  const void* ptrs[] = {a, c0, c1, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % bytes) return nullptr;
  const int nvec = D * size / bytes;
  if (chunks > 0 ? chunks != (nvec + lanes - 1) / lanes : lanes != 32) return nullptr;
  for (const RowBody& body : ROW_BODIES)
    if (body.dtype == dtype && body.bytes == bytes && body.lanes == lanes &&
        body.chunks == chunks)
      return &body;
  return nullptr;
}

// The plan comes from the wrapper's plan(); a plan the operands cannot
// take, or that no compiled body serves, is refused with
// cudaErrorInvalidValue.
extern "C" int adaln_modulate(const void* x, const void* shift, const void* scale,
                              void* out, int B, int T_, int D,
                              long long cond_stride, float eps, int dtype,
                              int bytes, int lanes, int chunks, int warps,
                              int blocks_per_b, void* stream) {
  const RowBody* body = row_body(x, shift, scale, out, B, T_, D, cond_stride, dtype,
                                 bytes, lanes, chunks, warps, blocks_per_b);
  if (!body) return static_cast<int>(cudaErrorInvalidValue);
  body->modulate(x, shift, scale, out, dim3(blocks_per_b, B), warps * 32, T_, D,
                 cond_stride, eps, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The same plan and refusals as adaln_modulate, the gate's row stride in
// place of the conditioning stride.
extern "C" int gate_residual(const void* resid, const void* gate, const void* y,
                             void* out, int B, int T_, int D,
                             long long gate_stride, int dtype, int bytes, int lanes,
                             int chunks, int warps, int blocks_per_b, void* stream) {
  const RowBody* body = row_body(resid, gate, y, out, B, T_, D, gate_stride, dtype,
                                 bytes, lanes, chunks, warps, blocks_per_b);
  if (!body) return static_cast<int>(cudaErrorInvalidValue);
  body->gate(resid, gate, y, out, dim3(blocks_per_b, B), warps * 32, T_, D,
             gate_stride, 0.f, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// ---- backward (the training path) -------------------------------------------
//
// The reference defines no backward: jax.value_and_grad differentiates the
// TPU kernels' forwards through XLA. Here the forwards are hand-written, so
// their gradients are kernels too, in two deterministic stages (no
// atomics, so a training step repeats bit for bit):
// * stage 1, a block per (tile of rows, b).
//   modulate, register bodies (modulate_bwd_rows; the forward's compiled
//   widths, blocks of rows_threads): a group of LANES lanes owns a row,
//   which it reads once into registers as 16-byte chunks in the forward's
//   layout (lane l holds chunks l, l + LANES, ...; scale's chunks come from
//   L1). From those registers: the fp32 mean and rstd as the forward
//   computes them, then mean(g_hat) and mean(g_hat x_hat) with g_hat = g
//   (1 + scale), each a butterfly over the group; dx = rstd (g_hat -
//   mean(g_hat) - x_hat mean(g_hat x_hat)) is written once. Each lane adds
//   its columns' g and g x_hat to the group's fp32 partial row in shared
//   memory over the rows the group takes; the groups' rows are summed in
//   group order into the tile's partial row of an fp32 workspace.
//   The generic body (modulate_bwd_kernel, any other D, BWD_THREADS) walks
//   a row from memory in each pass and its column pass reads the tile's
//   rows again.
//   gate_residual (gate_bwd_rows, grid (column strips, tiles, B)): a thread
//   owns one chunk of a row's columns, 16 bytes where every pointer, the
//   rows and the gate's row stride allow (8 bf16 or 4 fp32; else the
//   widest access they all take), and loads its gate chunk once into
//   registers. A block is `groups` row groups over one strip of `cols`
//   chunks; group i takes the tile's rows i * turns .. (i + 1) * turns - 1
//   in order, GATE_BWD_UNROLL rows' g and y loads in flight at once, and
//   writes dy = gate * g (one fp32 product, rounded once to the output
//   type: the plain version's arithmetic, so dy is bit-equal to it) as
//   one access a row. Its partial sums of g y stay in fp32 registers in
//   row order; the block adds its groups' partials in group order, in
//   shared memory, into the tile's partial row of the workspace, so the
//   tile's sum runs over its rows in order.
// * stage 2: modulate's register bodies and gate_residual sum b's tiles in
//   tile order (tile_sum_kernel, a thread a column of the workspace,
//   launched as a programmatic dependent of stage 1 so that its launch
//   overlaps the row pass); modulate's generic body in an ordinary second
//   launch (column_sum_kernel). Each output is rounded once to the
//   parameter's dtype (dshift, dscale; dgate). dresid is the incoming
//   gradient itself.
// Bound on the H100: bytes, as the forwards. At the training shape (batch
// 8, T = 256, D = 1152, bf16) modulate's backward reads x and g and writes
// dx (14.2 MB, 4.2 us at 3.35 TB/s); gate_residual's reads g and y and
// writes dy (the same). Both read each row once; the workspace adds a
// tile's partial row (fp32) a tile.

constexpr int BWD_THREADS = 256;
constexpr int BWD_MAX_ROWS = 64;  // rows of one tile

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
modulate_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                    const T* __restrict__ scale, T* __restrict__ dx,
                    float* __restrict__ part, int T_, int D, long long cond_stride,
                    int rows, float eps) {
  __shared__ float s_mu[BWD_MAX_ROWS], s_r[BWD_MAX_ROWS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long b = blockIdx.y;
  const int t0 = blockIdx.x * rows;
  const int nrows = min(rows, T_ - t0);
  const T* sc = scale + b * cond_stride;
  for (int i = warp; i < nrows; i += warps) {  // warp-uniform: every lane shuffles
    const long long row = (b * T_ + t0 + i) * D;
    const T* xr = x + row;
    const T* gr = g + row;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += to_f32(xr[c]);
    const float mu = group_sum<32>(s) / D;
    float s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = to_f32(xr[c]) - mu;
      s2 += d * d;
    }
    const float r = rsqrtf(group_sum<32>(s2) / D + eps);
    float sg = 0.f, sgx = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float gh = to_f32(gr[c]) * (1.f + to_f32(sc[c]));
      sg += gh;
      sgx += gh * ((to_f32(xr[c]) - mu) * r);
    }
    const float mg = group_sum<32>(sg) / D, mgx = group_sum<32>(sgx) / D;
    for (int c = lane; c < D; c += 32) {
      const float gh = to_f32(gr[c]) * (1.f + to_f32(sc[c]));
      const float xh = (to_f32(xr[c]) - mu) * r;
      dx[row + c] = from_f32<T>(r * (gh - mg - xh * mgx));
    }
    if (lane == 0) {
      s_mu[i] = mu;
      s_r[i] = r;
    }
  }
  __syncthreads();
  float* pg = part + (b * gridDim.x + blockIdx.x) * 2LL * D;  // [sum g | sum g x_hat]
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float a = 0.f, ax = 0.f;
    for (int i = 0; i < nrows; ++i) {
      const long long idx = (b * T_ + t0 + i) * D + c;
      const float gv = to_f32(g[idx]);
      a += gv;
      ax += gv * ((to_f32(x[idx]) - s_mu[i]) * s_r[i]);
    }
    pg[c] = a;
    pg[D + c] = ax;
  }
}

// Threads a block of modulate's backward register bodies (kernel.py:
// BWD_ROWS_THREADS): bf16 rows need fewer registers
constexpr int BF16_ROWS_THREADS = 512;
template <typename T>
__host__ __device__ constexpr int rows_threads() {
  return sizeof(T) == 2 ? BF16_ROWS_THREADS : 256;
}

// The register bodies of modulate's backward: grid (tiles, B), a tile being
// the (rows_threads<T>() / LANES) * turns rows t0 .. of one b; group i takes rows
// t0 + i, t0 + i + GROUPS, ... (turns of them). Dynamic shared memory:
// GROUPS partial rows of 2D floats ([sum g | sum g x_hat]), summed in group
// order into the tile's row of `part`.
template <typename T, int VEC, int LANES, int NCHUNK>
__global__ void __launch_bounds__(rows_threads<T>(), 1)
modulate_bwd_rows(const T* __restrict__ g, const T* __restrict__ x,
                  const T* __restrict__ scale, T* __restrict__ dx, float* __restrict__ part,
                  int T_, int D, long long cond_stride, int turns, float eps) {
  using C = Chunk<T, VEC>;
  constexpr int GROUPS = rows_threads<T>() / LANES;
  extern __shared__ float spart[];
  const int sub = (threadIdx.x & 31) % LANES, grp = threadIdx.x / LANES;
  const int nvec = D / VEC;
  const long long b = blockIdx.y;
  const int t0 = blockIdx.x * GROUPS * turns;
  const T* sc = scale + b * cond_stride;
  float* mine = spart + grp * 2 * D;
  // the tile sums may launch now: they wait for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // the loop bound is uniform across the group, so every lane reaches
  // every shuffle; a row past T adds zeros and writes nothing
  for (int k = 0; k < turns; ++k) {
    const int t = t0 + k * GROUPS + grp;
    const bool valid = t < T_;
    const long long row = (b * T_ + (valid ? t : 0)) * D;
    C xv[NCHUNK], gv[NCHUNK];  // the row, read once
#pragma unroll
    for (int j = 0; j < NCHUNK; ++j) {
      const int c = j * LANES + sub;
      xv[j].zero();
      gv[j].zero();
      if (valid && c < nvec) {
        xv[j].load(x + row + c * VEC);
        gv[j].load(g + row + c * VEC);
      }
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NCHUNK; ++j)
#pragma unroll
      for (int i = 0; i < VEC; ++i) s += xv[j].get(i);
    const float mu = group_sum<LANES>(s) / D;
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NCHUNK; ++j) {
      if (j * LANES + sub < nvec) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = xv[j].get(i) - mu;
          s2 += d * d;
        }
      }
    }
    const float r = rsqrtf(group_sum<LANES>(s2) / D + eps);
    // scale's chunks come again from L1 at each use: held in registers
    // across the rows they would spill
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < NCHUNK; ++j) {
      const int c = j * LANES + sub;
      C sv;
      sv.zero();
      if (c < nvec) sv.load(sc + c * VEC);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float gh = gv[j].get(i) * (1.f + sv.get(i));
        sg += gh;
        sgx += gh * ((xv[j].get(i) - mu) * r);
      }
    }
    const float mg = group_sum<LANES>(sg) / D, mgx = group_sum<LANES>(sgx) / D;
#pragma unroll
    for (int j = 0; j < NCHUNK; ++j) {
      const int c = j * LANES + sub;
      if (c >= nvec) continue;
      C sv;
      sv.load(sc + c * VEC);
      float f[VEC], pg[VEC], pgx[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float gi = gv[j].get(i), gh = gi * (1.f + sv.get(i));
        const float xh = (xv[j].get(i) - mu) * r;
        f[i] = r * (gh - mg - xh * mgx);
        pg[i] = valid ? gi : 0.f;
        pgx[i] = valid ? gi * xh : 0.f;
      }
      if (valid) store_chunk<T, VEC>(dx + row + c * VEC, f);
      // the group's partial sums, 16 bytes at a time
      float4* pc = reinterpret_cast<float4*>(mine + c * VEC);
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        float4 a = make_float4(pg[4 * q], pg[4 * q + 1], pg[4 * q + 2], pg[4 * q + 3]);
        float4 ax = make_float4(pgx[4 * q], pgx[4 * q + 1], pgx[4 * q + 2], pgx[4 * q + 3]);
        if (k > 0) {
          const float4 o = pc[q], ox = pc[q + D / 4];
          a.x += o.x; a.y += o.y; a.z += o.z; a.w += o.w;
          ax.x += ox.x; ax.y += ox.y; ax.z += ox.z; ax.w += ox.w;
        }
        pc[q] = a;
        pc[q + D / 4] = ax;
      }
    }
  }
  __syncthreads();
  float* pg = part + (b * gridDim.x + blockIdx.x) * 2LL * D;  // [sum g | sum g x_hat]
  for (int c = threadIdx.x; c < 2 * D; c += rows_threads<T>()) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) a += spart[i * 2 * D + c];
    pg[c] = a;
  }
}

constexpr int SUM_THREADS = 128;

// out_k[b, c] = b's tile rows of `part` ((B, tiles, nout * D) fp32) summed
// in tile order at column k * D + c, for k < nout (dshift and dscale of
// modulate, nout 2; dgate, nout 1): a thread a column, rounded once
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
tile_sum_kernel(const float* __restrict__ part, T* __restrict__ out0,
                T* __restrict__ out1, int tiles, int D, int nout) {
  const long long b = blockIdx.y;
  const int c = blockIdx.x * SUM_THREADS + threadIdx.x;
  const long long width = static_cast<long long>(nout) * D;
  // launched as a programmatic dependent of the row pass: wait for its
  // partial rows
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (c >= width) return;
  const float* p = part + b * tiles * width + c;
  float a = 0.f;
#pragma unroll 16  // the DiT's 16-32 tiles a b: every load in flight at once
  for (int i = 0; i < tiles; ++i) a += p[i * width];
  *(c < D ? out0 + b * D + c : out1 + b * D + c - D) = from_f32<T>(a);
}

// tile_sum_kernel over the (B, tiles, nout * D) workspace, as a
// programmatic dependent launch: set up while the row pass ends
template <typename T>
static int launch_tile_sums(const float* part, void* out0, void* out1, int B, int tiles,
                            int D, int nout, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nout * D + SUM_THREADS - 1) / SUM_THREADS, B);
  cfg.blockDim = dim3(SUM_THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, tile_sum_kernel<T>, part,
                                             static_cast<T*>(out0), static_cast<T*>(out1),
                                             tiles, D, nout);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// rows of g and y whose loads a thread of gate_bwd_rows has in flight at
// once (kernel.py: GATE_BWD_UNROLL); a thread takes a multiple of them
constexpr int GATE_BWD_UNROLL = 4;
constexpr int GATE_BWD_MAX_THREADS = 512;

// grid (strips, tiles, B), blocks of cols * groups threads: thread (i, c)
// owns chunk blockIdx.x * cols + c of each row (VEC elements, one access)
// and takes rows t0 + i * turns .. t0 + (i + 1) * turns - 1 of b, t0 =
// blockIdx.y * groups * turns. Dynamic shared memory: groups partial rows
// of cols * VEC floats where groups > 1.
template <typename T, int VEC>
__global__ void __launch_bounds__(GATE_BWD_MAX_THREADS)
gate_bwd_rows(const T* __restrict__ g, const T* __restrict__ gate,
              const T* __restrict__ y, T* __restrict__ dy, float* __restrict__ part,
              int T_, int D, long long gate_stride, int cols, int turns) {
  using C = Chunk<T, VEC>;
  extern __shared__ float spart[];
  const int c = threadIdx.x % cols, grp = threadIdx.x / cols;
  const int groups = blockDim.x / cols;
  const int chunk = blockIdx.x * cols + c;
  const bool live = chunk < D / VEC;
  const long long b = blockIdx.z;
  const int t0 = (blockIdx.y * groups + grp) * turns;
  // the tile sums may launch now: they wait for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  C gc;  // the gate chunk, held for every row
  gc.zero();
  if (live) gc.load(gate + b * gate_stride + chunk * VEC);
  float gf[VEC], acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    gf[i] = gc.get(i);
    acc[i] = 0.f;
  }
  const long long col0 = b * T_ * D + static_cast<long long>(chunk) * VEC;
  for (int k = 0; k < turns; k += GATE_BWD_UNROLL) {
    C gv[GATE_BWD_UNROLL], yv[GATE_BWD_UNROLL];
#pragma unroll
    for (int u = 0; u < GATE_BWD_UNROLL; ++u) {  // every load, then the math
      const int t = t0 + k + u;
      gv[u].zero();
      yv[u].zero();
      if (live && t < T_) {
        gv[u].load(g + col0 + static_cast<long long>(t) * D);
        yv[u].load(y + col0 + static_cast<long long>(t) * D);
      }
    }
#pragma unroll
    for (int u = 0; u < GATE_BWD_UNROLL; ++u) {
      const int t = t0 + k + u;
      if (!live || t >= T_) continue;
      float f[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float gi = gv[u].get(i);
        f[i] = __fmul_rn(gf[i], gi);
        acc[i] += gi * yv[u].get(i);
      }
      store_chunk<T, VEC>(dy + col0 + static_cast<long long>(t) * D, f);
    }
  }
  // the tile's partial row: the groups' sums in group order
  float* prow = part + (b * gridDim.y + blockIdx.y) * static_cast<long long>(D);
  if (groups == 1) {
    if (live) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) prow[chunk * VEC + i] = acc[i];
    }
    return;
  }
  const int width = cols * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) spart[grp * width + c * VEC + i] = acc[i];
  __syncthreads();
  const int c0 = blockIdx.x * width;
  for (int e = threadIdx.x; e < width && c0 + e < D; e += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < groups; ++i) a += spart[i * width + e];
    prow[c0 + e] = a;
  }
}

// out_k[b, c] = sum over the tiles of part[b, tile, k, c], in tile order,
// for k < nout (the (B, tiles, nout, D) workspace of modulate's generic
// body), in an ordinary second launch.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
column_sum_kernel(const float* __restrict__ part, T* __restrict__ out0,
                  T* __restrict__ out1, int tiles, int D, int nout) {
  const long long b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= D) return;
  for (int k = 0; k < nout; ++k) {
    const float* p = part + (b * tiles * nout + k) * (long long)D + c;
    float a = 0.f;
    for (int i = 0; i < tiles; ++i) a += p[(long long)i * nout * D];
    (k == 0 ? out0 : out1)[b * D + c] = from_f32<T>(a);
  }
}

static bool bwd_ok(int B, int T_, int D, int rows, long long cond_stride, int dtype) {
  return (dtype == DTYPE_F32 || dtype == DTYPE_BF16) && B >= 1 && B <= 65535 && T_ >= 1 &&
         D >= 1 && D <= MOD_MAX_D && rows >= 1 && rows <= BWD_MAX_ROWS && cond_stride >= 0;
}

template <typename T>
static int launch_modulate_bwd(const void* g, const void* x, const void* scale, void* dx,
                               void* dshift, void* dscale, float* part, int B, int T_,
                               int D, long long cond_stride, float eps, int rows,
                               cudaStream_t s) {
  const int tiles = (T_ + rows - 1) / rows;
  modulate_bwd_kernel<T><<<dim3(tiles, B), BWD_THREADS, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(dx), part, T_, D, cond_stride, rows, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  column_sum_kernel<T><<<dim3((D + BWD_THREADS - 1) / BWD_THREADS, B), BWD_THREADS, 0, s>>>(
      part, static_cast<T*>(dshift), static_cast<T*>(dscale), tiles, D, 2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, int LANES, int NCHUNK>
static int launch_modulate_bwd_rows(const void* g, const void* x, const void* scale,
                                    void* dx, void* dshift, void* dscale, float* part, int B,
                                    int T_, int D, long long cond_stride, float eps,
                                    int turns, cudaStream_t s) {
  constexpr int GROUPS = rows_threads<T>() / LANES;
  const int smem = GROUPS * 2 * D * static_cast<int>(sizeof(float));
  static int sized = 0;  // the dynamic shared memory set so far, per instantiation
  if (smem > sized) {
    const cudaError_t err = cudaFuncSetAttribute(modulate_bwd_rows<T, VEC, LANES, NCHUNK>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = smem;
  }
  const int tiles = (T_ + GROUPS * turns - 1) / (GROUPS * turns);
  modulate_bwd_rows<T, VEC, LANES, NCHUNK><<<dim3(tiles, B), rows_threads<T>(), smem, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(dx), part, T_, D, cond_stride, turns, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_tile_sums<T>(part, dshift, dscale, B, tiles, D, 2, s);
}

using BwdRowsLaunch = int (*)(const void*, const void*, const void*, void*, void*, void*,
                              float*, int, int, int, long long, float, int, cudaStream_t);
// modulate's backward register bodies: the forward's (ROW_BODIES), mirrored
// by kernels/adaln_modulate/kernel.py (REGISTER_BODIES)
struct BwdBody {
  int dtype, bytes, lanes, chunks;
  BwdRowsLaunch launch;
};
#define BWD_BODY(DT, T, BYTES, LANES, CHUNKS) \
  {DT, BYTES, LANES, CHUNKS, launch_modulate_bwd_rows<T, BYTES / sizeof(T), LANES, CHUNKS>}
static const BwdBody BWD_BODIES[] = {
    BWD_BODY(DTYPE_BF16, bf16, 16, 32, 5), BWD_BODY(DTYPE_BF16, bf16, 16, 16, 3),
    BWD_BODY(DTYPE_BF16, bf16, 16, 16, 1), BWD_BODY(DTYPE_F32, float, 16, 32, 9),
    BWD_BODY(DTYPE_F32, float, 16, 32, 3), BWD_BODY(DTYPE_F32, float, 16, 16, 2),
};
#undef BWD_BODY

template <typename T, int VEC>
static int launch_gate_bwd(const void* g, const void* gate, const void* y, void* dy,
                           void* dgate, float* part, int B, int T_, int D,
                           long long gate_stride, int cols, int groups, int turns,
                           cudaStream_t s) {
  const int strips = (D / VEC + cols - 1) / cols;
  const int tiles = (T_ + groups * turns - 1) / (groups * turns);
  const int smem = groups > 1 ? groups * cols * VEC * static_cast<int>(sizeof(float)) : 0;
  gate_bwd_rows<T, VEC><<<dim3(strips, tiles, B), cols * groups, smem, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(gate), static_cast<const T*>(y),
      static_cast<T*>(dy), part, T_, D, gate_stride, cols, turns);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_tile_sums<T>(part, dgate, dgate, B, tiles, D, 1, s);
}

using GateBwdLaunch = int (*)(const void*, const void*, const void*, void*, void*, float*,
                              int, int, int, long long, int, int, int, cudaStream_t);
// gate_residual's backward bodies: (dtype, access bytes), mirrored by
// kernels/adaln_modulate/kernel.py (ACCESS_BYTES)
struct GateBwdBody {
  int dtype, bytes;
  GateBwdLaunch launch;
};
#define GATE_BWD_BODY(DT, T, BYTES) {DT, BYTES, launch_gate_bwd<T, BYTES / sizeof(T)>}
static const GateBwdBody GATE_BWD_BODIES[] = {
    GATE_BWD_BODY(DTYPE_BF16, bf16, 16), GATE_BWD_BODY(DTYPE_BF16, bf16, 8),
    GATE_BWD_BODY(DTYPE_BF16, bf16, 4),  GATE_BWD_BODY(DTYPE_BF16, bf16, 2),
    GATE_BWD_BODY(DTYPE_F32, float, 16), GATE_BWD_BODY(DTYPE_F32, float, 8),
    GATE_BWD_BODY(DTYPE_F32, float, 4),
};
#undef GATE_BWD_BODY

// g, x, dx: contiguous (B, T, D); scale: (B, D) rows of stride cond_stride;
// dshift, dscale: contiguous (B, D); part: an fp32 workspace of
// (B, tiles, 2, D). All of one dtype (part aside). chunks 0: the generic
// body, tiles of `rows` rows. chunks > 0: the register body of (dtype,
// bytes, lanes, chunks), tiles of (rows_threads / lanes) * rows rows (rows:
// the rows each group takes); refused where the operands cannot take the
// plan (as adaln_modulate's plans) or no body is compiled for it. Either
// sums the tiles in a second launch.
extern "C" int adaln_modulate_bwd(const void* g, const void* x, const void* scale, void* dx,
                                  void* dshift, void* dscale, void* part, int B, int T_,
                                  int D, long long cond_stride, float eps, int dtype,
                                  int rows, int bytes, int lanes, int chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (chunks > 0) {
    // the forward's checks of alignment and chunk count, on (x, scale, g, dx)
    if (!row_body(x, scale, g, dx, B, T_, D, cond_stride, dtype, bytes, lanes, chunks, 1,
                  1) ||
        rows < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    for (const BwdBody& body : BWD_BODIES)
      if (body.dtype == dtype && body.bytes == bytes && body.lanes == lanes &&
          body.chunks == chunks)
        return body.launch(g, x, scale, dx, dshift, dscale, p, B, T_, D, cond_stride, eps,
                           rows, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!bwd_ok(B, T_, D, rows, cond_stride, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  return dtype == DTYPE_F32
             ? launch_modulate_bwd<float>(g, x, scale, dx, dshift, dscale, p, B, T_, D,
                                          cond_stride, eps, rows, s)
             : launch_modulate_bwd<bf16>(g, x, scale, dx, dshift, dscale, p, B, T_, D,
                                         cond_stride, eps, rows, s);
}

// g, y, dy: contiguous (B, T, D); gate: (B, D) rows of stride gate_stride;
// dgate: contiguous (B, D); part: fp32 (B, tiles, D), tiles = ceil(T /
// (groups * turns)). The plan (kernel.py: plan_gate_bwd): accesses of
// `bytes` (every pointer, the rows and the gate's row stride aligned to
// it), blocks of `cols` chunks by `groups` row groups, `turns` rows a
// group (a multiple of GATE_BWD_UNROLL). A plan the operands cannot take,
// or that no compiled body serves, is refused with cudaErrorInvalidValue.
extern "C" int gate_residual_bwd(const void* g, const void* gate, const void* y, void* dy,
                                 void* dgate, void* part, int B, int T_, int D,
                                 long long gate_stride, int dtype, int bytes, int cols,
                                 int groups, int turns, void* stream) {
  const int size = dtype == DTYPE_F32 ? 4 : dtype == DTYPE_BF16 ? 2 : 0;
  if (!size || B < 1 || B > 65535 || T_ < 1 || D < 1 || D > MOD_MAX_D || gate_stride < 0 ||
      bytes < size || bytes % size || (D * size) % bytes || (gate_stride * size) % bytes ||
      cols < 1 || groups < 1 || cols * groups > GATE_BWD_MAX_THREADS || turns < 1 ||
      turns % GATE_BWD_UNROLL || (T_ + groups * turns - 1) / (groups * turns) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {g, gate, y, dy};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % bytes) return static_cast<int>(cudaErrorInvalidValue);
  for (const GateBwdBody& body : GATE_BWD_BODIES)
    if (body.dtype == dtype && body.bytes == bytes)
      return body.launch(g, gate, y, dy, dgate, static_cast<float*>(part), B, T_, D,
                         gate_stride, cols, groups, turns, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaErrorInvalidValue);
}

EXPORT_ERROR_STRING
