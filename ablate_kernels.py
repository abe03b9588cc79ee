#!/usr/bin/env python3
"""Where the time of the port's redesigned kernels (flash_attention and
its backward's wgmma body, quant_matmul's wgmma and skinny bodies,
adaln_modulate and its backward, gate_residual and its backward,
unipc_update's sampler-row ops) goes, on the
card: ablation timings at the main path's shapes.

    python3 ablate_kernels.py          # from the repository root, one CUDA card
    python3 ablate_kernels.py _bwd     # only the ablations whose name has "_bwd"

Each ablation is a copy of a kernel's CUDA source with one part of its work
taken out (the product, the softmax's exponentials, the backward's
products or exponentials pass by pass, the widening, the
loads after the first ring's worth, modulate's reductions or conditioning
loads, gate_residual's gate, the backward's tile sums or partial rows, the
row ops' weight prologue or ring write).
Its output is wrong and unchecked; only its device time counts, next to
the unchanged kernel built the same way. adaln_modulate, gate_residual,
the skinny body and the row ops are also timed on other plans than their
plan() picks (ADALN_PLANS, GATE_PLANS, GATE_BWD_TARGETS, SKINNY_PLANS,
ROW_PLANS): other grids, 4-warp blocks, 8- and 4-byte accesses, half and
double the K split.
All copies build in parallel under build/ablate/; each is timed by
chip_smoke.device_ms (100 calls in a CUDA graph), gate_residual and the
skinny body also by chip_smoke.rotated_ms (operands rotated past the L2).
An edit whose anchor text
is no longer in the source fails the run, so the ablations follow the
kernels or stop.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

OUT = ROOT / "build" / "ablate"

# modulate's register body with the statistics constant (mu 0, r 1) and
# with no shift/scale loads (their registers stay zero)
_NO_STATS = [
    ("        for (int i = 0; i < VEC; ++i) s += xv[j].get(i);\n"
     "      const float mu = group_sum<LANES>(s) / D;",
     "        for (int i = 0; i < VEC; ++i) s += xv[j].get(i);\n"
     "      const float mu = 0.f;"),
    ("      const float r = rsqrtf(group_sum<LANES>(s2) / D + eps);\n"
     "      if (!valid) continue;",
     "      const float r = 1.f;\n      if (!valid) continue;")]
_NO_COND = [
    ("      if (c < nvec) {\n        csh[j].load(sh + c * VEC);\n"
     "        csc[j].load(sc + c * VEC);\n      }",
     "      (void)c;")]

# the skinny body's x and weight loads replaced by values computed from
# the indices (the registers stay live, nothing is read)
_SKINNY_NO_X = (
    "          sk_load<XB>(xv[u][mt], xb + (m * ldx + k0) * XS, in && vec_x && k0 + 4 <= K,\n"
    "                      in ? (K - k0) * XS : 0);",
    "          for (int q = 0; q < XB / 4; ++q) xv[u][mt][q] = m * 7 + k0 + q;\n"
    "          (void)in;")
_SKINNY_NO_W = (
    "          sk_load<VW>(v[u][r], wb + (k0 + r) * ldw + n, in && vec_w && n + VW <= N,\n"
    "                      in ? N - n : 0);",
    "          for (int q = 0; q < VW / 4; ++q) v[u][r][q] = (k0 + r) * 131 + n + q;\n"
    "          (void)in;")

# the row ops' weight prologue replaced by explicit weights: no index load,
# no table row, no products (the weights and use_c read from RowArgs.weights)
_ROW_EXPLICIT = (
    "    long long r = __ldg(a.idx + (a.per_slot ? b : 0));\n"
    "    r = r < 0 ? 0 : (r >= a.n_rows ? a.n_rows - 1 : r);\n"
    "    const float* row = a.rows + r * a.cols;\n"
    "    const float s = __fmul_rn(a.sign, __ldg(row + C_OUT_SCALE));\n"
    "    const float* wcol = row + (MODE == PREDICT ? C_W : C_W + a.K);\n"
    "    w[0] = __ldg(row + (MODE == PREDICT ? C_BASE_X : C_BASE_X_C));\n"
    "    w[1] = __ldg(row + (MODE == PREDICT ? C_BASE_M0 : C_BASE_M0_C));\n"
    "#pragma unroll\n"
    "    for (int k = 0; k < MAX_TERMS - 2; ++k) w[2 + k] = k < a.K ? "
    "__fmul_rn(s, __ldg(wcol + k)) : 0.f;\n"
    "    if constexpr (MODE == CORRECT) {\n"
    "      w[MAX_TERMS - 1] = __fmul_rn(s, __ldg(row + C_W_CORR_NEW));\n"
    "      use_c = __ldg(row + C_USE_C);\n"
    "    }\n",
    "#pragma unroll\n"
    "    for (int k = 0; k < MAX_TERMS; ++k) w[k] = __ldg(a.weights + k);\n"
    "    use_c = __ldg(a.weights + MAX_TERMS);\n")
_ROW_NO_RING = (
    "    en.store(ring_out + row);\n#pragma unroll\n"
    "    for (int k = 0; k < MAX_TERMS - 2; ++k)\n"
    "      if (k < K) ch[1 + k].store(ring_out + (k + 1) * slot + row);\n",
    "    (void)ring_out;\n    (void)slot;\n")

# the backward's wgmma body, pass by pass: its products (S and dP, then dQ;
# S^T and dP^T, then dV and dK) replaced by a use of their operands, its
# exponentials by their arguments; "loads only" both (the producer's ring
# and the consumers' waits and releases stay)
_DQ_NO_PRODUCTS = [
    ("      wgmma_ss<WB_BK>(sc, desc_k(q_u, 64, kk), desc_k(k_u, 64, kk), kk);",
     "      (void)kk;"),
    ("      wgmma_ss<WB_BK>(dp, desc_k(do_u, 64, kk), desc_k(v_u, 64, kk), kk);",
     "      (void)kk;"),
    ("      wgmma_dn<ND>(dqa, hi[kk], k_u, 64, kk);\n"
     "      wgmma_dn<ND>(dqa, lo[kk], k_u, 64, kk);",
     "      dqa[0] += __uint_as_float(hi[kk][0] ^ lo[kk][3]);")]
_DQ_NO_EXP = [
    ("        sc[j] = exp2f(sc[j] * scale_log2 - lse2[(j >> 1) & 1]) * (dp[j] - dlt[(j >> 1) & 1]);",
     "        sc[j] = (sc[j] * scale_log2 - lse2[(j >> 1) & 1]) * (dp[j] - dlt[(j >> 1) & 1]);"),
    ("          const float pv = ok ? exp2f(sc[4 * n + e] * scale_log2 - lse2[e >> 1]) : 0.f;",
     "          const float pv = ok ? sc[4 * n + e] * scale_log2 - lse2[e >> 1] : 0.f;")]
_DKDV_NO_PRODUCTS = [
    ("        wgmma_ss<BQ>(pt, desc_k(k_u, 64, kk), desc_k(q_u, BQ, kk), kk);  // S^T",
     "        (void)kk;"),
    ("        wgmma_ss<BQ>(dpt, desc_k(v_u, 64, kk), desc_k(do_u, BQ, kk), kk);  // dP^T",
     "        (void)kk;"),
    ("        wgmma_dn<ND>(dva, hi[kk], do_u, BQ, kk);\n"
     "        wgmma_dn<ND>(dva, lo[kk], do_u, BQ, kk);",
     "        dva[0] += __uint_as_float(hi[kk][0] ^ lo[kk][3]);"),
    ("        wgmma_dn<ND>(dka, shi[kk], q_u, BQ, kk);\n"
     "        wgmma_dn<ND>(dka, slo[kk], q_u, BQ, kk);",
     "        dka[0] += __uint_as_float(shi[kk][0] ^ slo[kk][3]);")]
_DKDV_NO_EXP = [
    ("          const float pv = ok ? exp2f(pt[4 * n + e] * scale_log2 - ls.x) : 0.f;",
     "          const float pv = ok ? pt[4 * n + e] * scale_log2 - ls.x : 0.f;")]

_MOD_NO_TILE_SUMS = (
    "  return launch_tile_sums<T>(part, dshift, dscale, B, tiles, D, 2, s);",
    "  return static_cast<int>(cudaGetLastError());")
_GATE_NO_TILE_SUMS = (
    "  return launch_tile_sums<T>(part, dgate, dgate, B, tiles, D, 1, s);",
    "  return static_cast<int>(cudaGetLastError());")

# name -> (source, [(anchor, replacement)])
ABLATIONS = {
    "flash_attention": ("flash_attention", []),
    "flash_attention no QK^T": ("flash_attention", [
        ("        mma_k16(s[n], qf[kk], b0, b1);\n        mma_k16(s[n], qf[kk + 1], b2, b3);",
         "        (void)b0; (void)b1; (void)b2; (void)b3;"),
        ("        mma_k8(s[n], qf8[0], qf8[1], b0);", "        (void)b0;")]),
    "flash_attention no PV": ("flash_attention", [
        ("        mma_k16(oacc[n], pa, b0, b1);\n        mma_k16(oacc[n + 1], pa, b2, b3);\n"
         "        mma_k16(oacc[n], pl, b0, b1);\n        mma_k16(oacc[n + 1], pl, b2, b3);",
         "        oacc[n][0] += __uint_as_float(pa[0] & pl[0] & b0 & b2);"),
        ("        mma_k16(oacc[NDV - 1], pa, b0, b1);\n        mma_k16(oacc[NDV - 1], pl, b0, b1);",
         "        oacc[NDV - 1][0] += __uint_as_float(pa[1] & pl[1] & b0 & b1);")]),

    "flash_attention no exp": ("flash_attention", [
        ("        const float p0 = exp2f(sv[0] - m_r[0]), p1 = exp2f(sv[1] - m_r[0]);\n"
         "        const float p2 = exp2f(sv[2] - m_r[1]), p3 = exp2f(sv[3] - m_r[1]);",
         "        const float p0 = sv[0] - m_r[0], p1 = sv[1] - m_r[0];\n"
         "        const float p2 = sv[2] - m_r[1], p3 = sv[3] - m_r[1];")]),
    "flash_attention first K/V tiles only": ("flash_attention", [
        ("    if (i < n_tiles) {\n      unsigned char* st",
         "    if (i < MMA_STAGES - 1 && i < n_tiles) {\n      unsigned char* st")]),
    "flash_attention_bwd": ("flash_attention", []),
    "flash_attention_bwd dq pass only (no dk/dv launch)": ("flash_attention", [
        ("  err = cudaLaunchKernelEx(&cfg, attn_bwd_dkdv_wg<ND, MASK>,",
         "  if (nq > 0) return static_cast<int>(cudaGetLastError());\n"
         "  err = cudaLaunchKernelEx(&cfg, attn_bwd_dkdv_wg<ND, MASK>,")]),
    "flash_attention_bwd dk/dv pass only (no dq launch)": ("flash_attention", [
        ("  attn_bwd_dq_wg<ND, MASK><<<dim3(sh.B * sh.Hq, nq), WB_THREADS, W::DQ_ALLOC, s>>>(",
         "  if (nq < 0) attn_bwd_dq_wg<ND, MASK><<<dim3(sh.B * sh.Hq, nq), WB_THREADS, W::DQ_ALLOC, s>>>(")]),
    "flash_attention_bwd dq pass no Delta loads": ("flash_attention", [
        ("      for (int c = half; c < D / 8; c += 2) {",
         "      for (int c = half; c < 0; c += 2) {")]),
    "flash_attention_bwd dq pass no products": ("flash_attention", _DQ_NO_PRODUCTS),
    "flash_attention_bwd dq pass no exp": ("flash_attention", _DQ_NO_EXP),
    "flash_attention_bwd dq pass loads only": (
        "flash_attention", _DQ_NO_PRODUCTS + _DQ_NO_EXP),
    "flash_attention_bwd dq pass first ring of loads only": ("flash_attention", [
        ("      if (i >= WB_STAGES) mbar_wait(empty + 8 * s, (i / WB_STAGES - 1) & 1);\n"
         "      const unsigned k_u = ring_u + s * 2 * W::TILE64;",
         "      if (i >= WB_STAGES) { mbar_wait(empty + 8 * s, (i / WB_STAGES - 1) & 1);\n"
         "        mbar_arrive(full + 8 * s); continue; }\n"
         "      const unsigned k_u = ring_u + s * 2 * W::TILE64;")]),
    "flash_attention_bwd dk/dv pass first ring of loads only": ("flash_attention", [
        ("        if (i >= WB_STAGES) mbar_wait(empty + 8 * s, (i / WB_STAGES - 1) & 1);\n"
         "        const unsigned st_u = ring_u + s * 2 * W::TILEQ;",
         "        if (i >= WB_STAGES) { mbar_wait(empty + 8 * s, (i / WB_STAGES - 1) & 1);\n"
         "          mbar_arrive(full + 8 * s); continue; }\n"
         "        const unsigned st_u = ring_u + s * 2 * W::TILEQ;")]),
    "flash_attention_bwd dq pass ring only (first ring of loads, no products, no exp)": (
        "flash_attention", _DQ_NO_PRODUCTS + _DQ_NO_EXP + [
            ("      if (i >= WB_STAGES) mbar_wait(empty + 8 * s, (i / WB_STAGES - 1) & 1);\n"
             "      const unsigned k_u = ring_u + s * 2 * W::TILE64;",
             "      if (i >= WB_STAGES) { mbar_wait(empty + 8 * s, (i / WB_STAGES - 1) & 1);\n"
             "        mbar_arrive(full + 8 * s); continue; }\n"
             "      const unsigned k_u = ring_u + s * 2 * W::TILE64;")]),
    "flash_attention_bwd dk/dv pass ring only (first ring of loads, no products, no exp)": (
        "flash_attention", _DKDV_NO_PRODUCTS + _DKDV_NO_EXP + [
            ("        if (i >= WB_STAGES) mbar_wait(empty + 8 * s, (i / WB_STAGES - 1) & 1);\n"
             "        const unsigned st_u = ring_u + s * 2 * W::TILEQ;",
             "        if (i >= WB_STAGES) { mbar_wait(empty + 8 * s, (i / WB_STAGES - 1) & 1);\n"
             "          mbar_arrive(full + 8 * s); continue; }\n"
             "        const unsigned st_u = ring_u + s * 2 * W::TILEQ;")]),
    "flash_attention_bwd dk/dv pass no products": (
        "flash_attention", _DKDV_NO_PRODUCTS),
    "flash_attention_bwd dk/dv pass no exp": ("flash_attention", _DKDV_NO_EXP),
    "flash_attention_bwd dk/dv pass loads only": (
        "flash_attention", _DKDV_NO_PRODUCTS + _DKDV_NO_EXP),
    "adaln_modulate_bwd": ("adaln_modulate", []),
    "adaln_modulate_bwd no tile sums (no second launch)": ("adaln_modulate", [
        _MOD_NO_TILE_SUMS]),
    "adaln_modulate_bwd dx only (no partial sums)": ("adaln_modulate", [
        _MOD_NO_TILE_SUMS,
        ("        pc[q] = a;\n        pc[q + D / 4] = ax;", "        (void)a;\n        (void)ax;"),
        ("  __syncthreads();\n  float* pg = part + (b * gridDim.x + blockIdx.x) * 2LL * D;  "
         "// [sum g | sum g x_hat]\n  for (int c = threadIdx.x; c < 2 * D; c += rows_threads<T>()) {",
         "  if (D > 0) return;\n  float* pg = part + (b * gridDim.x + blockIdx.x) * 2LL * D;\n"
         "  for (int c = threadIdx.x; c < 2 * D; c += rows_threads<T>()) {")]),
    "gate_residual_bwd": ("adaln_modulate", []),
    "gate_residual_bwd no tile sums (no second launch)": ("adaln_modulate", [
        _GATE_NO_TILE_SUMS]),
    # the partial rows dropped: the y loads and the products go with them
    "gate_residual_bwd g loads and dy stores only": ("adaln_modulate", [
        _GATE_NO_TILE_SUMS,
        ("  // the tile's partial row: the groups' sums in group order\n",
         "  if (T_ > 0) return;\n")]),
    "quant_matmul": ("quant_matmul", []),
    "quant_matmul no product": ("quant_matmul", [
        ("        wgmma_n144_rs(acc, a[kk], smem_desc(x_u + kk * 32, 16, 1024, 1));",
         "        if (nk < 0) wgmma_n144_rs(acc, a[kk], smem_desc(x_u + kk * 32, 16, 1024, 1));")]),
    "quant_matmul no widening": ("quant_matmul", [
        ("        a_fragment<WT>(r[(kk & 1) * 2], r[(kk & 1) * 2 + 1], a[kk]);",
         "        a[kk][0] = a[kk][1] = r[(kk & 1) * 2];\n"
         "        a[kk][2] = a[kk][3] = r[(kk & 1) * 2 + 1];")]),
    "quant_matmul first ring of loads only": ("quant_matmul", [
        ("        if (g >= STAGES) mbar_wait(empty + 8 * s, (g / STAGES - 1) & 1);\n",
         "        if (g >= STAGES) { mbar_wait(empty + 8 * s, (g / STAGES - 1) & 1);\n"
         "          mbar_arrive(full + 8 * s); continue; }\n")]),
    "adaln_modulate": ("adaln_modulate", []),
    "adaln_modulate no reductions (constant mean and variance)": (
        "adaln_modulate", _NO_STATS),
    "adaln_modulate no conditioning loads": ("adaln_modulate", _NO_COND),
    "adaln_modulate loads and stores only": ("adaln_modulate", [
        *_NO_STATS, *_NO_COND,
        ("            f[i] = modulated(xv[j].get(i), mu, r, csc[j].get(i), "
         "csh[j].get(i));", "            f[i] = xv[j].get(i);")]),
    # a (bf16, 8-byte, 32 lanes, 9 chunks) register body of both kernels
    "adaln_modulate 8-byte accesses": ("adaln_modulate", [
        ("    ROW_BODY(DTYPE_BF16, bf16, 16, 32, 5),\n",
         "    ROW_BODY(DTYPE_BF16, bf16, 16, 32, 5),\n"
         "    ROW_BODY(DTYPE_BF16, bf16, 8, 32, 9),\n")]),
    "gate_residual loads and stores only (resid + y, no gate loads)": (
        "adaln_modulate", [
            ("      if (c < nvec) cg[j].load(g + c * VEC);", "      (void)c;"),
            ("          for (int i = 0; i < VEC; ++i) f[i] = gated(rv[j].get(i), "
             "cg[j].get(i), yv[j].get(i));",
             "          for (int i = 0; i < VEC; ++i) f[i] = rv[j].get(i) + "
             "yv[j].get(i);")]),
    "quant_matmul skinny no products": ("quant_matmul", [
        ("              mma_16816(acc[2 * q + h][mt], a, bx[mt][0], bx[mt][1]);",
         "              acc[2 * q + h][mt][0] += __uint_as_float("
         "(a[0] ^ a[1] ^ a[2] ^ a[3]) & bx[mt][0] & bx[mt][1]);")]),
    "quant_matmul skinny no widening": ("quant_matmul", [
        ("          for (int r = 0; r < 4; ++r) widen4<WT>(v[u][r][q], f[r]);",
         "          for (int r = 0; r < 4; ++r)\n"
         "            for (int c = 0; c < 4; ++c) f[r][c] = __uint_as_float(v[u][r][q] << (8 * c));")]),
    "quant_matmul skinny no x loads": ("quant_matmul", [_SKINNY_NO_X]),
    "quant_matmul skinny no weight loads": ("quant_matmul", [_SKINNY_NO_W]),
    "quant_matmul skinny no loads": ("quant_matmul", [_SKINNY_NO_X, _SKINNY_NO_W]),
    # 16-warp blocks: launch bounds of 512 threads hold a thread to 128
    # registers, so a warp loads 5 of its groups at once, not 9
    "quant_matmul skinny 16-warp blocks": ("quant_matmul", [
        ("constexpr int SK_MAX_SPLIT = 8;", "constexpr int SK_MAX_SPLIT = 16;"),
        ("  return m_tiles == 2 ? 9 :", "  return m_tiles == 2 ? 5 :")]),
    "unipc_update": ("unipc_update", []),
    "unipc_update no weight prologue (explicit weights)": (
        "unipc_update", [_ROW_EXPLICIT]),
    "unipc_update no ring write": ("unipc_update", [_ROW_NO_RING]),
}

# plans the adaLN libraries are timed on, as edits of plan()'s at the main
# shape (B 16, T 256: 256 blocks of 8 warps, 2 rows a warp):
# {ablation: {label: edit}}
ADALN_PLANS = {
    "adaln_modulate": {
        "": lambda p: p,
        ", grid of all rows (512 blocks, 1 row a warp)": lambda p: dict(
            p, blocks=16 * 32),
        ", grid-stride, 128 blocks, 4 rows a warp": lambda p: dict(
            p, blocks=16 * 8),
        ", grid-stride, 64 blocks, 8 rows a warp": lambda p: dict(
            p, blocks=16 * 4),
        ", 4-warp blocks (512 blocks, 2 rows a warp)": lambda p: dict(
            p, rows_per_block=4, blocks=16 * 32),
    },
    "adaln_modulate 8-byte accesses": {
        ", 9 chunks a lane": lambda p: dict(p, access_bytes=8, chunks=9)},
}
# gate_residual's plans on the adaLN libraries, at the main shape (the
# plan: 256 blocks of 8 warps, 2 rows a warp)
GATE_PLANS = {
    "adaln_modulate": {
        "": lambda p: p,
        ", grid of all rows (512 blocks, 1 row a warp)": lambda p: dict(
            p, blocks=16 * 32)},
    "adaln_modulate 8-byte accesses": {
        ", 8-byte accesses, 9 chunks a lane": lambda p: dict(
            p, access_bytes=8, chunks=9)},
    "gate_residual loads and stores only (resid + y, no gate loads)": {
        "": lambda p: p},
}
# gate_residual_bwd's plans at the DiT's training shape (8, 256, 1152)
# bf16, as plan_gate_bwd makes them with other targets: (blocks an SM,
# threads a block); the first is the plan's own
GATE_BWD_TARGETS = [(2, 256), (1, 256), (4, 256), (2, 128), (4, 128),
                    (1, 432), (2, 432)]
# the skinny body's plans at the adaLN sites (the plan: split 8)
SKINNY_PLANS = {
    "quant_matmul": {
        "": lambda p: p,
        ", half the split (4 warps a block)": lambda p: dict(p, split=4)},
    "quant_matmul skinny 16-warp blocks": {
        ", double the split (16 warps a block)": lambda p: dict(p, split=16)},
    **{name: {"": lambda p: p} for name in (
        "quant_matmul skinny no products", "quant_matmul skinny no widening",
        "quant_matmul skinny no x loads", "quant_matmul skinny no weight loads",
        "quant_matmul skinny no loads")},
}

# the row ops' plans at the main state (the plan: 16-byte accesses, 16
# blocks of 128 threads a row, one access a thread: it is already the grid
# of all rows' accesses)
ROW_PLANS = {
    "unipc_update": {
        "": lambda p: p,
        ", 4-byte accesses (one element), the plan's grid (4 a thread)":
            lambda p: dict(p, access_bytes=4),
        ", 4-byte accesses, grid of all rows' accesses (64 blocks a row)":
            lambda p: dict(p, access_bytes=4, blocks_per_row=64),
        ", grid of all rows' accesses": lambda p: p,
        ", a quarter of the grid (4 accesses a thread)": lambda p: dict(
            p, blocks_per_row=4),
        ", 256-thread blocks": lambda p: dict(p, threads=256,
                                              blocks_per_row=8)},
    "unipc_update no weight prologue (explicit weights)": {"": lambda p: p},
    "unipc_update no ring write": {"": lambda p: p},
}


def build_all(only: str = "") -> dict:
    """Compile every ablation whose name contains `only` in parallel;
    {name: library path}."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, procs = build._nvcc(), {}
    for i, (name, (src, edits)) in enumerate(ABLATIONS.items()):
        if only not in name:
            continue
        text = (build.CSRC / f"{src}.cu").read_text()
        for anchor, repl in edits:
            if anchor not in text:
                raise SystemExit(f"ablation {name!r}: anchor not in {src}.cu:\n{anchor}")
            text = text.replace(anchor, repl)
        cu, so = OUT / f"a{i}_{src}.cu", OUT / f"a{i}_{src}.so"
        cu.write_text(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name!r}:\n{log[-4000:]}")
        libs[name] = so
    return libs


def use(src: str, so: Path) -> None:
    """Point the kernel wrapper of `src` at the library `so`."""
    from repro_torch.kernels.adaln_modulate import kernel as adaln_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.quant_matmul import kernel as qmm_kernel
    from repro_torch.kernels.unipc_update import kernel as uni_kernel

    lib = ctypes.CDLL(str(so))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    build._LIBS[src] = lib
    for launcher in {"flash_attention": (fa_kernel._launcher,
                                         fa_kernel._bwd_launcher),
                     "quant_matmul": (qmm_kernel._launcher,),
                     "adaln_modulate": (adaln_kernel._launchers,
                                        adaln_kernel._bwd_launchers),
                     "unipc_update": (uni_kernel._launcher,)}[src]:
        launcher.cache_clear()


def row_operands(dev, g) -> dict:
    """{op: (mode, RowArgs, like, plan, operands)} of the row ops at the
    main state (8 requests of 256 x 32 fp32 latents, a ring of 3, the nfe
    10 order 3 table, uniform row 5), each RowArgs also carrying the
    explicit weights that the no-prologue ablation reads (and the others
    ignore); `operands` holds the tensors its pointers point into."""
    from repro_torch.core.coeffs import augment_step_rows
    from repro_torch.core.unipc import rows_on
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec, SamplerEngine
    from repro_torch.kernels.unipc_update import kernel as uni_kernel
    from repro_torch.kernels.unipc_update import ops as uni_ops

    tab = SamplerEngine(VPLinear(), eps=None).compile(
        EngineSpec(nfe=10, order=3, cfg_scale=2.0))
    rows = uni_ops.pack_weight_rows(rows_on(augment_step_rows(tab), dev))
    K = tab.w_pred.shape[1]
    x, e_new, x_pred = (torch.randn(8, 256, 32, generator=g, device=dev)
                        for _ in range(3))
    E = torch.randn(K + 1, 8, 256, 32, generator=g, device=dev)
    idx = torch.tensor(5, device=dev)
    weights = torch.randn(uni_kernel.MAX_TERMS + 1, generator=g, device=dev)
    out, E_next = torch.empty_like(x), torch.empty_like(E)
    ops = {}
    for op, mode in (("predict", uni_kernel.PREDICT),
                     ("correct", uni_kernel.CORRECT)):
        args, bits = uni_kernel._row_args(x, E, rows, idx, tab.sign, out)
        args.weights = weights.data_ptr()
        if mode == uni_kernel.CORRECT:
            args.e_new, args.rs_e = e_new.data_ptr(), 256 * 32
            args.x_pred, args.rs_xp = x_pred.data_ptr(), 256 * 32
            args.ring_out = E_next.data_ptr()
        ops[op] = (mode, args, x, uni_kernel._plan(bits, 4, 8, 256 * 32, x),
                   (x, E, e_new, x_pred, out, E_next, rows, idx, weights))
    return ops


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ablate_kernels.py needs a CUDA card")
    from repro_torch.kernels.adaln_modulate import kernel as adaln_kernel
    from repro_torch.kernels.adaln_modulate import ops as adaln_ops
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.quant_matmul import kernel as qmm_kernel
    from repro_torch.kernels.quant_matmul import ref as qmm_ref
    from repro_torch.kernels.unipc_update import kernel as uni_kernel

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}")
    libs = build_all(sys.argv[1] if len(sys.argv) > 1 else "")
    g = torch.Generator(device=dev).manual_seed(0)
    # flash_attention at the dit-i256 shape, head-major views as in the model
    q, k, v = (torch.randn(16, 256, 16, 72, generator=g, device=dev).to(
        torch.bfloat16).transpose(1, 2) for _ in range(3))
    # quant_matmul w8a16 at the three token sites
    sites = {}
    for site, (M, K, N) in {"wq": (4096, 1152, 1152), "w1": (4096, 1152, 4608),
                            "w2": (4096, 4608, 1152)}.items():
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        qw, ws = qmm_ref.quantize(torch.randn(K, N, generator=g, device=dev))
        sites[site] = (x, qw, ws.float().contiguous())
    # adaln_modulate at the dit-i256 block shape, shift/scale read in place
    # from the (16, 6 x 1152) modulation as the DiT does
    bf = torch.bfloat16
    xm = torch.randn(16, 256, 1152, generator=g, device=dev).to(bf)
    mod = torch.randn(16, 6 * 1152, generator=g, device=dev).to(bf)
    msh, msc, mout = mod[:, :1152], mod[:, 1152:2304], torch.empty_like(xm)
    mod_plan = adaln_kernel.plan(xm, msh, msc, mout)
    bound_ms, by = chip_smoke.bound(adaln_ops.cost_modulate(xm, msh, msc))
    print(f"adaln_modulate bound {bound_ms:.5f} ms ({by}); plan {mod_plan}")
    # gate_residual at the same shape, the gate read in place from the
    # modulation, in the graph and on six sets of operands (170 MB)
    gsets = [(torch.randn(16, 256, 1152, generator=g, device=dev).to(bf),
              torch.randn(16, 6 * 1152, generator=g, device=dev).to(bf)[
                  :, 2304:3456],
              torch.randn(16, 256, 1152, generator=g, device=dev).to(bf),
              torch.empty_like(xm)) for _ in range(6)]
    gate_plan = adaln_kernel.plan_gate(*gsets[0])
    bound_ms, by = chip_smoke.bound(adaln_ops.cost_gate(*gsets[0][:3]))
    print(f"gate_residual bound {bound_ms:.6f} ms ({by}); plan {gate_plan}")
    # quant_matmul w8a16 at the two adaLN sites, and on weights rotated
    # over 100 MB
    skinny = {}
    for site, (M, K, N) in {"ada": (16, 1152, 6912),
                            "final_ada": (16, 1152, 2304)}.items():
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        ws_ = [qmm_ref.quantize(torch.randn(K, N, generator=g, device=dev))
               for _ in range(-(-100_000_000 // (K * N)) + 1)]
        skinny[site] = (x, [w for w, _ in ws_], ws_[0][1].float().contiguous(),
                        torch.empty(M, N, dtype=torch.bfloat16, device=dev))
    rows = row_operands(dev, g)
    # modulate_bwd at the DiT's training shape, scale read in place
    xb, gb = (torch.randn(8, 256, 1152, generator=g, device=dev).to(bf)
              for _ in range(2))
    sb = torch.randn(8, 6 * 1152, generator=g, device=dev).to(bf)[:, 1152:2304]
    # gate_residual_bwd at the same shape, the gate read in place
    yb = torch.randn(8, 256, 1152, generator=g, device=dev).to(bf)
    gtb = torch.randn(8, 6 * 1152, generator=g, device=dev).to(bf)[
        :, 2304:3456]
    print(f"gate_residual_bwd bound "
          f"{chip_smoke.bound(adaln_ops.cost_gate_bwd(gb, gtb, yb))[0]:.6f} "
          f"ms; plan {adaln_kernel.plan_gate_bwd(gb, gtb, yb, yb)}")
    # flash_attention_bwd (the wgmma body) at qwen2-0.5b's AR step and
    # whisper's encoder, the forward's lse and o32 from the unedited library
    bwd_cases = {}
    for label, (B, Hq, Hkv, S, D, causal) in {
            "qwen2-0.5b AR (8, 14/2, 512, 64) causal": (8, 14, 2, 512, 64, True),
            "whisper encoder (8, 12, 1500, 64)": (8, 12, 12, 1500, 64, False)}.items():
        qb, dob = (torch.randn(B, S, Hq, D, generator=g, device=dev).to(bf)
                   .transpose(1, 2) for _ in range(2))
        kb, vb = (torch.randn(B, S, Hkv, D, generator=g, device=dev).to(bf)
                  .transpose(1, 2) for _ in range(2))
        _, lse, o32 = fa_kernel.flash_attention(qb, kb, vb, causal=causal, lse=True)
        bwd_cases[label] = (qb, kb, vb, o32, lse, dob, causal)
    for name, so in libs.items():
        src = ABLATIONS[name][0]
        use(src, so)
        if src == "unipc_update":
            for label, edit in ROW_PLANS[name].items():
                times = {op: chip_smoke.device_ms(functools.partial(
                    uni_kernel._launch, mode, args, like, edit(p)))
                    for op, (mode, args, like, p, _) in rows.items()}
                print(f"row ops [{name}]{label}: " + ", ".join(
                    f"{op} {t:.6f} ms" for op, t in times.items()))
        elif name.startswith("gate_residual_bwd"):
            targets = (GATE_BWD_TARGETS if name == "gate_residual_bwd"
                       else GATE_BWD_TARGETS[:1])
            for per_sm, threads in targets:
                kept = (adaln_kernel.GATE_BWD_BLOCKS_PER_SM,
                        adaln_kernel.GATE_BWD_THREADS)
                adaln_kernel.GATE_BWD_BLOCKS_PER_SM = per_sm
                adaln_kernel.GATE_BWD_THREADS = threads
                try:
                    gp = adaln_kernel.plan_gate_bwd(gb, gtb, yb, yb)
                finally:
                    (adaln_kernel.GATE_BWD_BLOCKS_PER_SM,
                     adaln_kernel.GATE_BWD_THREADS) = kept
                ms = chip_smoke.device_ms(functools.partial(
                    adaln_kernel._launch_gate_bwd, gb, gtb, yb,
                    torch.empty_like(yb), gp))
                print(f"{name} (8, 256, 1152) bf16, {gp['blocks']} blocks "
                      f"of {gp['cols']} x {gp['groups']}, "
                      f"{gp['rows_per_thread']} rows a thread, "
                      f"{gp['tiles']} tiles: {ms:.6f} ms")
        elif name.startswith("adaln_modulate_bwd"):
            held = adaln_kernel.BWD_ROWS_THREADS[bf] // 32  # rows a block at once
            for turns in (1, 2, 4):  # rows a warp takes
                bp = dict(adaln_kernel.plan_bwd(gb, xb, sb, xb),
                          rows_per_group=turns, tiles=256 // (held * turns))
                ms = chip_smoke.device_ms(functools.partial(
                    adaln_kernel._launch_modulate_bwd, gb, xb, sb,
                    torch.empty_like(xb), 1e-5, bp))
                print(f"{name} (8, 256, 1152) bf16, {turns} rows a warp "
                      f"({8 * bp['tiles']} blocks of {held} warps): {ms:.6f} ms")
        elif src == "adaln_modulate":
            mod_plans = {} if name.startswith("gate_residual") else {
                "": lambda p: p}
            for label, edit in ADALN_PLANS.get(name, mod_plans).items():
                ms = chip_smoke.device_ms(functools.partial(
                    adaln_kernel._launch_modulate, xm, msh, msc, mout, 1e-5,
                    edit(mod_plan)))
                print(f"{name}{label}: {ms:.5f} ms")
            for label, edit in GATE_PLANS.get(name, {}).items():
                gp = edit(gate_plan)
                ms = chip_smoke.device_ms(functools.partial(
                    adaln_kernel._launch_gate, *gsets[0], gp))
                rot = chip_smoke.rotated_ms([functools.partial(
                    adaln_kernel._launch_gate, *a, gp) for a in gsets])
                print(f"gate_residual [{name}]{label}: graph {ms:.5f} ms, "
                      f"rotated {rot:.5f} ms")
        elif name.startswith("flash_attention_bwd"):
            print(f"{name}: " + ", ".join(
                f"{label} {chip_smoke.device_ms(functools.partial(fa_kernel.flash_attention_bwd, qb, kb, vb, o32, lse, dob, causal=causal)):.6f} ms"
                for label, (qb, kb, vb, o32, lse, dob, causal) in bwd_cases.items()))
        elif src == "flash_attention":
            ms = chip_smoke.device_ms(functools.partial(
                fa_kernel.flash_attention, q, k, v, causal=False))
            print(f"{name}: {ms:.5f} ms")
        else:
            if "skinny" not in name:
                times = {site: chip_smoke.device_ms(functools.partial(
                    qmm_kernel.quant_matmul, x, qw, sc,
                    out_dtype=torch.bfloat16))
                    for site, (x, qw, sc) in sites.items()}
                print(f"{name}: " + ", ".join(f"{s} {t:.5f} ms"
                                              for s, t in times.items()))
            for label, edit in SKINNY_PLANS.get(name, {}).items():
                parts = []
                for site, (x, wts, sc, o) in skinny.items():
                    sp = edit(qmm_kernel.plan(x, wts[0]))
                    ms = chip_smoke.device_ms(functools.partial(
                        qmm_kernel._launch, x, wts[0], sc, o, sp))
                    rot = chip_smoke.rotated_ms([functools.partial(
                        qmm_kernel._launch, x, w, sc, o, sp) for w in wts])
                    parts.append(f"{site} graph {ms:.5f} ms, rotated "
                                 f"{rot:.5f} ms")
                print(f"skinny [{name}]{label}: " + "; ".join(parts))


if __name__ == "__main__":
    main()
