#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (`src/repro_torch`).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits non-zero):
  1. device — the card, its power limit, torch/CUDA versions; TF32 off.
  2. build  — nvcc builds every kernel of the main path from `csrc/`.
  3. kernels — each kernel against its plain PyTorch version at the main
     path's shapes (and a ragged / GQA case), timed on the device (a CUDA
     graph of many calls, replayed between CUDA events) beside its bound,
     its plain version and one PyTorch library call; the wrapper's host
     cost per call is reported apart.
  4. main path — guided UniPC sampling of full-width dit-i256 (28 blocks,
     d_model 1152, 16 heads of dim 72, bf16 activations, fp32 params) through
     `repro_torch.launch.sample.sample`: launch counts, kernel vs plain-pinned
     latents, a reduced-size card vs CPU check, wall time and peak memory.
  5. serving step — four requests admitted at staggered ticks into a
     per-slot `StepProgram` at full width (fp32 activations), and a fifth
     re-admitted into the slot the first one freed (over its stale eval
     ring and class id); each held against a batch-1 uniform run, and one
     uniform run held against the plain-pinned path at fp32.
The last two lines are the kernels JSON and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
MAIN_TOL = 1e-2     # bf16 eval bound (DESIGN.md §11.3)
# Two bf16 implementations differ by single-ulp roundings (2^-8 relative)
# of eps; guidance 2.0 takes 3 e_cond - 2 e_uncond (5x), and the latents'
# L-inf scale is |x_T| / alpha_T while eps enters as sigma / alpha_T times
# eps: the floor of the main path's kernel-vs-plain rel L-inf is about
# 5 * 2^-8 * max|eps| / max|x_T|. With out_proj at 0.02 N(0, 1) (eps std
# ~0.7) it measured 1.1e-2 with either attention body; at 0.01 the floor is
# about half the bound. A wrong kernel moves eps by O(1) of itself and the
# latents by far more than 1e-2; the fp32 checks hold the kernels at 1e-4.
OUT_PROJ_SCALE = 0.01
SERVE_TOL = 1e-4
SMALL_TOL = 1e-4


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def device_ms(fn, iters: int = 100, reps: int = 5) -> float:
    """Device ms per call: `iters` calls captured in one CUDA graph, the
    graph replayed `reps` times between CUDA events. No host cost is in the
    measurement (the Python/ctypes wrapper runs once, at capture). The
    working sets fit the 50 MB L2, as on the main path where each op reads
    what the previous one just wrote."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


def host_call_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean ms per call over `iters` eager back-to-back calls between CUDA
    events: for a kernel shorter than its wrapper's host cost this is the
    rate the host can launch at, not the kernel's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def kernel_phase(dev) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.adaln_modulate import ops as adaln_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.unipc_update import ops as uni_ops

    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    out = {}

    def record(name, cases, timed):
        """cases: [(label, kernel_out, plain_out, dtype)]; timed: (kernel
        fn, plain fn, library fn or None, bytes, flops, dtype)."""
        errs = []
        for label, k_out, p_out, dt in cases:
            torch.cuda.synchronize()
            if not torch.isfinite(k_out.float()).all():
                fail(f"{name} [{label}]: non-finite kernel output")
            err = rel_err(k_out, p_out)
            abs_err = float((k_out.double() - p_out.double()).abs().max())
            print(f"  {name} [{label}] rel L-inf {err:.3e} (tol {TOL[dt]:g}) "
                  f"abs {abs_err:.3e}")
            if not err <= TOL[dt]:
                fail(f"{name} [{label}] disagrees with its plain version: "
                     f"rel {err:.3e} > {TOL[dt]:g}")
            errs.append((label, err, abs_err))
        k_fn, p_fn, lib_fn, b, fl, dt = timed
        bms, by = bound(b, fl, dt)
        out[name] = dict(
            max_abs_err=max(a for _, _, a in errs),
            max_rel_err=max(e for _, e, _ in errs),
            cases={label: e for label, e, _ in errs},
            ms=device_ms(k_fn), host_call_ms=host_call_ms(k_fn),
            plain_ms=device_ms(p_fn),
            library_ms=device_ms(lib_fn) if lib_fn is not None else None,
            bound_ms=bms, bound_by=by)

    # B1 unipc_update at the main path's state (8 requests, 256 x 32 fp32):
    # the predictor's 4 terms with (K,) weights, the corrector's 5 with
    # per-slot (K, B) weights, and a ragged bf16 case.
    t4 = randn(4, 8, 256, 32)
    w4 = randn(4)
    t5 = randn(5, 8, 256, 32)
    w5b = randn(5, 8)
    tr = randn(6, 3, 1000, dtype=torch.bfloat16)
    wr = randn(6, 3)
    cases = [
        ("main (K,) K=4 fp32", uni_ops.weighted_combine(t4, w4),
         uni_ops.weighted_combine(t4, w4, backend="plain"), torch.float32),
        ("per-slot (K,B) K=5 fp32", uni_ops.weighted_combine(t5, w5b),
         uni_ops.weighted_combine(t5, w5b, backend="plain"), torch.float32),
        ("ragged N=1000 bf16", uni_ops.weighted_combine(tr, wr),
         uni_ops.weighted_combine(tr, wr, backend="plain"), torch.bfloat16),
    ]
    record("unipc_update", cases, (
        lambda: uni_ops.weighted_combine(t4, w4),
        lambda: uni_ops.weighted_combine(t4, w4, backend="plain"),
        lambda: torch.einsum("k,kbtl->btl", w4, t4),
        nbytes(t4, w4) + nbytes(t4[0]), 2 * t4.numel(), torch.float32))

    # B2/B3 at the dit-i256 block shape: net batch 16 (8 requests x CFG),
    # T = 256, D = 1152, bf16, conditioning read in place from the (B, 6D)
    # modulation vector as the DiT does.
    B, T, D = 16, 256, 1152
    x = randn(B, T, D, dtype=torch.bfloat16)
    y = randn(B, T, D, dtype=torch.bfloat16)
    mod = randn(B, 6 * D, dtype=torch.bfloat16)
    sh, sc, gt = mod[:, :D], mod[:, D:2 * D], mod[:, 2 * D:3 * D]
    xr = randn(2, 37, 72)
    modr = randn(2, 2 * 72)
    cases = [
        ("main bf16 D=1152", adaln_ops.modulate(x, sh, sc),
         adaln_ops.modulate(x, sh, sc, backend="plain"), torch.bfloat16),
        ("ragged T=37 D=72 fp32",
         adaln_ops.modulate(xr, modr[:, :72], modr[:, 72:]),
         adaln_ops.modulate(xr, modr[:, :72], modr[:, 72:], backend="plain"),
         torch.float32),
    ]
    record("adaln_modulate", cases, (
        lambda: adaln_ops.modulate(x, sh, sc),
        lambda: adaln_ops.modulate(x, sh, sc, backend="plain"),
        None, 2 * nbytes(x) + nbytes(sh, sc), 8 * x.numel(), torch.float32))
    cases = [
        ("main bf16 D=1152", adaln_ops.gate_residual(x, gt, y),
         adaln_ops.gate_residual(x, gt, y, backend="plain"), torch.bfloat16),
        ("ragged T=37 D=72 fp32",
         adaln_ops.gate_residual(xr, modr[:, :72], xr * 0.5),
         adaln_ops.gate_residual(xr, modr[:, :72], xr * 0.5, backend="plain"),
         torch.float32),
    ]
    record("gate_residual", cases, (
        lambda: adaln_ops.gate_residual(x, gt, y),
        lambda: adaln_ops.gate_residual(x, gt, y, backend="plain"),
        lambda: torch.addcmul(x, gt[:, None], y),
        3 * nbytes(x) + nbytes(gt), 2 * x.numel(), torch.float32))

    # B4 flash_attention at the dit-i256 shape: net batch 16, 16 heads,
    # S = 256, head dim 72, bf16, non-causal; q/k/v are head-major views of
    # (B, S, H, D) projections as in the model. Plus the reduced config's
    # GQA (4 q heads over 2 kv heads, D = 32) at a ragged S, and causal.
    H, S, Dh = 16, 256, 72
    q, k, v = (randn(B, S, H, Dh, dtype=torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    qg = randn(2, 4, 100, 32)
    kg, vg = randn(2, 2, 100, 32), randn(2, 2, 100, 32)
    # D = 36 is no multiple of 8: the bf16 body's 2-byte tile loads
    qo = randn(2, 4, 100, 36, dtype=torch.bfloat16)
    ko, vo = (randn(2, 2, 100, 36, dtype=torch.bfloat16) for _ in range(2))
    cases = [
        ("main bf16 D=72", fa_ops.attention(q, k, v, causal=False),
         fa_ops.attention(q, k, v, causal=False, backend="plain"),
         torch.bfloat16),
        ("GQA 4/2 D=32 S=100 fp32", fa_ops.attention(qg, kg, vg, causal=False),
         fa_ops.attention(qg, kg, vg, causal=False, backend="plain"),
         torch.float32),
        ("GQA causal window=40 fp32",
         fa_ops.attention(qg, kg, vg, causal=True, window=40),
         fa_ops.attention(qg, kg, vg, causal=True, window=40, backend="plain"),
         torch.float32),
        ("GQA causal D=36 S=100 bf16",
         fa_ops.attention(qo, ko, vo, causal=True),
         fa_ops.attention(qo, ko, vo, causal=True, backend="plain"),
         torch.bfloat16),
    ]
    record("flash_attention", cases, (
        lambda: fa_ops.attention(q, k, v, causal=False),
        lambda: fa_ops.attention(q, k, v, causal=False, backend="plain"),
        lambda: F.scaled_dot_product_attention(q, k, v),
        4 * nbytes(q), 4 * B * H * S * S * Dh, torch.bfloat16))
    return out


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------


def perturbed_params(cfg, dev, seed=0):
    """init_params with the zero-initialised adaLN and output weights
    perturbed: under adaLN-zero the untrained DiT's output is otherwise
    exactly zero and every comparison vacuous. The adaLN weights get
    0.02 N(0, 1); out_proj gets OUT_PROJ_SCALE N(0, 1), which sets the eps
    scale (std ~ 34 x scale at d_model 1152)."""
    from repro_torch.models import api

    params = api.init_params(cfg, seed, dev)
    bb = params["backbone"]
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    for tree, key, scale in (
            (bb["blocks"], "ada", 0.02), (bb["blocks"], "ada_b", 0.02),
            (bb, "final_ada", 0.02), (bb, "final_ada_b", 0.02),
            (bb, "out_proj", OUT_PROJ_SCALE)):
        tree[key] = tree[key] + scale * torch.randn(
            tree[key].shape, generator=g, device=dev, dtype=tree[key].dtype)
    return params


def main_path_phase(dev, counts_out: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.sample import build_engine, latent_shape, sample

    batch, nfe, order, g_scale = 8, 10, 3, 2.0
    cfg = get_config("dit-i256")
    assert cfg.dtype == "bfloat16" and cfg.head_dim == 72
    params = perturbed_params(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    x_T = torch.randn(latent_shape(cfg, batch), generator=gen, device=dev)

    # every op pinned to its plain version, same params and x_T
    plain_cfg = dataclasses.replace(cfg, attention_backend="plain",
                                    adaln_backend="plain")
    engine = build_engine(plain_cfg, params, VPLinear(), batch, seed=0,
                          device=dev)
    spec = EngineSpec(nfe=nfe, order=order, cfg_scale=g_scale,
                      fused_update=False)
    LAUNCHES.clear()
    x_plain = engine.build(spec)(x_T)
    torch.cuda.synchronize()
    if sum(LAUNCHES.values()):
        fail(f"the plain-pinned run launched kernels: {dict(LAUNCHES)}")

    # the main path, through the user's entry point, counted
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x0 = sample("dit-i256", reduced=False, nfe=nfe, order=order,
                cfg_scale=g_scale, batch=batch, params=params, x_T=x_T,
                device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts_out.update(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)

    rows = nfe + 1
    expected = {"unipc_update": 2 * rows,
                "adaln_modulate": (2 * cfg.num_layers + 1) * rows,
                "gate_residual": 2 * cfg.num_layers * rows,
                "flash_attention": cfg.num_layers * rows}
    print(f"  launches {dict(sorted(counts_out.items()))} expected {expected}")
    if dict(counts_out) != expected:
        fail(f"launch counts {dict(counts_out)} != expected {expected}")
    if x0.shape != tuple(x_T.shape) or not np.isfinite(x0).all():
        fail(f"main path output shape {x0.shape} / finite "
             f"{np.isfinite(x0).all()}")
    err = rel_err(torch.as_tensor(x0), x_plain.cpu())
    print(f"  kernel vs plain latents: rel L-inf {err:.3e} (tol {MAIN_TOL:g})")
    if not err <= MAIN_TOL:
        fail(f"main path latents disagree with the plain path: {err:.3e}")
    print(f"  wall {wall:.3f} s for {batch} requests = "
          f"{wall / batch * 1e3:.1f} ms per request end to end; peak memory "
          f"{peak / 2**30:.2f} GiB")

    # a small input through the kernels on the card and the plain path on
    # the CPU: the reduced config (fp32, GQA 4/2, head dim 32)
    small = get_config("dit-i256").reduced()
    sp = perturbed_params(small, "cpu", seed=3)
    xs = torch.randn(latent_shape(small, 2), generator=torch.Generator(
        device="cpu").manual_seed(5))
    on_card = sample("dit-i256", reduced=True, nfe=5, order=3, cfg_scale=2.0,
                     batch=2, params=sp, x_T=xs, device=dev)
    on_cpu = sample("dit-i256", reduced=True, nfe=5, order=3, cfg_scale=2.0,
                    batch=2, params=sp, x_T=xs, device="cpu")
    small_err = rel_err(torch.as_tensor(on_card), torch.as_tensor(on_cpu))
    print(f"  reduced dit-i256, card kernels vs CPU plain: rel L-inf "
          f"{small_err:.3e} (tol {SMALL_TOL:g})")
    if not small_err <= SMALL_TOL:
        fail(f"reduced-size card vs CPU disagree: {small_err:.3e}")
    return dict(wall_s=wall, ms_per_request=wall / batch * 1e3,
                peak_bytes=peak, rel_err_vs_plain=err, rows=rows,
                small_rel_err=small_err)


# --------------------------------------------------------------------------
# phase 5: the serving step
# --------------------------------------------------------------------------


def serving_phase(dev) -> float:
    from repro_torch.configs import get_config
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec
    from repro_torch.launch.sample import build_engine, latent_shape

    cfg = dataclasses.replace(get_config("dit-i256"), dtype="float32")
    params = perturbed_params(cfg, dev)
    engine = build_engine(cfg, params, VPLinear(), 4, per_request_cond=True,
                          device=dev)
    spec = EngineSpec(nfe=10, order=3, cfg_scale=2.0)
    program = engine.build_step(spec)
    sample_shape = latent_shape(cfg, 1)[1:]
    # the fifth request arrives a tick after the first one finishes (it
    # holds rows 0..n_rows-1 from tick 0), so its freed slot first parks
    # idle on row 0 and is then re-admitted over a stale ring and class
    reuse_tick = program.n_rows + 1
    reqs = []
    for rid, (arrival, g) in enumerate(zip((0, 1, 2, 3, reuse_tick),
                                           (1.0, 2.0, 3.5, 1.5, 2.5))):
        seed = 100 + rid
        x_T = torch.randn(sample_shape, generator=torch.Generator(
            device=dev).manual_seed(seed), device=dev)
        cls = int(np.random.default_rng(seed).integers(0, 1000))
        reqs.append(dict(rid=rid, arrival=arrival, g=g, x_T=x_T, cls=cls))

    slots = 4
    state = program.init_state(slots, sample_shape)
    g_slot = program.init_g(slots)
    cls_slot = torch.zeros(slots, dtype=torch.long, device=dev)
    row = np.zeros(slots, np.int64)
    owner = [None] * slots
    freed = set()                      # slots a finished request has left
    done, tick = {}, 0
    while len(done) < len(reqs):
        for r in reqs:
            if r["arrival"] == tick:
                s = owner.index(None)
                r["slot"], r["reused"] = s, s in freed
                # admission writes the slot in place: its latent, a zeroed
                # eval ring, its guidance scale and class
                x, E = state
                x[s] = r["x_T"]
                E[:, s] = 0
                g_slot[s] = r["g"]
                cls_slot[s] = r["cls"]
                row[s] = 0
                owner[s] = r["rid"]
        busy = np.array([o is not None for o in owner])
        idx = torch.as_tensor(np.where(busy, row, 0), device=dev)
        state = program.step(state, idx, g_slot, {"class_ids": cls_slot})
        row[busy] += 1
        for s in range(slots):
            if owner[s] is not None and row[s] == program.n_rows:
                done[owner[s]] = state[0][s].clone()
                owner[s] = None
                freed.add(s)
        tick += 1
    worst = 0.0
    uniform = {}
    for r in reqs:
        ref = engine.build(dataclasses.replace(spec, cfg_scale=r["g"]))(
            r["x_T"][None], class_ids=torch.tensor([r["cls"]], device=dev))[0]
        uniform[r["rid"]] = ref
        err = rel_err(done[r["rid"]], ref)
        print(f"  request {r['rid']} (arrival {r['arrival']}, slot "
              f"{r['slot']}{' reused' if r['reused'] else ''}, g {r['g']}, "
              f"class {r['cls']}): staggered vs uniform rel L-inf {err:.3e}")
        if not torch.isfinite(done[r["rid"]]).all() or not err <= SERVE_TOL:
            fail(f"request {r['rid']}: staggered step disagrees with its "
                 f"uniform run ({err:.3e} > {SERVE_TOL:g})")
        worst = max(worst, err)
    print(f"  {len(reqs)} requests over {tick} ticks, worst {worst:.3e} "
          f"(tol {SERVE_TOL:g})")
    if not reqs[-1]["reused"]:
        fail("the last request did not land in a slot a finished request "
             "had freed: re-admission went untested")

    # the same fp32 full-width uniform run with every op pinned to its
    # plain version: the kernels at full width, at fp32 precision
    plain_cfg = dataclasses.replace(cfg, attention_backend="plain",
                                    adaln_backend="plain")
    plain = build_engine(plain_cfg, params, VPLinear(), 4,
                         per_request_cond=True, device=dev)
    r = reqs[0]
    x_plain = plain.build(dataclasses.replace(
        spec, cfg_scale=r["g"], fused_update=False))(
            r["x_T"][None], class_ids=torch.tensor([r["cls"]], device=dev))[0]
    fp32_err = rel_err(uniform[r["rid"]], x_plain)
    print(f"  fp32 full width, kernels vs plain (request 0): rel L-inf "
          f"{fp32_err:.3e} (tol {SERVE_TOL:g})")
    if not fp32_err <= SERVE_TOL:
        fail(f"fp32 full-width kernels disagree with the plain path: "
             f"{fp32_err:.3e}")
    return worst, fp32_err


# --------------------------------------------------------------------------


KERNELS = [  # name, source, replaces (TPU kernel file:line), launches per eval
    ("unipc_update", "src/repro_torch/kernels/csrc/unipc_update.cu",
     "src/repro/kernels/unipc_update/kernel.py:48", None),
    ("adaln_modulate", "src/repro_torch/kernels/csrc/adaln_modulate.cu",
     "src/repro/kernels/adaln_modulate/kernel.py:61", 57),
    ("gate_residual", "src/repro_torch/kernels/csrc/adaln_modulate.cu",
     "src/repro/kernels/adaln_modulate/kernel.py:90", 56),
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention/kernel.py:84", 28),
]


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}; run "
             f"it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda:0")

    print("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    name = torch.cuda.get_device_name(0)
    print(f"  {name}; power limit {smi[0].split(',')[-1].strip()}; torch "
          f"{torch.__version__}; CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} card(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== phase 2: build")
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build()
    print(f"  built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s (parallel nvcc, sm_90a)")
    for kname, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {kname}: {line.strip()}")

    print("== phase 3: kernels vs plain versions (main-path shapes)")
    kstats = kernel_phase(dev)

    print("== phase 4: main path (dit-i256 full width, nfe 10, order 3, "
          "cfg 2.0, batch 8)")
    counts: dict = {}
    main_stats = main_path_phase(dev, counts)

    print("== phase 5: serving step (4 slots, staggered, slot reuse, fp32 "
          "full width)")
    serve_worst, fp32_err = serving_phase(dev)

    entries = []
    for kname, src, replaces, per_eval in KERNELS:
        st = kstats[kname]
        entries.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=counts.get(kname, 0),
            launches_per_eval=per_eval if per_eval else "2 per row",
            max_abs_err=st["max_abs_err"], max_rel_err=st["max_rel_err"],
            cases=st["cases"], ms=st["ms"], kernel_ms=st["ms"],
            host_call_ms=st["host_call_ms"], plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
            bound_by=st["bound_by"], library_ms=st["library_ms"]))
    summary = dict(main_path=main_stats, serving_worst_rel_err=serve_worst,
                   fp32_full_width_kernel_vs_plain=fp32_err)
    print("summary " + json.dumps(summary))
    print(json.dumps({"kernels": entries}))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
