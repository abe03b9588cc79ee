"""Quantized denoiser path: QuantSpec, calibration, param-tree quantization
(the port of `repro.models.quant`).

    QuantSpec (a serving tier's precision contract)
      -> calibrate_act_stats (per-site activation absmax over a few
         deterministic DDIM probe trajectories; only the a8 tiers need it)
      -> quantize_params (replace each selected weight leaf with a quant
         record {"qw", "ws"[, "sa"]})
      -> layers.dense_apply routes records through the quant_matmul op

Routing is structural: a dense site sees either a raw weight tensor (the
float path) or a record installed here, so CFG stacking, the per-slot step
and every other eval path quantize with no change. Static metadata (bits,
granularity, families) lives on the spec; the param tree carries only
tensors, stacked over blocks as (L, ...) like the float leaves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..diffusion.schedules import VPLinear
from ..kernels.quant_matmul import ref as qref
from . import dit

FAMILIES = ("attn", "mlp", "adaln")

# dense site -> (family, activation-stat name); per-block sites live inside
# params["backbone"]["blocks"], final_ada at the backbone top level. wq/wk/wv
# share one stat: DiT attention is self-attention, all three read the same
# normed activation.
_BLOCK_SITES = {
    "wq": ("attn", "qkv"), "wk": ("attn", "qkv"), "wv": ("attn", "qkv"),
    "wo": ("attn", "wo"),
    "w1": ("mlp", "mlp_in"), "w2": ("mlp", "mlp_mid"),
    "ada": ("adaln", "ada"),
}
PER_BLOCK_STATS = ("qkv", "wo", "mlp_in", "mlp_mid", "ada")


@dataclass(frozen=True)
class QuantSpec:
    """A quality tier's precision contract (immutable, hashable)."""
    bits: int = 8               # weight bits: 8 | 4 (int8 container)
    act_bits: int = 16          # 16 = float activations, 8 = static int8
    granularity: str = "channel"  # per-output-"channel" | per-"tensor"
    fmt: str = "int"            # "int" | "fp8" (e4m3 weights)
    families: Tuple[str, ...] = FAMILIES


# the serving tier names (EngineSpec.quant / --quant). w4a16 is the
# deliberately harsh tier (per-tensor int4).
QUANT_MODES = {
    "w8a16": QuantSpec(),
    "w8a8": QuantSpec(act_bits=8),
    "fp8a16": QuantSpec(fmt="fp8"),
    "w4a16": QuantSpec(bits=4, granularity="tensor"),
}


def quant_spec(mode: str) -> QuantSpec:
    if mode not in QUANT_MODES:
        raise ValueError(f"quant mode must be one of "
                         f"{('none',) + tuple(QUANT_MODES)}, got {mode!r}")
    return QUANT_MODES[mode]


def _require_dit(cfg):
    if cfg.family != "dit":
        raise ValueError(f"the quantized denoiser path needs the dit family "
                         f"(adaLN block stack); arch {cfg.arch_id!r} is "
                         f"family {cfg.family!r}")


# ---------------------------------------------------------------------------
# calibration: per-site activation absmax over probe trajectories
# ---------------------------------------------------------------------------

def calibrate_act_stats(cfg, params, *, schedule=None, nfe: int = 6,
                        batch: int = 2, seed: int = 0, class_ids=None,
                        x_probe: Optional[torch.Tensor] = None):
    """Record per-dense-site activation absmax along `batch` deterministic
    DDIM probe trajectories, on the device the params live on.

    The replay chains the same `dit._embed`, `dit._block` and `dit._head`
    that `dit_apply` runs (with their `tap` hook set), so the recorded
    activations are exactly the sampling ones.

    The probe latents `x_probe` (batch, T, latent) and `class_ids` default
    to draws from a torch.Generator seeded with `seed` — the port's own
    numbers, not the reference's jax.random ones; pass them to replay the
    reference's probe. Returns {stat_name: np.float32 array}, (num_layers,)
    per block site and a scalar for final_ada; bit-identical given (params,
    probe, nfe)."""
    _require_dit(cfg)
    schedule = schedule or VPLinear()
    bk = params["backbone"]
    dev = bk["in_proj"].device
    L = int(cfg.num_layers)
    stats = {name: torch.zeros((L,), dtype=torch.float32, device=dev)
             for name in PER_BLOCK_STATS}
    stats["final_ada"] = torch.zeros((), dtype=torch.float32, device=dev)

    gen = torch.Generator(device=dev).manual_seed(seed)
    if x_probe is None:
        x_probe = torch.randn((batch, cfg.patch_tokens, cfg.latent_dim),
                              generator=gen, device=dev, dtype=torch.float32)
    x = torch.as_tensor(x_probe, device=dev).to(cfg.activation_dtype)
    if class_ids is None and "class_embed" in bk:
        n_cls = bk["class_embed"].shape[0] - 1
        class_ids = torch.randint(0, n_cls, (x.shape[0],), generator=gen,
                                  device=dev)
    if class_ids is not None:
        class_ids = torch.as_tensor(class_ids, device=dev).long()

    cur = {"i": 0}

    def tap(site, v):
        m = v.to(torch.float32).abs().amax()
        if stats[site].ndim:
            i = cur["i"]
            stats[site][i] = torch.maximum(stats[site][i], m)
        else:
            stats[site] = torch.maximum(stats[site], m)

    def tapped_eps(x_t, t):
        h, c = dit._embed(bk, cfg, x_t, t, class_ids)
        for i, bp in enumerate(dit._layers(bk["blocks"], L)):
            cur["i"] = i
            h = dit._block(h, bp, cfg, c, tap=tap)
        return dit._head(bk, cfg, h, c, tap=tap)

    # coarse DDIM trajectory, T -> t_eps: the probe visits the noise levels
    # a served request does, so the absmax covers the sampling range
    ts = np.linspace(schedule.T, schedule.t_eps, nfe + 1)
    with torch.no_grad():
        for t, t_next in zip(ts[:-1], ts[1:]):
            eps = tapped_eps(x, t)
            a, s = float(schedule.alpha(t)), float(schedule.sigma(t))
            a_n = float(schedule.alpha(t_next))
            s_n = float(schedule.sigma(t_next))
            x0 = (x - s * eps) / a
            x = a_n * x0 + s_n * eps
        tapped_eps(x, ts[-1])  # stats at the final (lowest-noise) state too
    return {k: v.cpu().numpy().astype(np.float32) for k, v in stats.items()}


# ---------------------------------------------------------------------------
# param-tree quantization
# ---------------------------------------------------------------------------

def _record(w, spec: QuantSpec, amax=None) -> dict:
    qw, ws = qref.quantize(w, bits=spec.bits, granularity=spec.granularity,
                           fmt=spec.fmt)
    rec = {"qw": qw, "ws": ws}
    if spec.act_bits == 8:
        amax = torch.as_tensor(np.asarray(amax, np.float32), device=w.device)
        rec["sa"] = amax.clamp_min(1e-12) / torch.tensor(
            qref.ACT_QMAX, dtype=torch.float32, device=w.device)
    return rec


def quantize_params(cfg, params, spec: QuantSpec, act_stats=None) -> dict:
    """Replace the selected dense weight leaves with quant records.

    Per-block leaves are stacked (L, K, N); quantization reduces over K
    only, so each block keeps its own per-channel scales: ws is (L, N) and
    sa (L,). `act_stats` (from `calibrate_act_stats`) is required for a8
    tiers. The input tree is not modified; untouched leaves are shared."""
    _require_dit(cfg)
    if spec.act_bits == 8 and act_stats is None:
        raise ValueError("act_bits=8 needs calibrated activation stats — "
                         "run models.quant.calibrate_act_stats (or go "
                         "through api.calibrate_and_quantize)")
    out = dict(params)
    bk = dict(out["backbone"])
    blocks = dict(bk["blocks"])
    blocks["attn"] = dict(blocks["attn"])
    for name, (family, stat) in _BLOCK_SITES.items():
        if family not in spec.families:
            continue
        amax = act_stats[stat] if spec.act_bits == 8 else None
        tree = blocks["attn"] if name in ("wq", "wk", "wv", "wo") else blocks
        tree[name] = _record(tree[name], spec, amax)
    bk["blocks"] = blocks
    if "adaln" in spec.families:
        amax = act_stats["final_ada"] if spec.act_bits == 8 else None
        bk["final_ada"] = _record(bk["final_ada"], spec, amax)
    out["backbone"] = bk
    return out


def quant_param_bytes(params) -> dict:
    """Quantized vs fp32 weight bytes over the installed records: {"quant":
    bytes actually stored, "fp32": the bytes the same sites would cost
    unquantized}."""
    n = {"quant": 0, "fp32": 0}

    def visit(sub):
        if isinstance(sub, dict) and "qw" in sub:
            n["quant"] += sum(v.numel() * v.element_size()
                              for v in sub.values())
            n["fp32"] += sub["qw"].numel() * 4
        elif isinstance(sub, dict):
            for v in sub.values():
                visit(v)

    visit(params)
    return n
