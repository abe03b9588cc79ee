"""Guided sampling: classifier-free guidance, guidance-scale schedules and
dynamic thresholding.

Two CFG forms:

* `cfg_model` — two sequential network evals per step (cond, then uncond);
  the reference semantics, used by the python-loop solvers.
* `cfg_model_fused` — one batched network eval per step on the stacked
  [cond; uncond] batch; what the engine runs, with the guidance scale
  riding the table as a per-eval column (`guidance_schedule`).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .process import eps_to_x0
from .schedules import NoiseSchedule

GUIDANCE_SCHEDULES = ("constant", "linear", "cosine")


def cfg_model(eps_cond: Callable, eps_uncond: Callable, scale: float):
    """epsilon_tilde = (1 + s) * eps_cond - s * eps_uncond (Ho & Salimans)."""

    def fn(x, t):
        return (1.0 + scale) * eps_cond(x, t) - scale * eps_uncond(x, t)

    return fn


def cfg_model_fused(eps_stacked: Callable):
    """Fused CFG: one batched eval per step.

    eps_stacked(xx, t) runs the eps-net on a 2B batch whose conditioning is
    [cond_0..cond_{B-1}, null_0..null_{B-1}]. The returned fn takes the
    guidance scale `g` as an argument. Both `t` and `g` may be per-sample
    (B,): t is then tiled to the 2B stacked batch and g broadcast over the
    sample dims. Extra keyword arguments (per-slot class ids) pass through.
    """

    def fn(x, t, g, **extra):
        t = torch.as_tensor(t, device=x.device)
        tt = torch.cat([t, t], dim=0) if t.ndim == 1 else t
        ee = eps_stacked(torch.cat([x, x], dim=0), tt, **extra)
        g = torch.as_tensor(g, dtype=torch.float32, device=x.device)
        # JAX promotes bf16 x f32 to f32; torch keeps bf16 for a 0-d g
        ee = ee.to(torch.promote_types(ee.dtype, g.dtype))
        e_cond, e_uncond = torch.chunk(ee, 2, dim=0)
        if g.ndim == 1:
            g = g.reshape(g.shape + (1,) * (e_cond.ndim - 1))
        return (1.0 + g) * e_cond - g * e_uncond

    return fn


def guidance_schedule(scale: float, n_evals: int, kind: str = "constant",
                      scale_end: Optional[float] = None) -> np.ndarray:
    """(n_evals,) per-eval guidance scales, host-side float64.

    'constant' holds `scale`; 'linear' / 'cosine' ramp from `scale` at the
    first eval to `scale_end` (default 0) at the last.
    """
    if kind not in GUIDANCE_SCHEDULES:
        raise ValueError(f"kind must be one of {GUIDANCE_SCHEDULES}, got {kind!r}")
    end = 0.0 if scale_end is None else float(scale_end)
    u = np.linspace(0.0, 1.0, n_evals)
    if kind == "constant":
        return np.full(n_evals, float(scale))
    if kind == "linear":
        return scale + (end - scale) * u
    return scale + (end - scale) * 0.5 * (1.0 - np.cos(np.pi * u))


def _row_quantile(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(B,) quantile of each row of `rows` (B, n) at its level q (B,), by
    `jnp.quantile`'s default linear interpolation in fp32: position
    q * (n - 1) between the sorted elements at its floor and its ceiling,
    weights (1 - f, f); a row holding a NaN gives NaN. Built from
    `torch.sort` and gathers: `torch.quantile` takes no per-row level, and
    its checks read tensors on the host, which a CUDA graph cannot
    capture."""
    n = rows.shape[1]
    rows = torch.where(torch.isnan(rows).any(dim=1, keepdim=True),
                       torch.nan, rows)
    srt = torch.sort(rows, dim=1).values
    pos = q * float(n - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    lo = lo.clamp(0, n - 1).long()[:, None]
    hi = hi.clamp(0, n - 1).long()[:, None]
    return (srt.gather(1, lo)[:, 0] * (1.0 - w_hi)
            + srt.gather(1, hi)[:, 0] * w_hi)


def dynamic_threshold(x0: torch.Tensor, percentile=0.995,
                      floor: float = 1.0) -> torch.Tensor:
    """Imagen-style dynamic thresholding (Saharia et al., 2022): clip x0 to
    the per-sample `percentile` absolute value and rescale into
    [-floor, floor]. `percentile` is a float or a 0-d or per-slot (B,)
    tensor — per-slot percentiles in the continuous-batching step, each
    sample quantiled at its own level. No host read: capturable in a CUDA
    graph."""
    B = x0.shape[0]
    q = (percentile.to(torch.float32).reshape(-1).expand(B)
         if torch.is_tensor(percentile) else   # a fill, not a host copy
         torch.full((B,), percentile, dtype=torch.float32, device=x0.device))
    s = _row_quantile(x0.reshape(B, -1).abs(), q).to(x0.dtype)
    s = torch.clamp_min(s, floor).reshape((-1,) + (1,) * (x0.ndim - 1))
    return torch.minimum(torch.maximum(x0, -s), s) / s * floor


def guided_data_model(
    schedule: NoiseSchedule,
    eps_cond: Callable,
    eps_uncond: Optional[Callable] = None,
    guidance_scale: float = 0.0,
    thresholding: bool = False,
    threshold_percentile: float = 0.995,
):
    """Data-prediction model with CFG and optional dynamic thresholding: the
    configuration the paper uses for conditional sampling (UniPC-B2,
    Table 9)."""
    eps = (
        cfg_model(eps_cond, eps_uncond, guidance_scale)
        if eps_uncond is not None and guidance_scale != 0.0
        else eps_cond
    )

    def fn(x, t):
        x0 = eps_to_x0(schedule, x, t, eps(x, t))
        if thresholding:
            x0 = dynamic_threshold(x0, threshold_percentile)
        return x0

    return fn
