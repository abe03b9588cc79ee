"""Classifier-free guidance fused into one batched eval, and guidance-scale
schedules. Dynamic thresholding is not yet ported."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

GUIDANCE_SCHEDULES = ("constant", "linear", "cosine")


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
