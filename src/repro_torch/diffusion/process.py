"""Prediction-type conversion between the eps-net and the solver."""

from __future__ import annotations

import torch

from .schedules import NoiseSchedule


def _bcast_t(coef, t, x):
    """Align a t-shaped coefficient with x: a scalar t broadcasts as is; a
    (B,) per-sample t (the continuous-batching step, where every slot sits at
    its own timestep) gains trailing singleton dims to scale (B, ...) states."""
    if t.ndim == 0:
        return coef
    return coef.reshape(coef.shape + (1,) * (x.ndim - t.ndim))


def eps_to_x0(schedule: NoiseSchedule, x_t, t, eps):
    """x0 = (x_t - sigma_t eps) / alpha_t. t: scalar or (B,).

    A low-precision eps (a bf16 network output) is widened first: JAX
    promotes bf16 x f32 to f32, where torch would keep a 0-d f32 coefficient
    times a bf16 tensor in bf16."""
    t = torch.as_tensor(t, device=x_t.device)
    a, s = schedule.alpha_sigma_torch(t)
    eps = eps.to(torch.promote_types(eps.dtype, s.dtype))
    return (x_t - _bcast_t(s, t, x_t) * eps) / _bcast_t(a, t, x_t)
