"""The forward process, the training loss, and prediction-type conversion
between the eps-net and the solver."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .schedules import NoiseSchedule


def _t_like(t, x):
    """`t` as a tensor on x's device. A host number takes x's precision
    (at least fp32), so a float64 loop keeps float64 schedule values; a
    tensor keeps its own dtype."""
    if torch.is_tensor(t):
        return t.to(x.device)
    return torch.as_tensor(t, dtype=torch.promote_types(x.dtype,
                                                        torch.float32),
                           device=x.device)


def _bcast_t(coef, t, x):
    """Align a t-shaped coefficient with x: a scalar t broadcasts as is; a
    (B,) per-sample t (the continuous-batching step, where every slot sits at
    its own timestep) gains trailing singleton dims to scale (B, ...) states."""
    if t.ndim == 0:
        return coef
    return coef.reshape(coef.shape + (1,) * (x.ndim - t.ndim))


def q_sample(schedule: NoiseSchedule, x0, t, noise):
    """x_t = alpha_t x0 + sigma_t eps, with t broadcast over the batch."""
    a, s = schedule.alpha_sigma_torch(_t_like(t, x0))
    bshape = (-1,) + (1,) * (x0.ndim - 1)
    return a.reshape(bshape) * x0 + s.reshape(bshape) * noise


def draw_t_noise(schedule: NoiseSchedule, x0, rng):
    """The loss's draws (t, noise): t ~ U[t_eps, T] (B,) fp32 and noise ~
    N(0, 1) fp32 in x0's shape, cast to x0's dtype. `rng` is a
    torch.Generator on x0's device (t first, then the noise), or the pair
    (t, noise) itself: the reference draws with jax.random, which torch
    cannot reproduce, so parity runs pass the reference's own draws."""
    if isinstance(rng, torch.Generator):
        u = torch.rand((x0.shape[0],), generator=rng, device=x0.device,
                       dtype=torch.float32)
        t = schedule.t_eps + (schedule.T - schedule.t_eps) * u
        noise = torch.randn(x0.shape, generator=rng, device=x0.device,
                            dtype=torch.float32)
    else:  # numpy arrays are copied: a jax array's numpy view is read-only
        t, noise = (a if torch.is_tensor(a) else torch.from_numpy(
            np.array(a, dtype=np.float32)) for a in rng)
        t = t.to(device=x0.device, dtype=torch.float32)
        noise = noise.to(device=x0.device, dtype=torch.float32)
    return t, noise.to(x0.dtype)


def diffusion_loss(schedule: NoiseSchedule, eps_model: Callable, x0, rng,
                   weighting: str = "uniform"):
    """E ||eps_theta(x_t, t) - eps||^2 with t ~ U[t_eps, T] (`rng`: see
    `draw_t_noise`)."""
    t, noise = draw_t_noise(schedule, x0, rng)
    x_t = q_sample(schedule, x0, t, noise)
    pred = eps_model(x_t, t)
    err = (pred - noise) ** 2
    if weighting == "snr_trunc":  # min(SNR, 5) weighting
        a, s = schedule.alpha_sigma_torch(t)
        w = torch.clamp((a / s) ** 2, max=5.0).reshape(
            (-1,) + (1,) * (x0.ndim - 1))
        err = err * w
    return torch.mean(err)


def eps_to_x0(schedule: NoiseSchedule, x_t, t, eps):
    """x0 = (x_t - sigma_t eps) / alpha_t. t: scalar or (B,).

    A low-precision eps (a bf16 network output) is widened first: JAX
    promotes bf16 x f32 to f32, where torch would keep a 0-d f32 coefficient
    times a bf16 tensor in bf16."""
    t = _t_like(t, x_t)
    a, s = schedule.alpha_sigma_torch(t)
    eps = eps.to(torch.promote_types(eps.dtype, s.dtype))
    return (x_t - _bcast_t(s, t, x_t) * eps) / _bcast_t(a, t, x_t)


def x0_to_eps(schedule: NoiseSchedule, x_t, t, x0):
    """eps = (x_t - alpha_t x0) / sigma_t. t: scalar or (B,)."""
    t = _t_like(t, x_t)
    a, s = schedule.alpha_sigma_torch(t)
    return (x_t - _bcast_t(a, t, x_t) * x0) / _bcast_t(s, t, x_t)


def wrap_model(schedule: NoiseSchedule, eps_model: Callable, prediction: str):
    """Adapt a noise-prediction network to the solver's prediction type."""
    if prediction == "noise":
        return eps_model

    def data_model(x, t):
        return eps_to_x0(schedule, x, t, eps_model(x, t))

    return data_model
