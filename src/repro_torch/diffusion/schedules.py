"""Noise schedules in the (alpha_t, sigma_t, lambda_t) parametrization.

lambda_t = log(alpha_t / sigma_t) is the half log-SNR. Host-side schedule
math is float64 numpy (it feeds the UniPC coefficient tables, and is the
same code as `repro.diffusion.schedules`, so the tables are bit-equal); the
quantities needed on the device have fp32 torch twins.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["NoiseSchedule", "VPLinear", "VPCosine", "EDMSchedule",
           "timestep_grid"]


class NoiseSchedule:
    """Continuous-time schedule on t in [t_eps, T]."""

    T: float = 1.0
    t_eps: float = 1e-3

    # ---- host (numpy, float64) ----
    def log_alpha(self, t):
        raise NotImplementedError

    def alpha(self, t):
        return np.exp(self.log_alpha(np.asarray(t, np.float64)))

    def sigma(self, t):
        a = self.alpha(t)
        return np.sqrt(np.clip(1.0 - a * a, 1e-30, None))

    def lam(self, t):
        t = np.asarray(t, np.float64)
        la = self.log_alpha(t)
        return la - 0.5 * np.log(np.clip(1.0 - np.exp(2 * la), 1e-30, None))

    def t_of_lam(self, lam):
        raise NotImplementedError

    # ---- device (torch, the tensor's dtype) ----
    def log_alpha_torch(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def alpha_sigma_torch(self, t: torch.Tensor):
        a = torch.exp(self.log_alpha_torch(t))
        return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-20))


@dataclass
class VPLinear(NoiseSchedule):
    """Variance-preserving linear-beta schedule (ScoreSDE / DDPM continuous)."""

    beta_0: float = 0.1
    beta_1: float = 20.0
    T: float = 1.0
    t_eps: float = 1e-3

    def log_alpha(self, t):
        t = np.asarray(t, np.float64)
        return -0.25 * t**2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0

    def t_of_lam(self, lam):
        lam = np.asarray(lam, np.float64)
        # alpha^2 = sigmoid(2 lam)  ->  log alpha^2 = -softplus(-2 lam)
        log_a2 = -np.logaddexp(0.0, -2.0 * lam)
        d = self.beta_1 - self.beta_0
        return (-self.beta_0 + np.sqrt(self.beta_0**2 - 2.0 * d * log_a2)) / d

    def log_alpha_torch(self, t):
        return -0.25 * t**2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0


@dataclass
class VPCosine(NoiseSchedule):
    """Cosine schedule (Nichol & Dhariwal, 2021), continuous form."""

    s: float = 0.008
    T: float = 0.9946  # keep beta bounded as in the iDDPM implementation
    t_eps: float = 1e-3

    def log_alpha(self, t):
        t = np.asarray(t, np.float64)
        f = np.cos((t + self.s) / (1 + self.s) * math.pi / 2)
        f0 = math.cos(self.s / (1 + self.s) * math.pi / 2)
        return np.log(np.clip(f / f0, 1e-30, None))

    def t_of_lam(self, lam):
        lam = np.asarray(lam, np.float64)
        log_a2 = -np.logaddexp(0.0, -2.0 * lam)
        f0 = math.cos(self.s / (1 + self.s) * math.pi / 2)
        f = np.exp(0.5 * log_a2) * f0
        return np.arccos(np.clip(f, -1.0, 1.0)) * 2 * (1 + self.s) / math.pi - self.s

    def log_alpha_torch(self, t):
        f = torch.cos((t + self.s) / (1 + self.s) * math.pi / 2)
        f0 = math.cos(self.s / (1 + self.s) * math.pi / 2)
        return torch.log(torch.clamp(f / f0, min=1e-20))


@dataclass
class EDMSchedule(NoiseSchedule):
    """alpha = 1, sigma = t (Karras et al. style; lambda = -log t)."""

    T: float = 80.0
    t_eps: float = 0.002

    def log_alpha(self, t):
        return np.zeros_like(np.asarray(t, np.float64))

    def sigma(self, t):
        return np.asarray(t, np.float64)

    def lam(self, t):
        return -np.log(np.asarray(t, np.float64))

    def t_of_lam(self, lam):
        return np.exp(-np.asarray(lam, np.float64))

    def log_alpha_torch(self, t):
        return torch.zeros_like(t)

    def alpha_sigma_torch(self, t):
        return torch.ones_like(t), t


def timestep_grid(schedule: NoiseSchedule, num_steps: int, spacing: str = "logsnr"):
    """Return (t, lam, alpha, sigma) arrays of length num_steps+1 from T to t_eps.

    spacing: 'logsnr' (uniform in lambda — the DPM-Solver/UniPC default),
    'time_uniform', or 'time_quadratic'.
    """
    if spacing == "logsnr":
        lam_T = float(schedule.lam(schedule.T))
        lam_0 = float(schedule.lam(schedule.t_eps))
        lams = np.linspace(lam_T, lam_0, num_steps + 1)
        ts = schedule.t_of_lam(lams)
    elif spacing == "time_uniform":
        ts = np.linspace(schedule.T, schedule.t_eps, num_steps + 1)
    elif spacing == "time_quadratic":
        ts = np.linspace(schedule.T**0.5, schedule.t_eps**0.5, num_steps + 1) ** 2
    else:
        raise ValueError(spacing)
    ts = np.asarray(ts, np.float64)
    lams = schedule.lam(ts)
    return ts, lams, schedule.alpha(ts), schedule.sigma(ts)
