"""Analytic Gaussian DPM — the order-of-accuracy instrument.

For x0 ~ N(mu, s^2 I) the marginal at time t is
q_t = N(alpha_t mu, (alpha_t^2 s^2 + sigma_t^2) I), so the exact noise
prediction (score * -sigma) is

    eps*(x, t) = sigma_t (x - alpha_t mu) / (alpha_t^2 s^2 + sigma_t^2).

The diffusion ODE becomes *linear* with a known solution: writing
v_t = alpha_t^2 s^2 + sigma_t^2, the exact ODE trajectory from (x_T, T) to t is

    x_t = alpha_t mu + sqrt(v_t / v_T) * (x_T - alpha_T mu)

(the probability-flow map of a Gaussian marginal family is affine and matches
the marginals' means/variances along the flow). This gives machine-precision
ground truth for measuring a solver's empirical order of convergence
(paper Thm 3.1 / Cor 3.2) without any pretrained network.

Host float64 math, the same as `repro.diffusion.gaussian`'s: GaussianDPM's
`eps_model` and `exact_solution` take numpy arrays or torch tensors of any
float dtype (the schedule values enter as host floats); MixtureDPM's
`eps_model` works in numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .schedules import NoiseSchedule


@dataclass
class GaussianDPM:
    schedule: NoiseSchedule
    mu: float = 0.7
    s: float = 0.35

    def _v(self, t):
        a = self.schedule.alpha(t)
        sig = self.schedule.sigma(t)
        return a * a * self.s**2 + sig * sig

    def eps_model(self, x, t):
        """Exact noise prediction (host floats ok: t scalar)."""
        t = float(np.asarray(t))
        a = float(self.schedule.alpha(t))
        sig = float(self.schedule.sigma(t))
        return sig * (x - a * self.mu) / (a * a * self.s**2 + sig * sig)

    def exact_solution(self, x_T, t):
        """Exact probability-flow ODE solution at time t from x_T at T."""
        t_T = self.schedule.T
        a_t = float(self.schedule.alpha(t))
        a_T = float(self.schedule.alpha(t_T))
        ratio = np.sqrt(float(self._v(t)) / float(self._v(t_T)))
        return a_t * self.mu + ratio * (x_T - a_T * self.mu)


@dataclass
class MixtureDPM:
    """Gaussian-mixture data distribution — exact eps via the closed-form
    mixture score. No closed ODE solution; the reference trajectory is a
    999-step DDIM exactly as in the paper's Fig. 4c protocol. Component 0
    doubles as the 'conditional' model for classifier-free guidance benches."""

    schedule: NoiseSchedule
    mus: tuple = (-1.0, 1.2)
    ss: tuple = (0.3, 0.5)
    ws: tuple = (0.35, 0.65)

    def eps_model(self, x, t):
        t = float(np.asarray(t))
        a = float(self.schedule.alpha(t))
        sig = float(self.schedule.sigma(t))
        x = np.asarray(x, np.float64)
        # responsibilities and per-component eps
        log_rho = []
        comp_eps = []
        for mu, s, w in zip(self.mus, self.ss, self.ws):
            v = a * a * s * s + sig * sig
            log_rho.append(np.log(w) - 0.5 * np.log(v)
                           - 0.5 * (x - a * mu) ** 2 / v)
            comp_eps.append(sig * (x - a * mu) / v)
        log_rho = np.stack(log_rho)
        log_rho -= log_rho.max(axis=0, keepdims=True)
        rho = np.exp(log_rho)
        rho /= rho.sum(axis=0, keepdims=True)
        return (rho * np.stack(comp_eps)).sum(axis=0)

    def component_eps_model(self, idx: int):
        comp = GaussianDPM(self.schedule, mu=self.mus[idx], s=self.ss[idx])
        return comp.eps_model


def empirical_order(errors, step_counts):
    """Fit slope of log(err) vs log(1/M): the measured order of convergence."""
    x = np.log(1.0 / np.asarray(step_counts, dtype=np.float64))
    y = np.log(np.asarray(errors, dtype=np.float64))
    return float(np.polyfit(x, y, 1)[0])
