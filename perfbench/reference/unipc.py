"""Multistep UniPC (Zhao et al. 2023, arXiv:2302.04867, Algorithms 5-8) in
plain PyTorch: data prediction, B(h) = bh1 or bh2, the predictor UniP-p and
the corrector UniC-p, warm-up orders and lower orders at the end, as the
authors' released sampler (`multistep_uni_pc_bh_update`) computes them.

The coefficients are float64; the state is float64 between model calls,
and each model call takes float32. `sample` makes `nfe` model calls.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


class VPLinear:
    """The variance-preserving linear-beta schedule (ScoreSDE): log alpha_t =
    -(beta_1 - beta_0) t^2 / 4 - beta_0 t / 2, lambda_t = log(alpha_t /
    sigma_t)."""

    def __init__(self, beta_0: float, beta_1: float, T: float,
                 t_eps: float):
        self.b0, self.b1, self.T, self.t_eps = beta_0, beta_1, T, t_eps

    def log_alpha(self, t: float) -> float:
        return -0.25 * t * t * (self.b1 - self.b0) - 0.5 * t * self.b0

    def alpha(self, t: float) -> float:
        return math.exp(self.log_alpha(t))

    def sigma(self, t: float) -> float:
        return math.sqrt(1.0 - math.exp(2.0 * self.log_alpha(t)))

    def lam(self, t: float) -> float:
        la = self.log_alpha(t)
        return la - 0.5 * math.log(1.0 - math.exp(2.0 * la))

    def t_of_lam(self, lam: float) -> float:
        log_a2 = -math.log1p(math.exp(-2.0 * lam))   # alpha^2 = sigmoid(2 lam)
        d = self.b1 - self.b0
        return (-self.b0 + math.sqrt(self.b0 ** 2 - 2.0 * d * log_a2)) / d


def schedule_of(spec: dict) -> VPLinear:
    s = spec["schedule"]
    if s["kind"] != "vp_linear":
        raise ValueError(f"no reference schedule {s['kind']!r}")
    return VPLinear(s["beta_0"], s["beta_1"], s["T"], s["t_eps"])


def timesteps(sched: VPLinear, nfe: int, spacing: str) -> list:
    """The nfe + 1 times from T down to t_eps; 'logsnr' is uniform in
    lambda."""
    if spacing != "logsnr":
        raise ValueError(f"no reference spacing {spacing!r}")
    l0, l1 = sched.lam(sched.T), sched.lam(sched.t_eps)
    return [sched.t_of_lam(l0 + (l1 - l0) * i / nfe) for i in range(nfe + 1)]


def _update(sched, x, models, ts, t, order, variant, model_fn,
            use_corrector):
    """One UniPC step from ts[-1] to t of order `order` over the model
    outputs `models` (data predictions at `ts`, oldest first). Returns (x_t,
    the model output at x_t's predictor value, or None)."""
    m0, t0 = models[-1], ts[-1]
    lam0, lam_t = sched.lam(t0), sched.lam(t)
    h = lam_t - lam0
    rks, D1s = [], []
    for i in range(1, order):
        rk = (sched.lam(ts[-(i + 1)]) - lam0) / h
        rks.append(rk)
        D1s.append((models[-(i + 1)] - m0) / rk)
    rks.append(1.0)
    rks = torch.tensor(rks, dtype=F64)
    hh = -h                                  # data prediction
    h_phi_1 = math.expm1(hh)
    h_phi_k = h_phi_1 / hh - 1.0
    if variant == "bh1":
        B_h = hh
    elif variant == "bh2":
        B_h = math.expm1(hh)
    else:
        raise ValueError(f"no reference B(h) {variant!r}")
    R, b = [], []
    fact = 1
    for i in range(1, order + 1):
        R.append(rks ** (i - 1))
        b.append(h_phi_k * fact / B_h)
        fact *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / fact
    R = torch.stack(R)
    b = torch.tensor(b, dtype=F64)
    rhos_p = None
    if D1s:
        rhos_p = (torch.tensor([0.5], dtype=F64) if order == 2 else
                  torch.linalg.solve(R[:-1, :-1], b[:-1]))
    rhos_c = (torch.tensor([0.5], dtype=F64) if order == 1 else
              torch.linalg.solve(R, b))
    a_t, s_t, s_0 = sched.alpha(t), sched.sigma(t), sched.sigma(t0)
    x_base = (s_t / s_0) * x - a_t * h_phi_1 * m0
    pred = sum(float(r) * d for r, d in zip(rhos_p, D1s)) if D1s else 0.0
    x_t = x_base - a_t * B_h * pred
    if not use_corrector:
        return x_t, None
    model_t = model_fn(x_t, t)
    corr = (sum(float(r) * d for r, d in zip(rhos_c[:-1], D1s))
            if D1s else 0.0)
    x_t = x_base - a_t * B_h * (corr + float(rhos_c[-1]) * (model_t - m0))
    return x_t, model_t


def sample(model_fn, x_T: torch.Tensor, spec: dict) -> torch.Tensor:
    """UniPC-`order` with `nfe` model calls from x_T (float64 state).
    `model_fn(x, t)` returns the data prediction at x (float64). The
    corrector runs after every step but the last."""
    sched = schedule_of(spec)
    nfe, order = spec["nfe"], spec["order"]
    ts = timesteps(sched, nfe, spec["spacing"])
    x = x_T.to(F64)
    models, t_prev = [model_fn(x, ts[0])], [ts[0]]
    for step in range(1, nfe + 1):
        p = min(order, step)
        if spec["lower_order_final"]:
            p = min(p, nfe + 1 - step)
        last = step == nfe
        x, m = _update(sched, x, models, t_prev, ts[step], p,
                       spec["variant"], model_fn, use_corrector=not last)
        if not last:
            models.append(m)
            t_prev.append(ts[step])
    return x
