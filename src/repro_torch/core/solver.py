"""Solver substrate: grids, eval history, and the unified UniPC step (the
port of `repro.core.solver`).

The paper's central observation is that predictor and corrector share one
analytical form (Eq. 3 / Eq. 8-9): a semilinear base plus a weighted sum of
model-output differences at points with relative log-SNR offsets r_m. UniP
uses only previous points; UniC appends the current point (r = 1).
`unified_step` below is that form; multistep UniPC of any order, UniC
bolted onto any solver (Table 2) and the singlestep variants are choices of
which (lambda, eval) points to feed it.

This is the python-loop path, the reference the engine's row tables are
held against. It works on torch tensors of any float dtype (float64 on the
CPU for the tests, fp32 on the card); the grid, the lambdas and every
coefficient stay host float64, so looking a point up never reads a tensor.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Optional, Sequence, Tuple

import numpy as np
import torch

from .coeffs import unipc_weights
from ..diffusion.schedules import NoiseSchedule, timestep_grid

ModelFn = Callable[[torch.Tensor, float], torch.Tensor]  # (x, t) -> prediction


@dataclass
class Grid:
    """Sampling grid from T down to t_eps, with host-precision schedule values."""

    t: np.ndarray
    lam: np.ndarray
    alpha: np.ndarray
    sigma: np.ndarray

    @classmethod
    def build(cls, schedule: NoiseSchedule, num_steps: int, spacing: str = "logsnr"):
        return cls(*timestep_grid(schedule, num_steps, spacing))

    def __len__(self):
        return len(self.t) - 1


class History:
    """Recent model evaluations as (lambda, t, output) in evaluation order,
    in a bounded deque. The lambdas and times are host floats, so a lookup
    compares numbers and never syncs with the card."""

    def __init__(self, maxlen: int = 16):
        self.maxlen = maxlen
        self.items: Deque[Tuple[float, float, torch.Tensor]] = deque(maxlen=maxlen)

    def push(self, lam: float, t: float, out):
        self.items.append((float(lam), float(t), out))

    def last(self, k: int, before_lam: Optional[float] = None, exclude_lam=()):
        """Most recent k entries (newest first), optionally excluding lambdas."""
        out = []
        if k <= 0:
            return out
        for lam, t, e in reversed(self.items):
            if any(abs(lam - ex) < 1e-12 for ex in exclude_lam):
                continue
            if before_lam is not None and lam >= before_lam - 1e-12:
                continue
            out.append((lam, t, e))
            if len(out) == k:
                break
        return out

    def at_lam(self, lam: float):
        for l, t, e in reversed(self.items):
            if abs(l - lam) < 1e-12:
                return e
        raise KeyError(f"no eval at lambda={lam}")


class EvalCounter:
    """Wraps a model fn, counting NFE."""

    def __init__(self, fn: ModelFn):
        self.fn = fn
        self.nfe = 0

    def __call__(self, x, t):
        self.nfe += 1
        return self.fn(x, t)


def semilinear_base(x, m0, *, alpha_s, alpha_t, sigma_s, sigma_t, h, prediction):
    """The order-1 (DDIM) part of the unified update."""
    if prediction == "noise":
        return (alpha_t / alpha_s) * x - sigma_t * np.expm1(h) * m0
    return (sigma_t / sigma_s) * x + alpha_t * (-np.expm1(-h)) * m0


def unified_step(
    x,
    m0,
    points: Sequence[Tuple[float, torch.Tensor]],
    *,
    lam_s: float,
    lam_t: float,
    alpha_s: float,
    alpha_t: float,
    sigma_s: float,
    sigma_t: float,
    prediction: str,
    variant: str = "bh2",
    current=None,
):
    """One unified UniP/UniC update (Eq. 3 / 8 / 9).

    x:       state at the anchor point s (already corrected, if applicable)
    m0:      model output at the anchor (evaluated at the uncorrected sample)
    points:  [(lambda_m, model_out_m)] extra points (previous in multistep,
             intermediate in singlestep); may be empty -> DDIM / UniP-1.
    current: model output at lam_t (appends r = 1) -> corrector form.
    """
    h = float(lam_t - lam_s)
    rs = [(lam_m - lam_s) / h for lam_m, _ in points]
    outs = [e for _, e in points]
    if current is not None:
        rs.append(1.0)
        outs.append(current)
    base = semilinear_base(
        x, m0, alpha_s=alpha_s, alpha_t=alpha_t, sigma_s=sigma_s, sigma_t=sigma_t,
        h=h, prediction=prediction,
    )
    if not rs:
        return base
    w = unipc_weights(np.array(rs), h, variant, prediction)
    acc = 0.0
    for w_m, e_m in zip(w, outs):
        acc = acc + float(w_m) * (e_m - m0)
    scale = sigma_t if prediction == "noise" else alpha_t
    sign = -1.0 if prediction == "noise" else 1.0
    return base + sign * scale * acc


@dataclass
class CorrectorConfig:
    """UniC-p applied after any solver (Alg. 1 / 3)."""

    order: int  # p: number of difference points incl. the current one
    variant: str = "bh2"
    oracle: bool = False          # re-evaluate at the corrected sample (Table 3)
    at_last_step: bool = False    # costs one extra NFE if True
    free_oracle: float = 0.0      # estimate eps(x_c) ~ eps(x_pred) + gamma *
    # J_hat (x_c - x_pred) with a free secant Jacobian-diagonal estimate from
    # the last two stored evals (paper §4.2 future work); gamma in (0, 1].


class GridSolver:
    """The python loop shared by UniPC and every baseline.

    Subclasses implement `predict(i, x, hist) -> x_pred` and may evaluate the
    model at intermediate points (pushing them to `hist`). The loop keeps
    the grid-point evals, applies the optional method-agnostic UniC, and
    counts NFE (the corrector re-uses the next step's eval; no extra NFE
    except oracle / at_last_step).
    """

    prediction: str = "data"
    order: int = 1  # order of accuracy of the predictor (for UniC-p default)

    def __init__(self, model_fn: ModelFn, grid: Grid):
        self.model = EvalCounter(model_fn)
        self.grid = grid

    # -- subclass hook -------------------------------------------------------
    def predict(self, i: int, x, hist: History):
        raise NotImplementedError

    # -- the sampling loop ---------------------------------------------------
    def sample(self, x_T, corrector: Optional[CorrectorConfig] = None):
        g = self.grid
        M = len(g)
        hist = History()            # every eval (incl. singlestep intermediates)
        self._grid_hist = History()  # grid-point evals only: the corrector
        # anchors on these; intermediate evals sit at low-order-accurate
        # estimates and would degrade UniC's order (cf. Thm 3.1 regularity)
        x = x_T
        e0 = self.model(x_T, float(g.t[0]))
        hist.push(g.lam[0], g.t[0], e0)
        self._grid_hist.push(g.lam[0], g.t[0], e0)
        prev_pair = (x_T, e0)
        for i in range(1, M + 1):
            x_pred = self.predict(i, x, hist)
            last = i == M
            do_corr = corrector is not None and (not last or corrector.at_last_step)
            need_eval = (i < M) or do_corr
            e_new = self.model(x_pred, float(g.t[i])) if need_eval else None
            if do_corr:
                x = self._correct(i, x, x_pred, e_new, corrector)
                if corrector.oracle:
                    e_new = self.model(x, float(g.t[i]))
                elif corrector.free_oracle and e_new is not None:
                    # push a free estimate of eps(x_c) instead of
                    # eps(x_pred): a secant diagonal Jacobian from the
                    # previous (sample, eval) pair
                    xp, ep = prev_pair
                    denom = x_pred - xp
                    ok = denom.abs() > 1e-8
                    jhat = torch.where(
                        ok, (e_new - ep) / torch.where(ok, denom, 1.0), 0.0)
                    jhat = jhat.clamp(-5.0, 5.0)
                    e_new = e_new + corrector.free_oracle * jhat * (x - x_pred)
            else:
                x = x_pred
            if e_new is not None:
                hist.push(g.lam[i], g.t[i], e_new)
                self._grid_hist.push(g.lam[i], g.t[i], e_new)
                prev_pair = (x_pred, e_new)
        return x

    def _correct(self, i, x_prev, x_pred, e_new, cfg: CorrectorConfig):
        g = self.grid
        hist = self._grid_hist
        order = cfg.order_at(i) if hasattr(cfg, "order_at") else cfg.order
        m0 = hist.at_lam(g.lam[i - 1])
        pts = hist.last(order - 1, before_lam=float(g.lam[i - 1]))
        points = [(lam, e) for lam, _, e in reversed(pts)]
        return unified_step(
            x_prev, m0, points,
            lam_s=g.lam[i - 1], lam_t=g.lam[i],
            alpha_s=g.alpha[i - 1], alpha_t=g.alpha[i],
            sigma_s=g.sigma[i - 1], sigma_t=g.sigma[i],
            prediction=self.prediction, variant=cfg.variant, current=e_new,
        )
