"""Baseline solvers the paper compares against (the port of
`repro.core.baselines`), all on the GridSolver loop, so the
method-agnostic UniC can be bolted onto each of them (Table 2). The
coefficients are host float64, the states torch tensors.

* DDIM (Song et al., 2021a)               — order 1; identical to UniP-1.
* DPM-Solver 2S/3S (Lu et al., 2022a)     — singlestep, noise prediction.
* DPM-Solver++ 1M/2M/3M (Lu et al., 2022b)— multistep, data prediction.
* DPM-Solver++ 3S                          — singlestep, data prediction.
* PNDM / PLMS (Liu et al., 2022)          — pseudo linear multistep, noise pred.
* DEIS tAB-k (Zhang & Chen, 2022)         — time-domain exponential integrator,
  polynomial extrapolation with numerically exact integral weights.
"""

from __future__ import annotations

import math

import numpy as np

from .solver import Grid, GridSolver, History, semilinear_base, unified_step


class DDIM(GridSolver):
    """First-order exponential-integrator step == UniP-1 (Section 3.3)."""

    order = 1

    def __init__(self, model_fn, grid: Grid, prediction: str = "noise"):
        super().__init__(model_fn, grid)
        self.prediction = prediction

    def predict(self, i, x, hist: History):
        g = self.grid
        m0 = hist.at_lam(g.lam[i - 1])
        return unified_step(
            x, m0, [],
            lam_s=g.lam[i - 1], lam_t=g.lam[i],
            alpha_s=g.alpha[i - 1], alpha_t=g.alpha[i],
            sigma_s=g.sigma[i - 1], sigma_t=g.sigma[i],
            prediction=self.prediction,
        )


class DPMSolverPP(GridSolver):
    """DPM-Solver++ multistep (1M/2M/3M), data prediction, exactly the update
    formulas of Lu et al. 2022b; lower-order warm-up and lower-order-final."""

    prediction = "data"

    def __init__(self, model_fn, grid: Grid, order: int = 2,
                 lower_order_final: bool = True):
        assert order in (1, 2, 3)
        super().__init__(model_fn, grid)
        self.order = order
        self.lower_order_final = lower_order_final

    def predict(self, i, x, hist: History):
        g = self.grid
        M = len(g)
        p = min(self.order, i)
        if self.lower_order_final:
            p = min(p, M - i + 1)
        lam = g.lam
        m0 = hist.at_lam(lam[i - 1])
        h = lam[i] - lam[i - 1]
        sig_r = g.sigma[i] / g.sigma[i - 1]
        a_t = g.alpha[i]
        phi_1 = math.expm1(-h)
        if p == 1:
            return sig_r * x - a_t * phi_1 * m0
        m1 = hist.at_lam(lam[i - 2])
        h_0 = lam[i - 1] - lam[i - 2]
        r0 = h_0 / h
        D1_0 = (m0 - m1) / r0
        if p == 2:
            return sig_r * x - a_t * phi_1 * m0 - 0.5 * a_t * phi_1 * D1_0
        m2 = hist.at_lam(lam[i - 3])
        h_1 = lam[i - 2] - lam[i - 3]
        r1 = h_1 / h
        D1_1 = (m1 - m2) / r1
        D1 = D1_0 + (r0 / (r0 + r1)) * (D1_0 - D1_1)
        D2 = (D1_0 - D1_1) / (r0 + r1)
        phi_2 = phi_1 / h + 1.0
        phi_3 = phi_2 / h - 0.5
        return (sig_r * x - a_t * phi_1 * m0 + a_t * phi_2 * D1 - a_t * phi_3 * D2)


class DPMSolverSinglestep(GridSolver):
    """DPM-Solver-2/-3 (noise prediction, singlestep; Lu et al. 2022a) and
    DPM-Solver++(3S) via prediction='data'."""

    def __init__(self, model_fn, grid: Grid, noise_schedule, order: int = 3,
                 prediction: str = "noise"):
        assert order in (2, 3)
        super().__init__(model_fn, grid)
        self.order = order
        self.prediction = prediction
        self.noise_schedule = noise_schedule
        self.r_inner = [0.5] if order == 2 else [1.0 / 3.0, 2.0 / 3.0]

    def _point(self, lam_m):
        t_m = float(self.noise_schedule.t_of_lam(lam_m))
        return t_m, float(self.noise_schedule.alpha(t_m)), float(self.noise_schedule.sigma(t_m))

    def predict(self, i, x, hist: History):
        g = self.grid
        lam_s, lam_t = float(g.lam[i - 1]), float(g.lam[i])
        h = lam_t - lam_s
        a_s, s_s = g.alpha[i - 1], g.sigma[i - 1]
        a_t, s_t = g.alpha[i], g.sigma[i]
        m_s = hist.at_lam(g.lam[i - 1])
        noise = self.prediction == "noise"
        if self.order == 2:
            r1 = self.r_inner[0]
            lam_1 = lam_s + r1 * h
            t1, a1, s1 = self._point(lam_1)
            if noise:
                x1 = (a1 / a_s) * x - s1 * math.expm1(r1 * h) * m_s
            else:
                x1 = (s1 / s_s) * x - a1 * math.expm1(-r1 * h) * m_s
            m1 = self.model(x1, t1)
            hist.push(lam_1, t1, m1)
            if noise:
                return ((a_t / a_s) * x - s_t * math.expm1(h) * m_s
                        - s_t / (2 * r1) * math.expm1(h) * (m1 - m_s))
            return ((s_t / s_s) * x - a_t * math.expm1(-h) * m_s
                    - a_t / (2 * r1) * math.expm1(-h) * (m1 - m_s))
        # order 3
        r1, r2 = self.r_inner
        lam_1, lam_2 = lam_s + r1 * h, lam_s + r2 * h
        t1, a1, s1 = self._point(lam_1)
        t2, a2, s2 = self._point(lam_2)
        if noise:
            phi_11 = math.expm1(r1 * h)
            phi_12 = math.expm1(r2 * h)
            phi_1 = math.expm1(h)
            phi_22 = math.expm1(r2 * h) / (r2 * h) - 1.0
            phi_2 = phi_1 / h - 1.0
            x1 = (a1 / a_s) * x - s1 * phi_11 * m_s
            m1 = self.model(x1, t1)
            hist.push(lam_1, t1, m1)
            x2 = ((a2 / a_s) * x - s2 * phi_12 * m_s
                  - (r2 / r1) * s2 * phi_22 * (m1 - m_s))
            m2 = self.model(x2, t2)
            hist.push(lam_2, t2, m2)
            return ((a_t / a_s) * x - s_t * phi_1 * m_s
                    - (1.0 / r2) * s_t * phi_2 * (m2 - m_s))
        phi_11 = math.expm1(-r1 * h)
        phi_12 = math.expm1(-r2 * h)
        phi_1 = math.expm1(-h)
        phi_22 = math.expm1(-r2 * h) / (r2 * h) + 1.0
        phi_2 = phi_1 / h + 1.0
        x1 = (s1 / s_s) * x - a1 * phi_11 * m_s
        m1 = self.model(x1, t1)
        hist.push(lam_1, t1, m1)
        x2 = ((s2 / s_s) * x - a2 * phi_12 * m_s
              + (r2 / r1) * a2 * phi_22 * (m1 - m_s))
        m2 = self.model(x2, t2)
        hist.push(lam_2, t2, m2)
        return ((s_t / s_s) * x - a_t * phi_1 * m_s
                + (1.0 / r2) * a_t * phi_2 * (m2 - m_s))


# Adams-Bashforth coefficients on newest-first evals (PLMS warm-up ladder).
# Shared with the engine compiler: a PLMS step is the DDIM transfer map of
# e_AB = sum_j AB[n][j] * E[j], and sum_j AB[n][j] == 1 for every n.
PLMS_AB = {
    1: np.array([1.0]),
    2: np.array([3.0, -1.0]) / 2.0,
    3: np.array([23.0, -16.0, 5.0]) / 12.0,
    4: np.array([55.0, -59.0, 37.0, -9.0]) / 24.0,
}


class PNDM(GridSolver):
    """PLMS variant of PNDM: Adams-Bashforth extrapolation of the noise
    prediction fed through the DDIM transfer map; lower-order AB warm-up."""

    prediction = "noise"
    order = 4

    def predict(self, i, x, hist: History):
        g = self.grid
        es = [e for _, _, e in hist.last(4)]  # newest first
        n = min(len(es), i)
        ab = PLMS_AB[min(n, 4)]
        e = sum(c * e_j for c, e_j in zip(ab, es))
        return semilinear_base(
            x, e, alpha_s=g.alpha[i - 1], alpha_t=g.alpha[i],
            sigma_s=g.sigma[i - 1], sigma_t=g.sigma[i],
            h=float(g.lam[i] - g.lam[i - 1]), prediction="noise",
        )


class DEIS(GridSolver):
    """DEIS tAB-k: exponential integrator in the *time* domain with Lagrange
    extrapolation of eps over previous timesteps. The integral

        x_t = (alpha_t/alpha_s) x_s - alpha_t * int e^{-lambda(tau)} lambda'(tau) L_j(tau) dtau

    has no closed form, so the per-step weights are computed with Gauss-Legendre
    quadrature in float64 at construction (faithful to the method: DEIS's
    integrals are also evaluated numerically)."""

    prediction = "noise"

    def __init__(self, model_fn, grid: Grid, noise_schedule, order: int = 3,
                 quad_points: int = 64):
        super().__init__(model_fn, grid)
        self.order = order
        self.noise_schedule = noise_schedule
        self.quad_points = quad_points

    def predict(self, i, x, hist: History):
        g = self.grid
        k = min(self.order, i)
        pts = hist.last(k)  # newest first: t_{i-1}, t_{i-2}, ...
        ts_prev = [t for _, t, _ in pts]
        es = [e for _, _, e in pts]
        ws = deis_quad_weights(self.noise_schedule, float(g.t[i - 1]),
                               float(g.t[i]), float(g.alpha[i]), ts_prev,
                               self.quad_points)
        acc = 0.0
        for w, e in zip(ws, es):
            acc = acc + w * e
        return (g.alpha[i] / g.alpha[i - 1]) * x + acc


def deis_quad_weights(noise_schedule, t_lo, t_hi, alpha_t, ts_prev,
                      quad_points: int = 64):
    """DEIS per-eval weights w_j = -alpha_t * int_{t_lo}^{t_hi} e^{-lam(tau)}
    lam'(tau) L_j(tau) dtau, with L_j the Lagrange basis over `ts_prev`.

    Module-level (shared by the python-loop `DEIS` and the engine's weight-
    table compiler): Gauss-Legendre quadrature in float64 — faithful to the
    method, whose integrals are also evaluated numerically."""
    nodes, gl_w = np.polynomial.legendre.leggauss(quad_points)
    tau = 0.5 * (t_hi - t_lo) * nodes + 0.5 * (t_hi + t_lo)
    jac = 0.5 * (t_hi - t_lo)
    eps = 1e-5
    dlam = (noise_schedule.lam(tau + eps) - noise_schedule.lam(tau - eps)) / (2 * eps)
    kern = np.exp(-noise_schedule.lam(tau)) * dlam
    ws = []
    for j in range(len(ts_prev)):
        L = np.ones_like(tau)
        for k in range(len(ts_prev)):
            if k != j:
                L *= (tau - ts_prev[k]) / (ts_prev[j] - ts_prev[k])
        ws.append(-float(alpha_t) * float(np.sum(gl_w * kern * L)) * jac)
    return ws
