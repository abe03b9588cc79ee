"""Per-step weight-table compilers: the solver zoo as data (the port of
`repro.engine.compiler`), the per-eval model columns, and the flight
step's coded done mask.

Every solver emits rows of the same `SolverTable` that
`core.coeffs.build_unipc_schedule` emits for UniPC — `(base_x, base_m0,
w_pred, base_*_corr, w_corr_*, out_scale)` per step, host-side float64 — so
the one row-loop sampler (`core.unipc`, the `unipc_update` row ops) runs
all of them unchanged. The translations:

* **DDIM** — the semilinear base alone (UniP-1); zero difference weights.
* **DPM-Solver++ 1M/2M/3M** — Lu et al. 2022b's D1/D2 combinations re-based
  onto newest-first differences D_m = E[m] − E[0] (linear, exact).
* **PLMS / Adams-Bashforth (PNDM)** — e_AB = Σ c_j E[j] with Σ c_j = 1, so
  e_AB = m0 + Σ_{j≥1} c_j D_j and the AB ladder folds into the weight rows.
* **DEIS tAB-k** — quadrature weights w_j on raw evals e_j become
  base_m0 = Σ w_j plus difference weights (e_j = m0 + D_j).
* **DPM-Solver 2S/3S (singlestep)** — compiled onto an expanded grid: each
  grid step becomes `order` rows (one per intermediate point), with the
  state re-based from the previous intermediate state, so the eval ring
  holds exactly the intermediates the singlestep formulas need.
* **UniC bolt-on** (Table 2) — for any multistep table: corrector rows from
  `unipc_weights` on [r_prev..., 1] over the semilinear base (which is why
  the table carries separate `base_*_corr` columns: DEIS's predictor base
  absorbs its quadrature weights and differs from the semilinear one).

Warm-up is data, not shape: rows beyond a step's true order are zero-padded.
"""

from __future__ import annotations

import math
from dataclasses import replace as dc_replace

import numpy as np
import torch

from ..core import (DDIM, DEIS, DPMSolverPP, DPMSolverSinglestep, Grid, PNDM,
                    UniPC)
from ..core.baselines import PLMS_AB, deis_quad_weights
from ..core.coeffs import (SolverTable, build_unipc_schedule,
                           semilinear_coeffs, unipc_weights)
from ..core.solver import CorrectorConfig
from ..diffusion.guidance import guidance_schedule
from ..diffusion.schedules import timestep_grid
from .specs import EngineSpec, SolverDef, register, solver_def


def compile_table(spec: EngineSpec, noise_schedule) -> SolverTable:
    """Resolve the spec against the registry and compile its weight table."""
    spec = spec.resolve()
    return solver_def(spec.solver).compile(spec, noise_schedule)


def build_loop(spec: EngineSpec, noise_schedule, model_fn):
    """The python-loop GridSolver reference for the same spec (same grid,
    same corrector policy): what the engine's row loop is held against."""
    spec = spec.resolve()
    return solver_def(spec.solver).loop(spec, noise_schedule, model_fn)


def apply_model_cols(tab: SolverTable, spec: EngineSpec) -> SolverTable:
    """Return `tab` with the spec's per-eval model columns attached: the
    guidance-scale schedule `g` and the dynamic-thresholding percentile
    `tq`. The input table is not mutated."""
    spec = spec.resolve()
    n_evals = len(tab.timesteps)
    cols = dict(tab.model_cols or {})
    if spec.cfg_scale:
        cols["g"] = guidance_schedule(spec.cfg_scale, n_evals,
                                      spec.cfg_schedule, spec.cfg_scale_end)
    if spec.thresholding:
        if tab.prediction != "data":
            raise ValueError("dynamic thresholding clips the x0 "
                             "prediction; use a data-prediction solver")
        cols["tq"] = guidance_schedule(spec.threshold_percentile, n_evals)
    return dc_replace(tab, model_cols=cols)


def step_guidance_profile(tab: SolverTable, spec: EngineSpec) -> np.ndarray:
    """(M+1,) guidance profile for the per-slot step path, host-side float64:
    the compiled `g` column normalized by the spec's nominal scale. The
    effective per-slot scale at row i is `g_slot * profile[i]`."""
    cols = tab.model_cols or {}
    if "g" not in cols or not spec.cfg_scale:
        raise ValueError("guidance profile needs a table compiled with "
                         "cfg_scale != 0")
    return np.asarray(cols["g"], np.float64) / float(spec.cfg_scale)


# ---------------------------------------------------------------------------
# shared machinery
# ---------------------------------------------------------------------------


def _empty_table(spec: EngineSpec, noise_schedule, steps: int, K: int,
                 prediction: str) -> SolverTable:
    t, lam, alpha, sigma = timestep_grid(noise_schedule, steps, spec.spacing)
    M = steps
    Kc = max(K, spec.corrector_order - 1 if spec.use_corrector else 0, 1)
    return SolverTable(
        lambdas=lam, alphas=alpha, sigmas=sigma, order=spec.order,
        prediction=prediction, variant=spec.variant,
        base_x=np.zeros(M), base_m0=np.zeros(M),
        w_pred=np.zeros((M, Kc)), w_corr_prev=np.zeros((M, Kc)),
        w_corr_new=np.zeros(M), use_corrector=np.zeros(M),
        out_scale=(sigma[1:] if prediction == "noise" else alpha[1:]).copy(),
        sign=-1.0 if prediction == "noise" else 1.0,
        timesteps=t, orders=[],
        base_x_corr=np.zeros(M), base_m0_corr=np.zeros(M),
    )


def _apply_unic(tab: SolverTable, spec: EngineSpec) -> SolverTable:
    """Fill the corrector columns: UniC-p over the solver's own grid, anchored
    on the semilinear base (method-agnostic, Alg. 1/3 / Table 2)."""
    lam, alpha, sigma = tab.lambdas, tab.alphas, tab.sigmas
    M = len(tab.base_x)
    p = spec.corrector_order
    for i in range(1, M + 1):
        h = float(lam[i] - lam[i - 1])
        tab.base_x_corr[i - 1], tab.base_m0_corr[i - 1] = semilinear_coeffs(
            h, alpha[i - 1], alpha[i], sigma[i - 1], sigma[i], tab.prediction)
        p_i = min(p, i)
        r_prev = np.array(
            [(lam[i - 1 - m] - lam[i - 1]) / h for m in range(1, p_i)])
        wc = unipc_weights(np.concatenate([r_prev, [1.0]]), h, spec.variant,
                           tab.prediction)
        tab.w_corr_prev[i - 1, : len(wc) - 1] = wc[:-1]
        tab.w_corr_new[i - 1] = wc[-1]
        last = i == M
        tab.use_corrector[i - 1] = 1.0 if (not last or spec.corrector_at_last) else 0.0
    return tab


def _loop_corrector(spec: EngineSpec):
    if not spec.use_corrector:
        return None
    return CorrectorConfig(order=spec.corrector_order, variant=spec.variant,
                           at_last_step=spec.corrector_at_last)


def _grid(spec: EngineSpec, noise_schedule, steps: int) -> Grid:
    return Grid.build(noise_schedule, steps, spec.spacing)


def _with_solver(s, sample_fn):
    """Expose the GridSolver on the loop closure so callers can read the
    measured NFE (`fn.solver.model.nfe`) after a run."""
    sample_fn.solver = s
    return sample_fn


# ---------------------------------------------------------------------------
# UniPC — the native table (delegates to core.coeffs)
# ---------------------------------------------------------------------------


def _compile_unipc(spec: EngineSpec, noise_schedule) -> SolverTable:
    t, lam, alpha, sigma = timestep_grid(noise_schedule, spec.nfe, spec.spacing)
    return build_unipc_schedule(
        lambdas=lam, alphas=alpha, sigmas=sigma, timesteps=t,
        order=spec.order, prediction=spec.prediction, variant=spec.variant,
        use_corrector=spec.use_corrector,
        corrector_at_last=spec.corrector_at_last,
        lower_order_final=spec.lower_order_final,
    )


def _loop_unipc(spec: EngineSpec, noise_schedule, model_fn):
    s = UniPC(model_fn, _grid(spec, noise_schedule, spec.nfe),
              order=spec.order, prediction=spec.prediction,
              variant=spec.variant, lower_order_final=spec.lower_order_final)
    return _with_solver(
        s, lambda x_T: s.sample_pc(x_T, use_corrector=spec.use_corrector))


register(SolverDef(
    name="unipc", prediction="data", fixed_prediction=False,
    compile=_compile_unipc, loop=_loop_unipc, corrector_default=True))


# ---------------------------------------------------------------------------
# DDIM — the semilinear base alone (== UniP-1)
# ---------------------------------------------------------------------------


def _compile_ddim(spec: EngineSpec, noise_schedule) -> SolverTable:
    tab = _empty_table(spec, noise_schedule, spec.nfe, 1, spec.prediction)
    lam, alpha, sigma = tab.lambdas, tab.alphas, tab.sigmas
    for i in range(1, spec.nfe + 1):
        h = float(lam[i] - lam[i - 1])
        tab.base_x[i - 1], tab.base_m0[i - 1] = semilinear_coeffs(
            h, alpha[i - 1], alpha[i], sigma[i - 1], sigma[i], spec.prediction)
        tab.orders.append(1)
    if spec.use_corrector:
        _apply_unic(tab, spec)
    return tab


def _loop_ddim(spec: EngineSpec, noise_schedule, model_fn):
    s = DDIM(model_fn, _grid(spec, noise_schedule, spec.nfe),
             prediction=spec.prediction)
    return _with_solver(
        s, lambda x_T: s.sample(x_T, corrector=_loop_corrector(spec)))


register(SolverDef(
    name="ddim", prediction="noise", fixed_prediction=False,
    compile=_compile_ddim, loop=_loop_ddim,
    default_corrector_order=lambda spec: 1))


# ---------------------------------------------------------------------------
# DPM-Solver++ 1M/2M/3M — D1/D2 combinations re-based onto D_m = E[m] − E[0]
# ---------------------------------------------------------------------------


def _compile_dpmpp(spec: EngineSpec, noise_schedule) -> SolverTable:
    order = spec.order
    if order not in (1, 2, 3):
        raise ValueError("DPM-Solver++ multistep supports orders 1-3, got "
                         f"order={order}")
    M = spec.nfe
    tab = _empty_table(spec, noise_schedule, M, max(1, order - 1), "data")
    lam, alpha, sigma = tab.lambdas, tab.alphas, tab.sigmas
    for i in range(1, M + 1):
        p = min(order, i)
        if spec.lower_order_final:
            p = min(p, M - i + 1)
        h = float(lam[i] - lam[i - 1])
        a_t = alpha[i]
        phi_1 = math.expm1(-h)
        tab.base_x[i - 1] = sigma[i] / sigma[i - 1]
        tab.base_m0[i - 1] = -a_t * phi_1
        tab.orders.append(max(1, p))
        if p >= 2:
            r0 = float(lam[i - 1] - lam[i - 2]) / h
            if p == 2:
                # −0.5·a_t·φ1·D1_0 with D1_0 = (m0−m1)/r0 = −D_1/r0
                tab.w_pred[i - 1, 0] = 0.5 * phi_1 / r0
            else:
                r1 = float(lam[i - 2] - lam[i - 3]) / h
                c0 = r0 / (r0 + r1)
                # D1 = (1+c0)·D1_0 − c0·D1_1; D2 = (D1_0 − D1_1)/(r0+r1),
                # with D1_0 = −D_1/r0 and D1_1 = (D_1 − D_2)/r1
                d1 = np.array([-(1.0 + c0) / r0 - c0 / r1, c0 / r1])
                d2 = np.array([(-1.0 / r0 - 1.0 / r1) / (r0 + r1),
                               1.0 / (r1 * (r0 + r1))])
                phi_2 = phi_1 / h + 1.0
                phi_3 = phi_2 / h - 0.5
                tab.w_pred[i - 1, :2] = phi_2 * d1 - phi_3 * d2
    if spec.use_corrector:
        _apply_unic(tab, spec)
    return tab


def _loop_dpmpp(spec: EngineSpec, noise_schedule, model_fn):
    s = DPMSolverPP(model_fn, _grid(spec, noise_schedule, spec.nfe),
                    order=spec.order,
                    lower_order_final=spec.lower_order_final)
    return _with_solver(
        s, lambda x_T: s.sample(x_T, corrector=_loop_corrector(spec)))


register(SolverDef(
    name="dpmpp", prediction="data",
    compile=_compile_dpmpp, loop=_loop_dpmpp))


# ---------------------------------------------------------------------------
# PLMS / Adams-Bashforth (PNDM) — AB ladder folded into the weight rows
# ---------------------------------------------------------------------------


def _compile_plms(spec: EngineSpec, noise_schedule) -> SolverTable:
    M = spec.nfe
    tab = _empty_table(spec, noise_schedule, M, 3, "noise")
    lam, alpha, sigma = tab.lambdas, tab.alphas, tab.sigmas
    for i in range(1, M + 1):
        h = float(lam[i] - lam[i - 1])
        n = min(i, 4)
        ab = PLMS_AB[n]
        tab.base_x[i - 1] = alpha[i] / alpha[i - 1]
        tab.base_m0[i - 1] = -sigma[i] * math.expm1(h)
        # e_AB = m0 + Σ_{j≥1} ab[j]·D_j  (Σ ab = 1), through the DDIM map:
        # −σ_t·expm1(h)·ab[j] on D_j, i.e. w_j = expm1(h)·ab[j] under sign=−1
        tab.w_pred[i - 1, : n - 1] = math.expm1(h) * ab[1:]
        tab.orders.append(n)
    if spec.use_corrector:
        _apply_unic(tab, spec)
    return tab


def _loop_plms(spec: EngineSpec, noise_schedule, model_fn):
    s = PNDM(model_fn, _grid(spec, noise_schedule, spec.nfe))
    return _with_solver(
        s, lambda x_T: s.sample(x_T, corrector=_loop_corrector(spec)))


register(SolverDef(
    name="pndm", prediction="noise",
    compile=_compile_plms, loop=_loop_plms,
    default_corrector_order=lambda spec: PNDM.order))


# ---------------------------------------------------------------------------
# DEIS tAB-k — quadrature weights on raw evals become base_m0 + diff weights
# ---------------------------------------------------------------------------


def _compile_deis(spec: EngineSpec, noise_schedule,
                  quad_points: int = 64) -> SolverTable:
    order = spec.order
    M = spec.nfe
    tab = _empty_table(spec, noise_schedule, M, max(1, order - 1), "noise")
    t, alpha, sigma = tab.timesteps, tab.alphas, tab.sigmas
    for i in range(1, M + 1):
        k = min(order, i)
        ts_prev = [float(t[i - 1 - m]) for m in range(k)]  # newest first
        ws = deis_quad_weights(noise_schedule, float(t[i - 1]), float(t[i]),
                               float(alpha[i]), ts_prev, quad_points)
        tab.base_x[i - 1] = alpha[i] / alpha[i - 1]
        # Σ_j w_j e_j = (Σ w_j)·m0 + Σ_{j≥1} w_j·D_j; scan adds −σ_t·w on D_j
        tab.base_m0[i - 1] = float(np.sum(ws))
        tab.w_pred[i - 1, : k - 1] = -np.asarray(ws[1:]) / sigma[i]
        tab.orders.append(k)
    if spec.use_corrector:
        _apply_unic(tab, spec)
    return tab


def _loop_deis(spec: EngineSpec, noise_schedule, model_fn):
    s = DEIS(model_fn, _grid(spec, noise_schedule, spec.nfe), noise_schedule,
             order=spec.order)
    return _with_solver(
        s, lambda x_T: s.sample(x_T, corrector=_loop_corrector(spec)))


register(SolverDef(
    name="deis", prediction="noise",
    compile=_compile_deis, loop=_loop_deis))


# ---------------------------------------------------------------------------
# DPM-Solver 2S/3S — singlestep, compiled onto an expanded grid
# ---------------------------------------------------------------------------
#
# Each grid step [s → t] becomes `order` scan rows, one per intermediate
# point. The scan carries the *latest intermediate state*, so each row's
# update is re-based: substitute x = inverse-transfer(carry) into the
# original formula (exact, linear). At row k the eval ring holds exactly
# [m_{k-1}, ..., m_s]: the intermediates the singlestep formulas combine.


def _dpm_singlestep_rows(h, r_inner, aa, ss, prediction):
    """Per-substep (base_x, base_m0, w[]) for one grid step.

    aa/ss: [a_s, a_1, (a_2), a_t] / [s_s, s_1, (s_2), s_t] at the anchor,
    intermediate(s), and target. Mirrors `DPMSolverSinglestep.predict`.
    """
    noise = prediction == "noise"
    sgn = 1.0 if noise else -1.0      # expm1 argument sign: +h noise, −h data
    # role swap: noise scales differences by σ (sign −1), data by α (sign +1)
    A = aa if noise else ss           # semilinear ratio numerators
    S = ss if noise else aa           # difference/output scales
    rows = []
    if len(r_inner) == 1:             # order 2
        r1 = r_inner[0]
        phi_11 = math.expm1(sgn * r1 * h)
        phi_1 = math.expm1(sgn * h)
        a_s, a_1, a_t = A
        s_s, s_1, s_t = S
        rows.append((a_1 / a_s, -s_1 * phi_11, []))
        c_m1 = -(s_t / (2 * r1)) * phi_1
        c_ms = (a_t / a_1) * s_1 * phi_11 - s_t * phi_1 + (s_t / (2 * r1)) * phi_1
        rows.append((a_t / a_1, c_m1 + c_ms, [c_ms]))
        return rows
    r1, r2 = r_inner                  # order 3
    phi_11 = math.expm1(sgn * r1 * h)
    phi_12 = math.expm1(sgn * r2 * h)
    phi_1 = math.expm1(sgn * h)
    phi_22 = math.expm1(sgn * r2 * h) / (r2 * h) - sgn
    phi_2 = phi_1 / h - sgn
    a_s, a_1, a_2, a_t = A
    s_s, s_1, s_2, s_t = S
    rows.append((a_1 / a_s, -s_1 * phi_11, []))
    # x2 = (a2/a_s)x − s2·φ12·m_s − sgn·(r2/r1)·s2·φ22·(m1 − m_s), re-based on x1
    g22 = sgn * (r2 / r1) * s_2 * phi_22
    c_m1 = -g22
    c_ms = (a_2 / a_1) * s_1 * phi_11 - s_2 * phi_12 + g22
    rows.append((a_2 / a_1, c_m1 + c_ms, [c_ms]))
    # x_t = (a_t/a_s)x − s_t·φ1·m_s − sgn·(1/r2)·s_t·φ2·(m2 − m_s), re-based on x2
    g2 = sgn * (1.0 / r2) * s_t * phi_2
    c_m2 = -g2
    c_m1 = (a_t / a_2) * g22
    c_ms = (a_t / a_2) * (s_2 * phi_12 - g22) - s_t * phi_1 + g2
    rows.append((a_t / a_2, c_m2 + c_m1 + c_ms, [c_m1, c_ms]))
    return rows


def _compile_dpm_singlestep(spec: EngineSpec, noise_schedule) -> SolverTable:
    order = spec.order
    if order not in (2, 3):
        raise ValueError("DPM-Solver singlestep supports orders 2 and 3, "
                         f"got order={order}")
    prediction = spec.prediction
    G = max(1, spec.nfe // order)
    t, lam, alpha, sigma = timestep_grid(noise_schedule, G, spec.spacing)
    r_inner = [0.5] if order == 2 else [1.0 / 3.0, 2.0 / 3.0]
    # expanded point sequence: anchor, then every intermediate + grid target
    ts, lams, alphas, sigmas = [t[0]], [lam[0]], [alpha[0]], [sigma[0]]
    S = G * order
    K = order - 1
    tab_rows = []
    for i in range(1, G + 1):
        h = float(lam[i] - lam[i - 1])
        pts_a, pts_s, pts_t, pts_l = [alpha[i - 1]], [sigma[i - 1]], [], []
        for r in r_inner:
            lam_m = float(lam[i - 1] + r * h)
            t_m = float(noise_schedule.t_of_lam(lam_m))
            pts_t.append(t_m)
            pts_l.append(lam_m)
            pts_a.append(float(noise_schedule.alpha(t_m)))
            pts_s.append(float(noise_schedule.sigma(t_m)))
        pts_a.append(alpha[i])
        pts_s.append(sigma[i])
        pts_t.append(float(t[i]))
        pts_l.append(float(lam[i]))
        ts.extend(pts_t)
        lams.extend(pts_l)
        alphas.extend(pts_a[1:])
        sigmas.extend(pts_s[1:])
        rows = _dpm_singlestep_rows(h, r_inner, pts_a, pts_s, prediction)
        # difference weights carry out_scale at each row's own target point
        scales = pts_s[1:] if prediction == "noise" else pts_a[1:]
        sign = -1.0 if prediction == "noise" else 1.0
        for (bx, bm, cs), sc in zip(rows, scales):
            w = np.zeros(max(1, K))
            w[: len(cs)] = sign * np.asarray(cs) / sc if cs else []
            tab_rows.append((bx, bm, w, sc))
    base_x = np.array([r[0] for r in tab_rows])
    base_m0 = np.array([r[1] for r in tab_rows])
    w_pred = np.stack([r[2] for r in tab_rows])
    out_scale = np.array([r[3] for r in tab_rows])
    return SolverTable(
        lambdas=np.asarray(lams), alphas=np.asarray(alphas),
        sigmas=np.asarray(sigmas), order=order, prediction=prediction,
        variant=spec.variant,
        base_x=base_x, base_m0=base_m0, w_pred=w_pred,
        w_corr_prev=np.zeros_like(w_pred), w_corr_new=np.zeros(S),
        use_corrector=np.zeros(S), out_scale=out_scale,
        sign=-1.0 if prediction == "noise" else 1.0,
        timesteps=np.asarray(ts), orders=[order] * G,
    )


def _loop_dpm_singlestep(spec: EngineSpec, noise_schedule, model_fn):
    G = max(1, spec.nfe // spec.order)
    s = DPMSolverSinglestep(model_fn, _grid(spec, noise_schedule, G),
                            noise_schedule, order=spec.order,
                            prediction=spec.prediction)
    return _with_solver(s, lambda x_T: s.sample(x_T))


register(SolverDef(
    name="dpm", prediction="noise", fixed_prediction=False, singlestep=True,
    compile=_compile_dpm_singlestep, loop=_loop_dpm_singlestep))


# The flight step's done mask (DESIGN.md §16): a coded int32 per slot, not
# a boolean, so a slot that finished with a non-finite latent is told apart
# from one that finished well, on the device, with no host read.

DONE_IDLE = 0        # slot not finishing this tick (idle or mid-flight)
DONE_OK = 1          # slot finished; latent is finite
DONE_NONFINITE = 2   # slot finished; latent contains NaN/Inf


def finite_slots(x: torch.Tensor) -> torch.Tensor:
    """(B,) bool: True where every element of slot b of `x` is finite."""
    return torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)


def flag_done(done: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The coded (B,) int32 done mask from a boolean one and the slots'
    latents (DONE_* above)."""
    code = torch.where(finite_slots(x), DONE_OK, DONE_NONFINITE)
    return torch.where(done, code, DONE_IDLE).to(torch.int32)
