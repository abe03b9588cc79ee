"""The port's noise schedules and forward process against the JAX
reference's.

* VPLinear, VPCosine and EDM: host float64 functions and timestep grids
  (every spacing) bit-equal (`assert_array_equal`), and the DEIS quadrature
  weights built on them bit-equal;
* the torch twins (`alpha_sigma_torch`) against JAX's at fp32 (<= 1e-6
  relative L-inf: sigma = sqrt(1 - alpha^2) cancels near t_eps, so not
  element by element) and against the host float64 values at float64
  (<= 1e-12);
* `q_sample`, `x0_to_eps`, `wrap_model` and `eps_to_x0` at fp32 against
  the reference's (<= 1e-5 relative), and at float64 inverse to each other
  (<= 1e-12);
* tests/test_schedules_extra.py rerun on the port's loop solvers, with its
  expectations, and each run against the reference's loop (<= 1e-10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jc
from repro.core.baselines import deis_quad_weights as j_deis_weights
from repro.diffusion import EDMSchedule as JEDM
from repro.diffusion import GaussianDPM as JGauss
from repro.diffusion import VPCosine as JCos
from repro.diffusion import VPLinear as JVP
from repro.diffusion import process as jp
from repro.diffusion import timestep_grid as j_grid
from repro_torch import core as tc
from repro_torch.core.baselines import deis_quad_weights as t_deis_weights
from repro_torch.diffusion import (EDMSchedule, GaussianDPM, VPCosine,
                                   VPLinear, empirical_order, timestep_grid)
from repro_torch.diffusion import process as tp

torch.set_num_threads(2)

# name -> (port schedule, reference schedule)
SCHEDULES = {
    "vp-linear": (VPLinear(), JVP()),
    "vp-linear-0.05-12": (VPLinear(beta_0=0.05, beta_1=12.0),
                          JVP(beta_0=0.05, beta_1=12.0)),
    "vp-cosine": (VPCosine(), JCos()),
    "edm": (EDMSchedule(), JEDM()),
    "edm-10": (EDMSchedule(T=10.0, t_eps=0.05), JEDM(T=10.0, t_eps=0.05)),
}


def _ts(sched):
    return np.linspace(sched.t_eps, sched.T, 37)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_host_schedule_functions_bit_equal(name):
    t_s, j_s = SCHEDULES[name]
    ts = _ts(t_s)
    for fn in ("log_alpha", "alpha", "sigma", "lam"):
        np.testing.assert_array_equal(getattr(t_s, fn)(ts),
                                      getattr(j_s, fn)(ts), err_msg=fn)
    lams = j_s.lam(ts)
    np.testing.assert_array_equal(t_s.t_of_lam(lams), j_s.t_of_lam(lams))
    np.testing.assert_allclose(t_s.t_of_lam(t_s.lam(ts)), ts, rtol=1e-9)


@pytest.mark.parametrize("nfe", [5, 16])
@pytest.mark.parametrize("spacing", ["logsnr", "time_uniform",
                                     "time_quadratic"])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_timestep_grids_bit_equal(name, spacing, nfe):
    t_s, j_s = SCHEDULES[name]
    for got, want in zip(timestep_grid(t_s, nfe, spacing),
                         j_grid(j_s, nfe, spacing)):
        np.testing.assert_array_equal(got, want)
    assert len(tc.Grid.build(t_s, nfe, spacing)) == nfe


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("name", ["vp-linear", "vp-cosine", "edm-10"])
def test_deis_quad_weights_bit_equal(name, order):
    """Every step's weights of a 12-step grid: float64 numpy end to end."""
    t_s, j_s = SCHEDULES[name]
    t, _, alpha, _ = timestep_grid(t_s, 12)
    for i in range(1, 13):
        ts_prev = [float(t[i - 1 - m]) for m in range(min(order, i))]
        got = t_deis_weights(t_s, float(t[i - 1]), float(t[i]),
                             float(alpha[i]), ts_prev)
        want = j_deis_weights(j_s, float(t[i - 1]), float(t[i]),
                              float(alpha[i]), ts_prev)
        assert all(isinstance(w, float) for w in got)
        np.testing.assert_array_equal(got, want, err_msg=f"step {i}")


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_torch_twins_match_reference_and_host(name):
    t_s, j_s = SCHEDULES[name]
    ts = _ts(t_s)
    a32, s32 = t_s.alpha_sigma_torch(torch.as_tensor(ts, dtype=torch.float32))
    ja, js = j_s.alpha_sigma_jax(jnp.asarray(ts, jnp.float32))
    assert a32.dtype == s32.dtype == torch.float32
    for got, want in ((a32, ja), (s32, js)):
        assert _rel(got, want) <= 1e-6
    a64, s64 = t_s.alpha_sigma_torch(torch.as_tensor(ts))
    np.testing.assert_allclose(a64.numpy(), t_s.alpha(ts), rtol=1e-12)
    np.testing.assert_allclose(s64.numpy(), t_s.sigma(ts), rtol=1e-12)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("name", ["vp-linear", "vp-cosine", "edm"])
def test_process_matches_reference(name, per_sample):
    t_s, j_s = SCHEDULES[name]
    rng = np.random.default_rng(0)
    x, eps = (rng.normal(size=(4, 16, 3)).astype(np.float32)
              for _ in range(2))
    t = (np.array([0.9, 0.5, 0.2, 0.01], np.float32) * t_s.T if per_sample
         else np.float32(0.4 * t_s.T))
    tt = torch.as_tensor(t) if per_sample else float(t)
    X, EPS = torch.as_tensor(x), torch.as_tensor(eps)
    xt = tp.q_sample(t_s, X, torch.as_tensor(np.broadcast_to(t, (4,)).copy()),
                     EPS)
    j_xt = jp.q_sample(j_s, jnp.asarray(x),
                       jnp.asarray(np.broadcast_to(t, (4,))), jnp.asarray(eps))
    assert _rel(xt, j_xt) <= 1e-5
    pairs = [(tp.x0_to_eps(t_s, xt, tt, X), jp.x0_to_eps(j_s, j_xt, t, x)),
             (tp.eps_to_x0(t_s, xt, tt, EPS), jp.eps_to_x0(j_s, j_xt, t, eps))]
    for pred in ("noise", "data"):
        pairs.append((
            tp.wrap_model(t_s, lambda x_, t_: 0.5 * x_, pred)(xt, tt),
            jp.wrap_model(j_s, lambda x_, t_: 0.5 * x_, pred)(j_xt, t)))
    for got, want in pairs:
        assert got.dtype == torch.float32 and got.shape == (4, 16, 3)
        assert _rel(got, want) <= 1e-5
    # at float64 the conversions invert each other
    x64, e64 = X.double(), EPS.double()
    t64 = tt.double() if per_sample else tt
    xt64 = tp.q_sample(t_s, x64, torch.as_tensor(np.broadcast_to(
        t, (4,)).astype(np.float64)), e64)
    np.testing.assert_allclose(tp.x0_to_eps(t_s, xt64, t64, x64).numpy(),
                               e64.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tp.eps_to_x0(t_s, xt64, t64, e64).numpy(),
                               x64.numpy(), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# tests/test_schedules_extra.py on the port's loop solvers
# ---------------------------------------------------------------------------


def _loop_errors(name, lib_run, Ms, x_T, mu=0.7, s=0.35):
    """errors of the port's run at each M, each run also held against the
    reference's loop on the same numpy inputs (<= 1e-10)."""
    t_s, j_s = SCHEDULES[name]
    d, jd = GaussianDPM(t_s, mu=mu, s=s), JGauss(j_s, mu=mu, s=s)
    errs = []
    for M in Ms:
        got, g = lib_run(tc, d, torch.as_tensor(x_T), M)
        want, _ = lib_run(jc, jd, x_T.copy(), M)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-10, err_msg=f"M={M}")
        errs.append(float(np.max(np.abs(
            got.numpy() - d.exact_solution(x_T, g.t[-1])))) + 1e-300)
    return errs


def _unipc_run(order, spacing="logsnr", lower_order_final=False):
    def run(lib, d, x_T, M):
        g = lib.Grid.build(d.schedule, M, spacing=spacing)
        s = lib.UniPC(lambda x, t: d.eps_model(x, t), g, order=order,
                      prediction="noise", lower_order_final=lower_order_final)
        return s.sample_pc(x_T, use_corrector=True), g
    return run


@pytest.mark.parametrize("name", ["vp-cosine", "vp-linear-0.05-12"])
def test_unipc_on_other_vp_schedules(name):
    errs = _loop_errors(name, _unipc_run(3), (20, 80),
                        np.array([1.1, -0.4, 0.8]))
    assert errs[1] < errs[0] / 50, errs  # >= order-3 behaviour


def test_unipc_on_edm_schedule():
    """EDM: alpha=1, sigma=t (VE parametrization) — the lambda maps outside
    the VP family."""
    errs = _loop_errors("edm-10", _unipc_run(2), (20, 80),
                        np.array([2.0, -1.5, 0.7]), mu=0.3, s=0.5)
    assert errs[1] < errs[0] / 8 and errs[1] < 1e-2, errs


def test_singlestep_unipc_order():
    """Singlestep UniPC-2 measured order ~2 (NFE = 2 per grid step)."""
    def run(lib, d, x_T, M):
        g = lib.Grid.build(d.schedule, M)
        return lib.UniPCSinglestep(lambda x, t: d.eps_model(x, t), g,
                                   d.schedule, order=2,
                                   prediction="noise").sample(x_T), g

    Ms = (10, 20, 40, 80)
    errs = _loop_errors("vp-linear", run, Ms,
                        np.array([1.3, -0.2, 0.5, 0.9, -1.1]))
    slope = empirical_order(errs, Ms)
    assert slope > 1.6, (slope, errs)


@pytest.mark.parametrize("spacing", ["time_uniform", "time_quadratic"])
def test_time_spacings(spacing):
    """time_uniform / quadratic spacings also converge (coarser than
    logsnr)."""
    errs = _loop_errors("vp-linear", _unipc_run(2, spacing, True), (80,),
                        np.array([1.0, -0.5]))
    assert errs[0] < 0.05, (spacing, errs)
