"""The port's python-loop solvers (`core/solver.py`, `core/unipc.py`'s loop
classes, `core/baselines.py`) and its analytic test model against the JAX
reference's.

* every loop solver of the zoo, with and without UniC (the oracle too), on
  the analytic Gaussian DPM in float64 torch, against the reference's loop
  fed the same numpy inputs: <= 1e-10; the free oracle <= 1e-6 (the
  reference forms its estimate in jnp float32);
* `GaussianDPM`, `MixtureDPM` and `empirical_order` against the
  reference's: <= 1e-12;
* `cfg_model` and `guided_data_model` (with and without thresholding)
  against the reference's on the same fp32 inputs: <= 1e-5;
* the reference's order and solver tests (tests/test_order.py,
  tests/test_solvers.py) rerun on the port, with their expectations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jc
from repro.core.solver import CorrectorConfig as JCorr
from repro.diffusion import GaussianDPM as JGauss
from repro.diffusion import MixtureDPM as JMix
from repro.diffusion import VPLinear as JVP
from repro.diffusion import empirical_order as j_empirical_order
from repro.diffusion.guidance import cfg_model as j_cfg_model
from repro.diffusion.guidance import guided_data_model as j_guided
from repro_torch import core as tc
from repro_torch.core.solver import CorrectorConfig
from repro_torch.diffusion import GaussianDPM, MixtureDPM, VPLinear
from repro_torch.diffusion import empirical_order
from repro_torch.diffusion.guidance import cfg_model as t_cfg_model
from repro_torch.diffusion.guidance import guided_data_model as t_guided

torch.set_num_threads(2)

X_T = np.array([1.3, -0.2, 0.5, 0.9, -1.1], np.float64)   # conftest's x_T
MS = [20, 40, 80, 160]


@pytest.fixture(scope="module")
def dpm():
    return GaussianDPM(VPLinear())


def _noise(d):
    """The exact eps of `d` on whatever array it is given (numpy for the
    reference, float64 torch for the port), as tests/test_solvers.py."""
    return lambda x, t: d.eps_model(x, t)


def _data(d):
    def f(x, t):
        sched = d.schedule
        a, s = float(sched.alpha(t)), float(sched.sigma(t))
        return (x - s * d.eps_model(x, t)) / a
    return f


def _model(d, prediction):
    return _noise(d) if prediction == "noise" else _data(d)


def _x(x_T=X_T):
    return torch.as_tensor(x_T, dtype=torch.float64)


def _err(x0, d, g, x_T=X_T):
    return float(np.max(np.abs(np.asarray(x0, np.float64)
                               - d.exact_solution(np.asarray(x_T), g.t[-1]))))


# ---------------------------------------------------------------------------
# every loop solver against the reference's, float64
# ---------------------------------------------------------------------------

# name -> (constructor(lib, model, grid, schedule), prediction)
SOLVERS = {
    "ddim-noise": (lambda L, m, g, s: L.DDIM(m, g, prediction="noise"),
                   "noise"),
    "ddim-data": (lambda L, m, g, s: L.DDIM(m, g, prediction="data"), "data"),
    "dpmpp-1": (lambda L, m, g, s: L.DPMSolverPP(m, g, order=1), "data"),
    "dpmpp-2": (lambda L, m, g, s: L.DPMSolverPP(m, g, order=2), "data"),
    "dpmpp-3": (lambda L, m, g, s: L.DPMSolverPP(m, g, order=3), "data"),
    "dpmpp-3-no-lower-final": (lambda L, m, g, s: L.DPMSolverPP(
        m, g, order=3, lower_order_final=False), "data"),
    "dpm-2s-noise": (lambda L, m, g, s: L.DPMSolverSinglestep(
        m, g, s, order=2, prediction="noise"), "noise"),
    "dpm-3s-noise": (lambda L, m, g, s: L.DPMSolverSinglestep(
        m, g, s, order=3, prediction="noise"), "noise"),
    "dpm-2s-data": (lambda L, m, g, s: L.DPMSolverSinglestep(
        m, g, s, order=2, prediction="data"), "data"),
    "dpm-3s-data": (lambda L, m, g, s: L.DPMSolverSinglestep(
        m, g, s, order=3, prediction="data"), "data"),
    "pndm": (lambda L, m, g, s: L.PNDM(m, g), "noise"),
    "deis-2": (lambda L, m, g, s: L.DEIS(m, g, s, order=2), "noise"),
    "deis-3": (lambda L, m, g, s: L.DEIS(m, g, s, order=3), "noise"),
    "unipc-1-noise": (lambda L, m, g, s: L.UniPC(
        m, g, order=1, prediction="noise"), "noise"),
    "unipc-2-data-bh1": (lambda L, m, g, s: L.UniPC(
        m, g, order=2, prediction="data", variant="bh1"), "data"),
    "unipc-3-data": (lambda L, m, g, s: L.UniPC(
        m, g, order=3, prediction="data"), "data"),
    "unipc-3-noise-vary": (lambda L, m, g, s: L.UniPC(
        m, g, order=3, prediction="noise", variant="vary"), "noise"),
    "unipc-schedule": (lambda L, m, g, s: L.UniPC(
        m, g, order=4, prediction="noise",
        order_schedule=[1, 2, 3, 4, 4, 3, 2, 2, 1, 1]), "noise"),
    "unipc-ss-2": (lambda L, m, g, s: L.UniPCSinglestep(
        m, g, s, order=2, prediction="noise"), "noise"),
    "unipc-ss-3": (lambda L, m, g, s: L.UniPCSinglestep(
        m, g, s, order=3, prediction="data"), "data"),
}

# how the loop is driven: label -> corrector from the library's
# CorrectorConfig class, or None
DRIVES = {
    "plain": None,
    "unic-2": lambda C: C(order=2, variant="bh2"),
    "unic-3-at-last": lambda C: C(order=3, variant="bh1", at_last_step=True),
    "oracle": lambda C: C(order=2, oracle=True),
}


def _run(lib, C, name, drive, d, x_T, nfe=10):
    ctor, pred = SOLVERS[name]
    g = lib.Grid.build(d.schedule, nfe)
    s = ctor(lib, _model(d, pred), g, d.schedule)
    corr = DRIVES[drive]
    out = s.sample(x_T, corrector=corr(C) if corr else None)
    return out, s.model.nfe


@pytest.mark.parametrize("drive", list(DRIVES))
@pytest.mark.parametrize("name", list(SOLVERS))
def test_loop_solver_matches_reference(name, drive):
    got, nfe = _run(tc, CorrectorConfig, name, drive,
                    GaussianDPM(VPLinear()), _x())
    want, want_nfe = _run(jc, JCorr, name, drive, JGauss(JVP()), X_T.copy())
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert nfe == want_nfe
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", ["ddim-noise", "dpmpp-3", "unipc-3-data"])
def test_free_oracle_matches_reference(name):
    """The free-oracle corrector's secant estimate: <= 1e-6, because the
    reference forms it with jnp, in float32 on this host, where the port
    keeps the loop's float64."""
    ctor, pred = SOLVERS[name]
    out = {}
    for lib, C, d, x in ((tc, CorrectorConfig, GaussianDPM(VPLinear()), _x()),
                         (jc, JCorr, JGauss(JVP()), X_T.copy())):
        s = ctor(lib, _model(d, pred), lib.Grid.build(d.schedule, 10),
                 d.schedule)
        out[lib] = (s.sample(x, corrector=C(order=2, free_oracle=0.5)),
                    s.model.nfe)
    unic, nfe = _run(tc, CorrectorConfig, name, "unic-2",
                     GaussianDPM(VPLinear()), _x())
    assert out[tc][1] == out[jc][1] == nfe
    assert out[tc][0].dtype == torch.float64
    # the estimate changes the run
    assert not np.allclose(out[tc][0].numpy(), unic.numpy(), rtol=0,
                           atol=1e-9)
    np.testing.assert_allclose(out[tc][0].numpy(),
                               np.asarray(out[jc][0], np.float64), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("oracle", [False, True])
@pytest.mark.parametrize("use_corrector", [False, True])
def test_unipc_sample_pc_matches_reference(use_corrector, oracle):
    d, jd = GaussianDPM(VPLinear()), JGauss(JVP())
    got = tc.UniPC(_data(d), tc.Grid.build(d.schedule, 12), order=3).sample_pc(
        _x(), use_corrector=use_corrector, oracle=oracle)
    want = jc.UniPC(_data(jd), jc.Grid.build(jd.schedule, 12),
                    order=3).sample_pc(X_T, use_corrector=use_corrector,
                                       oracle=oracle)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def test_history_lookups_match_reference():
    t_h, j_h = tc.History(maxlen=4), jc.History(maxlen=4)
    for i, lam in enumerate([-5.0, -3.0, -1.0, 1.0, 3.0, 5.0]):
        t_h.push(np.float64(lam), 0.1 * i, i)
        j_h.push(np.float64(lam), 0.1 * i, i)
    assert len(t_h.items) == 4
    for kw in ({"k": 2}, {"k": 3, "before_lam": 3.0},
               {"k": 4, "exclude_lam": (1.0,)}, {"k": 0}):
        assert t_h.last(**kw) == j_h.last(**kw)
    assert all(isinstance(lam, float) for lam, _, _ in t_h.items)
    assert t_h.at_lam(3.0) == j_h.at_lam(3.0)
    with pytest.raises(KeyError, match="no eval"):
        t_h.at_lam(-5.0)


# ---------------------------------------------------------------------------
# the analytic models
# ---------------------------------------------------------------------------


def test_gaussian_and_mixture_match_reference():
    x = np.linspace(-2.5, 2.5, 11)
    for t in (1.0, 0.5, 0.05, 1e-3):
        for mu, s in ((0.7, 0.35), (-0.4, 0.5)):
            d, jd = GaussianDPM(VPLinear(), mu, s), JGauss(JVP(), mu, s)
            np.testing.assert_allclose(
                d.eps_model(torch.as_tensor(x), t).numpy(), jd.eps_model(x, t),
                rtol=0, atol=1e-12)
            np.testing.assert_allclose(d.exact_solution(x, t),
                                       jd.exact_solution(x, t), rtol=0,
                                       atol=1e-12)
        m, jm = MixtureDPM(VPLinear()), JMix(JVP())
        np.testing.assert_array_equal(m.eps_model(x, t), jm.eps_model(x, t))
        np.testing.assert_array_equal(m.component_eps_model(1)(x, t),
                                      jm.component_eps_model(1)(x, t))
    errs = [0.3, 0.04, 0.006, 0.0007]
    assert empirical_order(errs, MS) == j_empirical_order(errs, MS)


# ---------------------------------------------------------------------------
# sequential guidance
# ---------------------------------------------------------------------------


def _gauss_eps(mu, s, xp):
    asarray, exp, sqrt, log_alpha = xp

    def eps(x, t):
        t = asarray(t)
        a = exp(log_alpha(t))
        sig = sqrt(1 - a * a)
        return sig * (x - a * mu) / (a * a * s ** 2 + sig * sig)

    return eps


def _pair(mu, s):
    return (_gauss_eps(mu, s, (jnp.asarray, jnp.exp, jnp.sqrt,
                               JVP().log_alpha_jax)),
            _gauss_eps(mu, s, (lambda t: torch.as_tensor(t, dtype=torch.float32),
                               torch.exp, torch.sqrt, VPLinear().log_alpha_torch)))


@pytest.mark.parametrize("thresholding", [False, True])
def test_cfg_model_and_guided_data_model_match_reference(thresholding):
    (jc_, tc_), (ju, tu) = _pair(0.7, 0.35), _pair(-0.4, 0.5)
    x = np.random.default_rng(0).normal(size=(3, 64)).astype(np.float32) * 2
    for t in (0.9, 0.3, 0.01):
        np.testing.assert_allclose(
            t_cfg_model(tc_, tu, 2.0)(torch.as_tensor(x), t).numpy(),
            np.asarray(j_cfg_model(jc_, ju, 2.0)(jnp.asarray(x), t)),
            rtol=0, atol=1e-5)
        got = t_guided(VPLinear(), tc_, tu, 2.0, thresholding, 0.9)(
            torch.as_tensor(x), t)
        want = j_guided(JVP(), jc_, ju, 2.0, thresholding, 0.9)(
            jnp.asarray(x), t)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# the reference's order tests (tests/test_order.py), on the port
# ---------------------------------------------------------------------------


def _unipc_errors(d, order, prediction, variant, use_corrector):
    errs = []
    for M in MS:
        g = tc.Grid.build(d.schedule, M)
        s = tc.UniPC(_model(d, prediction), g, order=order,
                     prediction=prediction, variant=variant,
                     lower_order_final=False)
        errs.append(_err(s.sample_pc(_x(), use_corrector=use_corrector), d, g)
                    + 1e-300)
    return errs


@pytest.mark.parametrize("order,expect", [(1, 1.0), (2, 2.0), (3, 3.0)])
@pytest.mark.parametrize("prediction", ["noise", "data"])
def test_unip_order(dpm, order, expect, prediction):
    """Cor 3.2: UniP-p has order p."""
    errs = _unipc_errors(dpm, order, prediction, "bh2", False)
    slope = empirical_order(errs, MS)
    assert slope > expect - 0.35, (slope, errs)


@pytest.mark.parametrize("order,expect", [(1, 2.0), (2, 3.0)])
@pytest.mark.parametrize("variant", ["bh1", "bh2", "vary"])
def test_unipc_order(dpm, order, expect, variant):
    """Thm 3.1: UniPC-p (predictor + corrector) has order p+1."""
    errs = _unipc_errors(dpm, order, "noise", variant, True)
    slope = empirical_order(errs, MS)
    assert slope > expect - 0.35, (slope, errs)


def test_unic_raises_ddim_order(dpm):
    """Table 2 mechanism: UniC-1 after DDIM raises the measured order by ~1."""
    slopes = {}
    for corr in (None, CorrectorConfig(order=1, variant="bh2")):
        errs = []
        for M in MS:
            g = tc.Grid.build(dpm.schedule, M)
            x0 = tc.DDIM(_noise(dpm), g, prediction="noise").sample(
                _x(), corrector=corr)
            errs.append(_err(x0, dpm, g) + 1e-300)
        slopes[corr is None] = empirical_order(errs, MS)
    assert slopes[False] > slopes[True] + 0.6, slopes


def test_oracle_not_worse(dpm):
    """Table 3: UniC-oracle (re-eval at the corrected point) >= plain UniC."""
    res = {}
    for oracle in (False, True):
        g = tc.Grid.build(dpm.schedule, 20)
        s = tc.UniPC(_data(dpm), g, order=2, prediction="data")
        x0 = s.sample(_x(), corrector=CorrectorConfig(order=2, variant="bh2",
                                                      oracle=oracle))
        res[oracle] = _err(x0, dpm, g)
    assert res[True] <= res[False] * 1.5, res


# ---------------------------------------------------------------------------
# the reference's solver tests (tests/test_solvers.py), on the port
# ---------------------------------------------------------------------------

BASELINES = {
    "ddim": lambda d, g: tc.DDIM(_noise(d), g, prediction="noise"),
    "dpmpp2": lambda d, g: tc.DPMSolverPP(_data(d), g, order=2),
    "dpmpp3": lambda d, g: tc.DPMSolverPP(_data(d), g, order=3),
    "dpm3s": lambda d, g: tc.DPMSolverSinglestep(_noise(d), g, d.schedule,
                                                 order=3, prediction="noise"),
    "pndm": lambda d, g: tc.PNDM(_noise(d), g),
    "deis": lambda d, g: tc.DEIS(_noise(d), g, d.schedule, order=3),
}


def test_ddim_equals_unip1(dpm):
    """§3.3: when p=1, UniP reduces to DDIM — exact equality."""
    g = tc.Grid.build(dpm.schedule, 12)
    d = tc.DDIM(_noise(dpm), g, prediction="noise").sample(_x())
    u = tc.UniPC(_noise(dpm), g, order=1, prediction="noise").sample_pc(
        _x(), use_corrector=False)
    np.testing.assert_allclose(d.numpy(), u.numpy(), rtol=1e-12)


def test_dpm_solver2_equals_unip2_bh2(dpm):
    """§3.3: DPM-Solver-2 is UniP-2 with B(h) = e^h - 1 (singlestep,
    r1 = 0.5)."""
    g = tc.Grid.build(dpm.schedule, 10)
    ref = tc.DPMSolverSinglestep(_noise(dpm), g, dpm.schedule, order=2,
                                 prediction="noise").sample(_x())
    uni = tc.UniPCSinglestep(_noise(dpm), g, dpm.schedule, order=2,
                             prediction="noise", variant="bh2").sample(_x())
    np.testing.assert_allclose(ref.numpy(), uni.numpy(), rtol=1e-7)


@pytest.mark.parametrize("solver_key", list(BASELINES))
def test_baselines_converge(dpm, solver_key):
    errs = []
    for M in (20, 80):
        g = tc.Grid.build(dpm.schedule, M)
        errs.append(_err(BASELINES[solver_key](dpm, g).sample(_x()), dpm, g))
    assert errs[1] < errs[0], (solver_key, errs)
    assert errs[1] < 0.05, (solver_key, errs)


@pytest.mark.parametrize("solver_key,order", [
    ("ddim", 1), ("dpmpp2", 2), ("dpmpp3", 3), ("dpm3s", 3), ("pndm", 3),
    ("deis", 3)])
def test_unic_improves_every_solver(dpm, solver_key, order):
    """Table 2: UniC is method-agnostic — it improves each off-the-shelf
    solver at the same grid."""
    res = {}
    for use_c in (False, True):
        g = tc.Grid.build(dpm.schedule, 16)
        corr = CorrectorConfig(order=order, variant="bh2") if use_c else None
        res[use_c] = _err(BASELINES[solver_key](dpm, g).sample(
            _x(), corrector=corr), dpm, g)
    assert res[True] < res[False], (solver_key, res)


def test_unic_improves_dpmpp(dpm):
    """UniC after DPM-Solver++(2M) reduces error at a fixed budget."""
    errors = {}
    for corr in (None, CorrectorConfig(order=2, variant="bh2")):
        g = tc.Grid.build(dpm.schedule, 40)
        x0 = tc.DPMSolverPP(_data(dpm), g, order=2).sample(_x(),
                                                          corrector=corr)
        errors[corr is None] = _err(x0, dpm, g)
    assert errors[False] < errors[True], errors


def test_singlestep_unipc_converges(dpm):
    errs = []
    for M in (10, 40):
        g = tc.Grid.build(dpm.schedule, M)
        s = tc.UniPCSinglestep(_noise(dpm), g, dpm.schedule, order=3,
                               prediction="noise")
        errs.append(_err(s.sample(_x()), dpm, g))
    assert errs[1] < errs[0] and errs[1] < 0.01, errs


def test_custom_order_schedule(dpm):
    """Table 4 mechanism: arbitrary order schedules run and stay finite."""
    g = tc.Grid.build(dpm.schedule, 7)
    for sched in ([1, 2, 3, 3, 3, 2, 1], [1, 2, 2, 3, 3, 3, 4],
                  [1, 2, 3, 4, 5, 6, 7]):
        s = tc.UniPC(_noise(dpm), g, order=max(sched), prediction="noise",
                     order_schedule=sched)
        assert torch.isfinite(s.sample_pc(_x(), use_corrector=True)).all()


def test_nfe_accounting(dpm):
    """The corrector adds no NFE (the current-step eval is re-used); the
    oracle does (Table 3's NFE caveat)."""
    for use_c in (False, True):
        g = tc.Grid.build(dpm.schedule, 9)
        s = tc.UniPC(_noise(dpm), g, order=3, prediction="noise")
        s.sample_pc(_x(), use_corrector=use_c)
        assert s.model.nfe == 9, (use_c, s.model.nfe)
    g = tc.Grid.build(dpm.schedule, 9)
    s = tc.UniPC(_noise(dpm), g, order=3, prediction="noise")
    s.sample(_x(), corrector=CorrectorConfig(order=3, oracle=True))
    assert s.model.nfe > 9
