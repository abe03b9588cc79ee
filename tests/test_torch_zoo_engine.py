"""The solver zoo through the port's engine, against the JAX reference's and
against the port's own loop references.

* every compiler's weight table, and the row table the engine loads,
  bit-equal to the reference's (`assert_array_equal` on every column):
  the cases of tests/test_engine.py's scan tests at NFE 5/10/20, DPM-Solver
  2S/3S at NFE 10/20 and every UniC bolt-on case;
* the engine's row loop (fp32) against the port's python-loop reference
  (float64) on the analytic Gaussian DPM: <= 1e-5, as tests/test_engine.py
  (DPM-Solver singlestep from NFE 10, where the re-based rows' fp32
  cancellation stays under the bound); the singlestep compile is exact at
  float64 (<= 1e-9); UniC improves every bolted-on solver;
* the port's engine against JAX's engine on the same fp32 inputs, guided,
  for every solver, and `build_loop` with sequential guidance against the
  reference's `build_loop` and the port's engine: <= 1e-5 for data
  prediction, 1e-4 for noise prediction (`_guided_tol`);
* plan banks that mix solvers (a `dpmpp` tier beside `unipc` tiers; noise
  tiers of ring depths 2-4) against the reference's `build_bank`, tick by
  tick through `step_flight` (meta and done codes equal; states <= 1e-5,
  noise tiers 2e-3 relative, `BANK_NOISE_TOL`), and each completion
  against its tier's uniform run (<= 1e-5);
* the spec checks, the registry's errors and `launch/sample.py`'s
  `--solver` / `--loop` / `--thresholding` / `--no-fused-update` and their
  argparse errors; `sample()` of the reduced dit-i256 for a zoo solver
  against the reference's engine path (<= 1e-4 relative) and against its
  own loop.

The `gpu` tests hold the row kernel bit-equal to its plain version at fp32
on the widest zoo tables and a CUDA graph of each zoo run bit-equal to its
eager loop; they skip without a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.diffusion import VPLinear as JVP
from repro.engine import SOLVERS as J_SOLVERS
from repro.engine import EngineSpec as JSpec
from repro.engine import SamplerEngine as JEngine
from repro.engine import compile_table as j_compile
from repro.launch.sample import build_engine as j_build_engine
from repro.models import api as j_api
from repro_torch.core.coeffs import augment_step_rows as t_augment
from repro_torch.diffusion import GaussianDPM, VPLinear
from repro_torch.engine import SOLVERS, EngineSpec, SamplerEngine
from repro_torch.engine import compile_table
from repro_torch.engine.compiler import DONE_OK
from repro_torch.kernels.unipc_update import ops as row_ops
from repro_torch.launch import sample as launch
from repro_torch.models import api as t_api

torch.set_num_threads(2)

X_T = np.array([1.3, -0.2, 0.5, 0.9, -1.1], np.float64)   # conftest's x_T
COND, UNCOND = (0.7, 0.35), (-0.4, 0.5)   # (mu, s) of the analytic data laws

SCAN_CASES = [("ddim", 1), ("dpmpp", 1), ("dpmpp", 2), ("dpmpp", 3),
              ("pndm", 4), ("deis", 2), ("deis", 3), ("unipc", 2),
              ("unipc", 3)]                     # tests/test_engine.py:43-47
UNIC_CASES = [("ddim", 1), ("dpmpp", 2), ("dpmpp", 3), ("pndm", 4),
              ("deis", 3)]                      # tests/test_engine.py:93-94


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _gauss_eps(mu, s, xp):
    """Exact eps of data ~ N(mu, s^2 I) under VPLinear; scalar or (B,) t.
    `xp` is (asarray, exp, sqrt, log_alpha) of one framework."""
    asarray, exp, sqrt, log_alpha = xp

    def eps(x, t, **_):
        t = asarray(t)
        a = exp(log_alpha(t))
        sig = sqrt(1 - a * a)
        if t.ndim == 1:
            a = a.reshape((-1,) + (1,) * (x.ndim - 1))
            sig = sig.reshape(a.shape)
        return sig * (x - a * mu) / (a * a * s ** 2 + sig * sig)

    return eps


def _j_eps(mu, s):
    return _gauss_eps(mu, s, (jnp.asarray, jnp.exp, jnp.sqrt,
                              JVP().log_alpha_jax))


def _t_eps(mu, s, device="cpu"):
    return _gauss_eps(mu, s, (lambda t: torch.as_tensor(t, device=device),
                              torch.exp, torch.sqrt,
                              VPLinear().log_alpha_torch))


def _stacked(eps_c, eps_u, cat, split):
    def eps_stacked(xx, t, **_):
        x1, x2 = split(xx)
        t1, t2 = split(t) if np.ndim(t) == 1 else (t, t)
        return cat([eps_c(x1, t1), eps_u(x2, t2)])
    return eps_stacked


def j_engine():
    ec, eu = _j_eps(*COND), _j_eps(*UNCOND)
    return JEngine(JVP(), eps=ec, eps_uncond=eu, eps_stacked=_stacked(
        ec, eu, lambda a: jnp.concatenate(a, 0), lambda a: jnp.split(a, 2, 0)))


def t_engine(device="cpu"):
    ec, eu = _t_eps(*COND, device=device), _t_eps(*UNCOND, device=device)
    return SamplerEngine(VPLinear(), eps=ec, eps_uncond=eu,
                         eps_stacked=_stacked(ec, eu, lambda a: torch.cat(a, 0),
                                              lambda a: torch.chunk(a, 2, 0)),
                         device=device)


def _engines():
    """(the row-loop engine on the fp32 torch eps, the loop engine on the
    port's float64 GaussianDPM), as tests/test_engine.py:_engines."""
    dpm = GaussianDPM(VPLinear())
    return (SamplerEngine(dpm.schedule, eps=_t_eps(*COND), device="cpu"),
            SamplerEngine(dpm.schedule, eps=dpm.eps_model, device="cpu"))


# ---------------------------------------------------------------------------
# the tables, bit-equal
# ---------------------------------------------------------------------------

TABLE_CASES = ([(s, o, n, None) for s, o in SCAN_CASES for n in (5, 10, 20)]
               + [("dpm", o, n, None) for o in (2, 3) for n in (10, 20)]
               + [(s, o, 16, True) for s, o in UNIC_CASES])


@pytest.mark.parametrize("solver,order,nfe,use_corrector", TABLE_CASES,
                         ids=lambda v: str(v))
def test_tables_bit_equal_to_reference(solver, order, nfe, use_corrector):
    spec = dict(solver=solver, order=order, nfe=nfe,
                use_corrector=use_corrector)
    got = compile_table(EngineSpec(**spec), VPLinear())
    want = j_compile(JSpec(**spec), JVP())
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, (f.name, a, b)
    # the row table the engine loads, guided and thresholded where it can
    kw = dict(spec, cfg_scale=2.0, cfg_schedule="cosine",
              thresholding=got.prediction == "data")
    rows = t_augment(t_engine().compile(EngineSpec(**kw)))
    from repro.core.coeffs import augment_step_rows as j_augment
    want_rows = j_augment(j_engine().compile(JSpec(**kw)))
    assert sorted(rows) == sorted(want_rows)
    for k in rows:
        np.testing.assert_array_equal(rows[k], want_rows[k], err_msg=k)


# ---------------------------------------------------------------------------
# the engine's row loop against the port's loop references
# ---------------------------------------------------------------------------


def _scan_vs_loop(spec):
    eng, eng64 = _engines()
    out = eng.build(spec, jit=False)(torch.as_tensor(X_T, dtype=torch.float32))
    ref = eng64.build_loop(spec)(torch.as_tensor(X_T))
    assert out.dtype == torch.float32 and ref.dtype == torch.float64
    np.testing.assert_allclose(out.double().numpy(), ref.numpy(), rtol=0,
                               atol=1e-5)
    return out


@pytest.mark.parametrize("nfe", [5, 10, 20])
@pytest.mark.parametrize("solver,order", SCAN_CASES)
def test_engine_matches_own_loop(solver, order, nfe):
    _scan_vs_loop(EngineSpec(solver=solver, order=order, nfe=nfe))


@pytest.mark.parametrize("nfe", [10, 20])
@pytest.mark.parametrize("order", [2, 3])
def test_singlestep_dpm_engine_matches_own_loop(order, nfe):
    """DPM-Solver 2S/3S on the expanded grid, from NFE 10 (2 * order + 4):
    below it the re-based rows' expm1(h)-sized coefficients cancel in fp32
    beyond the bound; the compile itself is exact (next test)."""
    _scan_vs_loop(EngineSpec(solver="dpm", order=order, nfe=nfe))


@pytest.mark.parametrize("order", [2, 3])
def test_singlestep_dpm_compile_exact_fp64(order):
    """The expanded-grid re-basing is exact linear algebra: the port's row
    table executed in float64 (numpy, the row update written out) matches
    the port's float64 loop to near machine precision at NFE 5 (one or two
    giant-h grid steps)."""
    dpm = GaussianDPM(VPLinear())
    spec = EngineSpec(solver="dpm", order=order, nfe=5)
    rows = t_augment(compile_table(spec, dpm.schedule))
    K = rows["w_pred"].shape[1]
    sign = -1.0
    x, E = X_T.copy(), np.zeros((K + 1,) + X_T.shape)
    for j in range(len(rows["t"])):
        r = {k: v[j] for k, v in rows.items()}
        d = E[1:] - E[0]
        x_pred = (r["base_x"] * x + r["base_m0"] * E[0]
                  + sign * r["out_scale"] * np.tensordot(r["w_pred"], d, 1))
        e_new = dpm.eps_model(x_pred, r["t"])
        assert r["use_c"] == 0.0
        x, E = x_pred, np.concatenate([e_new[None], E[:-1]])
    ref = SamplerEngine(dpm.schedule, eps=dpm.eps_model,
                        device="cpu").build_loop(spec)(torch.as_tensor(X_T))
    np.testing.assert_allclose(x, ref.numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("solver,order", UNIC_CASES)
def test_unic_bolt_on_engine_matches_loop(solver, order):
    """Table 2 on the engine: the method-agnostic UniC composes with every
    compiled solver, is the loop's CorrectorConfig, and improves the
    solution at the same grid."""
    spec = EngineSpec(solver=solver, order=order, nfe=16, use_corrector=True)
    out = _scan_vs_loop(spec)
    eng, _ = _engines()
    plain = eng.build(dataclasses.replace(spec, use_corrector=None),
                      jit=False)(torch.as_tensor(X_T, dtype=torch.float32))
    dpm = GaussianDPM(VPLinear())
    exact = dpm.exact_solution(X_T, compile_table(spec, dpm.schedule)
                               .timesteps[-1])

    def err(x0):
        return float(np.max(np.abs(x0.double().numpy() - exact)))

    assert err(out) < err(plain), (solver, err(out), err(plain))


def test_widest_table_runs_six_term_corrector():
    """PNDM + UniC-4 (tests/test_engine.py:118): K = 3, a ring of 4 slots,
    6 corrector terms, the engine against the float64 loop."""
    spec = EngineSpec(solver="pndm", nfe=12, use_corrector=True)
    tab = _engines()[0].compile(spec)
    assert tab.w_pred.shape[1] == 3 and spec.resolve().corrector_order == 4
    assert np.count_nonzero(tab.w_corr_prev[-2]) == 3
    _scan_vs_loop(spec)


# ---------------------------------------------------------------------------
# against the reference's engine and build_loop
# ---------------------------------------------------------------------------

GUIDED = [dict(solver="ddim", nfe=10, use_corrector=True),
          dict(solver="dpmpp", order=3, nfe=10, use_corrector=True),
          dict(solver="dpmpp", order=2, nfe=10, thresholding=True),
          dict(solver="pndm", nfe=10, use_corrector=True),
          dict(solver="deis", order=3, nfe=10, use_corrector=True),
          dict(solver="dpm", order=3, nfe=12),
          dict(solver="dpm", order=2, nfe=10, prediction="data"),
          dict(solver="unipc", order=3, nfe=10, prediction="noise")]


def _guided_tol(spec) -> float:
    """Guided noise-prediction runs at fp32 sit about 1e-4 from their
    float64 loop in both frameworks (measured: PNDM + UniC-4 at NFE 10,
    9.8e-5 for the port's engine and for JAX's; the fp32 loops of both are
    equal), so two fp32 implementations differ there by up to that floor:
    1e-4. Data prediction stays at the reference's 1e-5."""
    return 1e-4 if spec.resolve().prediction == "noise" else 1e-5


@pytest.mark.parametrize("kw", GUIDED, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_guided_engine_matches_reference_engine(kw):
    kw = dict(kw, cfg_scale=2.0)
    x_T = np.random.default_rng(2).normal(size=(3, 8)).astype(np.float32)
    got = t_engine().build(EngineSpec(**kw))(torch.as_tensor(x_T))
    want = j_engine().build(JSpec(**kw))(jnp.asarray(x_T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=_guided_tol(EngineSpec(**kw)))


@pytest.mark.parametrize("kw", GUIDED, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_guided_build_loop_matches_reference_and_engine(kw):
    """Sequential CFG (two evals a step) in the loop reference, against
    the reference's `build_loop` and the port's fused-CFG engine."""
    kw = dict(kw, cfg_scale=2.0)
    x_T = np.random.default_rng(3).normal(size=(3, 8)).astype(np.float32)
    loop = t_engine().build_loop(EngineSpec(**kw))
    got = loop(torch.as_tensor(x_T))
    want = j_engine().build_loop(JSpec(**kw))(jnp.asarray(x_T))
    tol = _guided_tol(EngineSpec(**kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)
    fused = t_engine().build(EngineSpec(**kw))(torch.as_tensor(x_T))
    np.testing.assert_allclose(got.numpy(), fused.numpy(), rtol=0, atol=tol)
    tab = t_engine().compile(EngineSpec(**kw))
    # the loop evaluates every table row but the last one's point
    assert loop.solver.model.nfe == len(tab.timesteps) - 1


# ---------------------------------------------------------------------------
# plan banks that mix solvers, tick by tick beside the reference's
# ---------------------------------------------------------------------------

# (arrival tick, guidance scale, tier): six requests over three slots
TRACE = [(0, 1.0, "a"), (0, 2.0, "b"), (1, 3.5, "c"), (3, 0.5, "a"),
         (4, 2.0, "c"), (9, 1.5, "b")]
BANKS = {
    "dpmpp beside unipc": dict(
        a=dict(solver="unipc", nfe=5, order=2),
        b=dict(solver="dpmpp", nfe=8, order=3, use_corrector=True),
        c=dict(solver="unipc", nfe=12, order=3)),
    "noise tiers, rings of 2-4": dict(
        a=dict(solver="ddim", nfe=5),
        b=dict(solver="pndm", nfe=8, use_corrector=True),
        c=dict(solver="deis", nfe=6, order=3, use_corrector=True)),
}


# Guided multistep noise prediction at NFE 5-8 is ill-conditioned in fp32
# (difference weights up to 5.7 on eval differences that cancel): over 64
# requests of PNDM + UniC-4 at NFE 8, cfg 2.0, the port's engine and JAX's
# each sit up to 9.2e-4 from the float64 loop, the port the worse one in 53%
# of them (measured), so two fp32 implementations differ by up to twice that.
BANK_NOISE_TOL = 2e-3


def _x_T(rid):
    return np.random.default_rng(100 + rid).normal(size=(8,)).astype(
        np.float32)


class _Side:
    """One framework's slot state under the same host-side admissions."""

    def __init__(self, program, slots, torch_side):
        self.p, self.t = program, torch_side
        self.state = program.init_state(slots, (8,))
        self.meta = program.init_meta(slots)
        self.g = program.init_g(slots)

    def admit(self, s, x_T, off, budget, scale):
        x, E = self.state
        col = np.array([0, off, budget, 1], np.int32)
        if self.t:
            x[s] = torch.as_tensor(x_T)
            E[:, s] = 0
            self.meta[:, s] = torch.as_tensor(col)
            self.g[s] = scale
        else:
            self.state = (x.at[s].set(jnp.asarray(x_T)), E.at[:, s].set(0.0))
            self.meta = self.meta.at[:, s].set(jnp.asarray(col))
            self.g = self.g.at[s].set(scale)

    def tick(self):
        self.state, self.meta, done = self.p.step_flight(
            self.state, self.meta, self.g)
        return np.asarray(done)


@pytest.mark.parametrize("bank", list(BANKS))
def test_mixed_solver_bank_matches_reference_tick_by_tick(bank):
    tiers = BANKS[bank]
    t_prog = t_engine().build_bank(
        {k: EngineSpec(cfg_scale=2.0, **v) for k, v in tiers.items()})
    j_prog = j_engine().build_bank(
        {k: JSpec(cfg_scale=2.0, **v) for k, v in tiers.items()},
        donate=False)
    assert t_prog.tiers == j_prog.tiers and t_prog.ring == j_prog.ring
    noise = EngineSpec(**tiers["a"]).resolve().prediction == "noise"
    tol = BANK_NOISE_TOL if noise else 1e-5
    t, j = _Side(t_prog, 3, True), _Side(j_prog, 3, False)
    owner, queue, got, tick = [None] * 3, list(enumerate(TRACE)), {}, 0
    while len(got) < len(TRACE):
        while queue and queue[0][1][0] <= tick and None in owner:
            rid, (_, scale, tier) = queue.pop(0)
            s = owner.index(None)
            off, budget = t_prog.resolve_tier(tier)
            for side in (t, j):
                side.admit(s, _x_T(rid), off, budget, scale)
            owner[s] = rid
        done = t.tick()
        np.testing.assert_array_equal(done, j.tick())
        np.testing.assert_array_equal(t.meta.numpy(), np.asarray(j.meta))
        # relative L-inf: a guided slot's state grows to ~4 mid-trajectory
        assert _rel(t.state[0].numpy(), j.state[0]) <= tol, tick
        for s in np.flatnonzero(done):
            assert done[s] == DONE_OK
            got[owner[s]] = t.state[0][s].numpy().copy()
            owner[s] = None
        tick += 1
    eng = t_engine()
    for rid, (_, scale, tier) in enumerate(TRACE):
        ref = eng.build(EngineSpec(cfg_scale=scale, **tiers[tier]))(
            torch.as_tensor(_x_T(rid))[None])[0].numpy()
        np.testing.assert_allclose(got[rid], ref, rtol=0, atol=1e-5,
                                   err_msg=f"rid={rid} tier={tier}")


def test_bank_of_mixed_predictions_raises_as_the_reference():
    tiers = {"a": dict(solver="dpmpp", nfe=6), "b": dict(solver="pndm",
                                                          nfe=6)}
    for eng, Spec in ((t_engine(), EngineSpec), (j_engine(), JSpec)):
        with pytest.raises(ValueError, match="prediction"):
            eng.build_bank({k: Spec(**v) for k, v in tiers.items()})


# ---------------------------------------------------------------------------
# the spec checks and the registry
# ---------------------------------------------------------------------------


def test_registry_matches_reference():
    assert sorted(SOLVERS) == sorted(J_SOLVERS) == SamplerEngine.solvers()
    for name in SOLVERS:
        t_sd, j_sd = SOLVERS[name], J_SOLVERS[name]
        for f in ("prediction", "fixed_prediction", "singlestep",
                  "corrector_default"):
            assert getattr(t_sd, f) == getattr(j_sd, f), (name, f)


@pytest.mark.parametrize("kw", [
    {}, {"order": 2}, {"use_corrector": True}, {"corrector_order": 2,
                                                "use_corrector": True},
    {"use_corrector": False}, {"prediction": "noise"}],
    ids=lambda kw: str(kw))
@pytest.mark.parametrize("solver", sorted(J_SOLVERS))
def test_resolve_matches_reference(solver, kw):
    """Defaults (prediction, corrector on/off, the UniC order), and the
    reference's errors where it raises: fixed prediction, UniC on a
    singlestep solver."""
    try:
        want = JSpec(solver=solver, **kw).resolve()
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err).split(";")[0][:30]):
            EngineSpec(solver=solver, **kw).resolve()
        return
    got = EngineSpec(solver=solver, **kw).resolve()
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_unknown_solver_raises_key_error_and_cache_block_stays_unported():
    """An unknown solver raises the reference's KeyError; `cache_block`,
    ported since feature reuse, resolves as the reference's spec does."""
    for Spec in (EngineSpec, JSpec):
        with pytest.raises(KeyError, match="unknown solver 'heun'"):
            Spec(solver="heun").resolve()
    got = EngineSpec(solver="dpmpp", cache_block=2).resolve()
    want = JSpec(solver="dpmpp", cache_block=2).resolve()
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("kw,match", [
    (dict(solver="dpmpp", order=4), "orders 1-3"),
    (dict(solver="dpm", order=1), "orders 2 and 3")])
def test_compile_errors_match_reference(kw, match):
    for fn, Spec, sched in ((compile_table, EngineSpec, VPLinear()),
                            (j_compile, JSpec, JVP())):
        with pytest.raises(ValueError, match=match):
            fn(Spec(**kw), sched)


def test_loop_and_thresholding_errors():
    eng = t_engine()
    noise = EngineSpec(solver="pndm", thresholding=True)
    with pytest.raises(ValueError, match="data-prediction"):
        eng.build_loop(noise)
    with pytest.raises(ValueError, match="data-prediction"):
        eng.compile(noise)
    with pytest.raises(ValueError, match="constant cfg"):
        eng.build_loop(EngineSpec(solver="dpmpp", cfg_scale=2.0,
                                  cfg_schedule="linear"))
    bare = SamplerEngine(VPLinear(), eps=_t_eps(*COND), device="cpu")
    with pytest.raises(ValueError, match="eps_uncond"):
        bare.build_loop(EngineSpec(solver="dpmpp", cfg_scale=2.0))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv,match", [
    (["--loop", "--eval-dtype", "bfloat16"], "fp32-only"),
    (["--loop", "--quant", "w8a16"], "fp32-only"),
    (["--solver", "heun"], "invalid choice"),
])
def test_cli_argparse_errors(capsys, argv, match):
    with pytest.raises(SystemExit) as exc:
        launch.main(["--arch", "dit-cifar", "--device", "cpu"] + argv)
    assert exc.value.code == 2
    assert match in capsys.readouterr().err


def test_sample_refuses_a_loop_it_cannot_run():
    for kw in ({"eval_dtype": "bfloat16"}, {"quant": "w8a16"}):
        with pytest.raises(ValueError, match="fp32-only"):
            launch.sample("dit-cifar", loop=True, device="cpu", **kw)


@pytest.mark.parametrize("extra", [[], ["--loop"], ["--no-fused-update"]])
@pytest.mark.parametrize("solver", sorted(J_SOLVERS))
def test_cli_runs_every_solver(capsys, solver, extra):
    x0 = launch.main(["--arch", "dit-cifar", "--solver", solver, "--nfe", "6",
                      "--batch", "1", "--cfg-scale", "2.0", "--device",
                      "cpu"] + extra + (["--thresholding"] if solver in (
                          "unipc", "dpmpp") else []))
    out = capsys.readouterr().out
    assert np.isfinite(x0).all() and x0.shape == (1, 64, 32)
    assert out.startswith(f"{solver}-3 [cpu{' loop' if extra == ['--loop'] else ''}]")


def _reduced_dit_tree():
    jcfg = j_get_config("dit-i256").reduced()
    tree = jax.tree.map(np.asarray, j_api.init_params(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    tree = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype), tree)
    x_T = rng.normal(size=(2, jcfg.patch_tokens,
                           jcfg.latent_dim)).astype(np.float32)
    return jcfg, tree, x_T


@pytest.mark.parametrize("solver,order,nfe", [("dpmpp", 3, 6), ("dpm", 3, 6)])
def test_sample_matches_reference_engine_path_on_reduced_dit_i256(
        solver, order, nfe):
    """The whole slice: `sample(solver=...)` on the reduced dit-i256 with
    CFG against the reference's engine on the same params and x_T (<= 1e-4
    relative, the DiT eval's tolerance), and against the port's own loop
    (sequential CFG) on the same engine."""
    jcfg, tree, x_T = _reduced_dit_tree()
    eng = j_build_engine(jcfg, jax.tree.map(jnp.asarray, tree), JVP(), 2,
                         seed=0, want_cfg=True)
    spec = dict(solver=solver, order=order, nfe=nfe, cfg_scale=2.0)
    want = np.asarray(eng.build(JSpec(**spec))(jnp.asarray(x_T)))
    from repro_torch.configs import get_config

    params = t_api.params_from_numpy(tree, get_config("dit-i256").reduced(),
                                     "cpu")
    got = launch.sample("dit-i256", reduced=True, batch=2, seed=0,
                        params=params, x_T=x_T, device="cpu", **spec)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    loop = launch.sample("dit-i256", reduced=True, batch=2, seed=0,
                         params=params, x_T=x_T, device="cpu", loop=True,
                         **spec)
    assert _rel(loop, got) <= 1e-4


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

# the zoo tables the row kernel meets: K = 3 with six corrector terms, a
# corrector base that is not the predictor's, sign -1, per-row out_scale
CARD_TABLES = {
    "pndm+unic-4": dict(solver="pndm", nfe=10, use_corrector=True),
    "deis-3+unic": dict(solver="deis", order=3, nfe=10, use_corrector=True),
    "dpm-3s": dict(solver="dpm", order=3, nfe=10),
    "dpmpp-3+unic": dict(solver="dpmpp", order=3, nfe=10, use_corrector=True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("table", list(CARD_TABLES))
def test_card_row_kernel_on_zoo_tables_bit_equal(cuda, table):
    """Every row of the table, uniform and per slot, fp32 bit-equal to the
    plain version, with (8, 256, 32) operands as the main path's."""
    from repro_torch.core.unipc import rows_on

    tab = t_engine(cuda).compile(EngineSpec(**CARD_TABLES[table]))
    rows = row_ops.pack_weight_rows(rows_on(t_augment(tab), cuda))
    K, n_rows = tab.w_pred.shape[1], rows.shape[0]
    g = torch.Generator(device=cuda).manual_seed(K)
    x, e_new, x_pred = (torch.randn(8, 256, 32, generator=g, device=cuda)
                        for _ in range(3))
    E = torch.randn(K + 1, 8, 256, 32, generator=g, device=cuda)
    idxs = [torch.tensor(i, device=cuda) for i in range(n_rows)]
    idxs.append(torch.arange(8, device=cuda) * (n_rows // 7))
    for idx in idxs:
        got = [row_ops.unipc_row_predict(x, E, rows, idx, tab.sign)]
        got += row_ops.unipc_row_correct(x, E, e_new, x_pred, rows, idx,
                                         tab.sign)
        want = [row_ops.unipc_row_predict(x, E, rows, idx, tab.sign,
                                          backend="plain")]
        want += row_ops.unipc_row_correct(x, E, e_new, x_pred, rows, idx,
                                          tab.sign, backend="plain")
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), (table, idx)


@pytest.mark.gpu
@pytest.mark.parametrize("table", list(CARD_TABLES))
def test_card_zoo_run_replays_bit_equal_to_eager(cuda, table):
    eng = t_engine(cuda)
    spec = EngineSpec(cfg_scale=2.0, **CARD_TABLES[table])
    run, eager = eng.build(spec), eng.build(spec, jit=False)
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(4, 8)).astype(
        np.float32), device=cuda)
    first = run(x)
    second = run(torch.flip(x, dims=(0,)))
    torch.cuda.synchronize()
    assert torch.equal(first, eager(x))
    assert torch.equal(second, eager(torch.flip(x, dims=(0,))))
