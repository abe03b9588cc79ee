"""The port's sampler and engine against the JAX reference's.

* the row-loop `unipc_sample_scan` against JAX's `lax.scan` on an analytic
  Gaussian eps-net written in both frameworks: <= 1e-5 (fp32, the
  reference's own engine tolerance);
* `sample()` at the reduced dit-i256 with CFG against `repro.launch.sample`'s
  engine path on the same params and x_T: <= 1e-4 relative (the DiT eval's
  tolerance, tests/test_torch_dit.py);
* requests admitted at staggered ticks into a per-slot `StepProgram`
  against the uniform run and against JAX's `build_step(donate=False)`
  driven the same way: <= 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.core.unipc import make_unipc_schedule as j_make_schedule
from repro.core.unipc import unipc_sample_scan as j_scan
from repro.diffusion import VPLinear as JVP
from repro.diffusion.process import eps_to_x0 as j_eps_to_x0
from repro.engine import EngineSpec as JSpec
from repro.engine import SamplerEngine as JEngine
from repro.launch.sample import build_engine as j_build_engine
from repro.models import api as j_api
from repro_torch.core.unipc import make_unipc_schedule as t_make_schedule
from repro_torch.core.unipc import unipc_sample_scan as t_scan
from repro_torch.diffusion import VPLinear as TVP
from repro_torch.diffusion.process import eps_to_x0 as t_eps_to_x0
from repro_torch.engine import EngineSpec as TSpec
from repro_torch.engine import SamplerEngine as TEngine
from repro_torch.launch.sample import sample as t_sample
from repro_torch.models import api as t_api

torch.set_num_threads(2)

COND, UNCOND = (0.7, 0.35), (-0.4, 0.5)   # (mu, s) of the analytic data laws


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def j_gauss_eps(mu, s):
    """Exact eps of data ~ N(mu, s^2 I) under VPLinear; scalar or (B,) t."""
    sched = JVP()

    def eps(x, t):
        t = jnp.asarray(t)
        a = jnp.exp(sched.log_alpha_jax(t))
        sig = jnp.sqrt(1 - a * a)
        if t.ndim == 1:
            a = a.reshape((-1,) + (1,) * (x.ndim - 1))
            sig = sig.reshape(a.shape)
        return sig * (x - a * mu) / (a * a * s ** 2 + sig * sig)

    return eps


def t_gauss_eps(mu, s):
    sched = TVP()

    def eps(x, t):
        t = torch.as_tensor(t)
        a = torch.exp(sched.log_alpha_torch(t))
        sig = torch.sqrt(1 - a * a)
        if t.ndim == 1:
            a = a.reshape((-1,) + (1,) * (x.ndim - 1))
            sig = sig.reshape(a.shape)
        return sig * (x - a * mu) / (a * a * s ** 2 + sig * sig)

    return eps


def _stacked(eps_c, eps_u, cat, split):
    def eps_stacked(xx, t, **_):
        x1, x2 = split(xx)
        t1, t2 = split(t) if np.ndim(t) == 1 else (t, t)
        return cat([eps_c(x1, t1), eps_u(x2, t2)])
    return eps_stacked


def j_cfg_engine():
    ec, eu = j_gauss_eps(*COND), j_gauss_eps(*UNCOND)
    return JEngine(JVP(), eps=ec, eps_stacked=_stacked(
        ec, eu, lambda a: jnp.concatenate(a, 0), lambda a: jnp.split(a, 2, 0)))


def t_cfg_engine():
    ec, eu = t_gauss_eps(*COND), t_gauss_eps(*UNCOND)
    return TEngine(TVP(), eps=ec, eps_stacked=_stacked(
        ec, eu, lambda a: torch.cat(a, 0), lambda a: torch.chunk(a, 2, 0)),
        device="cpu")


# ---------------------------------------------------------------------------
# the sampler core
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nfe", [5, 10, 20])
@pytest.mark.parametrize("prediction", ["data", "noise"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_sample_scan_matches_reference_on_analytic_eps(order, prediction, nfe):
    """<= 1e-5, except noise prediction at NFE 5: its steps scale eps by
    sigma_t (e^h - 1) with e^h near 20, which lifts the one-ulp difference
    between the frameworks' exp in the analytic eps to ~4e-5 (measured);
    1e-4 there."""
    x_T = np.random.default_rng(0).normal(size=(3, 8)).astype(np.float32)
    j_eps, t_eps = j_gauss_eps(*COND), t_gauss_eps(*COND)
    if prediction == "data":
        j_model = lambda x, t: j_eps_to_x0(JVP(), x, t, j_eps(x, t))
        t_model = lambda x, t: t_eps_to_x0(TVP(), x, t, t_eps(x, t))
    else:
        j_model, t_model = j_eps, t_eps
    want = j_scan(j_model, jnp.asarray(x_T),
                  j_make_schedule(JVP(), nfe, order=order,
                                  prediction=prediction))
    got = t_scan(t_model, torch.as_tensor(x_T),
                 t_make_schedule(TVP(), nfe, order=order,
                                 prediction=prediction))
    tol = 1e-4 if (prediction, nfe) == ("noise", 5) else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)


def test_cfg_engine_build_matches_reference():
    spec = dict(nfe=8, order=3, cfg_scale=2.0, cfg_schedule="linear",
                cfg_scale_end=0.5)
    x_T = np.random.default_rng(1).normal(size=(2, 8)).astype(np.float32)
    want = j_cfg_engine().build(JSpec(**spec))(jnp.asarray(x_T))
    got = t_cfg_engine().build(TSpec(**spec))(torch.as_tensor(x_T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the whole slice: sample() on the DiT
# ---------------------------------------------------------------------------


def test_sample_matches_reference_engine_path_on_reduced_dit_i256():
    jcfg = j_get_config("dit-i256").reduced()
    tree = jax.tree.map(np.asarray, j_api.init_params(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    tree = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype), tree)
    batch = 2
    x_T = rng.normal(size=(batch, jcfg.patch_tokens,
                           jcfg.latent_dim)).astype(np.float32)

    eng = j_build_engine(jcfg, jax.tree.map(jnp.asarray, tree), JVP(), batch,
                         seed=0, want_cfg=True)
    spec = JSpec(nfe=5, order=3, cfg_scale=2.0)
    want = np.asarray(eng.build(spec)(jnp.asarray(x_T)))

    from repro_torch.configs import get_config

    params = t_api.params_from_numpy(tree, get_config("dit-i256").reduced(),
                                     "cpu")
    got = t_sample("dit-i256", reduced=True, nfe=5, order=3, cfg_scale=2.0,
                   batch=batch, seed=0, params=params, x_T=x_T, device="cpu")
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-4


# ---------------------------------------------------------------------------
# the per-slot serving step
# ---------------------------------------------------------------------------

REQS = [  # (arrival tick, guidance scale)
    (0, 1.0), (0, 2.0), (2, 3.5), (5, 0.5), (6, 2.0)]


def _x_T(rid):
    return np.random.default_rng(100 + rid).normal(size=(8,)).astype(np.float32)


def _serve(program, slots, admit, step, read):
    """Admit REQS first come first served into free slots once they have
    arrived, step every slot through its rows (idle slots park on row 0),
    return {rid: latent}. `admit(state, g, slot, rid, scale)` writes a
    request's x_T, zeroed eval ring and guidance scale."""
    state, g = program.init_state(slots, (8,)), program.init_g(slots)
    row = np.zeros(slots, np.int64)
    owner = [None] * slots
    queue = list(enumerate(REQS))
    done, tick = {}, 0
    while len(done) < len(REQS):
        while queue and queue[0][1][0] <= tick and None in owner:
            rid, (_, scale) = queue.pop(0)
            s = owner.index(None)
            state, g = admit(state, g, s, rid, scale)
            row[s], owner[s] = 0, rid
        busy = np.array([o is not None for o in owner])
        state = step(state, np.where(busy, row, 0).astype(np.int32), g)
        row[busy] += 1
        for s in range(slots):
            if owner[s] is not None and row[s] == program.n_rows:
                done[owner[s]] = read(state, s)
                owner[s] = None
        tick += 1
    return done


def _t_serve(spec_kw, slots=3):
    program = t_cfg_engine().build_step(TSpec(**spec_kw))

    def admit(state, g, s, rid, scale):
        x, E = state
        x[s] = torch.as_tensor(_x_T(rid))   # in-place admission
        E[:, s] = 0
        g[s] = scale
        return (x, E), g

    return _serve(program, slots, admit,
                  lambda st, idx, g: program.step(st, torch.as_tensor(idx), g),
                  lambda st, s: st[0][s].numpy().copy())


def _j_serve(spec_kw, slots=3):
    program = j_cfg_engine().build_step(JSpec(**spec_kw), donate=False)

    def admit(state, g, s, rid, scale):
        x, E = state
        return ((x.at[s].set(jnp.asarray(_x_T(rid))), E.at[:, s].set(0.0)),
                g.at[s].set(scale))

    return _serve(program, slots, admit,
                  lambda st, idx, g: program.step(st, jnp.asarray(idx), g),
                  lambda st, s: np.asarray(st[0][s]))


@pytest.mark.parametrize("cfg_schedule", ["constant", "cosine"])
def test_staggered_step_matches_uniform_runs_and_reference(cfg_schedule):
    spec_kw = dict(nfe=8, order=3, cfg_scale=2.0, cfg_schedule=cfg_schedule,
                   cfg_scale_end=0.5 if cfg_schedule != "constant" else None)
    got = _t_serve(spec_kw)
    want = _j_serve(spec_kw)
    eng = t_cfg_engine()
    for rid, (_, scale) in enumerate(REQS):
        # a slot's scale multiplies the nominal schedule's profile, so its
        # uniform twin ramps to end * scale / nominal
        end = spec_kw["cfg_scale_end"]
        uniform_kw = {**spec_kw, "cfg_scale": scale, "cfg_scale_end":
                      None if end is None else end * scale / 2.0}
        uniform = eng.build(TSpec(**uniform_kw))(
            torch.as_tensor(_x_T(rid))[None])[0].numpy()
        np.testing.assert_allclose(got[rid], uniform, rtol=0, atol=1e-5,
                                   err_msg=f"rid={rid} vs uniform")
        np.testing.assert_allclose(got[rid], want[rid], rtol=0, atol=1e-5,
                                   err_msg=f"rid={rid} vs JAX build_step")


# ---------------------------------------------------------------------------
# what the slice does not port fails loudly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,exc,match", [
    ({"cache_block": 2, "cfg_scale": 2.0}, ValueError, "unconditional"),
    ({"solver": "heun"}, KeyError, "unknown solver 'heun'")])
def test_unported_options_raise(kw, exc, match):
    """Feature reuse is ported and, as in the reference, refuses guidance;
    an unknown solver raises the reference's KeyError (every solver of the
    reference's zoo is ported)."""
    with pytest.raises(exc, match=match):
        TSpec(**kw).resolve()
    with pytest.raises(exc, match=match):
        JSpec(**kw).resolve()
