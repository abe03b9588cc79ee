"""The port's mesh layer against the JAX reference's (`parallel/sharding.py`,
`launch/mesh.py`, the sharding half of `launch/specs.py`, the shard-mapped
MoE, the slot-batch annotation, `sample_step_fn`, the dry run's `--mesh`).

* the rule tables, `logical_spec`, `normalize_axes`, `_axis_len` and the
  spec `shard` constrains to, equal to the reference's under the same
  contexts, on abstract meshes;
* every param, cache and batch leaf's spec and `shard_shape` equal to the
  reference's on the abstract production meshes (16 x 16, 2 x 16 x 16),
  for all ten architectures under each rule set they use. Nothing is
  allocated: the reference's trees come from `jax.eval_shape`, the port's
  live on the meta device;
* `moe_apply_shard_map` against the reference's `shard_map` on four forced
  host CPU devices. `XLA_FLAGS` acts only before JAX starts, so the
  reference runs once in a subprocess of its own (a module fixture) and
  hands its arrays over in an .npz; this process sets no environment
  variable;
* sampling, serving and training under the rules: the port on its 1x1 host
  mesh bit-identical to the port without rules, and close to the reference
  on a 1x1 mesh whose axes this file builds Auto-typed (JAX 0.9's
  `make_mesh`, which the reference's `make_host_mesh` calls, types them
  Explicit, and `with_sharding_constraint` refuses its specs then);
* the dry run under `--mesh single|multi`: one chip's argument bytes equal
  the reference's specs' `shard_shape` bytes on the same abstract mesh.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType
from jax.sharding import Mesh as JMesh

from repro import serving as jsv
from repro.configs import registry as j_registry
from repro.core import make_unipc_schedule as j_make_schedule
from repro.core import unipc as j_unipc
from repro.diffusion import VPLinear as JVP
from repro.engine import EngineSpec as JSpec
from repro.launch import specs as j_specs
from repro.launch.sample import build_engine as j_build_engine
from repro.models import api as j_api
from repro.optim import AdamW as JAdamW
from repro.parallel import sharding as j_sh
from repro_torch import serving as tsv
from repro_torch.configs import INPUT_SHAPES
from repro_torch.configs import registry as t_registry
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.core import make_unipc_schedule as t_make_schedule
from repro_torch.core import unipc as t_unipc
from repro_torch.diffusion import VPLinear as TVP
from repro_torch.engine import EngineSpec as TSpec
from repro_torch.launch import dryrun, mesh as t_mesh
from repro_torch.launch import specs as t_specs
from repro_torch.launch.sample import build_engine as t_build_engine
from repro_torch.models import api as t_api
from repro_torch.models import moe as t_moe
from repro_torch.parallel import sharding as t_sh

from test_torch_serving import perturbed_tree
from test_torch_token_models import reference_params

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
RULE_NAMES = ("TRAIN_RULES", "SERVE_RULES", "LONG_SERVE_RULES",
              "SEQ_PARALLEL_TRAIN_RULES", "KV_SEQ_SERVE_RULES")
PROD = {"single": (16, 16), "multi": (2, 16, 16)}
TOL = 1e-5                   # fp32 serving parity (tests/test_serving.py)


def _axes(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def meshes(shape):
    """(reference AbstractMesh, port abstract Mesh) of one shape."""
    return (AbstractMesh(shape, _axes(shape)),
            t_mesh.Mesh(dict(zip(_axes(shape), shape))))


def auto_host_mesh():
    """The reference's 1x1 host mesh with Auto-typed axes."""
    return JMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                 axis_types=(AxisType.Auto,) * 2)


def norm(spec):
    """A spec's entries with a str as its 1-tuple (JAX keeps a 1-tuple as
    the bare name)."""
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


# ---------------------------------------------------------------------------
# rule tables, contexts and the spec arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", RULE_NAMES)
def test_rule_tables_are_the_references(name):
    assert getattr(t_sh, name) == getattr(j_sh, name)


@pytest.mark.parametrize("shape", [(1, 1), (16, 16), (2, 16, 16), (4, 2)])
def test_normalize_axes_and_axis_len_match(shape):
    jm, tm = meshes(shape)
    for axes in (None, "data", "pod", ("pod", "data"), ("data", "model"),
                 ("pod",), ("model", "pod", "data")):
        assert t_sh.normalize_axes(tm, axes) == j_sh.normalize_axes(jm, axes)
        assert t_sh._axis_len(tm, axes) == j_sh._axis_len(jm, axes)
    assert t_mesh.axis_size(tm, "pod") == (2 if len(shape) == 3 else 1)


LOGICAL = [("batch", "seq", "d_model"), ("batch", "seq", "heads", None),
           ("expert_cap", "experts", None, "d_ff"), (None, "kv_seq"),
           ("fsdp", "model"), ("vocab",)]


def test_logical_spec_contexts_drop_axes_and_nesting():
    """No context: None; rules with no mesh still give a spec (as the
    reference's); drop_axes replicates; an inner context replaces the outer
    one and the outer comes back on exit, also after an exception."""
    jm, tm = meshes((16, 16))
    assert t_sh.logical_spec("batch") is None and t_sh.current_mesh() is None
    with t_sh.sharding_rules(None, t_sh.TRAIN_RULES), \
            j_sh.sharding_rules(None, j_sh.TRAIN_RULES):
        assert t_sh.logical_spec("batch", "fsdp") == \
            tuple(j_sh.logical_spec("batch", "fsdp"))
    for rules in RULE_NAMES:
        with t_sh.sharding_rules(tm, getattr(t_sh, rules),
                                 drop_axes=("heads",)), \
                j_sh.sharding_rules(jm, getattr(j_sh, rules),
                                    drop_axes=("heads",)):
            assert t_sh.current_mesh() is tm
            for axes in LOGICAL:
                assert t_sh.logical_spec(*axes) == \
                    tuple(j_sh.logical_spec(*axes)), (rules, axes)
            with t_sh.sharding_rules(tm, t_sh.SERVE_RULES), \
                    j_sh.sharding_rules(jm, j_sh.SERVE_RULES):
                assert t_sh.logical_spec("heads", "fsdp") == \
                    tuple(j_sh.logical_spec("heads", "fsdp")) == \
                    ("model", None)
            assert t_sh.logical_spec("heads") == (None,)
    with pytest.raises(RuntimeError):
        with t_sh.sharding_rules(tm, t_sh.TRAIN_RULES):
            raise RuntimeError
    assert t_sh.current_mesh() is None and t_sh.logical_spec("batch") is None
    for sh, m in ((t_sh, tm), (j_sh, jm)):     # no 'pod' on one pod
        with pytest.raises(ValueError, match="pod"):
            sh.named_sharding(m, "batch", None, rules=sh.SERVE_RULES)
    ns = t_sh.named_sharding(tm, "fsdp", "d_ff", rules=t_sh.TRAIN_RULES)
    jns = j_sh.named_sharding(jm, "fsdp", "d_ff", rules=j_sh.TRAIN_RULES)
    assert norm(ns.spec) == norm(jns.spec)
    assert ns.shard_shape((64, 4096)) == jns.shard_shape((64, 4096))


SHARD_CASES = [((8, 64, 896), ("batch", "seq", "d_model")),
               ((8, 64, 14, 64), ("batch", "seq", "heads", None)),
               ((8, 64, 2, 64), ("batch", "seq", "kv_heads", None)),
               ((8, 64, 4864), ("batch", "seq", "d_ff")),
               ((1, 8, 65, 512), ("expert_cap", "experts", None, "d_model")),
               ((3, 7, 151936), ("batch", "seq", "vocab")),
               ((11, 32, 16, 16), (None, "batch", None, None)),
               ((64, 4096, 32, 128), ("batch", "seq", "heads", None))]


@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16), (2, 4)])
@pytest.mark.parametrize("rules", RULE_NAMES)
def test_shard_constrains_to_the_references_spec(monkeypatch, shape, rules):
    """The spec `shard` checks a tensor against is the one the reference's
    `shard` hands `with_sharding_constraint` (captured here), and the
    tensor comes back as it is; no context: None and the tensor."""
    jm, tm = meshes(shape)
    seen = []
    monkeypatch.setattr(j_sh.jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(s) or x)
    for dims, axes in SHARD_CASES:
        x = torch.empty(dims, device="meta")
        assert t_sh.shard_spec(x, *axes) is None and t_sh.shard(x, *axes) is x
        with t_sh.sharding_rules(tm, getattr(t_sh, rules)), \
                j_sh.sharding_rules(jm, getattr(j_sh, rules)):
            assert t_sh.shard(x, *axes) is x
            got = t_sh.shard_spec(x, *axes)
            j_sh.shard(jax.ShapeDtypeStruct(dims, jnp.float32), *axes)
            assert norm(got) == norm(seen[-1].spec), (dims, axes)
            with pytest.raises(AssertionError):
                t_sh.shard(x, *axes[:-1])


def test_shard_checks_placement_on_a_concrete_mesh():
    cpu = t_mesh.make_host_mesh("cpu")
    assert (cpu.shape, cpu.devices, cpu.size) == (
        {"data": 1, "model": 1}, (torch.device("cpu"),), 1)
    x = torch.zeros(2, 3)
    with t_sh.sharding_rules(cpu, t_sh.SERVE_RULES):
        assert t_sh.shard(x, "batch", None) is x
        with pytest.raises(ValueError, match="meta"):
            t_sh.shard(x.to("meta"), "batch", None)
    with t_sh.sharding_rules(t_mesh.make_host_mesh("meta"), t_sh.SERVE_RULES):
        assert t_sh.shard(x.to("meta"), "batch", None).device.type == "meta"


def test_production_meshes_and_shard_shape():
    single, multi = (t_mesh.make_production_mesh(),
                     t_mesh.make_production_mesh(multi_pod=True))
    assert single.shape == {"data": 16, "model": 16}
    assert single.devices is None and multi.devices is None
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert (single.size, multi.size) == (256, 512)
    jm = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    spec = t_sh.P(("pod", "data"), "model")
    assert t_sh.NamedSharding(multi, spec).shard_shape((64, 4096)) == \
        j_sh.NamedSharding(jm, j_sh.P(("pod", "data"), "model")).shard_shape(
            (64, 4096)) == (2, 256)
    for bad in (t_sh.P("data", "data"), t_sh.P(("pod", "data"))):
        with pytest.raises(ValueError):
            t_sh.NamedSharding(single, bad)
    with pytest.raises(ValueError, match="splits"):
        t_sh.NamedSharding(single, t_sh.P("model")).shard_shape((14, 64))


# ---------------------------------------------------------------------------
# spec parity at production size
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _configs(arch):
    return j_registry.get_config(arch), t_registry.get_config(arch)


@functools.lru_cache(maxsize=None)
def _params(arch):
    jcfg, tcfg = _configs(arch)
    return j_specs.abstract_params(jcfg), t_specs.abstract_params(tcfg)


def _adapted(arch, shape):
    """Both configs as the dry run adapts them for `shape` (a window for
    long_500k, remat for training)."""
    jcfg, tcfg = _configs(arch)
    tcfg = dryrun.adapt_config(tcfg, shape)
    return dataclasses.replace(jcfg, sliding_window=tcfg.sliding_window,
                               remat=tcfg.remat), tcfg


def _rule_sets(arch):
    """{shape name: [rule-set names]}: `rules_for` of each shape and the
    rules of each mesh stage of the pair."""
    out = {}
    for name, shape in INPUT_SHAPES.items():
        if (arch, name) in dryrun.SKIPS:
            continue
        sets = [next(n for n in RULE_NAMES if getattr(t_sh, n)
                     is dryrun.rules_for(shape))]
        for st in dryrun.OPTIMIZATIONS.get((arch, name), {}).values():
            if st.get("rules") is not None:
                sets.append(next(n for n in RULE_NAMES
                                 if getattr(t_sh, n) is st["rules"]))
        out[name] = sorted(set(sets))
    return out


def _by_path_j(tree):
    return {tuple(str(getattr(k, "key", getattr(k, "name", k)))
                  for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _by_path_t(tree):
    from torch.utils._pytree import tree_flatten_with_path
    return {tuple(str(getattr(k, "key", getattr(k, "name", k)))
                  for k in path): leaf
            for path, leaf in tree_flatten_with_path(tree)[0]}


def _assert_same_specs(label, j_tree, j_sh_tree, t_tree, t_sh_tree):
    jl, jsd = _by_path_j(j_tree), _by_path_j(j_sh_tree)
    tl, tsd = _by_path_t(t_tree), _by_path_t(t_sh_tree)
    assert jl.keys() == tl.keys() == jsd.keys() == tsd.keys(), label
    for key, leaf in jl.items():
        assert tuple(leaf.shape) == tuple(tl[key].shape), (label, key)
        assert norm(tsd[key].spec) == norm(jsd[key].spec), (label, key)
        assert tsd[key].shard_shape(leaf.shape) == \
            jsd[key].shard_shape(leaf.shape), (label, key)
    return len(jl)


@pytest.mark.parametrize("mesh_kind", sorted(PROD))
@pytest.mark.parametrize("arch", j_registry.all_arch_ids())
def test_param_cache_and_batch_specs_match_at_production_size(arch,
                                                              mesh_kind):
    """For every shape the dry run takes and every rule set it uses there,
    each param, cache and batch leaf's spec and shard_shape equal the
    reference's on the same abstract mesh."""
    jm, tm = meshes(PROD[mesh_kind])
    jp, tp = _params(arch)
    leaves = 0
    for name, sets in _rule_sets(arch).items():
        shape = INPUT_SHAPES[name]
        jcfg, tcfg = _adapted(arch, shape)
        jb = j_specs.input_specs(jcfg, shape)
        tb = t_specs.input_specs(tcfg, shape)
        cache = None
        if shape.kind == "decode":
            cache = (j_specs.abstract_cache(jcfg, shape),
                     t_specs.abstract_cache(tcfg, shape))
        for rules in sets:
            jr, tr = getattr(j_sh, rules), getattr(t_sh, rules)
            tag = f"{arch} {name} {mesh_kind} {rules}"
            leaves += _assert_same_specs(
                tag + " params", jp, j_specs.param_shardings(jp, jm, jr),
                tp, t_specs.param_shardings(tp, tm, tr))
            leaves += _assert_same_specs(
                tag + " batch", jb, j_specs.batch_shardings(jb, jm, jr),
                tb, t_specs.batch_shardings(tb, tm, tr))
            if cache is not None:
                leaves += _assert_same_specs(
                    tag + " cache", cache[0],
                    j_specs.cache_shardings(cache[0], jm, jr), cache[1],
                    t_specs.cache_shardings(cache[1], tm, tr))
    assert leaves > 40


def test_guard_drops_what_one_chip_cannot_split():
    """qwen2-0.5b's 14 heads and 2 KV heads on a 16-way model axis: the
    head dims replicate, the rest shards, as in the reference."""
    jm, tm = meshes((16, 16))
    for dims, logical in (((24, 896, 14 * 64), ("fsdp", "model")),
                          ((128, 32768, 2, 64),
                           ("batch", "kv_seq", "kv_heads", None))):
        got = t_specs._guard(logical, dims, tm, t_sh.KV_SEQ_SERVE_RULES)
        want = j_specs._guard(logical, dims, jm, j_sh.KV_SEQ_SERVE_RULES)
        assert norm(got) == norm(want)
    assert t_specs._guard(("batch", "kv_seq", "kv_heads", None),
                          (128, 32768, 2, 64), tm,
                          t_sh.KV_SEQ_SERVE_RULES) == \
        (("data",), ("model",), None, None)


# ---------------------------------------------------------------------------
# the shard-mapped MoE block against the reference's on forced host devices
# ---------------------------------------------------------------------------

MOE_MESHES = ((1, 1), (2, 2), (4, 1), (1, 4))
CAPACITY = (8.0, 1.0)        # nothing dropped / tokens dropped per shard

MOE_SCRIPT = '''
import sys
import jax, numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs.base import ModelConfig
from repro.models.moe import moe_apply, moe_apply_shard_map, moe_init

out = {}
for cf in %r:
    cfg = ModelConfig(arch_id="t", family="moe", num_layers=1, d_model=32,
                      num_heads=4, d_ff=64, vocab_size=64, num_experts=4,
                      experts_per_token=2, moe_d_ff=64, capacity_factor=cf,
                      dtype="float32", param_dtype="float32")
    params = moe_init(jax.random.PRNGKey(0), cfg)
    x = 0.5 * jax.random.normal(jax.random.PRNGKey(1), (4, 8, cfg.d_model))
    out.update({f"{k}": np.asarray(v) for k, v in params.items()})
    out["x"] = np.asarray(x)
    y, aux = jax.jit(lambda p, x: moe_apply(p, x, cfg))(params, x)
    out[f"y_global_{cf}"], out[f"aux_global_{cf}"] = np.asarray(y), np.asarray(aux)
    for shape in %r:
        n = shape[0] * shape[1]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        y, aux = jax.jit(lambda p, x: moe_apply_shard_map(
            p, x, cfg, mesh))(params, x)
        tag = f"{shape[0]}x{shape[1]}_{cf}"
        out["y_" + tag], out["aux_" + tag] = np.asarray(y), np.asarray(aux)
np.savez(sys.argv[1], **out)
''' % (CAPACITY, MOE_MESHES)


@pytest.fixture(scope="module")
def moe_reference(tmp_path_factory):
    """The reference's moe_apply and shard-mapped block on 4 forced host
    CPU devices, run once in a fresh process (XLA_FLAGS acts only before
    JAX starts; this process sets no variable)."""
    d = tmp_path_factory.mktemp("moe_ref")
    (d / "ref.py").write_text(MOE_SCRIPT)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, str(d / "ref.py"), str(d / "ref.npz")],
                   env=env, check=True, timeout=120, capture_output=True)
    return dict(np.load(d / "ref.npz"))


def _moe_cfg(cf):
    return TModelConfig(arch_id="t", family="moe", num_layers=1, d_model=32,
                        num_heads=4, d_ff=64, vocab_size=64, num_experts=4,
                        experts_per_token=2, moe_d_ff=64, capacity_factor=cf,
                        dtype="float32", param_dtype="float32")


def _moe_port(ref):
    return ({k: torch.from_numpy(ref[k])
             for k in ("router", "w_gate", "w_up", "w_down")},
            torch.from_numpy(ref["x"]))


@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("shape", MOE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_shard_map_matches_the_references_shard_map(moe_reference,
                                                        shape, cf):
    """y within 1e-5 and aux within 1e-6 of the reference's shard_map on
    the same (data, model) mesh shape, the port's mesh abstract."""
    params, x = _moe_port(moe_reference)
    mesh = t_mesh.Mesh(dict(zip(("data", "model"), shape)))
    y, aux = t_moe.moe_apply_shard_map(params, x, _moe_cfg(cf), mesh)
    tag = f"{shape[0]}x{shape[1]}_{cf}"
    np.testing.assert_allclose(y.numpy(), moe_reference["y_" + tag],
                               rtol=0, atol=1e-5)
    assert abs(float(aux) - float(moe_reference["aux_" + tag])) <= 1e-6


def test_moe_shard_map_is_per_shard_at_2x2(moe_reference):
    """At 2x2 the aux is the mean of the per-shard auxes, not moe_apply's
    global one, and with capacity 1.0 each shard drops its own tokens: a
    port that called moe_apply would fail here. On 1x1 it is moe_apply."""
    params, x = _moe_port(moe_reference)
    ref = moe_reference
    for cf in CAPACITY:
        cfg = _moe_cfg(cf)
        y_g, aux_g = t_moe.moe_apply(params, x, cfg)
        np.testing.assert_allclose(y_g.numpy(), ref[f"y_global_{cf}"],
                                   rtol=0, atol=1e-5)
        y, aux = t_moe.moe_apply_shard_map(
            params, x, cfg, t_mesh.Mesh({"data": 2, "model": 2}))
        assert abs(float(aux) - float(aux_g)) > 1e-5
        assert abs(float(ref[f"aux_2x2_{cf}"])
                   - float(ref[f"aux_global_{cf}"])) > 1e-5
        y1, aux1 = t_moe.moe_apply_shard_map(
            params, x, cfg, t_mesh.make_host_mesh("cpu"))
        np.testing.assert_allclose(y1.numpy(), y_g.numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert float(aux1) == pytest.approx(float(aux_g), rel=1e-6)
    assert np.abs(y.numpy() - y_g.numpy()).max() > 1e-3   # cf 1.0 drops


def test_moe_shard_map_refuses_what_does_not_divide():
    params, x = {k: torch.zeros(s) for k, s in (
        ("router", (32, 4)), ("w_gate", (4, 32, 64)), ("w_up", (4, 32, 64)),
        ("w_down", (4, 64, 32)))}, torch.zeros(3, 8, 32)
    with pytest.raises(ValueError, match="divide"):
        t_moe.moe_apply_shard_map(params, x, _moe_cfg(8.0),
                                  t_mesh.Mesh({"data": 2, "model": 1}))


# ---------------------------------------------------------------------------
# sampling and serving under SERVE_RULES (tests/test_serving.py's mesh tests)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dit():
    """(jax engine, port engine, spec kwargs, x_T): the reduced dit-cifar
    with the same perturbed params in both frameworks, batch 2."""
    jcfg = j_registry.get_config("dit-cifar").reduced()
    tcfg = t_registry.get_config("dit-cifar").reduced()
    tree = perturbed_tree(jcfg)
    jeng = j_build_engine(jcfg, jax.tree.map(jnp.asarray, tree), JVP(), 2, 0)
    teng = t_build_engine(tcfg, t_api.params_from_numpy(tree, tcfg, "cpu"),
                          TVP(), 2, 0, device="cpu")
    x_T = np.random.default_rng(5).normal(
        size=(2, tcfg.patch_tokens, tcfg.latent_dim)).astype(np.float32)
    return jeng, teng, dict(solver="unipc", order=3, nfe=4), x_T


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def test_scan_path_bit_identical_under_serve_rules_mesh(dit):
    jeng, teng, kw, x_T = dit
    plain = teng.build(TSpec(**kw))(torch.from_numpy(x_T)).numpy()
    with t_sh.sharding_rules(t_mesh.make_host_mesh("cpu"), t_sh.SERVE_RULES):
        meshed = teng.build(TSpec(**kw))(torch.from_numpy(x_T)).numpy()
    np.testing.assert_array_equal(plain, meshed)
    with j_sh.sharding_rules(auto_host_mesh(), j_sh.SERVE_RULES):
        ref = np.asarray(jeng.build(JSpec(**kw))(jnp.asarray(x_T)))
    assert _rel(meshed, ref) <= TOL


def _serve(pkg, program, x_T, ctx=None):
    sched = pkg.SlotScheduler(program, 2, sample_shape=x_T.shape[1:])
    reqs = [pkg.Request(rid=i, arrival=float(2 * i), x_T=x_T[i])
            for i in range(2)]
    if ctx is None:
        pkg.run_trace(sched, reqs)
    else:
        with ctx:
            pkg.run_trace(sched, reqs)
    return {c.rid: c.latent for c in sched.completions}, sched


def test_step_path_bit_identical_under_serve_rules_mesh(dit, monkeypatch):
    """Two staggered requests through the step program: under SERVE_RULES
    on the host mesh bit-identical to no rules, with the slot state
    annotated at every step (the spec the reference gives it); within
    1e-5 of the reference's run under the rules on an Auto 1x1 mesh."""
    jeng, teng, kw, x_T = dit
    plain, _ = _serve(tsv, teng.build_step(TSpec(**kw)), x_T)
    seen = []
    real = t_sh.shard_spec
    monkeypatch.setattr(t_sh, "shard_spec",
                        lambda x, *a: seen.append(real(x, *a)) or seen[-1])
    meshed, sched = _serve(tsv, teng.build_step(TSpec(**kw)), x_T,
                           t_sh.sharding_rules(t_mesh.make_host_mesh("cpu"),
                                               t_sh.SERVE_RULES))
    assert set(plain) == set(meshed) == {0, 1}
    for r in plain:
        np.testing.assert_array_equal(plain[r], meshed[r])
    assert (("data",), None, None) in seen             # x, the cache
    assert (None, ("data",), None, None) in seen       # the ring E
    ref, _ = _serve(jsv, jeng.build_step(JSpec(**kw)), x_T,
                    j_sh.sharding_rules(auto_host_mesh(), j_sh.SERVE_RULES))
    for r in plain:
        assert _rel(meshed[r], ref[r]) <= TOL, r


def test_serve_entry_point_bit_identical_under_serve_rules():
    """launch.serve's DiT path with 4 requests, under the caller's
    SERVE_RULES context on the host mesh: the latents of the run without
    it."""
    from repro_torch.launch import serve as t_serve

    kw = dict(batch=2, nfe=3, requests=4, arrival_rate=1.0, device="cpu")
    plain = t_serve.serve_diffusion("dit-cifar", **kw)
    with t_sh.sharding_rules(t_mesh.make_host_mesh("cpu"), t_sh.SERVE_RULES):
        meshed = t_serve.serve_diffusion("dit-cifar", **kw)
    np.testing.assert_array_equal(plain, meshed)


# ---------------------------------------------------------------------------
# training under the mesh rules (tests/test_perf_features.py's mesh tests)
# ---------------------------------------------------------------------------


def test_seq_parallel_rules_lower_on_host_mesh():
    """olmo-1b (reduced) AR loss under SEQ_PARALLEL_TRAIN_RULES: bit-equal
    to the port without rules, within 1e-5 of the reference's under the
    rules on an Auto 1x1 mesh; its gradients too, to no rules."""
    jcfg, tcfg, jp, tp = reference_params("olmo-1b")
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 33))
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "targets": jnp.asarray(toks[:, 1:], jnp.int32)}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    loss = t_api.train_loss(tcfg, "ar")
    with torch.no_grad():
        plain = loss(tp, tb, None)
    with t_sh.sharding_rules(t_mesh.make_host_mesh("cpu"),
                             t_sh.SEQ_PARALLEL_TRAIN_RULES):
        with torch.no_grad():
            meshed = loss(tp, tb, None)
        leaf = tp["backbone"]["layers"]["attn"]["wq"].clone().requires_grad_()
        tpg = dict(tp, backbone=dict(tp["backbone"], layers=dict(
            tp["backbone"]["layers"],
            attn=dict(tp["backbone"]["layers"]["attn"], wq=leaf))))
        g_mesh, = torch.autograd.grad(loss(tpg, tb, None), leaf)
    g_plain, = torch.autograd.grad(loss(tpg, tb, None), leaf)
    assert torch.equal(plain, meshed) and torch.equal(g_plain, g_mesh)
    with j_sh.sharding_rules(auto_host_mesh(), j_sh.SEQ_PARALLEL_TRAIN_RULES):
        ref = j_api.train_loss(jcfg, "ar")(jp, jb, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(meshed), float(ref), rtol=1e-5)


def test_moe_shard_map_matches_global():
    """The reduced granite-moe forward with moe_shard_map=True on the 1x1
    host mesh takes the shard-mapped block and matches moe_apply's forward
    (the reference's own tolerance); with no mesh it is moe_apply's."""
    from repro_torch.models import transformer as t_tr

    _, tcfg, _, tp = reference_params("granite-moe-3b-a800m")
    smap = dataclasses.replace(tcfg, moe_shard_map=True)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (2, 16)))
    calls = []
    real = t_tr.moe_apply_shard_map

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    with torch.no_grad():
        h_g, aux_g = t_tr.forward(tp["backbone"], tcfg, toks)
        t_tr.moe_apply_shard_map = spy
        try:
            h_n, _ = t_tr.forward(tp["backbone"], smap, toks)
            assert not calls
            with t_sh.sharding_rules(t_mesh.make_host_mesh("cpu"),
                                     t_sh.TRAIN_RULES):
                h_s, aux_s = t_tr.forward(tp["backbone"], smap, toks)
        finally:
            t_tr.moe_apply_shard_map = real
    assert len(calls) == tcfg.num_layers
    assert torch.equal(h_n, h_g)
    np.testing.assert_allclose(h_s.numpy(), h_g.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux_s), float(aux_g), rtol=1e-4)


# ---------------------------------------------------------------------------
# sample_step_fn
# ---------------------------------------------------------------------------


def test_sample_step_fn_is_the_sampling_scan():
    """The dry run's closure runs the same trajectory as unipc_sample_scan
    (bit for bit), and the reference's closure's within 1e-5."""
    x_T = np.random.default_rng(6).normal(size=(3, 4, 8)).astype(np.float32)
    ts = t_make_schedule(TVP(), 6, order=3, prediction="data")
    js = j_make_schedule(JVP(), 6, order=3, prediction="data")

    def t_model(x, t):
        return torch.tanh(x) * (1.0 - 0.5 * t)

    def j_model(x, t):
        return jnp.tanh(x) * (1.0 - 0.5 * t)

    for fused in (True, False):
        got = t_unipc.sample_step_fn(ts, fused_update=fused)(
            t_model, torch.from_numpy(x_T))
        want = t_unipc.unipc_sample_scan(t_model, torch.from_numpy(x_T), ts,
                                         fused_update=fused)
        assert torch.equal(got, want)
        ref = j_unipc.sample_step_fn(js, fused_update=fused)(
            j_model, jnp.asarray(x_T))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the dry run's --mesh
# ---------------------------------------------------------------------------


def _reference_argument_bytes(arch, shape_name, rules_name, mesh_shape):
    """{part: one chip's bytes} from the reference's specs on an abstract
    mesh: params, AdamW state (moments as the params, step replicated),
    batch and cache, each leaf's shard_shape at its dtype."""
    shape = INPUT_SHAPES[shape_name]
    jcfg, _ = _adapted(arch, shape)
    jm = AbstractMesh(mesh_shape, _axes(mesh_shape))
    rules = getattr(j_sh, rules_name)

    def nbytes(tree, shardings):
        return sum(int(np.prod(s.shard_shape(a.shape))) * a.dtype.itemsize
                   for a, s in zip(jax.tree.leaves(tree),
                                   jax.tree.leaves(shardings)))

    params = j_specs.abstract_params(jcfg)
    p_sh = j_specs.param_shardings(params, jm, rules)
    out = {"params_bytes": nbytes(params, p_sh)}
    batch = j_specs.input_specs(jcfg, shape)
    out["batch_bytes"] = nbytes(batch, j_specs.batch_shardings(batch, jm,
                                                               rules))
    if shape.kind == "train":
        opt = jax.eval_shape(JAdamW().init, params)
        repl = j_sh.NamedSharding(jm, j_sh.P())
        out["optimizer_bytes"] = nbytes(opt, type(opt)(repl, p_sh, p_sh))
    if shape.kind == "decode":
        cache = j_specs.abstract_cache(jcfg, shape)
        out["cache_bytes"] = nbytes(cache, j_specs.cache_shardings(
            cache, jm, rules))
    return out


@pytest.mark.parametrize("mesh_kind", sorted(PROD))
@pytest.mark.parametrize("arch,shape,opt,rules", [
    ("qwen2-0.5b", "train_4k", None, "TRAIN_RULES"),
    ("deepseek-67b", "decode_32k", "kvseq", "KV_SEQ_SERVE_RULES")])
def test_dryrun_mesh_argument_bytes_are_the_references(arch, shape, opt,
                                                       rules, mesh_kind,
                                                       tmp_path):
    rec = dryrun.run_one(arch, shape, out_dir=tmp_path, opt=opt,
                         mesh_kind=mesh_kind)
    want = _reference_argument_bytes(arch, shape, rules, PROD[mesh_kind])
    mem = rec["memory"]
    assert {k: mem[k] for k in want} == want
    assert mem["argument_bytes"] == sum(want.values())
    assert (mem["temp_bytes"], mem["peak_bytes"], rec["collectives"]) == \
        (None, None, None)
    assert rec["chips"] == int(np.prod(PROD[mesh_kind]))
    assert rec["mesh"] == mesh_kind and "whole program" in rec["count_scope"]
    suffix = f"__{opt}" if opt else ""
    assert (tmp_path / f"{arch}__{shape}__{mesh_kind}{suffix}.json").exists()


def test_dryrun_h100x1_record_is_unchanged_and_host_mesh_is_one_card(
        tmp_path, capsys):
    """`--mesh h100x1` (the default) gives the record without a mesh, key
    for key; the 1x1 host mesh holds every byte on its one chip; the mesh
    stages run under every mesh."""
    cfg = dataclasses.replace(t_registry.get_config("qwen2-0.5b").reduced(),
                              arch_id="qwen2-0.5b")
    shape = INPUT_SHAPES["decode_32k"]
    small = dataclasses.replace(shape, seq_len=64, global_batch=2)
    base = dryrun.run_one(cfg, small)
    rec = dryrun.run_one(cfg, small, mesh_kind="h100x1")
    assert {k: v for k, v in rec.items() if k != "compile_s"} == \
        {k: v for k, v in base.items() if k != "compile_s"}
    host = dryrun.run_one(cfg, small, mesh_kind="host", opt="kvseq")
    assert host["chips"] == 1
    assert host["memory"]["argument_bytes"] == base["memory"]["argument_bytes"]
    assert host["roofline"] == base["roofline"]
    dryrun.main(["--sample", "--arch", "dit-cifar", "--mesh", "h100x1",
                 "single", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[ok] dit-cifar x sample_nfe10 x h100x1" in out
    assert "[ok] dit-cifar x sample_nfe10 x single" in out
    assert {p.name for p in tmp_path.glob("*.json")} == {
        "dit-cifar__sample_nfe10__h100x1.json",
        "dit-cifar__sample_nfe10__single.json"}
