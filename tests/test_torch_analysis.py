"""The port's analysis layer for one card (the roofline, the operation count,
the abstract specs and the meta-device dry run) against the JAX reference's
(`repro.analysis`, `repro.launch.specs`, `repro.configs.registry`).

Exact (integer) equality with the reference for `active_params`,
`model_flops_*`, `get_shape`, `all_arch_ids`, the input specs' shapes and
dtypes, the params' and caches' per-dtype counts and bytes and the dry
run's argument bytes, across the twelve archs. The port's FLOP count of an
eager run (`analysis/opcount.py`) within 1% of the reference's HLO count
(`repro/analysis/hlo.py`) of the same jitted forward, on a reduced
dit-cifar eps eval (fp32, non-causal, so the attention kernel's kept pairs
are S^2) and a reduced mamba2 forward (less the C.B products the
reference forms once a head and the port once a group); within 5% of 2ND
plus the causal-pair attention term on a reduced olmo (the counterpart
of `test_accounting.py::test_hlo_flops_match_2nd_rule`). Counts of one call
equal on CPU tensors and on the meta device (every key, exactly). The
`gpu` test (skipped without a card) is phase 15 (a) of `chip_smoke.py`:
the same equality between a count on the card and one on meta.
"""

import dataclasses
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hlo as j_hlo
from repro.analysis import roofline as j_roof
from repro.configs import registry as j_registry
from repro.launch import specs as j_specs
from repro.models import api as j_api
from repro.optim import AdamW as JAdamW
from repro_torch.analysis import opcount, roofline
from repro_torch.configs import INPUT_SHAPES, InputShape
from repro_torch.configs import registry
from repro_torch.kernels import dispatch
from repro_torch.kernels.adaln_modulate import ops as adaln_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import dryrun, specs
from repro_torch.models import api

torch.set_num_threads(2)

ARCHS = registry.all_arch_ids(True)
TOKEN_ARCHS = registry.all_arch_ids()
FLOP_TOL = 1e-2        # opcount against hlo.analyze, relative
RULE_TOL = 5e-2        # against 2ND + attention, as test_accounting.py


def _name(dtype) -> str:
    return str(np.dtype(dtype)) if not isinstance(dtype, torch.dtype) \
        else str(dtype).replace("torch.", "")


def _objective(arch):
    return "diffusion" if arch.startswith("dit") else "ar"


# ---------------------------------------------------------------------------
# roofline and registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_model_flops_equal_the_reference(arch):
    tc, jc = registry.get_config(arch), j_registry.get_config(arch)
    assert roofline.active_params(tc) == j_roof.active_params(jc)
    for tokens in (1, 4096, 256 * 4096):
        assert roofline.model_flops_train(tc, tokens) == \
            j_roof.model_flops_train(jc, tokens)
        assert roofline.model_flops_decode(tc, tokens) == \
            j_roof.model_flops_decode(jc, tokens)


def test_get_shape_and_all_arch_ids_equal_the_reference():
    assert registry.all_arch_ids() == j_registry.all_arch_ids()
    assert registry.all_arch_ids(True) == j_registry.all_arch_ids(True)
    for name in j_registry.INPUT_SHAPES:
        assert dataclasses.astuple(registry.get_shape(name)) == \
            dataclasses.astuple(j_registry.get_shape(name))


def test_roofline_adds_one_compute_term_per_dtype():
    """The compute term is sum_d flops[d] / peak[d]; one card has no link."""
    r = roofline.Roofline({torch.bfloat16: 989e12, "float32": 67e12},
                          3.35e12 / 2, model_flops=989e12)
    assert r.flops == 989e12 + 67e12
    assert r.compute_s == pytest.approx(2.0, rel=1e-12)
    assert r.memory_s == pytest.approx(0.5, rel=1e-12)
    assert (r.bottleneck, r.step_time_s, r.collective_s) == ("compute", r.compute_s, 0.0)
    assert r.mfu == pytest.approx(0.5, rel=1e-12)
    row = r.row()
    assert set(j_roof.Roofline(1.0, 1.0, 0.0, 1).row()) <= set(row)
    assert row["flops_by_dtype"] == {"bfloat16": 989e12, "float32": 67e12}
    with pytest.raises(ValueError, match="SPMD partitioner"):
        roofline.Roofline({}, 0.0, collective_bytes=1.0).collective_s
    ms, by = roofline.kernel_bound(dispatch.Cost(67e9, 1.0, torch.float32))
    assert (ms, by) == (pytest.approx(1.0, rel=1e-12), "operations")


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (1, 1, True, None), (7, 7, False, None), (300, 300, True, None),
    (300, 300, True, 64), (300, 300, False, 40), (100, 150, False, None),
    (130, 70, True, None), (90, 20, True, 5), (5, 512, True, None)])
def test_attention_pairs_count_the_mask_the_kernel_keeps(Sq, Skv, causal,
                                                         window):
    from repro_torch.kernels.flash_attention import ref as fa_ref

    ok = fa_ref._visible(Sq, Skv, causal, window, "cpu")
    assert fa_ops.attention_pairs(Sq, Skv, causal, window) == int(ok.sum())


# ---------------------------------------------------------------------------
# the small repairs: params and the plain version on the meta device
# ---------------------------------------------------------------------------

def test_init_params_builds_on_the_meta_device():
    cfg = registry.get_config("qwen2-0.5b").reduced()
    meta, cpu = (api.init_params(cfg, 0, d) for d in ("meta", "cpu"))
    flat_m = jax.tree.leaves(meta)
    flat_c = jax.tree.leaves(cpu)
    assert all(t.device.type == "meta" for t in flat_m)
    assert [(t.shape, t.dtype) for t in flat_m] == \
        [(t.shape, t.dtype) for t in flat_c]


def test_meta_tensors_take_the_plain_version_and_cuda_ones_the_kernel():
    meta = torch.empty(2, device="meta")
    assert dispatch.use_kernel(None, meta) is False
    assert dispatch.use_kernel(None, torch.empty(2)) is False
    card = types.SimpleNamespace(device=torch.device("cuda"))
    assert dispatch.use_kernel(None, card) is True
    assert dispatch.use_kernel("plain", card) is False
    with pytest.raises(RuntimeError, match="no kernel or plain path"):
        dispatch.use_kernel(None, types.SimpleNamespace(
            device=torch.device("xpu")))
    q = torch.empty(2, 4, 16, 32, device="meta")
    out = fa_ops.attention(q, q[:, :2], q[:, :2], causal=True)
    assert out.device.type == "meta" and out.shape == q.shape


@pytest.mark.parametrize("op", ["attention", "modulate", "gate_residual"])
def test_counted_autograd_route_gives_the_plain_gradients(op):
    """A CPU call that needs grad goes through the op's autograd Function
    with the plain forward and backward inside (the route the card takes
    with its kernels), counted or not; its gradients are autograd's through
    the pinned plain forward (`backend="plain"`), to 1e-5 relative
    (fp32)."""
    g = torch.Generator().manual_seed(0)
    if op == "attention":
        args = [torch.randn(2, 4, 33, 16, generator=g),
                torch.randn(2, 2, 33, 16, generator=g),
                torch.randn(2, 2, 33, 16, generator=g)]
        fn = functools.partial(fa_ops.attention, causal=True, window=8)
    else:
        args = [torch.randn(2, 9, 24, generator=g),
                torch.randn(2, 24, generator=g),
                torch.randn(2, 9 if op == "gate_residual" else 24, 24,
                            generator=g)]
        if op == "modulate":
            args = args[:2] + [torch.randn(2, 24, generator=g)]
            fn = adaln_ops.modulate
        else:
            args = [args[0], args[1], torch.randn(2, 9, 24, generator=g)]
            fn = adaln_ops.gate_residual
    w = torch.randn(fn(*args).shape, generator=g)

    def grads(route):
        leaves = [a.clone().requires_grad_() for a in args]
        if route == "counted":
            with opcount.OpCount() as count:
                (fn(*leaves) * w).sum().backward()
            # the op and its backward were reported
            assert any(k.endswith("_bwd") for k in count.kernels)
        else:
            out = fn(*leaves, **({"backend": "plain"} if route == "plain"
                                 else {}))
            assert (out.grad_fn.name().startswith("_")) == (route != "plain")
            (out * w).sum().backward()
        return [a.grad for a in leaves]

    want = grads("plain")
    for route in ("counted", "uncounted"):
        for a, b in zip(grads(route), want):
            assert float((a - b).abs().max() / b.abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# abstract specs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return j_specs.abstract_params(j_registry.get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return specs.abstract_params(registry.get_config(arch))


def _by_dtype(leaves) -> dict:
    out = {}
    for t in leaves:
        n = int(np.prod(t.shape))
        item = t.dtype.itemsize if not isinstance(t.dtype, torch.dtype) \
            else t.element_size()
        c, b = out.get(_name(t.dtype), (0, 0))
        out[_name(t.dtype)] = (c + n, b + n * item)
    return out


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch, shape):
    tc, jc = registry.get_config(arch), j_registry.get_config(arch)
    for objective in ("ar", "diffusion"):
        got = specs.input_specs(tc, INPUT_SHAPES[shape], objective)
        want = j_specs.input_specs(jc, j_registry.INPUT_SHAPES[shape],
                                   objective)
        assert list(got) == list(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert (tuple(got[k].shape), _name(got[k].dtype)) == \
                (tuple(want[k].shape), _name(want[k].dtype)), (k, objective)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_the_reference_per_dtype(arch):
    assert _by_dtype(jax.tree.leaves(_port_params(arch))) == \
        _by_dtype(jax.tree.leaves(_ref_params(arch)))


def _cache_cases():
    for arch in TOKEN_ARCHS:
        for shape in ("decode_32k", "long_500k"):
            if (arch, shape) not in dryrun.SKIPS:
                yield arch, shape


@pytest.mark.parametrize("arch,shape", list(_cache_cases()))
def test_abstract_cache_bytes_equal_the_reference(arch, shape):
    """Each cache at decode_32k, and at long_500k after adapt_config (the
    port's; the reference's module sets a 512-device XLA flag on import, so
    its copy is applied to the reference's config the same way)."""
    tc = dryrun.adapt_config(registry.get_config(arch), shape)
    jc = dataclasses.replace(j_registry.get_config(arch),
                             sliding_window=tc.sliding_window,
                             remat=tc.remat)
    got = specs.abstract_cache(tc, INPUT_SHAPES[shape])
    want = j_specs.abstract_cache(jc, j_registry.INPUT_SHAPES[shape])
    assert _by_dtype(jax.tree.leaves(got)) == _by_dtype(jax.tree.leaves(want))


def _tree_bytes(tree) -> int:
    return sum(int(np.prod(t.shape)) * t.dtype.itemsize
               for t in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_argument_bytes_equal_the_reference(arch):
    """A train step's arguments (params, AdamW state, batch) and, for the
    token archs, a decode step's (params, cache, batch)."""
    tc, jc = registry.get_config(arch), j_registry.get_config(arch)
    shapes = ["train_4k"] + (["decode_32k"] if arch in TOKEN_ARCHS else [])
    for shape in shapes:
        jshape = j_registry.INPUT_SHAPES[shape]
        want = _tree_bytes(_ref_params(arch)) + _tree_bytes(
            j_specs.input_specs(jc, jshape, _objective(arch)))
        if shape == "train_4k":
            want += _tree_bytes(jax.eval_shape(JAdamW().init,
                                               _ref_params(arch)))
        else:
            want += _tree_bytes(j_specs.abstract_cache(jc, jshape))
        w = dryrun.build_workload(tc, INPUT_SHAPES[shape], _objective(arch))
        got = dryrun.memory_record(w.parts, dict(
            peak_live_bytes=0, output_bytes=0, saved_bytes=0),
            train=shape == "train_4k")["argument_bytes"]
        assert got == want, (shape, got, want)


# ---------------------------------------------------------------------------
# the operation count against the reference's HLO count
# ---------------------------------------------------------------------------

def _hlo_flops(fn, *args) -> float:
    text = jax.jit(fn).lower(*args).compile().as_text()
    return j_hlo.analyze(text, 1)["flops"]


def test_dit_eval_flops_match_the_reference_hlo():
    arch = "dit-cifar"
    jc = dataclasses.replace(j_registry.get_config(arch).reduced(),
                             attention_backend="jnp", adaln_backend="jnp")
    tc = registry.get_config(arch).reduced()
    assert tc.dtype == "float32" and tc.family == "dit"
    B = 4
    x = jax.ShapeDtypeStruct((B, jc.patch_tokens, jc.latent_dim), jnp.float32)
    t = jax.ShapeDtypeStruct((B,), jnp.float32)
    ids = jax.ShapeDtypeStruct((B,), jnp.int32)
    j_net = j_api.eps_network(jc)
    want = _hlo_flops(lambda p, x, t, c: j_net(p, x, t, {"class_ids": c}),
                      j_specs.abstract_params(jc), x, t, ids)
    t_net = api.eps_network(tc)
    p = specs.abstract_params(tc)
    acct = opcount.analyze(
        t_net, p, torch.empty(B, tc.patch_tokens, tc.latent_dim,
                              device="meta"),
        torch.empty(B, device="meta"),
        {"class_ids": torch.zeros(B, dtype=torch.int64, device="meta")})
    assert acct["kernels"]["flash_attention"] == tc.num_layers
    assert abs(acct["flops"] - want) / want <= FLOP_TOL, (acct["flops"], want)
    assert set(acct["flops_by_dtype"]) == {"float32"}


@pytest.mark.parametrize("arch", [a for a in ARCHS if a.startswith("dit")])
def test_sample_model_flops_count_adaln_once_a_row(arch):
    """`model_flops_sample` is 2 N_active a token with the adaLN projections
    (6 d^2 a layer) once a row: exactly the per-token convention less their
    repeats, and (full width, counted on meta, batch 2) within the FLOPs an
    eval really does, by at most 5% (what it leaves out: attention's
    products), where the per-token convention is 1.44x over them."""
    cfg, B = registry.get_config(arch), 2
    adaln = 6 * cfg.num_layers * cfg.d_model ** 2
    per_token = 2.0 * roofline.active_params(cfg) * cfg.patch_tokens
    assert roofline.model_flops_sample(cfg, 3, B) == \
        3 * B * (per_token - 2.0 * adaln * (cfg.patch_tokens - 1))
    acct = opcount.analyze(
        api.eps_network(cfg), specs.abstract_params(cfg),
        torch.empty(B, cfg.patch_tokens, cfg.latent_dim, device="meta"),
        torch.empty(B, device="meta"),
        {"class_ids": torch.zeros(B, dtype=torch.int64, device="meta")})
    mf = roofline.model_flops_sample(cfg, 1, B)
    assert 0.95 * acct["flops"] <= mf <= acct["flops"]
    assert B * per_token > 1.4 * acct["flops"]


def test_mamba2_forward_flops_match_the_reference_hlo():
    """The port's SSD scan forms C.B once a group, where the reference's
    einsum forms it once a head (B and C broadcast over a group's heads,
    ROADMAP C6): the reference's HLO counts 2 b c (H - G) q^2 N more a
    layer. The rest is held within 1%."""
    from repro.models import hybrid as j_hybrid
    from repro_torch.models import hybrid as t_hybrid

    jc = j_registry.get_config("mamba2-780m").reduced()
    tc = registry.get_config("mamba2-780m").reduced()
    B, S = 2, 64
    want = _hlo_flops(lambda p, tok: j_hybrid.mamba_forward(
        p["backbone"], jc, tok)[0], j_specs.abstract_params(jc),
        jax.ShapeDtypeStruct((B, S), jnp.int32))
    q, chunks = tc.ssm_chunk, -(-S // tc.ssm_chunk)
    per_head_cb = tc.num_layers * 2 * B * chunks * (
        tc.ssm_heads - tc.ssm_groups) * q * q * tc.ssm_state
    assert per_head_cb > FLOP_TOL * want      # the difference is visible
    p = specs.abstract_params(tc)
    acct = opcount.analyze(
        lambda p, tok: t_hybrid.mamba_forward(p["backbone"], tc, tok)[0], p,
        torch.zeros(B, S, dtype=torch.int32, device="meta"))
    want -= per_head_cb
    assert abs(acct["flops"] - want) / want <= FLOP_TOL, (acct["flops"], want)


def test_opcount_flops_match_2nd_rule_with_causal_pairs():
    """A reduced olmo forward: 2 N D for the matmuls (qkvo, the gelu MLP,
    the output projection) plus, per layer, QK^T and PV over the causal
    pairs the kernel scores (S (S + 1) / 2, not the S^2 the reference's
    HLO counts)."""
    from repro_torch.models import transformer

    cfg = registry.get_config("olmo-1b").reduced(
        num_layers=4, d_model=128, d_ff=512, vocab_size=1024, num_heads=4,
        num_kv_heads=4)
    B, S = 4, 256
    p = specs.abstract_params(cfg)["backbone"]

    def fwd(p, tokens):
        h, _ = transformer.forward(p, cfg, tokens)
        return transformer.logits_from_hidden(p, cfg, h)

    acct = opcount.analyze(fwd, p, torch.zeros(B, S, dtype=torch.int32,
                                               device="meta"))
    d, f, L, V = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.vocab_size
    n_mat = L * (4 * d * d + 2 * d * f) + V * d
    pairs = S * (S + 1) // 2
    expect = 2 * n_mat * B * S + L * 2 * 2 * B * cfg.num_heads * pairs * (
        d // cfg.num_heads)
    assert abs(acct["flops"] - expect) / expect < RULE_TOL, (acct["flops"],
                                                              expect)


# ---------------------------------------------------------------------------
# one count on every device
# ---------------------------------------------------------------------------

def _count_cases():
    dit = registry.get_config("dit-cifar").reduced()
    lm = registry.get_config("qwen2-0.5b").reduced()

    def dit_eval(device):
        p = api.init_params(dit, 0, device)
        x = torch.zeros(2, dit.patch_tokens, dit.latent_dim, device=device)
        t = torch.full((2,), 0.5, device=device)
        ids = torch.zeros(2, dtype=torch.int64, device=device)
        return api.eps_network(dit), (p, x, t, {"class_ids": ids})

    def prefill(device):
        w = dryrun.build_workload(lm, InputShape("p", 24, 2, "prefill"),
                                  device=device)
        return w.fn, w.args

    def ar_step(device):
        w = dryrun.build_workload(dataclasses.replace(lm, remat=True),
                                  InputShape("t", 24, 2, "train"),
                                  device=device)
        return w.fn, w.args

    return {"dit eval": dit_eval, "qwen2 prefill": prefill,
            "qwen2 AR step": ar_step}


COUNT_KEYS = ("flops", "flops_by_dtype", "hbm_bytes", "min_bytes",
              "collectives", "kernels", "output_bytes", "peak_live_bytes",
              "saved_bytes")


@pytest.mark.parametrize("case", list(_count_cases()))
def test_counts_are_equal_on_cpu_and_on_meta(case):
    build = _count_cases()[case]
    counts = []
    for device in ("cpu", "meta"):
        fn, args = build(device)
        counts.append(opcount.analyze(fn, *args))
    assert set(counts[0]) == set(COUNT_KEYS)
    assert counts[0] == counts[1]
    assert counts[0]["kernels"] and counts[0]["flops"] > 0
    assert counts[0]["collectives"] == {"_total": 0.0}
    if case == "qwen2 AR step":
        assert counts[0]["kernels"]["flash_attention_bwd"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_count_cases()))
def test_card_counts_equal_the_meta_counts(case):
    """Phase 15 (a) of chip_smoke.py at the reduced size: the count taken
    on the card, where the kernels run, equals the count on meta, and the
    kernels it reports are those launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    build = _count_cases()[case]
    fn, args = build("cuda")
    dispatch.LAUNCHES.clear()
    card = opcount.analyze(fn, *args)
    torch.cuda.synchronize()
    assert dict(dispatch.LAUNCHES) == card["kernels"]
    fn, args = build("meta")
    assert opcount.analyze(fn, *args) == card


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

RECORD_KEYS = {"arch", "shape", "mesh", "chips", "opt", "objective",
               "compile_s", "cost_unfused", "min_bytes", "kernels", "memory",
               "collectives", "roofline", "params_active"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
               "activation_bytes", "fits_80GB", "params_bytes"}
FAMILY_ARCHS = {"dense": "qwen2-0.5b", "moe": "granite-moe-3b-a800m",
                "ssm": "mamba2-780m", "hybrid": "zamba2-7b",
                "vlm": "llama-3.2-vision-90b", "audio": "whisper-small"}


def _run_one_cases():
    yield "dit-cifar", "train"
    for arch in FAMILY_ARCHS.values():
        for kind in ("train", "prefill", "decode"):
            yield arch, kind


@pytest.mark.parametrize("arch,kind", list(_run_one_cases()))
def test_run_one_returns_the_record(arch, kind, tmp_path):
    cfg = registry.get_config(arch).reduced()
    shape = InputShape(f"tiny_{kind}", 16, 2, kind)
    rec = dryrun.run_one(cfg, shape, _objective(arch), out_dir=tmp_path)
    assert set(rec) == RECORD_KEYS
    assert MEMORY_KEYS <= set(rec["memory"])
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == \
        (arch, shape.name, dryrun.MESH, 1)
    assert rec["objective"] == (_objective(arch) if kind == "train"
                                else kind)
    r, m = rec["roofline"], rec["memory"]
    assert r["bottleneck"] in ("compute", "memory")
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert r["hbm_bytes_per_chip"] == rec["min_bytes"]
    assert rec["params_active"] == roofline.active_params(cfg)
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert m["fits_80GB"] is True
    assert (tmp_path / f"{arch}__{shape.name}__{dryrun.MESH}.json").exists()
    if kind == "train":
        assert m["optimizer_bytes"] > 2 * m["params_bytes"] - 64


def test_dryrun_refuses_the_mesh_stages():
    """No stage is refused now: the ones that set rules or moe_shard_map
    give the reference's rule tables and config, as the config-only ones
    give theirs; a stage the pair does not have raises."""
    from repro.parallel import sharding as j_sh

    granite, deepseek = "granite-moe-3b-a800m", "deepseek-67b"
    assert dryrun.stage(granite, "train_4k", "shard_map") == \
        dict(cfg=dict(moe_shard_map=True))
    assert dryrun.stage(granite, "train_4k", "shard_map_seqp") == dict(
        cfg=dict(moe_shard_map=True), rules=j_sh.SEQ_PARALLEL_TRAIN_RULES)
    assert dryrun.stage("mixtral-8x7b", "train_4k", "shard_map") == \
        dict(cfg=dict(moe_shard_map=True))
    assert dryrun.stage(deepseek, "train_4k", "seqp") == \
        dict(rules=j_sh.SEQ_PARALLEL_TRAIN_RULES)
    assert dryrun.stage(deepseek, "train_4k", "seqp_chunk") == dict(
        cfg=dict(attention_chunk=512), rules=j_sh.SEQ_PARALLEL_TRAIN_RULES)
    assert dryrun.stage(deepseek, "decode_32k", "kvseq_bf16") == dict(
        cfg=dict(param_dtype="bfloat16"), rules=j_sh.KV_SEQ_SERVE_RULES)
    for arch in (deepseek, "qwen2-0.5b"):
        assert dryrun.stage(arch, "decode_32k", "kvseq") == \
            dict(rules=j_sh.KV_SEQ_SERVE_RULES)
    assert dryrun.stage("qwen2-0.5b", "prefill_32k", "chunk512") == \
        dict(cfg=dict(attention_chunk=512))
    with pytest.raises(KeyError, match="no stage"):
        dryrun.stage("qwen2-0.5b", "prefill_32k", "kvseq")
