"""The port's decoder-only token family (dense and MoE) against the JAX
reference, module by module, on the same inputs.

Configs are compared field for field. Params come from the reference's
`init_params`, every float leaf perturbed by 0.05 N(0, 1) drawn with numpy
(zero-init biases and the diffusion head's zero-init out_proj would make
parts of the comparison vacuous), then carried over by
`api.params_from_numpy`. Inputs are drawn with numpy from a seed. fp32 on
the CPU throughout, where the flash_attention op is its plain version, as
the reference's is off the TPU; tolerance 1e-5 relative L-inf (matmul and
reduction order differ between XLA and PyTorch; measured about 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import api as j_api
from repro.models import diffusion_lm as j_dlm
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import api as t_api
from repro_torch.models import diffusion_lm as t_dlm
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf

torch.set_num_threads(2)

TOL = 1e-5
TOKEN_ARCHS = ["qwen2-0.5b", "qwen2.5-3b", "olmo-1b", "deepseek-67b",
               "granite-moe-3b-a800m", "mixtral-8x7b"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _t(a):
    return torch.as_tensor(np.array(a))


def reference_params(arch, seed=0, scale=0.05, **overrides):
    """(jax cfg, port cfg, jax params, port params): the reference's
    init_params with every float leaf perturbed by scale * N(0, 1)."""
    jcfg = j_get_config(arch).reduced(**overrides)
    tcfg = t_get_config(arch).reduced(**overrides)
    tree = jax.tree.map(np.asarray, j_api.init_params(
        jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(
        lambda a: (a + scale * rng.normal(size=a.shape)).astype(a.dtype), tree)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            t_api.params_from_numpy(tree, tcfg, "cpu"))


def _tokens(cfg, B, S, seed=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_the_reference_field_for_field(arch):
    """The full config and `reduced()` (with an override) carry the
    reference's fields and values; the dtypes map to torch's."""
    j, t = j_get_config(arch), t_get_config(arch)
    for jc, tc in ((j, t), (j.reduced(), t.reduced()),
                   (j.reduced(num_layers=3), t.reduced(num_layers=3))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.activation_dtype == getattr(torch, jc.dtype)
        assert tc.weight_dtype == getattr(torch, jc.param_dtype)
        assert (tc.ssm_d_inner, tc.ssm_heads) == (jc.ssm_d_inner, jc.ssm_heads)


def test_registry_ports_the_token_family_and_refuses_the_rest():
    """Every reference arch is ported (the vlm and audio families last):
    the registry refuses no arch of the reference, only an unknown one."""
    from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
    from repro.configs.registry import INPUT_SHAPES as J_SHAPES
    from repro_torch.configs import INPUT_SHAPES

    assert sorted(ARCH_IDS) == sorted(TOKEN_ARCHS + [
        "mamba2-780m", "zamba2-7b", "llama-3.2-vision-90b", "whisper-small",
        "dit-i256", "dit-cifar"])
    assert sorted(ARCH_IDS) == sorted(J_ARCH_IDS)
    for arch in J_ARCH_IDS:
        assert t_get_config(arch).arch_id == arch
    with pytest.raises(KeyError):
        t_get_config("gpt-9")
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms_match_reference(norm):
    rng = np.random.default_rng(3)
    x = (3.0 * rng.normal(size=(2, 5, 48)) + 0.5).astype(np.float32)
    params = {"w": rng.normal(size=48).astype(np.float32),
              "b": rng.normal(size=48).astype(np.float32)}
    if norm == "rmsnorm":
        params.pop("b")
    if norm == "nonparam_ln":
        params = {}
    want = j_layers.NORMS[norm][1](jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(x))
    got = t_layers.NORMS[norm][1]({k: _t(v) for k, v in params.items()},
                                  _t(x))
    assert _rel(got, want) <= TOL
    jinit, tinit = j_layers.NORMS[norm][0], t_layers.NORMS[norm][0]
    assert (jax.tree.map(np.asarray, jinit(48, jnp.float32)).keys()
            == tinit(48, torch.float32).keys())


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        t_layers.rope_freqs(64, theta).numpy(),
        np.asarray(j_layers.rope_freqs(64, theta)), rtol=1e-7)
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = t_layers.apply_rope(_t(x), _t(pos).long(), theta)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    jcfg = dataclasses.replace(j_get_config("qwen2-0.5b").reduced(), act=act)
    tcfg = dataclasses.replace(t_get_config("qwen2-0.5b").reduced(), act=act)
    p = jax.tree.map(np.asarray,
                     j_layers.mlp_init(jax.random.PRNGKey(5), jcfg))
    x = np.random.default_rng(5).normal(size=(2, 6, 128)).astype(np.float32)
    want = j_layers.mlp_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              jcfg)
    got = t_layers.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), tcfg)
    assert _rel(got, want) <= TOL
    tp = t_layers.mlp_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: v.shape for k, v in p.items()}


SDPA_CASES = [  # Sq, Skv, Hq, Hkv, causal, window, explicit positions
    (9, 9, 4, 4, True, None, False),
    (9, 9, 6, 2, True, None, False),      # GQA group 3
    (9, 9, 4, 2, False, None, False),
    (12, 12, 4, 2, True, 4, False),       # causal sliding window
    (12, 12, 4, 1, False, 5, False),      # bidirectional window, MQA
    (3, 10, 4, 2, True, None, True),      # decode-like: positions 7..9
    (5, 10, 4, 2, True, 3, True),
]


@pytest.mark.parametrize("Sq,Skv,Hq,Hkv,causal,window,positions", SDPA_CASES)
def test_sdpa_matches_reference(Sq, Skv, Hq, Hkv, causal, window, positions):
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, Sq, Hq, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, Skv, Hkv, 32)).astype(np.float32)
            for _ in range(2))
    qp = np.arange(Skv - Sq, Skv, dtype=np.int32) if positions else None
    kp = np.arange(Skv, dtype=np.int32) if positions else None
    want = j_layers.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, sliding_window=window,
                         q_positions=None if qp is None else jnp.asarray(qp),
                         kv_positions=None if kp is None else jnp.asarray(kp))
    got = t_layers.sdpa(_t(q), _t(k), _t(v), causal=causal,
                        sliding_window=window,
                        q_positions=None if qp is None else _t(qp).long(),
                        kv_positions=None if kp is None else _t(kp).long())
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("Sq,chunk,causal,window", [
    (21, 8, True, None),      # ragged tail: 21 = 2 * 8 + 5
    (21, 8, False, 6),
    (16, 4, True, 5),
])
def test_chunked_sdpa_matches_reference(Sq, chunk, causal, window):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, Sq, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, Sq, 2, 32)).astype(np.float32)
            for _ in range(2))
    want = j_layers.chunked_sdpa(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 sliding_window=window, chunk=chunk)
    got = t_layers.chunked_sdpa(_t(q), _t(k), _t(v), causal=causal,
                                sliding_window=window, chunk=chunk)
    assert got.shape == (2, Sq, 4, 32)
    assert _rel(got, want) <= TOL
    # and it is sdpa itself, blockwise
    assert _rel(got, t_layers.sdpa(_t(q), _t(k), _t(v), causal=causal,
                                   sliding_window=window)) <= TOL


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, sliding_window=4),
    dict(causal=True, attention_chunk=4),          # chunked_sdpa route
    dict(causal=False, rope=False),
    dict(causal=True, positions=True),             # explicit positions
    dict(causal=False, kv_src=True),               # cross-attention
])
def test_attention_apply_matches_reference(kw):
    kw = dict(kw)
    over = {"attention_chunk": kw.pop("attention_chunk", 0)}
    jcfg = j_get_config("qwen2-0.5b").reduced(**over)      # qkv_bias, GQA
    tcfg = t_get_config("qwen2-0.5b").reduced(**over)
    d_src = 40 if kw.get("kv_src") else None
    p = jax.tree.map(np.asarray, j_layers.attention_init(
        jax.random.PRNGKey(8), jcfg, d_kv_src=d_src))
    rng = np.random.default_rng(8)
    p = {k: (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
         for k, v in p.items()}                              # biases nonzero
    x = rng.normal(size=(2, 11, 128)).astype(np.float32)
    jkw, tkw = {}, {}
    if kw.pop("kv_src", False):
        src = rng.normal(size=(2, 5, 40)).astype(np.float32)
        jkw["kv_src"], tkw["kv_src"] = jnp.asarray(src), _t(src)
    if kw.pop("positions", False):
        pos = np.broadcast_to(np.arange(100, 111), (2, 11)).astype(np.int32)
        jkw["positions"] = jkw["kv_positions"] = jnp.asarray(pos)
        tkw["positions"] = tkw["kv_positions"] = _t(pos).long()
    want = j_layers.attention_apply(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x), jcfg, **jkw, **kw)
    got = t_layers.attention_apply({k: _t(v) for k, v in p.items()}, _t(x),
                                   tcfg, **tkw, **kw)
    assert _rel(got, want) <= TOL
    tp = t_layers.attention_init(torch.Generator().manual_seed(0), tcfg,
                                 "cpu", d_kv_src=d_src)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: v.shape for k, v in p.items()}


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_params(arch="granite-moe-3b-a800m", **over):
    jcfg = j_get_config(arch).reduced(**over)
    tcfg = t_get_config(arch).reduced(**over)
    p = jax.tree.map(np.asarray, j_moe.moe_init(jax.random.PRNGKey(9), jcfg))
    p["router"] = (p["router"] * 50).astype(np.float32)   # sharp routing
    return jcfg, tcfg, p


def _kept(cfg, top_i, G):
    """The reference's keep mask for a routing (position-in-expert < C)."""
    import math
    N, k = top_i.shape
    n, E = N // G, cfg.num_experts
    C = max(1, int(math.ceil(k * n / E * cfg.capacity_factor)))
    flat = top_i.reshape(G, n * k)
    oh = flat[..., None] == np.arange(E)
    pos = (np.cumsum(oh, axis=1) * oh).sum(-1) - 1
    return pos < C


@pytest.mark.parametrize("groups,capacity", [(0, 1.25), (2, 1.25),
                                             (0, 0.3), (2, 0.3)])
def test_moe_apply_matches_reference(groups, capacity):
    """G = 1 and G = 2, with drops under tight capacity: the same routing,
    the same kept and dropped slots, the same output and aux loss."""
    jcfg, tcfg, p = _moe_params(moe_dispatch_groups=groups,
                                capacity_factor=capacity)
    x = np.random.default_rng(10).normal(size=(2, 12, 128)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: _t(v) for k, v in p.items()}
    jprobs, jidx, jaux = j_moe._route(jp, jnp.asarray(x.reshape(24, 128)),
                                      jcfg)
    tprobs, tidx, taux = t_moe._route(tp, _t(x.reshape(24, 128)), tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert _rel(tprobs, jprobs) <= TOL and _rel(taux, jaux) <= TOL
    keep = _kept(jcfg, np.asarray(jidx), groups or 1)
    if capacity < 1:
        assert 0 < keep.sum() < keep.size                 # drops happen
    want, want_aux = j_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    got, got_aux = t_moe.moe_apply(tp, _t(x), tcfg)
    assert _rel(got, want) <= TOL and _rel(got_aux, want_aux) <= TOL
    # a dropped slot adds nothing: rows whose every slot dropped are zero
    dropped_rows = ~keep.reshape(24, -1).any(-1)
    assert np.all(got.numpy().reshape(24, 128)[dropped_rows] == 0)


def test_moe_decode_apply_matches_reference():
    jcfg, tcfg, p = _moe_params()
    x = np.random.default_rng(11).normal(size=(3, 1, 128)).astype(np.float32)
    want = j_moe.moe_decode_apply(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), jcfg)
    got = t_moe.moe_decode_apply({k: _t(v) for k, v in p.items()}, _t(x), tcfg)
    assert _rel(got, want) <= TOL


def test_moe_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    got_v, got_i = t_moe.top_k(probs, 2)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TOKEN_ARCHS)
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_reference(arch, causal):
    jcfg, tcfg, jp, tp = reference_params(arch)
    toks = _tokens(jcfg, 2, 10)
    jh, jaux = j_tf.forward(jp["backbone"], jcfg, jnp.asarray(toks),
                            causal=causal)
    th, taux = t_tf.forward(tp["backbone"], tcfg, _t(toks).long(),
                            causal=causal)
    assert _rel(th, jh) <= TOL
    assert abs(float(taux) - float(jaux)) <= TOL * max(abs(float(jaux)), 1)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-3b-a800m"])
def test_forward_from_inputs_embeds_matches_reference(arch):
    jcfg, tcfg, jp, tp = reference_params(arch)
    e = np.random.default_rng(12).normal(size=(2, 9, 128)).astype(np.float32)
    jh, _ = j_tf.forward(jp["backbone"], jcfg, None, causal=False,
                         inputs_embeds=jnp.asarray(e))
    th, _ = t_tf.forward(tp["backbone"], tcfg, None, causal=False,
                         inputs_embeds=_t(e))
    assert _rel(th, jh) <= TOL


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmo-1b",        # tied
                                  "qwen2.5-3b", "mixtral-8x7b"])  # untied
def test_logits_and_lm_loss_match_reference(arch):
    jcfg, tcfg, jp, tp = reference_params(arch)
    assert ("lm_head" in tp["backbone"]) == (not tcfg.tie_embeddings)
    toks = _tokens(jcfg, 2, 10)
    tgts = _tokens(jcfg, 2, 10, seed=13)
    h = np.random.default_rng(14).normal(size=(2, 4, 128)).astype(np.float32)
    want = j_tf.logits_from_hidden(jp["backbone"], jcfg, jnp.asarray(h))
    got = t_tf.logits_from_hidden(tp["backbone"], tcfg, _t(h))
    assert _rel(got, want) <= TOL
    want_loss = j_tf.lm_loss(jp["backbone"], jcfg, jnp.asarray(toks),
                             jnp.asarray(tgts))
    got_loss = t_tf.lm_loss(tp["backbone"], tcfg, _t(toks).long(),
                            _t(tgts).long())
    assert abs(float(got_loss) - float(want_loss)) <= TOL * float(want_loss)


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_param_trees_match_the_reference_layout(arch):
    """init_params draws the reference's tree (its own numbers): the same
    leaves at the same shapes and dtypes, and params_from_numpy refuses a
    tree stacked over another depth."""
    jcfg, tcfg = j_get_config(arch).reduced(), t_get_config(arch).reduced()
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jax.eval_shape(lambda: j_api.init_params(
                            jcfg, jax.random.PRNGKey(0))))
    got = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                       t_api.init_params(tcfg, 0, "cpu"))
    assert got == want
    tree = jax.tree.map(np.asarray,
                        j_api.init_params(jcfg, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="stacked over 2 layers"):
        t_api.params_from_numpy(tree, dataclasses.replace(tcfg, num_layers=3),
                                "cpu")


# ---------------------------------------------------------------------------
# diffusion LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_diffusion_lm_eps_network_matches_reference(arch):
    """The diffusion-LM eps-net (head + bidirectional backbone), out_proj
    perturbed (zero-init makes eps identically 0), scalar and per-sample t."""
    jcfg, tcfg, jp, tp = reference_params(arch)
    assert np.abs(np.asarray(jp["diffusion_head"]["out_proj"])).max() > 0
    x = np.random.default_rng(15).normal(
        size=(3, 64, jcfg.latent_dim)).astype(np.float32)
    for t in (np.float32(0.37), np.array([0.9, 0.5, 0.02], np.float32)):
        want = j_api.eps_network(jcfg)(jp, jnp.asarray(x), jnp.asarray(t), {})
        got = t_api.eps_network(tcfg)(tp, _t(x), _t(t), {})
        assert got.shape == (3, 64, jcfg.latent_dim)
        assert _rel(got, want) <= TOL


def test_diffusion_lm_apply_matches_reference_on_any_backbone():
    """diffusion_lm_apply itself, on a stand-in backbone (tanh)."""
    jcfg, tcfg, jp, tp = reference_params("qwen2-0.5b")
    x = np.random.default_rng(16).normal(size=(2, 5, 32)).astype(np.float32)
    want = j_dlm.diffusion_lm_apply(jp["diffusion_head"],
                                    lambda e: (jnp.tanh(e), 0.0), jcfg,
                                    jnp.asarray(x), 0.6)
    got = t_dlm.diffusion_lm_apply(tp["diffusion_head"],
                                   lambda e: (torch.tanh(e), 0.0), tcfg,
                                   _t(x), 0.6)
    assert _rel(got, want) <= TOL


def test_weights_kept_once_are_bit_equal_to_per_use_casts():
    """cast_weights_once at bf16 activations: every backbone leaf and the
    head's in/out projections cast once, t_mlp1/2 and the token latents
    left in fp32; the eps-net and a decode step bit-equal to the per-use
    casts."""
    _, tcfg, _, tp = reference_params("granite-moe-3b-a800m")
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    once = t_api.cast_weights_once(cfg, tp)
    assert all(v.dtype == torch.bfloat16
               for v in jax.tree.leaves(once["backbone"]))
    assert once["diffusion_head"]["in_proj"].dtype == torch.bfloat16
    assert once["diffusion_head"]["t_mlp1"] is tp["diffusion_head"]["t_mlp1"]
    assert once["token_latents"] is tp["token_latents"]
    x = torch.randn(2, 64, 32, generator=torch.Generator().manual_seed(0))
    net = t_api.eps_network(cfg)
    assert torch.equal(net(once, x, torch.tensor(0.4), {}),
                       net(tp, x, torch.tensor(0.4), {}))
    toks = torch.as_tensor(_tokens(cfg, 2, 6)).long()
    outs = []
    for p in (once, tp):
        lg, cache = t_api.prefill_fn(cfg)(p, {"tokens": toks}, 8)
        lg2, _ = t_api.decode_fn(cfg)(p, cache, toks[:, :1], 6)
        outs.append((lg, lg2))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_token_training_is_refused_as_not_yet_ported():
    """No token family is left to refuse: the audio family, the last with
    the vlm, builds both objectives from its own params and batch (its
    parity: tests/test_torch_encdec.py); a family the port does not know
    is refused, for both objectives and for init_params."""
    from repro_torch.data.synthetic import frontend_embeds

    audio = t_get_config("whisper-small").reduced()
    params = t_api.init_params(audio)
    toks = torch.as_tensor(_tokens(audio, 2, 8)).long()
    batch = {"tokens": toks, "targets": toks, **{
        k: torch.from_numpy(v) for k, v in frontend_embeds(audio, 2).items()}}
    for objective in ("ar", "diffusion"):
        loss = t_api.train_loss(audio, objective)(
            params, batch, torch.Generator().manual_seed(0))
        assert loss.ndim == 0 and torch.isfinite(loss)
    other = dataclasses.replace(audio, family="speech")
    for objective in ("ar", "diffusion"):
        with pytest.raises(ValueError, match="no such family"):
            t_api.train_loss(other, objective)
    with pytest.raises(ValueError, match="no such family"):
        t_api.init_params(other)
