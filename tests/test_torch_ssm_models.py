"""The port's SSM and hybrid token families (mamba2-780m: a Mamba2 stack;
zamba2-7b: Mamba2 groups with one shared attention block) against the JAX
reference, from the LMs through serving, diffusion-LM sampling and
training, on the same params and inputs.

Params are the reference's `init_params`, every float leaf perturbed by
0.05 N(0, 1) (the helper of `tests/test_torch_token_models.py`: the
diffusion head's zero-init out_proj would make the eps checks vacuous),
carried over by `api.params_from_numpy`. Configs are `reduced()`: mamba2 at
2 and 4 layers, zamba2 at 4 (two groups of 2) and 5 (two groups and a
one-layer tail), SSD chunk 32, so prompts of 40 take the scan's pad path.
fp32 on the CPU, where the attention op is its plain version; tolerances
1e-5 relative L-inf (logits, caches, eps, the forward), the loss 1e-6
relative and each gradient leaf 1e-5 relative L2 against
`jax.value_and_grad` (the SSM scalars A_log, dt_bias and D within 3e-5
where the reference's own fp32 gradient is further than 1e-5 from its
float64 run), five `train()` steps within 1e-5; greedy tokens
equal. The `gpu` tests (skipped without a card) hold flash_attention and
its backward at zamba2's head dim, 112 (3584 / 32), causal MHA, against
their plain versions, and the graphed decode step of both families
bit-equal to the eager one.
"""

import dataclasses
import zlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as j_syn
from repro.diffusion import VPLinear as JVP
from repro.engine import EngineSpec as JSpec
from repro.launch import serve as j_serve
from repro.launch import train as j_train
from repro.launch.sample import build_engine as j_build_engine
from repro.models import api as j_api
from repro.models import hybrid as j_hybrid
from repro_torch.checkpoint import ckpt as t_ckpt
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import synthetic as t_syn
from repro_torch.launch import sample as t_sample
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import api as t_api
from repro_torch.models import hybrid as t_hybrid
from test_torch_token_models import _rel, _t, _tokens, reference_params
from test_torch_token_serving import _Prompts
from test_torch_token_train import (_port_loss_and_grads,
                                    _reference_token_run, _token_batch)
from test_torch_train import _flat, _reference_draws, _rel_l2

torch.set_num_threads(2)

TOL = 1e-5
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
SCALAR_TOL = 3e-5
TRAIN_TOL = 1e-5
SSM_ARCHS = ["mamba2-780m", "zamba2-7b"]
# (arch, reduced() overrides): zamba2 reduces to two groups of 2 and no
# tail; 5 layers give two groups and a one-layer tail
DEPTHS = [("mamba2-780m", {}), ("mamba2-780m", dict(num_layers=4)),
          ("zamba2-7b", {}), ("zamba2-7b", dict(num_layers=5))]
DEPTH_IDS = ["mamba2-2L", "mamba2-4L", "zamba2-2x2", "zamba2-2x2+1"]


def _leaves(tree, prefix=""):
    """{path: tensor} of a nested dict of tensors (any dtype)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaves(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def _forward(module, cfg):
    return (module.mamba_forward if cfg.family == "ssm"
            else module.zamba_forward)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_configs_and_param_trees_match_the_reference(arch):
    """The full config and reduced() field for field (the sizes the chip
    runs: d_inner, heads); init_params draws the reference's tree at the
    same shapes and dtypes (its own numbers); params_from_numpy refuses a
    tree stacked over another depth."""
    from repro.configs.registry import get_config as j_get_config

    j, t = j_get_config(arch), t_get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.ssm_d_inner, t.ssm_heads) == (j.ssm_d_inner, j.ssm_heads)
    for over in ({}, dict(num_layers=5)):
        jcfg, tcfg = j.reduced(**over), t.reduced(**over)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            jax.eval_shape(lambda: j_api.init_params(
                                jcfg, jax.random.PRNGKey(0))))
        got = jax.tree.map(lambda a: (tuple(a.shape),
                                      str(a.dtype).split(".")[-1]),
                           t_api.init_params(tcfg, 0, "cpu"))
        assert got == want
        tree = jax.tree.map(np.asarray,
                            j_api.init_params(jcfg, jax.random.PRNGKey(0)))
        with pytest.raises(ValueError, match="stacked over"):
            t_api.params_from_numpy(
                tree, dataclasses.replace(tcfg, num_layers=tcfg.num_layers
                                          + 1), "cpu")


# ---------------------------------------------------------------------------
# the LMs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over", DEPTHS, ids=DEPTH_IDS)
def test_forward_matches_reference(arch, over):
    """The full-sequence forward from tokens and from input embeddings (the
    diffusion LM's eval, causal), S 40: a ragged last SSD chunk."""
    jcfg, tcfg, jp, tp = reference_params(arch, **over)
    toks = _tokens(jcfg, 2, 40)
    jh, jaux = _forward(j_hybrid, jcfg)(jp["backbone"], jcfg,
                                        jnp.asarray(toks))
    th, taux = _forward(t_hybrid, tcfg)(tp["backbone"], tcfg,
                                        _t(toks).long())
    assert _rel(th, jh) <= TOL
    assert float(taux) == float(jaux) == 0.0
    e = np.random.default_rng(12).normal(size=(2, 9, 128)).astype(np.float32)
    jh, _ = _forward(j_hybrid, jcfg)(jp["backbone"], jcfg, None,
                                     inputs_embeds=jnp.asarray(e))
    th, _ = _forward(t_hybrid, tcfg)(tp["backbone"], tcfg, None,
                                     inputs_embeds=_t(e))
    assert _rel(th, jh) <= TOL


def _decode_both(arch, S, max_len, steps, **over):
    """Prefill S tokens, then decode `steps` more in both frameworks; yields
    (label, port, reference) pairs of logits and every cache leaf."""
    jcfg, tcfg, jp, tp = reference_params(arch, **over)
    toks = _tokens(jcfg, 2, S + steps)
    jl, jc = j_api.prefill_fn(jcfg)(jp, {"tokens": jnp.asarray(toks[:, :S])},
                                    max_len)
    tl, tc = t_api.prefill_fn(tcfg)(tp, {"tokens": _t(toks[:, :S]).long()},
                                    max_len)
    yield "prefill logits", tl, jl
    for k, v in _flat(tc).items():
        yield f"prefill cache {k}", v, _flat(jc)[k]
    for i in range(steps):
        tok = toks[:, S + i:S + i + 1]
        jl, jc = j_api.decode_fn(jcfg)(jp, jc, jnp.asarray(tok),
                                       jnp.int32(S + i))
        same = tc
        tl, tc = t_api.decode_fn(tcfg)(tp, tc, _t(tok).long(), S + i)
        assert tc is same                       # written in place
        yield f"decode {i} logits", tl, jl
        for k, v in _flat(tc).items():
            yield f"decode {i} cache {k}", v, _flat(jc)[k]


@pytest.mark.parametrize("arch,over", DEPTHS, ids=DEPTH_IDS)
@pytest.mark.parametrize("S", [40, 2])
def test_prefill_and_decode_match_reference(arch, over, S):
    """Logits and every cache leaf (SSM states, conv windows, the shared
    block's KV caches) after prefill and each decode step; S 2 is a prompt
    shorter than the conv window."""
    n = 0
    for label, got, want in _decode_both(arch, S=S, max_len=S + 4, steps=3,
                                         **over):
        assert got.shape == want.shape, label
        assert _rel(got, want) <= TOL, label
        n += 1
    assert n >= 4 * (1 + 2)             # logits and >= 2 cache leaves


@pytest.mark.parametrize("arch,over", DEPTHS[1:], ids=DEPTH_IDS[1:])
def test_decode_matches_forward(arch, over):
    """prefill(t[:S]) then decode(t[S]) equals the full forward's logits at
    S (the reference's test_decode_matches_forward)."""
    _, tcfg, _, tp = reference_params(arch, **over)
    S = 37
    toks = _t(_tokens(tcfg, 2, S + 1)).long()
    hidden, _ = _forward(t_hybrid, tcfg)(tp["backbone"], tcfg, toks)
    want = t_hybrid.logits_from_hidden(tp["backbone"], tcfg, hidden)[:, S]
    _, cache = t_api.prefill_fn(tcfg)(tp, {"tokens": toks[:, :S]}, S + 4)
    got, _ = t_api.decode_fn(tcfg)(tp, cache, toks[:, S:S + 1], S)
    assert _rel(got[:, 0], want) <= TOL


@pytest.mark.parametrize("arch,over", [("mamba2-780m", {}),
                                       ("zamba2-7b", dict(num_layers=5))],
                         ids=["mamba2", "zamba2-tail"])
def test_init_cache_matches_reference(arch, over):
    jcfg, tcfg, _, _ = reference_params(arch, **over)
    want = jax.tree.map(np.asarray, j_api.init_cache(jcfg, 3, 20))
    got = _flat(t_api.init_cache(tcfg, 3, 20))
    assert got.keys() == _flat(want).keys()
    for k, v in _flat(want).items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        assert not got[k].any(), k


# ---------------------------------------------------------------------------
# the diffusion LM, the losses, the weights kept once
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over", DEPTHS[1:], ids=DEPTH_IDS[1:])
def test_eps_network_matches_reference(arch, over):
    """The diffusion-LM eps-net over the causal backbone, out_proj
    perturbed, scalar and per-sample t; 64 latent tokens, two SSD chunks."""
    jcfg, tcfg, jp, tp = reference_params(arch, **over)
    assert np.abs(np.asarray(jp["diffusion_head"]["out_proj"])).max() > 0
    x = np.random.default_rng(15).normal(
        size=(3, 64, jcfg.latent_dim)).astype(np.float32)
    for t in (np.float32(0.37), np.array([0.9, 0.5, 0.02], np.float32)):
        want = j_api.eps_network(jcfg)(jp, jnp.asarray(x), jnp.asarray(t), {})
        got = t_api.eps_network(tcfg)(tp, _t(x), _t(t), {})
        assert got.shape == (3, 64, jcfg.latent_dim)
        assert _rel(got, want) <= TOL


def _reference_float64_grads(jcfg, objective, jp, batch, key) -> dict:
    """The reference's own gradients with x64 enabled: params and
    activations in float64 (its explicit fp32 casts stay), the diffusion
    loss's t drawn as the fp32 run draws it and then widened."""
    uniform = jax.random.uniform

    def fp32_uniform(k, shape=(), dtype=None, minval=0.0, maxval=1.0):
        return uniform(k, shape, jnp.float32, minval, maxval).astype(
            jnp.float64)

    with jax.enable_x64(True), \
            mock.patch.object(jax.random, "uniform", fp32_uniform):
        c64 = dataclasses.replace(jcfg, dtype="float64",
                                  param_dtype="float64")
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           jp)
        grads = jax.grad(j_api.train_loss(c64, objective))(
            p64, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        return _flat(jax.tree.map(np.asarray, grads))


def _assert_grads_near(got, want, reference64, unread):
    """Each gradient leaf within GRAD_TOL relative L2 of the reference's.
    Past it only an SSM scalar leaf (A_log, dt_bias, D: one gradient
    summed over every position and head), within SCALAR_TOL, and only
    where the reference's fp32 gradient is itself more than GRAD_TOL from
    its float64 run (`reference64`, called once if needed) and the port's
    is within 1.5 times that distance of the same run. (zamba2 at 5 layers,
    diffusion loss: the port 1.2e-5 to 1.8e-5 from the reference, which is
    1.9e-5 to 6.6e-5 from its float64 run, the port 2.4e-5 to 8.2e-5.)"""
    assert got.keys() == want.keys() and len(want) >= 12
    truth = None
    for k in want:
        if any(k.startswith(u) for u in unread):    # zero on both sides
            assert got[k].size == 0 and not np.abs(want[k]).any(), k
            continue
        assert np.abs(want[k]).max() > 0, k         # perturbed: none vacuous
        err = _rel_l2(got[k], want[k])
        if err <= GRAD_TOL:
            continue
        assert k.endswith(("/A_log", "/dt_bias", "/D")), (k, err)
        assert err <= SCALAR_TOL, (k, err)
        truth = truth or reference64()
        ref_err = _rel_l2(want[k], truth[k])
        assert ref_err > GRAD_TOL, (k, err, ref_err)
        assert _rel_l2(got[k], truth[k]) <= 1.5 * ref_err, (k, err, ref_err)


@pytest.mark.parametrize("arch,over", DEPTHS[1:], ids=DEPTH_IDS[1:])
def test_ar_loss_and_grads_match_reference(arch, over):
    jcfg, tcfg, jp, tp = reference_params(arch, seed=6, **over)
    batch = _token_batch(tcfg)
    want_loss, want_grads = jax.value_and_grad(j_api.ar_loss(jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    loss, got = _port_loss_and_grads(t_api.train_loss(tcfg, "ar"), tp,
                                     batch, None)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * float(want_loss)
    _assert_grads_near(got, _flat(jax.tree.map(np.asarray, want_grads)),
                       lambda: _reference_float64_grads(jcfg, "ar", jp, batch,
                                                        None),
                       ("/diffusion_head", "/token_latents"))


@pytest.mark.parametrize("arch,over", DEPTHS[1:], ids=DEPTH_IDS[1:])
def test_diffusion_lm_loss_and_grads_match_reference(arch, over):
    """The eps MSE + the rounding loss with the reference's draws replayed
    from its key; the backbone runs from its input embeddings, so `embed`
    is not read."""
    jcfg, tcfg, jp, tp = reference_params(arch, seed=7, **over)
    batch = _token_batch(tcfg, seed=4)
    key = jax.random.PRNGKey(12)
    want_loss, want_grads = jax.value_and_grad(j_api.train_loss(
        jcfg, "diffusion"))(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                            key)
    draws = _reference_draws(key, (2, 16, tcfg.latent_dim))
    loss, got = _port_loss_and_grads(t_api.train_loss(tcfg, "diffusion"), tp,
                                     batch, draws)
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * float(want_loss)
    _assert_grads_near(got, _flat(jax.tree.map(np.asarray, want_grads)),
                       lambda: _reference_float64_grads(jcfg, "diffusion",
                                                        jp, batch, key),
                       ("/backbone/embed",))


@pytest.mark.parametrize("arch,over", [("mamba2-780m", {}),
                                       ("zamba2-7b", dict(num_layers=5))],
                         ids=["mamba2", "zamba2-tail"])
def test_remat_is_bit_equal(arch, over):
    """cfg.remat (each layer, and for zamba2 each group around its layers,
    under activation checkpointing) gives the same loss and gradients bit
    for bit, for both objectives."""
    _, tcfg, _, tp = reference_params(arch, seed=8, **over)
    batch = _token_batch(tcfg, seed=5)
    draws = (np.full(2, 0.4, np.float32),
             np.random.default_rng(9).normal(
                 size=(2, 16, tcfg.latent_dim)).astype(np.float32))
    for objective, rng in (("ar", None), ("diffusion", draws)):
        runs = [_port_loss_and_grads(t_api.train_loss(
            dataclasses.replace(tcfg, remat=remat), objective), tp, batch,
            rng) for remat in (False, True)]
        assert torch.equal(runs[0][0], runs[1][0])
        assert runs[0][1].keys() == runs[1][1].keys()
        for k in runs[0][1]:
            np.testing.assert_array_equal(runs[0][1][k], runs[1][1][k])


@pytest.mark.parametrize("arch,over", [("mamba2-780m", {}),
                                       ("zamba2-7b", dict(num_layers=5))],
                         ids=["mamba2", "zamba2-tail"])
def test_weights_kept_once_are_bit_equal_to_per_use_casts(arch, over):
    """cast_weights_once at bf16 activations: A_log and dt_bias (read in
    fp32) and the diffusion head's t_mlp1/2 and the token latents are
    shared, not cast; every other backbone leaf is bf16; the eps-net,
    prefill and a decode step are bit-equal to the per-use casts."""
    _, tcfg, _, tp = reference_params(arch, **over)
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    once = t_api.cast_weights_once(cfg, tp)
    for path, leaf in _leaves(once).items():
        fp32 = (path.endswith(("/A_log", "/dt_bias", "/t_mlp1", "/t_mlp2"))
                or path == "/token_latents")
        assert (leaf.dtype == torch.float32) == fp32, path
    stack = "layers" if cfg.family == "ssm" else "groups"
    for name in ("A_log", "dt_bias"):
        assert (once["backbone"][stack]["mamba"][name]
                is tp["backbone"][stack]["mamba"][name])
    x = torch.randn(2, 64, 32, generator=torch.Generator().manual_seed(0))
    net = t_api.eps_network(cfg)
    assert torch.equal(net(once, x, torch.tensor(0.4), {}),
                       net(tp, x, torch.tensor(0.4), {}))
    toks = torch.as_tensor(_tokens(cfg, 2, 6)).long()
    outs = []
    for p in (once, tp):
        lg, cache = t_api.prefill_fn(cfg)(p, {"tokens": toks}, 8)
        lg2, cache = t_api.decode_fn(cfg)(p, cache, toks[:, :1], 6)
        outs.append([lg, lg2] + list(_leaves(cache).values()))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# ---------------------------------------------------------------------------
# serving and sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over", [("mamba2-780m", {}),
                                       ("zamba2-7b", dict(num_layers=5))],
                         ids=["mamba2", "zamba2-tail"])
def test_serve_greedy_tokens_equal_reference(arch, over, monkeypatch):
    jcfg, tcfg, jp, tp = reference_params(arch, **over)
    prompts = _tokens(jcfg, 3, 9, seed=20)
    # the configs at this depth, handed to both as their full configs
    monkeypatch.setattr(j_serve, "get_config", lambda a: jcfg)
    monkeypatch.setattr(t_serve, "get_config", lambda a: tcfg)
    monkeypatch.setattr(j_serve.api, "init_params", lambda cfg, rng: jp)
    monkeypatch.setattr(j_serve, "TokenStream", _Prompts(prompts))
    want = j_serve.serve(arch, reduced=False, batch=3, prompt_len=9, gen=6)
    got = t_serve.serve(arch, reduced=False, batch=3, prompt_len=9, gen=6,
                        device="cpu", params=tp, prompts=prompts)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)


def test_serve_decode_loop_is_the_decode_step_loop():
    """serve's decoder (static token / pos buffers, the states in place)
    gives what a plain loop of decode_fn gives."""
    _, tcfg, _, tp = reference_params("zamba2-7b")
    prompts = _tokens(tcfg, 2, 7, seed=21)
    run = t_serve.serve("zamba2-7b", batch=2, prompt_len=7, gen=5,
                        device="cpu", params=tp, prompts=prompts,
                        return_run=True)
    logits, cache = t_api.prefill_fn(tcfg)(
        tp, {"tokens": _t(prompts).long()}, 12)
    assert torch.equal(logits, run.prefill_logits)
    toks = []
    tok = torch.argmax(logits[:, -1], -1)
    for i in range(5):
        toks.append(tok)
        logits, cache = t_api.decode_fn(tcfg)(tp, cache, tok[:, None], 7 + i)
        tok = torch.argmax(logits[:, -1], -1)
    np.testing.assert_array_equal(run.tokens, torch.stack(toks, 1).numpy())


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_sample_matches_reference_engine(arch):
    """UniPC-3 on the diffusion-LM eps-net: the port's `sample` with an
    explicit x_T against the reference's engine on the same params, and
    against the port's own python loop."""
    jcfg, tcfg, jp, tp = reference_params(arch)
    x_T = np.random.default_rng(22).normal(
        size=(2, 64, jcfg.latent_dim)).astype(np.float32)
    engine = j_build_engine(jcfg, jp, JVP(), 2)
    want = np.asarray(engine.build(JSpec(solver="unipc", nfe=6, order=3))(
        jnp.asarray(x_T)))
    got = t_sample.sample(arch, nfe=6, batch=2, params=tp, x_T=x_T,
                          device="cpu")
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert _rel(got, want) <= TOL
    loop = t_sample.sample(arch, nfe=6, batch=2, params=tp, x_T=x_T,
                           loop=True, device="cpu")
    assert _rel(loop, got) <= TOL


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,objective", [("mamba2-780m", "ar"),
                                            ("zamba2-7b", "diffusion")])
def test_train_five_steps_match_reference(monkeypatch, arch, objective):
    """Five `launch.train.train` steps from the reference's init (out_proj
    perturbed) on the reference's draws: the losses within 1e-5 relative,
    each param leaf within 1e-5 relative L2 of `repro.launch.train`'s."""
    for mod in (j_syn, t_syn):      # TokenStream's block seed: pinned
        monkeypatch.setattr(mod, "hash", lambda key: zlib.crc32(
            repr(key).encode()), raising=False)
    want_params, want_hist, init, draws = _reference_token_run(
        monkeypatch, arch, objective, 5, 4, 16, 0)
    monkeypatch.setattr(
        t_api, "init_params",
        lambda cfg, seed=0, device="cpu": t_api.params_from_numpy(
            init, cfg, device))
    monkeypatch.setattr(t_train, "step_rng", lambda gen, i: draws[i])
    params, hist = t_train.train(arch, reduced=True, objective=objective,
                                 steps=5, batch=4, seq=16, log_every=1,
                                 device="cpu")
    assert [h["step"] for h in hist] == [h["step"] for h in want_hist]
    for a, b in zip(hist, want_hist):
        assert abs(a["loss"] - b["loss"]) <= TRAIN_TOL * abs(b["loss"])
    w, g = _flat(jax.tree.map(np.asarray, want_params)), _flat(params)
    assert w.keys() == g.keys()
    for k in w:
        assert _rel_l2(g[k], w[k]) <= TRAIN_TOL, (k, _rel_l2(g[k], w[k]))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_clis_serve_sample_and_train_on_the_cpu(arch, tmp_path, capsys):
    """The three CLIs on `--device cpu`: serve decodes, train writes a
    diffusion-LM checkpoint, and `sample --ckpt` samples it bit-equal to
    the in-memory params."""
    out = t_serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "12",
                        "--gen", "4", "--device", "cpu"])
    assert out.shape == (2, 4) and out.dtype == np.int32
    assert f"token [cpu] {arch}: prefill" in capsys.readouterr().out
    params, hist = t_train.train(arch, reduced=True, objective="diffusion",
                                 steps=3, batch=2, seq=16, log_every=10,
                                 device="cpu", ckpt_dir=str(tmp_path))
    assert all(np.isfinite(h["loss"]) for h in hist)
    tree, step = t_ckpt.restore(str(tmp_path))
    assert step == 3 and set(tree["params"]) == {
        "backbone", "diffusion_head", "token_latents"}
    got = t_sample.main(["--arch", arch, "--ckpt", str(tmp_path), "--nfe",
                         "4", "--batch", "2", "--device", "cpu"])
    want = t_sample.sample(arch, reduced=True, params=params, nfe=4, batch=2,
                           device="cpu")
    assert got.shape == (2, 64, 32) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    t_train.main(["--arch", arch, "--objective", "ar", "--steps", "2",
                  "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert "step     1 loss" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# zamba2's shared block: 32 heads of 112, causal MHA; S 512 (its prefill
# and training length), 64 (its diffusion LM) and a ragged 200
D112 = [(2, 32, 512), (2, 32, 64), (1, 4, 200)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,S", D112)
def test_card_attention_at_head_dim_112_matches_plain(cuda, B, H, S, dtype):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref

    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v, do = (torch.randn(B, S, H, 112, generator=g, device=cuda)
                   .to(dtype).transpose(1, 2) for _ in range(4))
    out, lse, o32 = fa_kernel.flash_attention(q, k, v, causal=True,
                                              lse=True)
    want = fa_ref.attention(q, k, v, causal=True)
    err = (_rel(out.cpu().double(), want.cpu().double())
           if dtype == torch.float32 else _l2(out, want))
    assert err <= (1e-5 if dtype == torch.float32 else 1e-2), err
    again = fa_kernel.flash_attention(q, k, v, causal=True, lse=True)
    assert all(torch.equal(a, b) for a, b in zip((out, lse, o32), again))
    if dtype == torch.bfloat16:
        assert fa_kernel.plan(q, k, v, out)["chunks"] == 16
    assert torch.equal(o32.to(dtype), out)
    grads = fa_kernel.flash_attention_bwd(q, k, v, o32, lse, do, causal=True)
    plain = fa_ref.attention_bwd(q, k, v, o32, lse, do, causal=True)
    for a, b, src in zip(grads, plain, (q, k, v)):
        assert a.stride() == src.stride() and a.dtype == dtype
        err = (_rel(a.cpu().double(), b.cpu().double())
               if dtype == torch.float32 else _l2(a, b))
        assert err <= (1e-5 if dtype == torch.float32 else 1e-2), err
    again = fa_kernel.flash_attention_bwd(q, k, v, o32, lse, do, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_card_graph_decode_is_bit_equal_to_eager(cuda, arch, monkeypatch):
    """The decode step as a CUDA graph replay against the eager step, bf16
    activations over the weights kept once (the graph's warm-up must not
    advance the SSM states); the replayed loop makes no host sync."""
    cfg = t_serve.get_config(arch).reduced(dtype="bfloat16", num_layers=5)
    monkeypatch.setattr(t_serve, "get_config", lambda a: cfg)
    params = t_api.init_params(cfg, 0, cuda)
    prompts = _tokens(cfg, 4, 33, seed=23)
    kw = dict(reduced=False, batch=4, prompt_len=33, gen=12, device=cuda,
              params=params, prompts=prompts)
    eager = t_serve.serve(arch, jit=False, **kw)
    run = t_serve.serve(arch, return_run=True, **kw)
    assert run.decoder.graph is not None
    np.testing.assert_array_equal(run.tokens, eager)
    torch.cuda.set_sync_debug_mode("error")
    try:
        run.decoder.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
