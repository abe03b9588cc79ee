"""The port's vlm family (llama-3.2-vision-90b: groups of self-attention
layers, each closed by a gated cross-attention layer over projected image
embeddings) against the JAX reference, from the LM through serving,
diffusion-LM sampling and training, on the same params and inputs. The
helpers here serve `tests/test_torch_encdec.py` too.

Params are the reference's `init_params`, every float leaf perturbed by
0.05 N(0, 1) (the helper of `tests/test_torch_token_models.py`), and the
vlm's cross-attention gates set to U(0.3, 0.9): they start at zero, so a
fresh model's cross-attention adds exactly nothing and every image-path
check would be vacuous. Configs are `reduced()`: 4 layers in two groups of
one self-attention and one cross-attention layer, 16 image tokens (and 6
layers, three groups). Image embeddings and tokens are seeded numpy draws.
fp32 on the CPU, where the attention op is its plain version; tolerances
1e-5 relative L-inf (logits, caches, eps, the forward), the loss 1e-6
relative and each gradient leaf 1e-5 relative L2 against
`jax.value_and_grad` (a diffusion-loss leaf up to 2e-5 only where the
reference's own fp32 gradient is farther than that from its float64 run,
`assert_grads_match`), five `train()` steps within 1e-5; greedy tokens
equal. The `gpu` tests (skipped without a card) hold flash_attention and
its backward at the vlm's cross-attention shapes (Sq != Skv, non-causal,
GQA 64/8 at D 128) against their plain versions.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.data import synthetic as j_syn
from repro.diffusion import VPLinear as JVP
from repro.engine import EngineSpec as JSpec
from repro.engine import SamplerEngine as JEngine
from repro.launch import serve as j_serve
from repro.models import api as j_api
from repro.models import vlm as j_vlm
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import synthetic as t_syn
from repro_torch.diffusion import VPLinear as TVP
from repro_torch.engine import EngineSpec as TSpec
from repro_torch.engine import SamplerEngine as TEngine
from repro_torch.launch import sample as t_sample
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import api as t_api
from repro_torch.models import vlm as t_vlm
from repro_torch.optim import tree_leaves, tree_map
from test_torch_token_models import _rel, _t, _tokens
from test_torch_token_serving import _Prompts
from test_torch_ssm_models import _reference_float64_grads
from test_torch_token_train import _reference_token_run
from test_torch_train import _flat, _reference_draws, _rel_l2

torch.set_num_threads(2)

TOL = 1e-5
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
NOISE_TOL = 2e-5
TRAIN_TOL = 1e-5
ARCH = "llama-3.2-vision-90b"
COND = {"vlm": "image_embeds", "audio": "audio_embeds"}


def family_params(arch, seed=0, scale=0.05, **overrides):
    """(jax cfg, port cfg, jax params, port params): the reference's
    init_params with every float leaf perturbed by scale * N(0, 1), and a
    vlm's 0-d cross-attention gates drawn from U(0.3, 0.9)."""
    jcfg = j_get_config(arch).reduced(**overrides)
    tcfg = t_get_config(arch).reduced(**overrides)
    tree = jax.tree.map(np.asarray, j_api.init_params(
        jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(
        lambda a: (a + scale * rng.normal(size=a.shape)).astype(a.dtype), tree)
    if jcfg.family == "vlm":
        for gate in ("gate_attn", "gate_mlp"):
            old = tree["backbone"]["xattn_layers"][gate]
            tree["backbone"]["xattn_layers"][gate] = rng.uniform(
                0.3, 0.9, size=old.shape).astype(old.dtype)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            t_api.params_from_numpy(tree, tcfg, "cpu"))


def cond_inputs(cfg, B, seed=4):
    """{key: (B, n, d_model) fp32}: a vlm's image embeddings or an audio
    model's frames, N(0, 1) from numpy."""
    n = cfg.image_tokens if cfg.family == "vlm" else cfg.audio_frames
    return {COND[cfg.family]: np.random.default_rng(seed).normal(
        size=(B, n, cfg.d_model)).astype(np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    """numpy batch -> torch: integer arrays as int64, floats as fp32."""
    return {k: (_t(v).long() if np.issubdtype(np.asarray(v).dtype,
                                              np.integer) else _t(v))
            for k, v in batch.items()}


def loss_and_grads(loss_fn, params, batch, rng):
    """The port's loss and {path: gradient} (an empty tensor where the loss
    reads no leaf)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(leaves, _tb(batch), rng)
    flat = tree_leaves(leaves)
    grads = dict(zip(map(id, flat), torch.autograd.grad(
        loss, flat, allow_unused=True)))
    none = torch.zeros(0)
    return loss, _flat(tree_map(lambda p: (none if grads[id(p)] is None
                                           else grads[id(p)]), leaves))


def assert_grads_match(got, want, unread, reference64=None):
    """Each gradient leaf within GRAD_TOL relative L2 of the reference's.
    With `reference64` (the reference's float64 gradients, called once if
    needed) a leaf may pass GRAD_TOL, up to NOISE_TOL, only where the
    reference's own fp32 gradient is farther than GRAD_TOL from its
    float64 run and the port no farther from the reference than that.
    (whisper, diffusion loss, reduced: the token latents' gradient, about
    1e-10 an element, 1.03e-5 from the reference, which is 1.91e-5 from
    its float64 run; measured on the CPU.)"""
    assert got.keys() == want.keys() and len(want) >= 12
    truth = None
    for k in want:
        if any(k.startswith(u) for u in unread):     # zero on both sides
            assert got[k].size == 0 and not np.abs(want[k]).any(), k
            continue
        assert np.abs(want[k]).max() > 0, k          # perturbed: none vacuous
        err = _rel_l2(got[k], want[k])
        if err <= GRAD_TOL:
            continue
        assert reference64 is not None and err <= NOISE_TOL, (k, err)
        truth = truth or reference64()
        ref_err = _rel_l2(want[k], truth[k])
        assert GRAD_TOL < ref_err and err <= ref_err, (k, err, ref_err)


def _leaves(tree, prefix=""):
    """{path: tensor} of a nested dict of tensors (any dtype)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaves(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def token_batch(cfg, B=2, S=16, seed=3):
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "targets")}
    return dict(batch, **cond_inputs(cfg, B, seed + 10))


# ---------------------------------------------------------------------------
# shared checks (the audio family's file calls them too)
# ---------------------------------------------------------------------------

def check_configs_and_trees(arch, overs):
    """The full config and reduced() field for field; init_params draws the
    reference's tree at the same shapes and dtypes (its own numbers);
    params_from_numpy refuses a tree stacked over another depth."""
    j, t = j_get_config(arch), t_get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for over in overs:
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
        deeper = dataclasses.replace(
            tcfg, num_layers=tcfg.num_layers + (tcfg.cross_attn_every or 1))
        with pytest.raises(ValueError, match="stacked"):
            t_api.params_from_numpy(tree, deeper, "cpu")


def check_prefill_and_decode(arch, S, steps=3, **over):
    """Logits and every cache leaf after prefill and each decode step, the
    cache written in place; returns the number of pairs held."""
    jcfg, tcfg, jp, tp = family_params(arch, **over)
    toks = _tokens(jcfg, 2, S + steps)
    cond = cond_inputs(jcfg, 2)
    max_len = S + steps + 1
    jl, jc = j_api.prefill_fn(jcfg)(jp, _jb(dict(tokens=toks[:, :S], **cond)),
                                    max_len)
    tl, tc = t_api.prefill_fn(tcfg)(tp, _tb(dict(tokens=toks[:, :S], **cond)),
                                    max_len)
    # copies: the decode steps write the port's cache in place
    pairs = [("prefill logits", tl, jl)] + [
        (f"prefill cache {k}", v.copy(), _flat(jc)[k])
        for k, v in _flat(tc).items()]
    for i in range(steps):
        tok = toks[:, S + i:S + i + 1]
        jl, jc = j_api.decode_fn(jcfg)(jp, jc, jnp.asarray(tok),
                                       jnp.int32(S + i))
        same = tc
        tl, tc = t_api.decode_fn(tcfg)(tp, tc, _t(tok).long(), S + i)
        assert tc is same                           # written in place
        pairs.append((f"decode {i} logits", tl, jl))
        pairs += [(f"decode {i} cache {k}", v.copy(), _flat(jc)[k])
                  for k, v in _flat(tc).items()]
    assert _flat(tc).keys() == _flat(jc).keys()
    for label, got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape), label
        assert _rel(got, want) <= TOL, (label, _rel(got, want))
    return len(pairs)


def check_decode_matches_forward(arch, forward, **over):
    """prefill(t[:S]) then decode(t[S]) equals the full forward's logits at
    S (the reference's test_decode_matches_forward)."""
    from repro_torch.models import transformer as t_tf

    _, tcfg, _, tp = family_params(arch, **over)
    S = 21
    toks = _t(_tokens(tcfg, 2, S + 1)).long()
    cond = _tb(cond_inputs(tcfg, 2))
    hidden, _ = forward(tp["backbone"], tcfg, toks, *cond.values())
    want = t_tf.logits_from_hidden(tp["backbone"], tcfg, hidden)[:, S]
    _, cache = t_api.prefill_fn(tcfg)(tp, dict(tokens=toks[:, :S], **cond),
                                      S + 4)
    got, _ = t_api.decode_fn(tcfg)(tp, cache, toks[:, S:S + 1], S)
    assert _rel(got[:, 0], want) <= TOL


def check_eps_network(arch, **over):
    """The diffusion-LM eps-net over the bidirectional backbone conditioned
    on the batch's embeddings, out_proj perturbed, scalar and per-sample
    t; and the embeddings really condition it."""
    jcfg, tcfg, jp, tp = family_params(arch, **over)
    assert np.abs(np.asarray(jp["diffusion_head"]["out_proj"])).max() > 0
    x = np.random.default_rng(15).normal(
        size=(3, 64, jcfg.latent_dim)).astype(np.float32)
    cond = cond_inputs(jcfg, 3)
    for t in (np.float32(0.37), np.array([0.9, 0.5, 0.02], np.float32)):
        want = j_api.eps_network(jcfg)(jp, jnp.asarray(x), jnp.asarray(t),
                                       _jb(cond))
        got = t_api.eps_network(tcfg)(tp, _t(x), _t(t), _tb(cond))
        assert got.shape == (3, 64, jcfg.latent_dim)
        assert _rel(got, want) <= TOL
    other = t_api.eps_network(tcfg)(tp, _t(x), _t(t),
                                    _tb(cond_inputs(jcfg, 3, seed=9)))
    assert _rel(other, got) > 1e-3


def check_ar_loss_and_grads(arch, **over):
    jcfg, tcfg, jp, tp = family_params(arch, seed=6, **over)
    batch = token_batch(tcfg)
    want_loss, want_grads = jax.value_and_grad(j_api.ar_loss(jcfg))(
        jp, _jb(batch), None)
    loss, got = loss_and_grads(t_api.train_loss(tcfg, "ar"), tp, batch, None)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * float(want_loss)
    assert_grads_match(got, _flat(jax.tree.map(np.asarray, want_grads)),
                       ("/diffusion_head", "/token_latents"))


def check_diffusion_loss_and_grads(arch, **over):
    """The eps MSE + the rounding loss with the reference's draws replayed
    from its key; the backbone runs from its input embeddings, so `embed`
    is not read."""
    jcfg, tcfg, jp, tp = family_params(arch, seed=7, **over)
    batch = token_batch(tcfg, seed=4)
    key = jax.random.PRNGKey(12)
    want_loss, want_grads = jax.value_and_grad(j_api.train_loss(
        jcfg, "diffusion"))(jp, _jb(batch), key)
    draws = _reference_draws(key, (2, 16, tcfg.latent_dim))
    loss, got = loss_and_grads(t_api.train_loss(tcfg, "diffusion"), tp,
                               batch, draws)
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * float(want_loss)
    assert_grads_match(got, _flat(jax.tree.map(np.asarray, want_grads)),
                       ("/backbone/embed",),
                       lambda: _reference_float64_grads(jcfg, "diffusion",
                                                        jp, batch, key))


def check_remat(arch, **over):
    """cfg.remat gives the same loss and gradients bit for bit, for both
    objectives."""
    _, tcfg, _, tp = family_params(arch, seed=8, **over)
    batch = token_batch(tcfg, seed=5)
    draws = (np.full(2, 0.4, np.float32),
             np.random.default_rng(9).normal(
                 size=(2, 16, tcfg.latent_dim)).astype(np.float32))
    for objective, rng in (("ar", None), ("diffusion", draws)):
        runs = [loss_and_grads(t_api.train_loss(
            dataclasses.replace(tcfg, remat=remat), objective), tp, batch,
            rng) for remat in (False, True)]
        assert torch.equal(runs[0][0], runs[1][0])
        assert runs[0][1].keys() == runs[1][1].keys()
        for k in runs[0][1]:
            np.testing.assert_array_equal(runs[0][1][k], runs[1][1][k])


def check_weights_kept_once(arch, fp32_leaves):
    """cast_weights_once at bf16 activations: the leaves read in fp32
    (`fp32_leaves`, path suffixes) shared, every other backbone leaf bf16;
    the eps-net, prefill and a decode step bit-equal to the per-use
    casts."""
    _, tcfg, _, tp = family_params(arch)
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    once = t_api.cast_weights_once(cfg, tp)
    kept = _leaves(tp)
    for path, leaf in _leaves(once).items():
        fp32 = path.endswith(fp32_leaves) or path == "/token_latents"
        assert (leaf.dtype == torch.float32) == fp32, path
        assert (leaf is kept[path]) == fp32, path
    x = torch.randn(2, 64, 32, generator=torch.Generator().manual_seed(0))
    cond = _tb(cond_inputs(cfg, 2))
    net = t_api.eps_network(cfg)
    assert torch.equal(net(once, x, torch.tensor(0.4), cond),
                       net(tp, x, torch.tensor(0.4), cond))
    toks = torch.as_tensor(_tokens(cfg, 2, 6)).long()
    outs = []
    for p in (once, tp):
        lg, cache = t_api.prefill_fn(cfg)(p, dict(tokens=toks, **cond), 8)
        lg2, cache = t_api.decode_fn(cfg)(p, cache, toks[:, :1], 6)
        outs.append([lg, lg2] + list(_leaves(cache).values()))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def check_serve_greedy(arch, monkeypatch, **over):
    """serve() against the reference's on the same params, prompts and stub
    frontend (both draw `stub_embeds(batch, ..., seed)` themselves): the
    greedy tokens equal; the run records prefill's inputs."""
    jcfg, tcfg, jp, tp = family_params(arch, **over)
    prompts = _tokens(jcfg, 3, 9, seed=20)
    monkeypatch.setattr(j_serve, "get_config", lambda a: jcfg)
    monkeypatch.setattr(t_serve, "get_config", lambda a: tcfg)
    monkeypatch.setattr(j_serve.api, "init_params", lambda cfg, rng: jp)
    monkeypatch.setattr(j_serve, "TokenStream", _Prompts(prompts))
    want = j_serve.serve(arch, reduced=False, batch=3, prompt_len=9, gen=6)
    run = t_serve.serve(arch, reduced=False, batch=3, prompt_len=9, gen=6,
                        device="cpu", params=tp, prompts=prompts,
                        return_run=True)
    assert run.tokens.dtype == np.int32 and run.tokens.shape == (3, 6)
    np.testing.assert_array_equal(run.tokens, want)
    key = COND[tcfg.family]
    stub = j_syn.stub_embeds(3, run.inputs[key].shape[1], tcfg.d_model, 0)
    np.testing.assert_array_equal(run.inputs[key].numpy(), stub)


def check_engine_sampling(arch, **over):
    """UniPC-3 through the engine, the eps closure carrying the embeddings
    in its batch (launch.sample feeds none): the port's engine against the
    reference's on the same params and x_T."""
    jcfg, tcfg, jp, tp = family_params(arch, **over)
    cond = cond_inputs(jcfg, 2)
    x_T = np.random.default_rng(22).normal(
        size=(2, 64, jcfg.latent_dim)).astype(np.float32)
    jnet, tnet = j_api.eps_network(jcfg), t_api.eps_network(tcfg)
    jc, tc = _jb(cond), _tb(cond)
    want = np.asarray(JEngine(JVP(), eps=lambda x, t: jnet(
        jp, x, jnp.asarray(t, jnp.float32), jc)).build(
            JSpec(solver="unipc", nfe=6, order=3))(jnp.asarray(x_T)))
    got = TEngine(TVP(), eps=lambda x, t: tnet(tp, x, t, tc),
                  device="cpu").build(TSpec(solver="unipc", nfe=6, order=3))(
                      _t(x_T))
    assert tuple(got.shape) == want.shape and np.abs(want).max() > 0
    assert _rel(got, want) <= TOL


def check_sample_refuses(arch, capsys):
    """launch.sample refuses the family, naming the embeddings its eps-net
    lacks and the reference's own failure there, through sample(),
    build_engine() and the CLI."""
    cfg = t_get_config(arch).reduced()
    key = COND[cfg.family]
    with pytest.raises(ValueError, match=f"batch\\['{key}'\\].*reference's"):
        t_sample.sample(arch, device="cpu")
    with pytest.raises(ValueError, match=key):
        t_sample.build_engine(cfg, None, TVP(), 2, device="cpu")
    with pytest.raises(SystemExit):
        t_sample.main(["--arch", arch, "--device", "cpu"])
    err = capsys.readouterr().err
    assert key in err and "fails there too" in err


def check_train_five_steps(arch, objective, monkeypatch):
    """Five `launch.train.train` steps from the reference's init (out_proj
    perturbed) on the reference's draws and stub embeddings (seed + i a
    step): the losses within 1e-5 relative, each param leaf within 1e-5
    relative L2 of `repro.launch.train`'s."""
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


def check_batches(arch):
    """build_batch_fn: the reference's tokens, targets and stub embeddings
    (seed + i), bit-equal."""
    from repro.launch import train as j_train

    jfn = j_train.build_batch_fn(j_train.get_config(arch).reduced(), 3, 8,
                                 seed=2)
    tfn = t_train.build_batch_fn(t_get_config(arch).reduced(), 3, 8, seed=2)
    for i in (0, 5):
        want, got = jfn(i), tfn(i)
        assert want.keys() == got.keys() == {"tokens", "targets",
                                             COND[t_get_config(arch).family]}
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def check_clis(arch, tmp_path, capsys):
    """The CLIs on `--device cpu`: serve decodes (the stub frontend fed),
    train writes a checkpoint the port restores as it trained it."""
    from repro_torch.checkpoint import ckpt as t_ckpt

    out = t_serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "12",
                        "--gen", "4", "--device", "cpu"])
    assert out.shape == (2, 4) and out.dtype == np.int32
    assert f"token [cpu] {arch}: prefill" in capsys.readouterr().out
    params, hist = t_train.train(arch, reduced=True, objective="diffusion",
                                 steps=3, batch=2, seq=16, log_every=10,
                                 device="cpu", ckpt_dir=str(tmp_path))
    assert all(np.isfinite(h["loss"]) for h in hist)
    tree, step = t_ckpt.restore(str(tmp_path))
    assert step == 3
    cfg = t_get_config(arch).reduced()
    back = t_api.params_from_numpy(tree["params"], cfg, "cpu")
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(_flat(back)[k], v)
    t_train.main(["--arch", arch, "--objective", "ar", "--steps", "2",
                  "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert "step     1 loss" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the vlm
# ---------------------------------------------------------------------------

DEPTHS = [{}, dict(num_layers=6)]
DEPTH_IDS = ["2x(1+1)", "3x(1+1)"]


def test_configs_and_param_trees_match_the_reference():
    check_configs_and_trees(ARCH, DEPTHS)
    cfg = t_get_config(ARCH)
    assert (t_vlm._vlm_groups(cfg), cfg.image_tokens) == (20, 1600)
    with pytest.raises(ValueError, match="whole number"):
        t_vlm._vlm_groups(cfg.reduced(num_layers=5))


@pytest.mark.parametrize("over", DEPTHS, ids=DEPTH_IDS)
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_reference(over, causal):
    """The full-sequence forward over the image from tokens (causal, the AR
    path) and from input embeddings (bidirectional, the diffusion LM's)."""
    jcfg, tcfg, jp, tp = family_params(ARCH, **over)
    img = cond_inputs(jcfg, 2)["image_embeds"]
    toks = _tokens(jcfg, 2, 23)
    jh, jaux = j_vlm.vlm_forward(jp["backbone"], jcfg, jnp.asarray(toks),
                                 jnp.asarray(img), causal=causal)
    th, taux = t_vlm.vlm_forward(tp["backbone"], tcfg, _t(toks).long(),
                                 _t(img), causal=causal)
    assert _rel(th, jh) <= TOL
    assert float(taux) == float(jaux) == 0.0
    e = np.random.default_rng(12).normal(size=(2, 9, 128)).astype(np.float32)
    jh, _ = j_vlm.vlm_forward(jp["backbone"], jcfg, None, jnp.asarray(img),
                              inputs_embeds=jnp.asarray(e), causal=causal)
    th, _ = t_vlm.vlm_forward(tp["backbone"], tcfg, None, _t(img),
                              inputs_embeds=_t(e), causal=causal)
    assert _rel(th, jh) <= TOL


def test_cross_attention_gates_open_the_image_path():
    """At init the gates are zero and the image changes nothing (the
    reference's design); with the test's gates it moves the hidden state."""
    _, tcfg, _, tp = family_params(ARCH)
    toks = _t(_tokens(tcfg, 2, 7)).long()
    a, b = (_t(cond_inputs(tcfg, 2, seed=s)["image_embeds"]) for s in (1, 2))
    fwd = t_vlm.vlm_forward
    assert _rel(fwd(tp["backbone"], tcfg, toks, a)[0],
                fwd(tp["backbone"], tcfg, toks, b)[0]) > 1e-3
    fresh = t_api.init_params(tcfg, 0, "cpu")["backbone"]
    assert not fresh["xattn_layers"]["gate_attn"].any()
    assert torch.equal(fwd(fresh, tcfg, toks, a)[0],
                       fwd(fresh, tcfg, toks, b)[0])


def test_loss_matches_reference():
    jcfg, tcfg, jp, tp = family_params(ARCH, seed=3)
    b = token_batch(tcfg)
    want = j_vlm.vlm_loss(jp["backbone"], jcfg, *_jb(b).values())
    got = t_vlm.vlm_loss(tp["backbone"], tcfg, *_tb(b).values())
    assert abs(float(got) - float(want)) <= LOSS_TOL * float(want)


@pytest.mark.parametrize("over", DEPTHS, ids=DEPTH_IDS)
@pytest.mark.parametrize("S", [13, 2])
def test_prefill_and_decode_match_reference(over, S):
    """Logits and every cache leaf (the self-attention KV caches and the
    image K/V) after prefill and each of three decode steps."""
    assert check_prefill_and_decode(ARCH, S, **over) >= 4 * (1 + 4)


def test_decode_matches_forward():
    check_decode_matches_forward(ARCH, t_vlm.vlm_forward)


def test_init_cache_matches_reference():
    jcfg, tcfg, _, _ = family_params(ARCH)
    want = _flat(jax.tree.map(np.asarray, j_api.init_cache(jcfg, 3, 20)))
    got = _flat(t_api.init_cache(tcfg, 3, 20))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        assert not got[k].any(), k
    cache = t_api.init_cache(tcfg, 3, 20)
    assert cache["k"].data_ptr() != cache["v"].data_ptr()   # written apart


@pytest.mark.parametrize("over", DEPTHS, ids=DEPTH_IDS)
def test_eps_network_matches_reference(over):
    check_eps_network(ARCH, **over)


def test_ar_loss_and_grads_match_reference():
    check_ar_loss_and_grads(ARCH)


def test_diffusion_lm_loss_and_grads_match_reference():
    check_diffusion_loss_and_grads(ARCH)


def test_remat_is_bit_equal():
    check_remat(ARCH)


def test_weights_kept_once_are_bit_equal_to_per_use_casts():
    """The two 0-d gates of each cross-attention layer are read in fp32
    (tanh, then the cast), so they are shared, not cast."""
    check_weights_kept_once(ARCH, ("/gate_attn", "/gate_mlp", "/t_mlp1",
                                   "/t_mlp2"))


def test_serve_greedy_tokens_equal_reference(monkeypatch):
    check_serve_greedy(ARCH, monkeypatch)


def test_engine_sampling_matches_reference():
    check_engine_sampling(ARCH)


def test_sample_refuses_the_vlm(capsys):
    check_sample_refuses(ARCH, capsys)


@pytest.mark.parametrize("objective", ["ar", "diffusion"])
def test_train_five_steps_match_reference(monkeypatch, objective):
    check_train_five_steps(ARCH, objective, monkeypatch)


def test_batches_are_bit_equal():
    check_batches(ARCH)


def test_clis_serve_and_train_on_the_cpu(tmp_path, capsys):
    check_clis(ARCH, tmp_path, capsys)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def card_attention_case(dev, B, Hq, Hkv, Sq, Skv, D, causal, dtype):
    """flash_attention and its backward against their plain versions on
    head-major views of (B, S, H, D) projections, the backward from the
    forward's fp32 output (o32, which rounds to the output bit for bit),
    as the autograd Function runs it: the forward within 1e-5 (fp32) /
    1e-2 (bf16) relative L-inf, the gradients 1e-5 relative L-inf (fp32) /
    1e-2 relative L2 (bf16)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr

    g = torch.Generator(device=dev).manual_seed(Sq + Skv)
    q, do = (torch.randn(B, Sq, Hq, D, generator=g, device=dev).to(dtype)
             .transpose(1, 2) for _ in range(2))
    k, v = (torch.randn(B, Skv, Hkv, D, generator=g, device=dev).to(dtype)
            .transpose(1, 2) for _ in range(2))
    out, lse, o32 = fk.flash_attention(q, k, v, causal=causal, lse=True)
    assert torch.equal(o32.to(dtype), out)
    want = fr.attention(q, k, v, causal=causal)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _rel(out.double().cpu(), want.double().cpu()) <= tol
    got = fk.flash_attention_bwd(q, k, v, o32, lse, do, causal=causal)
    ref = fr.attention_bwd(q, k, v, o32, lse, do, causal=causal)
    for a, b in zip(got, ref):
        a, b = a.double().cpu(), b.double().cpu()
        err = (_rel(a, b) if dtype == torch.float32 else
               float((a - b).norm() / b.norm()))
        assert err <= tol


# the vlm's cross-attention: text over 1600 image tokens, GQA 64/8 at D 128
# (full width: 8 kv heads; cut here to 2 batch rows); its diffusion LM's 64
# queries; a ragged 200 over 333
VLM_CROSS = [(2, 64, 8, 512, 1600, 128), (2, 64, 8, 64, 1600, 128),
             (1, 8, 2, 200, 333, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", VLM_CROSS)
def test_card_cross_attention_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, D,
                                            dtype):
    card_attention_case(cuda, B, Hq, Hkv, Sq, Skv, D, False, dtype)


@pytest.mark.gpu
def test_card_vlm_decode_graph_is_bit_equal_to_eager(cuda):
    """The decode step captured as a CUDA graph (the image K/V read from
    the cache it captures) gives the eager step's tokens bit for bit."""
    _, tcfg, _, tp = family_params(ARCH)
    prompts = _tokens(tcfg, 2, 9, seed=3)
    kw = dict(batch=2, prompt_len=9, gen=6, device=cuda,
              params=t_api.params_to(tp, cuda), prompts=prompts)
    np.testing.assert_array_equal(t_serve.serve(ARCH, **kw),
                                  t_serve.serve(ARCH, jit=False, **kw))
