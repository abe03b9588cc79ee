"""Training the port's decoder-only token family (dense and MoE) against the
JAX reference's, on the same inputs.

* `kernels/flash_attention/ref.attention_bwd`, the plain backward the
  kernels are held to, against `jax.vjp` of the reference's
  `ref.attention` at fp32 (<= 1e-5 relative L-inf): causal, a window of
  4 with and without causal, GQA 4/2 and 7/1, Sq != Skv both ways (Sq >
  Skv + window - 1 leaves queries with every key masked, whose output is
  the mean of V);
* `api.train_loss(cfg, "ar")` on perturbed params (every float leaf +
  0.05 N(0, 1): the diffusion head's out_proj is zero-initialised): the
  loss <= 1e-6 relative and every gradient leaf <= 1e-5 relative L2
  against `jax.value_and_grad(repro.models.api.ar_loss(cfg))`, none
  vacuous, at reduced qwen2-0.5b (GQA, qkv bias), olmo-1b (untied head),
  granite-moe (the router's aux loss) and mixtral-8x7b (a sliding window
  of 8 at S 16, so that it masks); the leaves the AR loss does not read
  (the diffusion head, the token latents) are zero on both sides;
* the diffusion-LM loss (eps MSE + the alpha^2-weighted rounding
  cross-entropy) with the draws replayed from the reference's key, at
  reduced qwen2-0.5b and granite-moe, to the same tolerances;
* five `launch.train.train` steps of reduced qwen2-0.5b, AR and diffusion,
  with the reference's init (out_proj perturbed) and draws injected:
  losses within 1e-5 relative, each param leaf within 1e-5 relative L2 of
  `repro.launch.train.train` (the key bias through the trained logits,
  see KEY_BIAS);
* the token batches bit-equal; `cfg.remat` bit-equal to the plain
  forward, loss and gradients; the CLI; a trained diffusion LM's
  checkpoint through `launch.sample --ckpt`.

The `gpu` tests hold the attention backward kernel against the plain
version for every mask and group size (1e-5 relative L-inf at fp32, 1e-2
relative L2 at bf16), bit-equal across two calls, and skip elsewhere.
"""

import dataclasses
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as j_syn
from repro.kernels.flash_attention import ref as j_fa_ref
from repro.launch import train as j_train
from repro.models import api as j_api
from repro.models import transformer as j_tf
from repro_torch.checkpoint import ckpt as t_ckpt
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import synthetic as t_syn
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import sample as t_sample
from repro_torch.launch import train as t_train
from repro_torch.models import api as t_api
from repro_torch.models import transformer as t_tf
from repro_torch.optim import tree_leaves, tree_map
from test_torch_token_models import reference_params
from test_torch_train import _flat, _reference_draws, _rel_l2

torch.set_num_threads(2)

BWD_TOL = 1e-5
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
TRAIN_TOL = 1e-5
B, S = 2, 16


def _rel_linf(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _randn(shape, seed, dtype=torch.float32):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


# ---------------------------------------------------------------------------
# the plain attention backward
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, Sq, Skv, D, causal, window)
BWD_CASES = [
    (2, 2, 2, 19, 19, 32, True, None),       # causal
    (2, 2, 2, 19, 19, 32, False, 4),         # window 4
    (2, 2, 2, 19, 19, 32, True, 4),          # window 4, causal
    (2, 4, 2, 19, 19, 32, True, None),       # GQA 4/2
    (1, 7, 1, 21, 21, 64, True, None),       # GQA 7/1, qwen2's group
    (2, 4, 2, 13, 23, 32, True, None),       # Sq < Skv
    (1, 4, 2, 23, 13, 32, False, 4),         # Sq > Skv + 3: 7 dead queries
    (1, 7, 1, 23, 13, 32, True, 4),          # ... causal, GQA 7/1
]
BWD_IDS = ["causal", "window4", "window4-causal", "gqa4-2", "gqa7-1",
           "sq<skv", "sq>skv-dead-rows", "sq>skv-dead-rows-causal-gqa7"]


def _bwd_inputs(Bq, Hq, Hkv, Sq, Skv, D, dtype=torch.float32, seed=30):
    """q, k, v, do as head-major views of (B, S, H, D) projections."""
    q = _randn((Bq, Sq, Hq, D), seed, dtype).transpose(1, 2)
    k = _randn((Bq, Skv, Hkv, D), seed + 1, dtype).transpose(1, 2)
    v = _randn((Bq, Skv, Hkv, D), seed + 2, dtype).transpose(1, 2)
    do = _randn((Bq, Sq, Hq, D), seed + 3, dtype).transpose(1, 2)
    return q, k, v, do


@pytest.mark.parametrize("Bq,Hq,Hkv,Sq,Skv,D,causal,window", BWD_CASES,
                         ids=BWD_IDS)
def test_attention_bwd_matches_jax_vjp(Bq, Hq, Hkv, Sq, Skv, D, causal,
                                       window):
    q, k, v, do = _bwd_inputs(Bq, Hq, Hkv, Sq, Skv, D)
    o, vjp = jax.vjp(lambda a, b, c: j_fa_ref.attention(
        a, b, c, causal=causal, window=window),
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    lse = fa_ref.attention_lse(q, k, causal=causal, window=window)
    got = fa_ref.attention_bwd(q, k, v, torch.from_numpy(np.array(o)), lse,
                               do, causal=causal, window=window)
    for a, b, src in zip(got, want, (q, k, v)):
        assert a.shape == src.shape and a.dtype == torch.float32
        assert np.abs(np.asarray(b)).max() > 0
        assert _rel_linf(a.numpy(), b) <= BWD_TOL, _rel_linf(a.numpy(), b)


def test_attention_bwd_dead_queries():
    """A query with every key masked: dq 0, and dv of every key gains its
    do / Skv (the mean of V was its output), as jax.vjp gives."""
    q, k, v, do = _bwd_inputs(1, 2, 1, 9, 4, 32, seed=40)
    kw = dict(causal=False, window=2)          # queries 5..8 see no key
    o = fa_ref.attention(q, k, v, **kw)
    lse = fa_ref.attention_lse(q, k, **kw)
    dq, dk, dv = fa_ref.attention_bwd(q, k, v, o, lse, do, **kw)
    assert not dq[:, :, 5:].any()
    live = fa_ref.attention_bwd(q[:, :, :5], k, v, o[:, :, :5],
                                lse[:, :, :5], do[:, :, :5], **kw)
    torch.testing.assert_close(dk, live[1], rtol=1e-6, atol=1e-6)
    dead = do[:, :, 5:].sum(dim=(1, 2), keepdim=True)[:, 0] / 4
    torch.testing.assert_close(dv, live[2] + dead, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the AR loss and the diffusion-LM loss
# ---------------------------------------------------------------------------

# (arch, reduced() overrides): mixtral's window set below S so it masks
AR_ARCHS = [("qwen2-0.5b", {}), ("olmo-1b", {}),
            ("granite-moe-3b-a800m", {}),
            ("mixtral-8x7b", dict(sliding_window=8))]


def _token_batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "targets")}


def _port_loss_and_grads(loss_fn, params, batch, rng):
    """The loss and {path: gradient} (None where the loss reads no leaf)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(leaves, {k: torch.from_numpy(v).long()
                            for k, v in batch.items()}, rng)
    flat = tree_leaves(leaves)
    grads = dict(zip(map(id, flat), torch.autograd.grad(
        loss, flat, allow_unused=True)))
    none = torch.zeros(0)
    return loss, _flat(tree_map(lambda p: (none if grads[id(p)] is None
                                           else grads[id(p)]), leaves))


def _assert_grads_match(got, want, unread):
    assert got.keys() == want.keys() and len(want) >= 12
    for k in want:
        if any(k.startswith(u) for u in unread):   # zero on both sides
            assert got[k].size == 0 and not np.abs(want[k]).any(), k
            continue
        assert np.abs(want[k]).max() > 0, k        # perturbed: none vacuous
        assert _rel_l2(got[k], want[k]) <= GRAD_TOL, (k, _rel_l2(got[k],
                                                                 want[k]))


@pytest.mark.parametrize("arch,overrides", AR_ARCHS,
                         ids=[a for a, _ in AR_ARCHS])
def test_ar_loss_and_grads_match_reference(arch, overrides):
    jcfg, tcfg, jp, tp = reference_params(arch, seed=6, **overrides)
    batch = _token_batch(tcfg)
    want_loss, want_grads = jax.value_and_grad(j_api.ar_loss(jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    loss, got = _port_loss_and_grads(t_api.train_loss(tcfg, "ar"), tp,
                                     batch, None)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * float(want_loss)
    _assert_grads_match(got, _flat(jax.tree.map(np.asarray, want_grads)),
                        ("/diffusion_head", "/token_latents"))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-3b-a800m"])
def test_diffusion_lm_loss_and_grads_match_reference(arch):
    """Embedding-space diffusion with the rounding loss; the backbone runs
    from its input embeddings, so `embed` (and an untied `lm_head`) is not
    read."""
    jcfg, tcfg, jp, tp = reference_params(arch, seed=7)
    batch = _token_batch(tcfg, seed=4)
    key = jax.random.PRNGKey(12)
    want_loss, want_grads = jax.value_and_grad(j_api.train_loss(
        jcfg, "diffusion"))(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                            key)
    draws = _reference_draws(key, (B, S, tcfg.latent_dim))
    loss, got = _port_loss_and_grads(t_api.train_loss(tcfg, "diffusion"), tp,
                                     batch, draws)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * float(want_loss)
    _assert_grads_match(got, _flat(jax.tree.map(np.asarray, want_grads)),
                        ("/backbone/embed", "/backbone/lm_head"))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-3b-a800m"])
def test_remat_is_bit_equal(arch):
    """cfg.remat (activation checkpointing per block) gives the same loss
    and gradients bit for bit, for both objectives."""
    _, tcfg, _, tp = reference_params(arch, seed=8)
    batch = _token_batch(tcfg, seed=5)
    draws = (np.full(B, 0.4, np.float32),
             np.random.default_rng(9).normal(
                 size=(B, S, tcfg.latent_dim)).astype(np.float32))
    for objective, rng in (("ar", None), ("diffusion", draws)):
        runs = [_port_loss_and_grads(t_api.train_loss(
            dataclasses.replace(tcfg, remat=remat), objective), tp, batch,
            rng) for remat in (False, True)]
        assert torch.equal(runs[0][0], runs[1][0])
        assert runs[0][1].keys() == runs[1][1].keys()
        for k in runs[0][1]:
            np.testing.assert_array_equal(runs[0][1][k], runs[1][1][k])


def test_ar_loss_refusals():
    """The dit family has no AR objective, as in the reference; the vlm,
    the last family the port refused, has one (over the batch's image
    embeddings: tests/test_torch_vlm.py), and an unknown family is
    refused."""
    with pytest.raises(ValueError, match="no autoregressive objective"):
        t_api.ar_loss(t_get_config("dit-cifar").reduced())
    vlm = t_get_config("llama-3.2-vision-90b").reduced()
    batch = t_train.build_batch_fn(vlm, 2, 8)(0)
    loss = t_api.ar_loss(vlm)(t_api.init_params(vlm), batch, None)
    assert loss.ndim == 0 and torch.isfinite(loss)
    with pytest.raises(ValueError, match="no such family"):
        t_api.ar_loss(dataclasses.replace(vlm, family="video"))


# ---------------------------------------------------------------------------
# train()
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,seq", [("qwen2-0.5b", 16), ("olmo-1b", 24),
                                      ("granite-moe-3b-a800m", 8)])
def test_token_batches_are_bit_equal(arch, seq):
    jfn = j_train.build_batch_fn(j_train.get_config(arch).reduced(), 3, seq,
                                 seed=2)
    tfn = t_train.build_batch_fn(t_get_config(arch).reduced(), 3, seq,
                                 seed=2)
    for i in (0, 1, 7):
        want, got = jfn(i), tfn(i)
        assert want.keys() == got.keys() == {"tokens", "targets"}
        for k in want:
            assert got[k].dtype == torch.int64
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _reference_token_run(monkeypatch, arch, objective, steps, batch, seq,
                         seed):
    """The reference's train() from its init with the diffusion head's
    zero-initialised out_proj perturbed (0.05 N(0, 1), numpy; the
    backbone's gradients through it are exactly zero otherwise, then
    fp32 noise that AdamW amplifies), and the draws it made, replayed from
    its keys (rng, sub = split(PRNGKey(seed)) a step, the diffusion loss
    splitting sub)."""
    jcfg = j_train.get_config(arch).reduced()
    init = jax.tree.map(np.asarray, j_api.init_params(
        jcfg, jax.random.PRNGKey(seed)))
    head = init["diffusion_head"]
    head["out_proj"] = (0.05 * np.random.default_rng(seed).normal(
        size=head["out_proj"].shape)).astype(np.float32)
    monkeypatch.setattr(j_train.api, "init_params",
                        lambda cfg, rng: jax.tree.map(jnp.asarray, init))
    params, hist = j_train.train(arch, reduced=True, objective=objective,
                                 steps=steps, batch=batch, seq=seq,
                                 seed=seed, log_every=1)
    rng = jax.random.PRNGKey(seed)
    draws = []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        draws.append(_reference_draws(sub, (batch, seq, jcfg.latent_dim)))
    return params, hist, init, draws


# Each param leaf is held by its relative L2 distance, as the gradients
# are, but the key bias. Where an element's gradient is at the fp32 noise of
# its sums, AdamW's m / sqrt(v) turns that noise into a step of the order of
# the learning rate. The key bias's gradient nearly cancels in its
# low-frequency rotary components (a shift of every key that rope leaves
# unrotated does not move the softmax): 1e-8 to 1e-6 at the init, where
# the frameworks' sums disagree by up to 13%, and after five steps the leaf
# sits 3.5e-3 (AR) and 6.4e-3 (diffusion) from the reference's (relative
# L2; every other leaf <= 2.9e-6). It is held through what it does: the
# trained nets' logits (<= 1e-5 relative L2; 1.2e-6 measured), and the
# losses.
KEY_BIAS = "/backbone/layers/attn/bk"

@pytest.mark.parametrize("objective", ["ar", "diffusion"])
def test_train_five_steps_match_reference(monkeypatch, objective):
    # TokenStream seeds each block with Python's string hash, which changes
    # from process to process: pinned here (a CRC of the key, in both
    # packages) so that every run trains on the same batches
    for mod in (j_syn, t_syn):
        monkeypatch.setattr(mod, "hash", lambda key: zlib.crc32(
            repr(key).encode()), raising=False)
    want_params, want_hist, init, draws = _reference_token_run(
        monkeypatch, "qwen2-0.5b", objective, 5, 4, 16, 0)
    monkeypatch.setattr(
        t_api, "init_params",
        lambda cfg, seed=0, device="cpu": t_api.params_from_numpy(
            init, cfg, device))
    monkeypatch.setattr(t_train, "step_rng", lambda gen, i: draws[i])
    params, hist = t_train.train("qwen2-0.5b", reduced=True,
                                 objective=objective, steps=5, batch=4,
                                 seq=16, log_every=1, device="cpu")
    assert [h["step"] for h in hist] == [h["step"] for h in want_hist]
    for a, b in zip(hist, want_hist):
        assert abs(a["loss"] - b["loss"]) <= TRAIN_TOL * abs(b["loss"])
    w, g = _flat(jax.tree.map(np.asarray, want_params)), _flat(params)
    assert w.keys() == g.keys()
    for k in w:
        if k != KEY_BIAS:
            assert _rel_l2(g[k], w[k]) <= TRAIN_TOL, (k, _rel_l2(g[k], w[k]))
    # the key bias through what it does: the trained nets' logits
    jcfg = j_train.get_config("qwen2-0.5b").reduced()
    tokens = _token_batch(jcfg, seed=11)["tokens"]
    hidden, _ = j_tf.forward(want_params["backbone"], jcfg,
                             jnp.asarray(tokens))
    want = j_tf.logits_from_hidden(want_params["backbone"], jcfg, hidden)
    cfg = t_get_config("qwen2-0.5b").reduced()
    hidden, _ = t_tf.forward(params["backbone"], cfg,
                             torch.from_numpy(tokens).long())
    got = t_tf.logits_from_hidden(params["backbone"], cfg, hidden)
    assert _rel_l2(got.numpy(), want) <= TRAIN_TOL, _rel_l2(got.numpy(), want)
    assert all(not p.requires_grad and p.grad_fn is None
               for p in tree_leaves(params))


def test_train_cli_writes_log_and_checkpoint(tmp_path):
    t_train.main(["--arch", "qwen2-0.5b", "--objective", "ar", "--steps",
                  "4", "--batch", "2", "--seq", "16", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
                  "--log-file", str(tmp_path / "log.json")])
    hist = json.loads((tmp_path / "log.json").read_text())
    assert [h["step"] for h in hist] == [0, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)
    tree, step = t_ckpt.restore(str(tmp_path / "ck"))
    assert step == 4 and set(tree["params"]) == {
        "backbone", "diffusion_head", "token_latents"}


def test_trained_diffusion_lm_samples_from_its_checkpoint(tmp_path):
    """A diffusion LM trained by `train` goes through its checkpoint and
    `launch.sample --ckpt`: bit-equal to sampling the in-memory params."""
    params, _ = t_train.train("granite-moe-3b-a800m", reduced=True,
                              objective="diffusion", steps=3, batch=2,
                              seq=16, log_every=10, device="cpu",
                              ckpt_dir=str(tmp_path))
    got = t_sample.main(["--arch", "granite-moe-3b-a800m", "--ckpt",
                         str(tmp_path), "--nfe", "5", "--batch", "2",
                         "--device", "cpu"])
    want = t_sample.sample("granite-moe-3b-a800m", reduced=True,
                           params=params, nfe=5, batch=2, device="cpu")
    assert got.shape == want.shape == (2, 64, 32) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the backward kernel against its plain version (card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


CARD_CASES = BWD_CASES + [
    (2, 14, 2, 130, 130, 64, True, None),    # qwen2's group, ragged S
    (1, 24, 8, 100, 100, 64, True, None),    # granite's group
    (2, 14, 2, 150, 150, 64, True, 64),      # a window of 64, GQA 7
    (2, 14, 2, 64, 64, 64, False, None),     # the diffusion LM's
    (1, 4, 2, 70, 40, 72, True, 16),         # dead queries, D 72
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("Bq,Hq,Hkv,Sq,Skv,D,causal,window", CARD_CASES)
def test_card_attention_bwd_every_mask_matches_plain(cuda, Bq, Hq, Hkv, Sq,
                                                     Skv, D, causal, window,
                                                     dtype):
    q, k, v, do = (t.to(cuda) for t in _bwd_inputs(Bq, Hq, Hkv, Sq, Skv, D,
                                                   dtype))
    kw = dict(causal=causal, window=window)
    _, lse, o32 = fa_kernel.flash_attention(q, k, v, lse=True, **kw)
    got = fa_kernel.flash_attention_bwd(q, k, v, o32, lse, do, **kw)
    want = fa_ref.attention_bwd(q, k, v, o32, lse, do, **kw)
    for a, b, src in zip(got, want, (q, k, v)):
        assert a.stride() == src.stride() and a.dtype == dtype
        err = (_rel_linf(a.cpu().double(), b.cpu().double())
               if dtype == torch.float32 else _l2(a, b))
        assert err <= (1e-5 if dtype == torch.float32 else 1e-2), err
    again = fa_kernel.flash_attention_bwd(q, k, v, o32, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_card_attention_trains_under_grad_for_every_mask(cuda):
    """ops.attention under grad launches the forward and backward kernels
    for causal, windowed and GQA calls (no refusal, no plain fallback)."""
    for kw, hkv in (({"causal": True}, 2), ({"causal": False, "window": 4},
                                             4), ({"causal": True,
                                                   "window": 8}, 1)):
        q = _randn((1, 4, 40, 64), 60).to(cuda).requires_grad_()
        k, v = (_randn((1, hkv, 40, 64), s).to(cuda).requires_grad_()
                for s in (61, 62))
        dispatch.LAUNCHES.clear()
        out = fa_ops.attention(q, k, v, **kw)
        grads = torch.autograd.grad(out.square().sum(), (q, k, v))
        assert dict(dispatch.LAUNCHES) == {"flash_attention": 1,
                                           "flash_attention_bwd": 1}
        leaves = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(
            fa_ref.attention(*leaves, **kw).square().sum(), leaves)
        for a, b in zip(grads, want):
            assert _rel_linf(a.cpu(), b) <= 1e-4
