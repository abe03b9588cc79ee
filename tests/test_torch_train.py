"""The port's training slice against the JAX reference's, on the same inputs.

* `data/synthetic.py`: bit-equal (numpy both sides);
* `warmup_cosine` / `constant`: within 1 ulp of the reference's float32
  values (XLA's and torch's `cos` may differ in the last bit);
* `AdamW`: three updates on the same params and grads, clip on and off,
  weight decay on: <= 1e-6 relative L-inf per leaf (params and moments;
  the same fp32 arithmetic, sums in another order);
* `diffusion_loss` (process) and `api.diffusion_loss_fn` with the
  reference's own draws passed in (jax.random cannot be reproduced by
  torch): the loss <= 1e-6 relative and every gradient leaf <= 1e-5
  relative L2 against `jax.value_and_grad`, at the reduced dit-cifar and
  at a 2-block slice of dit-i256's full width (fp32, perturbed params:
  adaLN-zero would leave most gradients zero);
* `launch.train.train` for 5 steps with the reference's init and per-step
  draws injected: losses within 1e-5 relative, and each final param leaf
  within 1e-5 relative L2 and 1e-5 absolute, of `repro.launch.train.train`
  (relative L2 as for the gradients: the adaLN weights start at zero, and
  where a gradient element is tiny AdamW's m / sqrt(v) amplifies its fp32
  noise, so their largest single difference is 1.2e-4 of the leaf's
  largest value, 4.9e-8 absolute);
* checkpoints cross between the packages bit-equal, and a port-trained
  checkpoint sampled through `launch.sample --ckpt` matches the reference
  sampling the same checkpoint (x_T passed in) within 1e-5;
* the tuner trains before it searches; UniPC beats DDIM on the port's own
  training (the reference's `test_unipc_beats_ddim_on_trained_model`).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.data import synthetic as j_syn
from repro.diffusion import VPLinear as JVP
from repro.diffusion import process as j_process
from repro.launch import sample as j_sample
from repro.launch import train as j_train
from repro.models import api as j_api
from repro.optim import AdamW as JAdamW
from repro.optim import constant as j_constant
from repro.optim import warmup_cosine as j_warmup_cosine
from repro_torch.checkpoint import ckpt as t_ckpt
from repro_torch.data import synthetic as t_syn
from repro_torch.diffusion import VPLinear as TVP
from repro_torch.diffusion import process as t_process
from repro_torch.launch import sample as t_sample
from repro_torch.launch import train as t_train
from repro_torch.launch import tune as t_tune
from repro_torch.models import api as t_api
from repro_torch.optim import AdamW as TAdamW
from repro_torch.optim import constant as t_constant
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.optim import warmup_cosine as t_warmup_cosine
from test_torch_dit import reference_params

torch.set_num_threads(2)

LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
ADAM_TOL = 1e-6
TRAIN_TOL = 1e-5
SAMPLE_TOL = 1e-5


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _rel_linf(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a nested dict of tensors or arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if torch.is_tensor(tree):
        return {prefix: tree.detach().cpu().numpy()}
    return {prefix: np.asarray(tree)}


def _reference_draws(key, x0_shape, schedule=None):
    """(t, noise) exactly as `repro.models.api.diffusion_loss_fn` draws them
    from `key` (src/repro/models/api.py:198-206)."""
    schedule = schedule or JVP()
    rng_t, rng_e = jax.random.split(key)
    t = jax.random.uniform(rng_t, (x0_shape[0],), minval=schedule.t_eps,
                           maxval=schedule.T)
    noise = jax.random.normal(rng_e, x0_shape, jnp.float32)
    return np.asarray(t), np.asarray(noise)


# ---------------------------------------------------------------------------
# data, schedules, AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,tokens,dim,seed", [(8, 64, 32, 0),
                                                   (3, 256, 32, 7),
                                                   (2, 5, 48, 123)])
def test_synthetic_data_is_bit_equal(batch, tokens, dim, seed):
    np.testing.assert_array_equal(t_syn.latent_images(batch, tokens, dim,
                                                      seed),
                                  j_syn.latent_images(batch, tokens, dim,
                                                      seed))
    np.testing.assert_array_equal(t_syn.class_ids(batch, seed=seed),
                                  j_syn.class_ids(batch, seed=seed))
    np.testing.assert_array_equal(t_syn.stub_embeds(batch, tokens, dim, seed),
                                  j_syn.stub_embeds(batch, tokens, dim, seed))
    a = t_syn.TokenStream(97, 12, batch, seed).block(seed)
    b = j_syn.TokenStream(97, 12, batch, seed).block(seed)
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 11, 100), (1e-3, 1, 5),
                                               (1e-3, 20, 100), (0.5, 0, 7)])
def test_warmup_cosine_within_one_ulp(peak, warmup, total):
    steps = np.arange(0, total + 6, dtype=np.int32)
    want = np.asarray(j_warmup_cosine(peak, warmup, total)(jnp.asarray(steps)))
    got = t_warmup_cosine(peak, warmup, total)(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


def test_constant_schedule():
    want = np.asarray(j_constant(3e-4)(jnp.asarray(5, jnp.int32)))
    got = t_constant(3e-4)(torch.tensor(5, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _adam_tree(rng, scale):
    return {"w": (scale * rng.normal(size=(7, 5))).astype(np.float32),
            "blocks": {"a": (scale * rng.normal(size=(3, 4, 6))).astype(
                np.float32), "b": (scale * rng.normal(size=(11,))).astype(
                    np.float32)}}


@pytest.mark.parametrize("clip_norm,lr", [
    (1.0, "warmup_cosine"), (0.0, "warmup_cosine"), (1.0, 2e-3),
    (50.0, 2e-3)])
def test_adamw_three_updates_match_reference(clip_norm, lr):
    """Three updates with weight decay 0.1; clip 1.0 binds (the grads'
    global norm is about 10), 50 does not, 0 turns clipping off."""
    rng = np.random.default_rng(0)
    params = _adam_tree(rng, 1.0)
    grads = [_adam_tree(rng, 2.0) for _ in range(3)]
    sched = {"j": j_warmup_cosine(1e-2, 2, 10),
             "t": t_warmup_cosine(1e-2, 2, 10)} if lr == "warmup_cosine" \
        else {"j": lr, "t": lr}
    jopt = JAdamW(lr=sched["j"], clip_norm=clip_norm, weight_decay=0.1)
    topt = TAdamW(lr=sched["t"], clip_norm=clip_norm, weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(tree_map(torch.from_numpy, g), ts, tp)
        for want, got in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
            w, o = _flat(want), _flat(got)
            assert w.keys() == o.keys()
            for k in w:
                assert o[k].dtype == w[k].dtype
                assert _rel_linf(o[k], w[k]) <= ADAM_TOL, k
    assert int(ts.step) == int(js.step) == 3
    assert all(not p.requires_grad for p in tree_leaves(tp))


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighting", ["uniform", "snr_trunc"])
def test_process_diffusion_loss_matches_reference(weighting):
    """`diffusion.process.diffusion_loss` on a fixed eps-model (x_t -> a
    t-scaled tanh of it) with the reference's draws."""
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(4, 6, 5)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    rng_t, rng_e = jax.random.split(key)
    sch = JVP()
    t = jax.random.uniform(rng_t, (4,), minval=sch.t_eps, maxval=sch.T)
    noise = jax.random.normal(rng_e, x0.shape, x0.dtype)
    want = j_process.diffusion_loss(
        sch, lambda x, tt: jnp.tanh(x) * tt[:, None, None], jnp.asarray(x0),
        key, weighting=weighting)
    got = t_process.diffusion_loss(
        TVP(), lambda x, tt: torch.tanh(x) * tt[:, None, None],
        torch.from_numpy(x0), (np.asarray(t), np.asarray(noise)),
        weighting=weighting)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(float(got) - float(want)) <= LOSS_TOL * abs(float(want))


def test_draws_from_a_generator_cover_the_range():
    x0 = torch.zeros(4096, 2)
    t, noise = t_process.draw_t_noise(TVP(), x0,
                                      torch.Generator().manual_seed(0))
    assert t.dtype == noise.dtype == torch.float32
    assert 1e-3 <= float(t.min()) and float(t.max()) <= 1.0
    assert abs(float(noise.mean())) < 0.05 and abs(float(noise.std()) - 1) < 0.05
    again = t_process.draw_t_noise(TVP(), x0, torch.Generator().manual_seed(0))
    assert torch.equal(t, again[0]) and torch.equal(noise, again[1])


# (arch, perturbation, reduced() overrides): the reduced dit-cifar (GQA 4 q
# / 2 kv heads), and two blocks at dit-i256's full width. There the
# perturbation is 0.01: 0.05 N(0, 1) is above the init's own scale
# (1/sqrt(1152) = 0.029, 1/sqrt(4608) = 0.015) and drives eps_hat to std
# 3.1, where fp32 accumulation alone sets the two frameworks' eps_hat
# 7.0e-6 apart (relative L2) and their losses 1.04e-6; at 0.01 eps_hat has
# std 0.34 and they sit 6.4e-7 and 4.6e-9 apart (float64 loss of each).
LOSS_CONFIGS = [
    ("dit-cifar", 0.05, {}),
    ("dit-i256", 0.01, dict(num_layers=2, d_model=1152, num_heads=16,
                            num_kv_heads=16, head_dim=72, d_ff=4608)),
]


@pytest.mark.parametrize("arch,scale,overrides", LOSS_CONFIGS,
                         ids=["dit-cifar", "dit-i256-2-blocks"])
def test_diffusion_loss_and_grads_match_reference(arch, scale, overrides):
    jcfg, tcfg, tree = reference_params(arch, seed=4, scale=scale,
                                        **overrides)
    B = 2
    x0 = j_syn.latent_images(B, jcfg.patch_tokens, jcfg.latent_dim, 5)
    ids = j_syn.class_ids(B, seed=5)
    key = jax.random.PRNGKey(9)
    jbatch = {"latents": jnp.asarray(x0), "class_ids": jnp.asarray(ids)}
    want_loss, want_grads = jax.value_and_grad(j_api.diffusion_loss_fn(jcfg))(
        jax.tree.map(jnp.asarray, tree), jbatch, key)
    draws = _reference_draws(key, x0.shape)

    params = t_api.params_from_numpy(tree, tcfg, "cpu")
    leaves = tree_map(lambda p: p.requires_grad_(True), params)
    tbatch = {"latents": torch.from_numpy(x0),
              "class_ids": torch.from_numpy(ids).long()}
    loss = t_api.train_loss(tcfg, "diffusion")(leaves, tbatch, draws)
    loss_v = float(loss.detach())
    flat = tree_leaves(leaves)
    grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    got_grads = tree_map(lambda p: grads[id(p)], leaves)

    assert loss.dtype == torch.float32
    assert abs(loss_v - float(want_loss)) <= LOSS_TOL * float(want_loss)
    w, g = _flat(jax.tree.map(np.asarray, want_grads)), _flat(got_grads)
    assert w.keys() == g.keys() and len(w) >= 14
    for k in w:
        assert np.abs(w[k]).max() > 0, k          # perturbed: none vacuous
        assert _rel_l2(g[k], w[k]) <= GRAD_TOL, (k, _rel_l2(g[k], w[k]))


def test_train_loss_refuses_what_is_not_ported():
    """No family is left unported: the vlm's loss and batches (its image
    embeddings, the reference's stub of seed + i) are built; a family the
    port does not know is refused; the dit family has no AR objective, as
    in the reference."""
    from repro_torch.configs import get_config

    vlm = get_config("llama-3.2-vision-90b").reduced()
    batch = t_train.build_batch_fn(vlm, 2, 8)(3)
    assert batch["image_embeds"].shape == (2, vlm.image_tokens, vlm.d_model)
    assert torch.isfinite(t_api.train_loss(vlm, "ar")(
        t_api.init_params(vlm), batch, None))
    with pytest.raises(ValueError, match="no such family"):
        t_api.train_loss(get_config("dit-cifar").reduced(family="video"),
                         "ar")
    with pytest.raises(ValueError, match="no autoregressive objective"):
        t_api.train_loss(get_config("dit-cifar").reduced(), "ar")


# ---------------------------------------------------------------------------
# train()
# ---------------------------------------------------------------------------


def _reference_run(arch, steps, batch, seed, **kw):
    """The reference's train() and the draws and init it made, replayed
    from its keys (src/repro/launch/train.py: init from PRNGKey(seed), then
    rng, sub = split(rng) a step, the loss splitting sub)."""
    params, hist = j_train.train(arch, reduced=True, objective="diffusion",
                                 steps=steps, batch=batch, seed=seed,
                                 log_every=1, **kw)
    jcfg = j_train.get_config(arch).reduced()
    rng = jax.random.PRNGKey(seed)
    init = jax.tree.map(np.asarray, j_api.init_params(jcfg, rng))
    draws = []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        draws.append(_reference_draws(
            sub, (batch, jcfg.patch_tokens, jcfg.latent_dim)))
    return params, hist, init, draws


def _inject(monkeypatch, init, draws):
    """The port's train() from the reference's init and draws."""
    monkeypatch.setattr(
        t_api, "init_params",
        lambda cfg, seed=0, device="cpu": t_api.params_from_numpy(
            init, cfg, device))
    monkeypatch.setattr(t_train, "step_rng", lambda gen, i: draws[i])


def test_train_five_steps_match_reference(monkeypatch):
    want_params, want_hist, init, draws = _reference_run("dit-cifar", 5, 8, 0)
    _inject(monkeypatch, init, draws)
    params, hist = t_train.train("dit-cifar", reduced=True,
                                 objective="diffusion", steps=5, batch=8,
                                 log_every=1, device="cpu")
    assert [h["step"] for h in hist] == [h["step"] for h in want_hist]
    for a, b in zip(hist, want_hist):
        assert abs(a["loss"] - b["loss"]) <= TRAIN_TOL * abs(b["loss"])
    w, g = _flat(jax.tree.map(np.asarray, want_params)), _flat(params)
    assert w.keys() == g.keys()
    for k in w:
        assert _rel_l2(g[k], w[k]) <= TRAIN_TOL, (k, _rel_l2(g[k], w[k]))
        assert np.abs(g[k].astype(np.float64) - w[k]).max() <= TRAIN_TOL, k
    assert all(not p.requires_grad and p.grad_fn is None
               for p in tree_leaves(params))


def test_train_cli_writes_log_and_checkpoints(tmp_path):
    t_train.main(["--arch", "dit-cifar", "--objective", "diffusion",
                  "--steps", "4", "--batch", "2", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
                  "--log-file", str(tmp_path / "log.json")])
    hist = json.loads((tmp_path / "log.json").read_text())
    assert [h["step"] for h in hist] == [0, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)
    tree, step = t_ckpt.restore(str(tmp_path / "ck"))
    assert step == 4 and set(tree) == {"params"}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _mixed_tree():
    rng = np.random.default_rng(1)
    return {"params": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                       "blocks": {"k": rng.normal(size=(2, 4, 4)).astype(
                           np.float32)}},
            "ids": np.arange(6, dtype=np.int32),
            "stack": [np.float64(2.5) * np.ones(3), np.zeros((2, 2), np.int8)]}


def _assert_trees_bit_equal(a, b):
    fa, fb = _flat_lists(a), _flat_lists(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape
        np.testing.assert_array_equal(fa[k], fb[k])


def _flat_lists(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_lists(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_lists(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree.detach().cpu().numpy()
                               if torch.is_tensor(tree) else tree)}


@pytest.mark.parametrize("shard_mb", [512, 0])
def test_reference_checkpoint_restores_in_the_port(tmp_path, shard_mb):
    tree = _mixed_tree()
    j_ckpt.save(str(tmp_path), tree, step=7, shard_mb=shard_mb)
    got, step = t_ckpt.restore(str(tmp_path))
    assert step == 7
    _assert_trees_bit_equal(got, tree)


@pytest.mark.parametrize("shard_mb", [512, 0])
def test_port_checkpoint_restores_in_the_reference(tmp_path, shard_mb):
    tree = _mixed_tree()
    tree["params"] = tree_map(torch.from_numpy, tree["params"])
    t_ckpt.save(str(tmp_path), tree, step=3, shard_mb=shard_mb)
    got, step = j_ckpt.restore(str(tmp_path))
    assert step == 3
    _assert_trees_bit_equal(got, tree)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files[-1] == "shard_00000.npz" or files[0] == "manifest.json"
    with pytest.raises(TypeError, match="bfloat16"):
        t_ckpt.save(str(tmp_path / "bf"), {"w": torch.ones(2).bfloat16()})


def test_port_trained_checkpoint_samples_like_the_reference(tmp_path,
                                                            monkeypatch):
    """Train with the port, save, then sample the checkpoint through the
    port's `launch.sample --ckpt` and the reference's `sample` on the same
    restored tree and the reference's x_T."""
    params, _ = t_train.train("dit-cifar", reduced=True,
                              objective="diffusion", steps=6, batch=4,
                              log_every=10, device="cpu",
                              ckpt_dir=str(tmp_path))
    tree, _ = j_ckpt.restore(str(tmp_path))
    _assert_trees_bit_equal(tree["params"], params)
    kw = dict(nfe=6, batch=2, seed=3)
    want = j_sample.sample("dit-cifar", reduced=True, params=tree["params"],
                           **kw)
    x_T = np.asarray(jax.random.normal(
        jax.random.PRNGKey(3), want.shape, jnp.float32))
    monkeypatch.setattr(t_sample, "sample",
                        functools.partial(t_sample.sample, x_T=x_T))
    got = t_sample.main(["--arch", "dit-cifar", "--ckpt", str(tmp_path),
                         "--nfe", "6", "--batch", "2", "--seed", "3",
                         "--device", "cpu"])
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_linf(got, want) <= SAMPLE_TOL


# ---------------------------------------------------------------------------
# the tuner on a trained net, and the paper's claim
# ---------------------------------------------------------------------------


def test_tune_trains_first_on_the_cpu():
    plan, report = t_tune.tune("dit-cifar", nfe=5, budget=8, rounds=1,
                               ref_nfe=16, batch=2, train_steps=5,
                               device="cpu")
    assert np.isfinite(report["baseline"]) and np.isfinite(report["tuned"])
    assert report["tuned"] <= report["baseline"]
    assert plan.nfe == 5


def test_unipc_beats_ddim_on_port_trained_model():
    """The reference's Fig. 4c check (tests/test_system.py) on the port's
    own training: UniPC-3 vs DDIM at NFE 8, l2 distance to a 200-step DDIM
    reference, after 120 steps (the reference's budget and bound)."""
    from repro_torch.configs import get_config
    from repro_torch.core import DDIM, Grid, UniPC
    from repro_torch.diffusion import wrap_model

    params, _ = t_train.train("dit-cifar", reduced=True,
                              objective="diffusion", steps=120, batch=8,
                              seq=32, lr=1e-3, log_every=50, device="cpu")
    cfg = get_config("dit-cifar").reduced()
    sched = TVP()
    net = t_api.eps_network(cfg)
    extra = {"class_ids": torch.zeros((2,), dtype=torch.long)}

    @torch.no_grad()
    def eps(x, t):
        return net(params, x, torch.as_tensor(t, dtype=torch.float32), extra)

    model = wrap_model(sched, eps, "data")
    x_T = torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (2, cfg.patch_tokens, cfg.latent_dim))))
    ref = DDIM(model, Grid.build(sched, 200), prediction="data").sample(x_T)
    D = np.sqrt(ref.numel())
    errs = {"ddim": float(torch.linalg.norm(
        DDIM(model, Grid.build(sched, 8), prediction="data").sample(x_T)
        - ref)) / D}
    u = UniPC(model, Grid.build(sched, 8), order=3, prediction="data")
    errs["unipc"] = float(torch.linalg.norm(
        u.sample_pc(x_T, use_corrector=True) - ref)) / D
    assert errs["unipc"] < 0.9 * errs["ddim"], errs
