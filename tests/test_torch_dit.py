"""The port's DiT eps-network against the JAX reference's, same params.

Params come from the reference's `init_params`, perturbed (adaLN-zero
makes an untrained DiT's output exactly zero, which would make the
comparison vacuous), then carried over by `api.params_from_numpy`. fp32
throughout; tolerance <= 1e-4 relative L-inf (matmul and reduction order
differ between XLA and PyTorch on the CPU; measured well below).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import api as j_api
from repro.models.dit import timestep_embedding as j_temb
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import api as t_api
from repro_torch.models.dit import timestep_embedding as t_temb

torch.set_num_threads(2)

TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def reference_params(arch, seed=0, scale=0.05, **overrides):
    """(jax cfg, port cfg, numpy params): the reference's init_params with
    every float leaf perturbed by scale * N(0, 1) drawn with numpy."""
    jcfg = j_get_config(arch).reduced(**overrides)
    tcfg = t_get_config(arch).reduced(**overrides)
    tree = jax.tree.map(np.asarray, j_api.init_params(jcfg,
                                                       jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(
        lambda a: (a + scale * rng.normal(size=a.shape)).astype(a.dtype), tree)
    return jcfg, tcfg, tree


def eval_both(arch, class_ids, t, *, seed=0, **overrides):
    jcfg, tcfg, tree = reference_params(arch, seed, **overrides)
    B = len(class_ids)
    x = np.random.default_rng(seed + 2).normal(
        size=(B, jcfg.patch_tokens, jcfg.latent_dim)).astype(np.float32)
    want = j_api.eps_network(jcfg)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(t),
        {"class_ids": jnp.asarray(class_ids, jnp.int32)})
    params = t_api.params_from_numpy(tree, tcfg, "cpu")
    got = t_api.eps_network(tcfg)(
        params, torch.as_tensor(x), torch.as_tensor(t),
        {"class_ids": torch.as_tensor(class_ids).long()})
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("arch,overrides", [
    ("dit-i256", {}),                    # GQA 4 q / 2 kv heads, T = 256
    ("dit-cifar", {}),                   # T = 64, latent 48
    ("dit-i256", {"head_dim": 72}),      # the full config's head width
])
def test_dit_apply_matches_reference(arch, overrides):
    got, want = eval_both(arch, class_ids=[3, 999, 1000], t=np.float32(0.37),
                          **overrides)
    assert got.shape == want.shape and np.abs(want).max() > 1e-3
    assert _rel(got, want) <= TOL


def test_dit_apply_per_sample_timesteps_and_null_class():
    """(B,) per-slot timesteps, the null class (CFG's uncond branch)."""
    got, want = eval_both("dit-i256", class_ids=[1000, 1000, 5, 17],
                          t=np.array([0.9, 0.5, 0.1, 0.01], np.float32))
    assert _rel(got, want) <= TOL


def test_timestep_embedding_matches_reference():
    """Angles reach 1000 rad, where one fp32 ulp of the angle (6e-5; the
    two frameworks' exp differ in the last bit of the frequencies) moves
    sin/cos by as much: tolerance 1e-4 absolute."""
    t = np.array([1e-3, 0.25, 0.5, 1.0], np.float32)
    got = t_temb(torch.as_tensor(t), 256).numpy()
    want = np.asarray(j_temb(jnp.asarray(t), 256))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_params_bridge_keeps_layout_and_checks_depth():
    _, tcfg, tree = reference_params("dit-i256")
    params = t_api.params_from_numpy(tree, tcfg, "cpu")
    bb, ref = params["backbone"], tree["backbone"]
    assert bb["class_embed"].shape == (1001, tcfg.d_model)
    assert bb["blocks"]["attn"]["wk"].shape == ref["blocks"]["attn"]["wk"].shape
    np.testing.assert_array_equal(bb["blocks"]["w1"].numpy(),
                                  ref["blocks"]["w1"])
    with pytest.raises(ValueError, match="num_layers"):
        t_api.params_from_numpy(tree, dataclasses.replace(tcfg, num_layers=3),
                                "cpu")


def test_port_init_params_match_the_reference_tree_shapes():
    jcfg, tcfg, tree = reference_params("dit-cifar")
    ours = t_api.init_params(tcfg, seed=0, device="cpu")
    shapes = jax.tree.map(np.shape, tree)
    assert jax.tree.map(lambda t: tuple(t.shape), ours) == shapes
    assert not ours["backbone"]["blocks"]["ada"].any()    # adaLN-zero
