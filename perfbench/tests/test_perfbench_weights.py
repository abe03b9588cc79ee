"""What a configuration file names resolves as it did for the DiT files:
their weights drawn bit for bit as before (digests pinned at the parent
commit), their port configuration the same; and for another family, its
weights, its ModelConfig fields and its sample shape from the file."""

import dataclasses
import hashlib

import pytest
import torch

from perfbench import harness, weights
from perfbench.tests import tiny

FILES = ["dit-i256", "dit-s4-cifar", "dit-i256-w8a16"]
SEED = 2 ** 31 + 4242
# each file's own latent and classes, the widths cut
CUT = dict(num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=256)
# every leaf's digest at SEED under CUT, as weights.py drew them before
# configurations named their weights (the conditional files; the CIFAR
# file's differ where its latent width reaches)
BLOCKS = {
    "backbone/blocks/ada": "9aafbdf2f86139e7",
    "backbone/blocks/ada_b": "33fb9df62d65170d",
    "backbone/blocks/attn/wk": "b2f2e38d53f684a8",
    "backbone/blocks/attn/wo": "463870ef56632a1f",
    "backbone/blocks/attn/wq": "bd51a332ecae34fb",
    "backbone/blocks/attn/wv": "30b9154c82026aa0",
    "backbone/blocks/w1": "996f2213e09a36a0",
    "backbone/blocks/w2": "0253878e535d3afe",
}
I256 = {**BLOCKS,
        "backbone/class_embed": "e75ad732ea441766",
        "backbone/final_ada": "d7f7d1c2f7e7918c",
        "backbone/final_ada_b": "361c69df4ca35a8c",
        "backbone/in_proj": "379bd65097f75585",
        "backbone/out_proj": "b364cb9d2a85d778",
        "backbone/t_mlp1": "811eb3ef469ffdbf",
        "backbone/t_mlp2": "540c63b8dbeb7ab8"}
DIGESTS = {
    "dit-i256": I256,
    "dit-i256-w8a16": I256,
    "dit-s4-cifar": {**BLOCKS,
                     "backbone/final_ada": "6372d76d507cc763",
                     "backbone/final_ada_b": "69caed4ae7b066ff",
                     "backbone/in_proj": "7613c97123c5efeb",
                     "backbone/out_proj": "6607617c423aae6b",
                     "backbone/t_mlp1": "dfbecf5cf22ea2ff",
                     "backbone/t_mlp2": "5fce9db5c8933bbc"},
}


def load(name: str) -> dict:
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


def leaves(tree: dict, path: str = ""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


def digest(t: torch.Tensor) -> str:
    h = hashlib.sha256(f"{tuple(t.shape)} {t.dtype}".encode())
    h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", FILES)
def test_dit_weights_are_drawn_as_before(name):
    cfg = load(name)
    assert "weights" not in cfg          # the default, `dit`
    cfg.update(CUT)
    got = weights.make_params(cfg, SEED, torch.device("cpu"))
    assert {k: digest(v) for k, v in leaves(got)} == DIGESTS[name]


@pytest.mark.parametrize("name", FILES)
def test_port_config_of_the_dit_files_is_as_before(name):
    from repro_torch.configs.registry import get_config

    cfg = load(name)
    before = dataclasses.replace(
        get_config(cfg["arch"]), num_layers=cfg["num_layers"],
        d_model=cfg["d_model"], num_heads=cfg["num_heads"],
        num_kv_heads=cfg["num_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["d_ff"], patch_tokens=cfg["patch_tokens"],
        latent_dim=cfg["latent_dim"], dtype=cfg["dtype"],
        param_dtype=cfg["param_dtype"])
    assert harness.port_config(cfg) == before
    assert harness.sample_shape(cfg) == (cfg["patch_tokens"],
                                         cfg["latent_dim"])


def test_port_config_takes_a_familys_fields_from_the_file():
    cfg = dict(tiny.HYBRID, num_kv_heads=2)
    pc = harness.port_config(cfg)
    assert (pc.family, pc.num_kv_heads, pc.ssm_groups, pc.attn_every,
            pc.ssm_state, pc.vocab_size) == ("hybrid", 2, 2, 2, 16, 64)
    assert pc.patch_tokens == 0           # the registry's: not a DiT
    assert harness.port_config(tiny.HYBRID).num_kv_heads == 4
    assert harness.sample_shape(tiny.HYBRID) == (16, 8)
    with pytest.raises(ValueError, match="ssm_grups"):
        harness.port_config(dict(tiny.HYBRID, port={"ssm_grups": 2}))


def test_weights_of_another_family_are_found_by_name(monkeypatch, tmp_path):
    tiny.hybrid(monkeypatch, tmp_path)
    p = weights.make_params(tiny.HYBRID, SEED, torch.device("cpu"))
    again = weights.make_params(tiny.HYBRID, SEED, torch.device("cpu"))
    assert set(p) == {"backbone", "diffusion_head", "token_latents"}
    assert p["backbone"]["groups"]["mamba"]["in_proj"].shape[:2] == (1, 2)
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(leaves(p), leaves(again)))
    assert float(p["diffusion_head"]["out_proj"].abs().max()) > 0
    with pytest.raises(ModuleNotFoundError):
        weights.make_params(dict(tiny.HYBRID, weights="nonesuch"), SEED,
                            torch.device("cpu"))
