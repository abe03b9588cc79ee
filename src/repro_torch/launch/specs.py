"""Abstract input, param and cache specs and their sharding inference for
the dry run (the port of `repro/launch/specs.py`).

The reference's stand-ins are `jax.ShapeDtypeStruct`s; the port's are
tensors on the meta device: shapes and dtypes, no allocation, and every
op of the port runs on them (computing nothing), so the dry run can count
a whole step on them. `device` builds the same specs as real tensors (zeros
for the inputs), for the runs that hold the meta count against the card's.

Param shardings are inferred from leaf *path names* (the weight naming
convention is uniform across families) with divisibility guards; cache
shardings likewise. Logical axes ('fsdp' / 'model' / 'batch' / 'kv_seq')
resolve through the given rule set (`parallel/sharding.py`), so train uses
2D FSDPxTP weight sharding while serve replicates over data. The trees of
`NamedSharding`s mirror the port's dict trees (of meta or real tensors);
on an abstract production mesh their `shard_shape`s give each chip's bytes.
"""

from __future__ import annotations

import math
import re

import torch
from torch.utils._pytree import (MappingKey, tree_flatten_with_path,
                                  tree_leaves, tree_map)

from ..parallel.sharding import NamedSharding, P, resolve_spec

from ..configs.base import InputShape, ModelConfig
from ..models import api


def input_specs(cfg: ModelConfig, shape: InputShape, objective: str = "ar",
                device="meta") -> dict:
    """The batch dict of the given workload shape: the reference's keys,
    shapes and dtypes (int32 tokens)."""
    B, S = shape.global_batch, shape.seq_len
    act = cfg.activation_dtype

    def F(dims, dtype):
        return torch.zeros(dims, dtype=dtype, device=device)

    if shape.kind == "train":
        batch = {"tokens": F((B, S), torch.int32),
                 "targets": F((B, S), torch.int32)}
        if objective == "diffusion" and cfg.family == "dit":
            batch = {"latents": F((B, cfg.patch_tokens, cfg.latent_dim), act),
                     "class_ids": F((B,), torch.int32)}
    elif shape.kind == "prefill":
        batch = {"tokens": F((B, S), torch.int32)}
    else:  # decode: ONE token against a seq_len-deep cache
        batch = {"tokens": F((B, 1), torch.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = F((B, cfg.image_tokens, cfg.d_model), act)
    if cfg.family == "audio" and shape.kind != "decode":
        batch["audio_embeds"] = F((B, cfg.audio_frames, cfg.d_model), act)
    return batch


def abstract_params(cfg: ModelConfig, device="meta") -> dict:
    """`api.init_params` on the meta device: every leaf's shape and dtype."""
    return api.init_params(cfg, device=device)


def abstract_cache(cfg: ModelConfig, shape: InputShape, device="meta"):
    """The decode cache of a seq_len-deep batch: `api.init_cache`, or for
    the audio family the cache of a short prefill (its cross K/V included),
    as the reference's."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        batch = {"tokens": torch.zeros((B, min(S, 8)), dtype=torch.int32,
                                       device=device),
                 "audio_embeds": torch.zeros(
                     (B, cfg.audio_frames, cfg.d_model),
                     dtype=cfg.activation_dtype, device=device)}
        with torch.no_grad():
            _, cache = api.prefill_fn(cfg)(abstract_params(cfg, device),
                                           batch, S)
        return cache
    return api.init_cache(cfg, B, S, device)


# ---------------------------------------------------------------------------
# sharding inference
# ---------------------------------------------------------------------------

# leaf-name -> logical spec for the trailing dims (earlier dims: None/stack)
_PARAM_RULES = [
    (r"(w_down|wo|out_proj)$", ("model", "fsdp")),
    (r"(w_gate|w_up|wq|wk|wv|in_proj|lm_head|w1|w2|ada|img_proj|t_mlp\d)$",
     ("fsdp", "model")),
    (r"(embed|token_latents|class_embed)$", ("model", "fsdp")),
    (r"router$", ("fsdp", None)),
    (r"conv_w$", (None, "model")),
]

_CACHE_KV_KEYS = {"k", "v", "attn_k", "attn_v", "img_k", "img_v", "xk", "xv"}


def _guard(spec_entries, shape, mesh, rules) -> P:
    """Map logical names -> mesh axes, dropping any that don't divide evenly,
    are absent from this mesh, or were already claimed by an earlier dim."""
    return resolve_spec(mesh, rules, shape, spec_entries)


def _named_leaves(tree):
    """(last dict key or "", leaf) of each leaf, and the tree's spec."""
    flat, treedef = tree_flatten_with_path(tree)
    return [(str(path[-1].key) if path and isinstance(path[-1], MappingKey)
             else "", leaf) for path, leaf in flat], treedef


def param_shardings(params_abstract, mesh, rules: dict):
    leaves, treedef = _named_leaves(params_abstract)
    out = []
    for name, leaf in leaves:
        spec = None
        for pat, trailing in _PARAM_RULES:
            if re.search(pat, name):
                nd = leaf.dim()
                t = list(trailing)[-nd:] if nd < len(trailing) else list(trailing)
                entries = [None] * (nd - len(t)) + t
                spec = _guard(entries, leaf.shape, mesh, rules)
                break
        if spec is None:
            if leaf.dim() >= 2:
                entries = [None] * (leaf.dim() - 2) + ["fsdp", "model"]
                spec = _guard(entries, leaf.shape, mesh, rules)
            else:
                spec = P()
        out.append(NamedSharding(mesh, spec))
    return treedef.unflatten(out)


def cache_shardings(cache_abstract, mesh, rules: dict):
    leaves, treedef = _named_leaves(cache_abstract)
    out = []
    for name, leaf in leaves:
        nd = leaf.dim()
        if name in _CACHE_KV_KEYS:
            # (..., B, W, Hkv, D)
            entries = [None] * (nd - 4) + ["batch", "kv_seq", "kv_heads", None]
        elif name == "ssm":
            # (..., B, H, P, N)
            entries = [None] * (nd - 4) + ["batch", "heads", None, None]
        elif name == "conv":
            # (..., B, K, C)
            entries = [None] * (nd - 3) + ["batch", None, "d_ff"]
        else:
            entries = [None] * nd
        out.append(NamedSharding(mesh, _guard(entries, leaf.shape, mesh, rules)))
    return treedef.unflatten(out)


def batch_shardings(batch_abstract, mesh, rules: dict):
    def f(leaf):
        entries = ["batch"] + [None] * (leaf.dim() - 1)
        return NamedSharding(mesh, _guard(entries, leaf.shape, mesh, rules))

    return tree_map(f, batch_abstract)


def shard_bytes(tree, shardings) -> int:
    """The bytes one chip holds of `tree` (tensors) under `shardings` (the
    same tree of NamedShardings): each leaf's `shard_shape` at its dtype."""
    return sum(math.prod(s.shard_shape(t.shape)) * t.element_size()
               for t, s in zip(tree_leaves(tree), tree_leaves(shardings),
                               strict=True))
