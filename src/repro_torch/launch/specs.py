"""Abstract input, param and cache specs for the dry run (the port of the
first half of `repro/launch/specs.py`; its sharding half, the param, cache
and batch shardings, belongs to the mesh layer, ROADMAP 12e).

The reference's stand-ins are `jax.ShapeDtypeStruct`s; the port's are
tensors on the meta device: shapes and dtypes, no allocation, and every
op of the port runs on them (computing nothing), so the dry run can count
a whole step on them. `device` builds the same specs as real tensors (zeros
for the inputs), for the runs that hold the meta count against the card's.
"""

from __future__ import annotations

import torch

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
