"""Per-family model API, DiT family (the port's slice of `repro.models.api`)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..configs.base import ModelConfig
from .dit import dit_apply, init_dit

NUM_CLASSES = 1000  # init_params allocates NUM_CLASSES + 1 embeddings; the
                    # extra row is the CFG null class


def _require_dit(cfg: ModelConfig):
    if cfg.family != "dit":
        raise NotImplementedError(f"family {cfg.family!r} is not yet ported "
                                  f"(only the dit family is)")


def init_params(cfg: ModelConfig, seed: int = 0, device="cpu") -> dict:
    """Random params from a seeded torch.Generator on `device`."""
    _require_dit(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {"backbone": init_dit(cfg, gen, device, num_classes=NUM_CLASSES)}


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The port's params from the reference's `init_params` pytree given as
    nested dicts of numpy arrays (stacked (L, ...) blocks, (K, N) dense
    layout, class_embed (NUM_CLASSES + 1, d)). Same layout, same values."""
    _require_dit(cfg)
    blocks = tree["backbone"]["blocks"]
    if np.shape(blocks["w1"])[0] != cfg.num_layers:
        raise ValueError(f"blocks are stacked over {np.shape(blocks['w1'])[0]} "
                         f"layers, cfg has num_layers={cfg.num_layers}")

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.as_tensor(np.asarray(node)).to(device=device,
                                                     dtype=cfg.weight_dtype)

    return conv(tree)


def params_to(params: dict, device) -> dict:
    """The same params on `device` (no copy where they already are)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


def eps_network(cfg: ModelConfig) -> Callable:
    """(params, x_t (B, S, L), t, batch) -> eps-hat — what UniPC samples from."""
    _require_dit(cfg)
    return lambda p, x_t, t, batch: dit_apply(
        p["backbone"], cfg, x_t, t, batch.get("class_ids"))
