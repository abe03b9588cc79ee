"""Diffusion-LM head (the port of `repro.models.diffusion_lm`): turns a token
backbone into the eps-network of a continuous diffusion process over a
latent sequence (B, S, latent_dim), the vehicle for UniPC on every
architecture family (DESIGN.md §7.1).

A transformer backbone runs without a causal mask (it denoises
bidirectionally); the SSM and hybrid backbones stay causal by construction,
as the reference's do. Conditioning: sinusoidal timestep features through a
two-layer MLP, added to the input projection.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .dit import timestep_embedding
from .layers import dense_init


def init_diffusion_head(cfg, gen: torch.Generator, device) -> dict:
    d, L = cfg.d_model, cfg.latent_dim
    dt = cfg.weight_dtype
    return {
        "in_proj": dense_init(gen, L, d, dt, device),
        "t_mlp1": dense_init(gen, 256, d, dt, device),
        "t_mlp2": dense_init(gen, d, d, dt, device),
        "out_proj": torch.zeros((d, L), dtype=dt, device=device),
    }


def diffusion_lm_apply(head, backbone_forward, cfg, x_t, t) -> torch.Tensor:
    """x_t: (B, S, latent_dim); t scalar or (B,). backbone_forward:
    (inputs_embeds) -> (hidden, aux). Returns eps-hat (B, S, latent_dim) in
    the activation dtype."""
    B = x_t.shape[0]
    act = cfg.activation_dtype
    t = torch.as_tensor(t, dtype=torch.float32, device=x_t.device).expand(B)
    h = torch.matmul(x_t.to(act), head["in_proj"].to(act))
    c = F.silu(torch.matmul(timestep_embedding(t, 256),
                            head["t_mlp1"].to(torch.float32)))
    c = torch.matmul(c, head["t_mlp2"].to(torch.float32))
    h = h + c.to(h.dtype)[:, None]
    hidden, _aux = backbone_forward(h)
    return torch.matmul(hidden, head["out_proj"].to(hidden.dtype))
