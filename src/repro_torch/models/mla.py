"""Multi-head latent attention (MLA, DeepSeek-V2, arXiv:2405.04434), without
the query LoRA (DeepSeek-V2-Lite's). One layer:

    q          = h @ wq                      per head [q_nope, q_pe]
    c, k_pe    = split(h @ wkv_a, [kv_lora_rank, qk_rope_head_dim])
    kv         = RMSNorm(c) @ wkv_b          per head [k_nope, v]
    q_pe, k_pe = rope(q_pe), rope(k_pe)      k_pe one head, shared by all
    o          = softmax([q_nope, q_pe] . [k_nope, k_pe] * scale) v
    out        = o @ wo

with YaRN rope (`layers.yarn_rope`) and scale (qk_nope + qk_rope)^-0.5
times YaRN's mscale squared (`layers.yarn_mscale`, 1 at factor 1). The
scores are qk_nope + qk_rope deep and the values v_head_dim wide: the
flash_attention kernel takes the two as separate sizes. Params (K, N), as
every dense site's: wq (d, H (nope + rope)), wkv_a (d, rank + rope),
kv_norm {w} (rank,), wkv_b (rank, H (nope + v)), wo (H v, d).
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention import ops as fa_ops
from ..obs import trace
from .layers import (apply_rope, dense_apply, dense_init, rmsnorm,
                     rmsnorm_init, yarn_mscale, yarn_rope)


def mla_init(gen: torch.Generator, cfg, device) -> dict:
    d, H, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = cfg.weight_dtype
    return {
        "wq": dense_init(gen, d, H * (dn + dr), dt, device),
        "wkv_a": dense_init(gen, d, r + dr, dt, device),
        "kv_norm": rmsnorm_init(r, dt, device),
        "wkv_b": dense_init(gen, r, H * (dn + dv), dt, device),
        "wo": dense_init(gen, H * dv, d, dt, device),
    }


def softmax_scale(cfg) -> float:
    """(qk_nope + qk_rope)^-0.5, times mscale^2 under YaRN scaling."""
    m = yarn_mscale(cfg.rope_yarn_factor)
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


def rope_of(cfg, device):
    """The rope heads' inverse frequencies under YaRN, else None (theta's
    own)."""
    if cfg.rope_yarn_factor > 1.0:
        return yarn_rope(cfg, cfg.qk_rope_head_dim, device)
    return None


def mla_apply(params: dict, x: torch.Tensor, cfg, *,
              causal: bool = False) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), attention over positions 0..S-1."""
    B, S, _ = x.shape
    H, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    with trace.live("mla.attention"):
        q = dense_apply(x, params["wq"], cfg).reshape(B, S, H, dn + dr)
        ckv = dense_apply(x, params["wkv_a"], cfg)
        c = rmsnorm(params["kv_norm"], ckv[..., :r], eps=cfg.norm_eps)
        kv = dense_apply(c, params["wkv_b"], cfg).reshape(B, S, H, dn + dv)
        pos = torch.arange(S, device=x.device).expand(B, S)
        freqs = rope_of(cfg, x.device)
        q_pe = apply_rope(q[..., dn:], pos, cfg.rope_theta, freqs)
        k_pe = apply_rope(ckv[..., r:].reshape(B, S, 1, dr), pos,
                          cfg.rope_theta, freqs)
        q = torch.cat([q[..., :dn], q_pe], dim=-1)
        k = torch.cat([kv[..., :dn], k_pe.expand(B, S, H, dr)], dim=-1)
        out = fa_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                               kv[..., dn:].transpose(1, 2), causal=causal,
                               scale=softmax_scale(cfg),
                               backend=cfg.attention_backend).transpose(1, 2)
        return dense_apply(out.reshape(B, S, H * dv), params["wo"], cfg)

