"""Shared neural building blocks, float path (the port of `repro.models.layers`).

Params are nested dicts of tensors in the reference's layout: dense
weights are (K, N), so `x @ w` is the reference's einsum "...k,kn->...n".
"""

from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import ops as fa_ops
from ..kernels.quant_matmul import ops as qmm_ops


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32)
    return (scale * w).to(dtype)


def dense_apply(x: torch.Tensor, w, cfg=None) -> torch.Tensor:
    """x (..., K) @ w — the one dense contraction every weight site routes
    through. `w` is a raw (K, N) tensor, cast to x's dtype at use and
    multiplied by torch.matmul (as the reference leaves it to XLA), or a
    quant record {"qw", "ws"[, "sa"]} installed by
    `models.quant.quantize_params`, which goes through the quant_matmul
    kernel op with `cfg.quant_backend`."""
    if isinstance(w, dict):
        return qmm_ops.quant_matmul(x, w["qw"], w["ws"], sa=w.get("sa"),
                                    backend=getattr(cfg, "quant_backend",
                                                    None))
    return torch.matmul(x, w.to(x.dtype))


def attention_init(gen: torch.Generator, cfg, device) -> dict:
    d = cfg.d_model
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.weight_dtype
    return {
        "wq": dense_init(gen, d, hq * hd, dt, device),
        "wk": dense_init(gen, d, hkv * hd, dt, device),
        "wv": dense_init(gen, d, hkv * hd, dt, device),
        "wo": dense_init(gen, hq * hd, d, dt, device),
    }


def attention_apply(params: dict, x: torch.Tensor, cfg, *,
                    causal: bool = True, tap=None) -> torch.Tensor:
    """Full-sequence self-attention without rotary embeddings (the DiT's
    form of `repro.models.layers.attention_apply(rope=False)`), through the
    flash_attention kernel op. The head-major views of the (B, S, H, D)
    projections go to the kernel as strides, not copies. `tap` is the
    calibration hook of models/quant.py (None everywhere else): it sees the
    projections' input as "qkv" and the attention output as "wo"."""
    B, S = x.shape[:2]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if tap is not None:
        tap("qkv", x)
    q = dense_apply(x, params["wq"], cfg).reshape(B, S, hq, hd)
    k = dense_apply(x, params["wk"], cfg).reshape(B, S, hkv, hd)
    v = dense_apply(x, params["wv"], cfg).reshape(B, S, hkv, hd)
    out = fa_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal,
                           backend=cfg.attention_backend).transpose(1, 2)
    out = out.reshape(B, S, hq * hd)
    if tap is not None:
        tap("wo", out)
    return dense_apply(out, params["wo"], cfg)
