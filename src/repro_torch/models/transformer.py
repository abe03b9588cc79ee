"""Decoder-only transformer LM, dense or MoE blocks (the port of
`repro.models.transformer`).

Serves qwen2-0.5b / qwen2.5-3b / olmo-1b / deepseek-67b (dense) and, with
`cfg.num_experts > 0`, mixtral-8x7b / granite-moe (MoE), and
deepseek-v2-lite: latent attention (`models/mla.py`, `cfg.kv_lora_rank`),
`cfg.first_k_dense` leading dense layers (stacked apart, as
`dense_layers`), then MoE layers with shared experts, dispatched dropless
(`cfg.moe_dropless`); its forward only (no decode cache). Three entry
points:

  forward(params, cfg, tokens)                -> (hidden (B, S, d), aux)
  lm_loss(params, cfg, tokens, targets)       -> the AR training loss
  prefill(params, cfg, tokens, max_len)       -> (logits_last, cache)
  decode_step(params, cfg, cache, tok, pos)   -> (logits, cache)

Params mirror the reference pytree: `layers` holds each layer parameter
stacked over layers as (L, ...), looped over as the reference scans them.
KV caches are (L, B, W, Hkv, D) stacked over layers, where W is `max_len`
(full cache) or `cfg.sliding_window` (rolling cache). Keys are stored
rope'd at their true positions. `decode_step` writes the new token's K/V
into the cache in place, at slot `pos % W` computed on the device from a
0-d device `pos`, and builds the rolling-window mask there too, so a CUDA
graph can capture the step (the reference's `jax.jit(decode)`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import current_mesh, shard
from .layers import (NORMS, apply_rope, attention_apply, attention_init,
                     dense_init, layer_views, mlp_apply, mlp_init,
                     stack_trees)
from .mla import mla_apply, mla_init
from .moe import (moe_apply, moe_apply_dropless, moe_apply_shard_map,
                  moe_decode_apply, moe_init)


def layer_init(gen: torch.Generator, cfg, device, dense: bool = False) -> dict:
    ninit, _ = NORMS[cfg.norm]
    p = {
        "ln1": ninit(cfg.d_model, cfg.weight_dtype, device),
        "attn": (mla_init(gen, cfg, device) if cfg.kv_lora_rank
                 else attention_init(gen, cfg, device)),
        "ln2": ninit(cfg.d_model, cfg.weight_dtype, device),
    }
    if cfg.num_experts and not dense:
        p["moe"] = moe_init(gen, cfg, device)
    else:
        p["mlp"] = mlp_init(gen, cfg, device)
    return p


def init_lm(cfg, gen: torch.Generator, device) -> dict:
    """Random LM params from the seeded generator `gen` (its own numbers,
    not the reference's jax.random ones). The `cfg.first_k_dense` leading
    layers are stacked apart, as `dense_layers`."""
    ninit, _ = NORMS[cfg.norm]
    k = cfg.first_k_dense
    dense = [layer_init(gen, cfg, device, dense=True) for _ in range(k)]
    layers = [layer_init(gen, cfg, device) for _ in range(cfg.num_layers - k)]
    p = {
        "embed": dense_init(gen, cfg.vocab_size, cfg.d_model,
                            cfg.weight_dtype, device, scale=0.02),
        "layers": stack_trees(layers),
        "final_ln": ninit(cfg.d_model, cfg.weight_dtype, device),
    }
    if dense:
        p["dense_layers"] = stack_trees(dense)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                  cfg.weight_dtype, device)
    return p


def _embed(params, cfg, tokens):
    return params["embed"].to(cfg.activation_dtype)[tokens]


def _block(lp, x, cfg, *, sliding_window, causal=True, counter=None):
    _, napply = NORMS[cfg.norm]
    xn = napply(lp["ln1"], x, eps=cfg.norm_eps)
    if cfg.kv_lora_rank:
        h = mla_apply(lp["attn"], xn, cfg, causal=causal)
    else:
        h = attention_apply(lp["attn"], xn, cfg, causal=causal,
                            sliding_window=sliding_window)
    x = x + h
    y = napply(lp["ln2"], x, eps=cfg.norm_eps)
    if "moe" in lp:
        mesh = current_mesh()
        if cfg.moe_dropless:
            y, aux = moe_apply_dropless(lp["moe"], y, cfg, counter)
        elif cfg.moe_shard_map and mesh is not None:
            y, aux = moe_apply_shard_map(lp["moe"], y, cfg, mesh)
        else:
            y, aux = moe_apply(lp["moe"], y, cfg)
    else:
        y = mlp_apply(lp["mlp"], y, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def forward(params, cfg, tokens, *, causal: bool = True,
            inputs_embeds: Optional[torch.Tensor] = None,
            counter: Optional[torch.Tensor] = None) -> tuple:
    """Full-sequence forward; returns (hidden, aux_loss). With `cfg.remat`
    and grad mode on, each block runs under activation checkpointing
    (`torch.utils.checkpoint`, the reference's per-block `jax.checkpoint`):
    the same values, the block's activations recomputed in the backward.
    The `dense_layers` run first. `counter` (MoE layers, experts) int64 on
    the device, where given, gains each dropless layer's rows per expert."""
    x = inputs_embeds if inputs_embeds is not None else _embed(params, cfg,
                                                               tokens)
    x = shard(x, "batch", "seq", "d_model")
    block = functools.partial(_block, cfg=cfg,
                              sliding_window=cfg.sliding_window,
                              causal=causal)
    remat = cfg.remat and torch.is_grad_enabled()
    k = cfg.first_k_dense
    layers = (layer_views(params["dense_layers"], k) if k else []) + \
        layer_views(params["layers"], cfg.num_layers - k)
    auxs = []
    for i, lp in enumerate(layers):
        row = counter[i - k] if counter is not None and i >= k else None
        x, aux = (checkpoint(block, lp, x, use_reentrant=False, counter=row)
                  if remat else block(lp, x, counter=row))
        auxs.append(aux)
    _, napply = NORMS[cfg.norm]
    return (napply(params["final_ln"], x, eps=cfg.norm_eps),
            torch.sum(torch.stack(auxs)))


def logits_from_hidden(params, cfg, hidden) -> torch.Tensor:
    w = (params["embed"].T if cfg.tie_embeddings or "lm_head" not in params
         else params["lm_head"])
    return shard(torch.matmul(hidden, w.to(hidden.dtype)), "batch", "seq",
                 "vocab")


def lm_loss(params, cfg, tokens, targets) -> torch.Tensor:
    """The AR training loss, a 0-d fp32 tensor: the next-token NLL (fp32
    log-softmax of the logits) plus `cfg.router_aux_weight` times the
    router's aux loss, differentiable through both, as the reference's."""
    hidden, aux = forward(params, cfg, tokens)
    logits = logits_from_hidden(params, cfg, hidden).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long()).mean()
    return nll + cfg.router_aux_weight * aux


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with stacked KV caches
# ---------------------------------------------------------------------------

def cache_window(cfg, max_len: int) -> int:
    return min(cfg.sliding_window, max_len) if cfg.sliding_window else max_len


def _refuse_latent(cfg, what: str) -> None:
    if cfg.kv_lora_rank or cfg.first_k_dense:
        raise ValueError(f"{what}: {cfg.arch_id!r} runs latent attention "
                         f"and leading dense layers, whose decode cache "
                         f"the port does not have (its forward, the "
                         f"diffusion LM's eps-net and the AR loss run)")


def init_cache(cfg, batch: int, max_len: int, device="cpu") -> dict:
    _refuse_latent(cfg, "init_cache")
    W = cache_window(cfg, max_len)
    shape = (cfg.num_layers, batch, W, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.activation_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.activation_dtype, device=device)}


def device_pos(pos, device) -> torch.Tensor:
    """`pos` as a 0-d int64 tensor on `device`: a tensor as it is (moved if
    it must be), a host int by a device fill, not a host-to-device copy,
    so a CUDA graph can capture it (ROADMAP C6)."""
    if torch.is_tensor(pos):
        return pos.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), int(pos), dtype=torch.int64, device=device)


def _attn_with_cache(lp, x_tok, k_cache, v_cache, pos, cfg, W):
    """x_tok: (B, 1, d); cache slices (B, W, Hkv, D), written in place at
    slot pos % W; pos: a 0-d int64 device tensor."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B = x_tok.shape[0]
    a = lp["attn"]
    q = torch.matmul(x_tok, a["wq"].to(x_tok.dtype))
    k = torch.matmul(x_tok, a["wk"].to(x_tok.dtype))
    v = torch.matmul(x_tok, a["wv"].to(x_tok.dtype))
    if "bq" in a:
        q = q + a["bq"].to(x_tok.dtype)
        k = k + a["bk"].to(x_tok.dtype)
        v = v + a["bv"].to(x_tok.dtype)
    q = q.reshape(B, 1, hq, hd)
    k = k.reshape(B, 1, hkv, hd)
    v = v.reshape(B, 1, hkv, hd)
    posb = pos.reshape(1, 1).expand(B, 1)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    slot = torch.remainder(pos, W).reshape(1)
    k_cache.index_copy_(1, slot, k)
    v_cache.index_copy_(1, slot, v)
    # slot j holds position pos - ((pos - j) mod W); valid if <= pos (always,
    # once written) and > pos - W (rolling window): unwritten slots masked
    j = torch.arange(W, device=x_tok.device)
    key_pos = pos - torch.remainder(pos - j, W)
    valid = key_pos >= torch.clamp(pos - W + 1, min=0)
    if cfg.sliding_window:
        valid = valid & (key_pos > pos - cfg.sliding_window)
    logits = torch.einsum("bqhgd,bkhd->bhgqk",
                          q.reshape(B, 1, hkv, hq // hkv, hd),
                          k_cache).to(torch.float32)
    logits = logits / math.sqrt(hd)
    logits = logits.masked_fill(~valid, -1e30)
    # the softmax goes back to q's dtype before the product with v, as the
    # reference writes it (the flash kernel keeps fp32 p.v instead)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v_cache).reshape(B, 1, hq * hd)
    return torch.matmul(out, a["wo"].to(x_tok.dtype))


def decode_step(params, cfg, cache, token, pos) -> tuple:
    """token: (B, 1) integers; pos: an int or a 0-d integer tensor. Returns
    (logits (B, 1, V), cache), the cache updated in place."""
    _refuse_latent(cfg, "decode_step")
    _, napply = NORMS[cfg.norm]
    x = shard(_embed(params, cfg, token), "batch", "seq", "d_model")
    pos = device_pos(pos, x.device)
    W = cache["k"].shape[2]
    layers = layer_views(params["layers"], cfg.num_layers)
    for lp, kc, vc in zip(layers, cache["k"], cache["v"]):
        x = x + _attn_with_cache(lp, napply(lp["ln1"], x), kc, vc, pos, cfg, W)
        y = napply(lp["ln2"], x)
        if cfg.num_experts:
            y = moe_decode_apply(lp["moe"], y, cfg)
        else:
            y = mlp_apply(lp["mlp"], y, cfg)
        x = x + y
    hidden = napply(params["final_ln"], x)
    return logits_from_hidden(params, cfg, hidden), cache


def prefill_kv_cache(at, xn, pos, cfg, W: int) -> tuple:
    """One attention layer's KV cache (B, W, Hkv, D) rebuilt from its normed
    input xn (B, S, d) at positions `pos` (B, S): the keys rope'd, the last
    W positions kept at slot position mod W (zero slots past a shorter
    prompt), as the decode path's incremental writes would leave it."""
    B, S = xn.shape[:2]
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    k = torch.matmul(xn, at["wk"].to(xn.dtype))
    v = torch.matmul(xn, at["wv"].to(xn.dtype))
    if "bk" in at:
        k = k + at["bk"].to(xn.dtype)
        v = v + at["bv"].to(xn.dtype)
    k = apply_rope(k.reshape(B, S, hkv, hd), pos, cfg.rope_theta)
    v = v.reshape(B, S, hkv, hd)
    if S < W:
        pad = (0, 0, 0, 0, 0, W - S)
        return (torch.nn.functional.pad(k, pad),
                torch.nn.functional.pad(v, pad))
    # keep positions S-W..S-1, placed at slot = position mod W
    slots = torch.remainder(torch.arange(S - W, S, device=xn.device), W)
    zeros = torch.zeros((B, W, hkv, hd), dtype=k.dtype, device=xn.device)
    return (zeros.index_copy(1, slots, k[:, S - W:]),
            zeros.index_copy(1, slots, v[:, S - W:]))


def prefill(params, cfg, tokens, max_len: int) -> tuple:
    """Process a full prompt, build the cache, return last-position logits.

    The cache is built by re-projecting K/V from each layer's normed input
    (equivalent to the decode path's incremental writes), as the reference
    writes it; attention itself goes through the flash_attention kernel op
    (causal, GQA, the config's window)."""
    _refuse_latent(cfg, "prefill")
    _, napply = NORMS[cfg.norm]
    B, S = tokens.shape
    W = cache_window(cfg, max_len)
    x = shard(_embed(params, cfg, tokens), "batch", "seq", "d_model")
    pos = torch.arange(S, device=x.device).expand(B, S)
    ks, vs = [], []
    for lp in layer_views(params["layers"], cfg.num_layers):
        xn = napply(lp["ln1"], x)
        a = attention_apply(lp["attn"], xn, cfg, causal=True,
                            sliding_window=cfg.sliding_window)
        h2 = x + a
        y = napply(lp["ln2"], h2)
        if cfg.num_experts:
            y, _ = moe_apply(lp["moe"], y, cfg)
        else:
            y = mlp_apply(lp["mlp"], y, cfg)
        kc, vc = prefill_kv_cache(lp["attn"], xn, pos, cfg, W)
        ks.append(kc)
        vs.append(vc)
        x = h2 + y
    hidden = napply(params["final_ln"], x[:, -1:])
    return (logits_from_hidden(params, cfg, hidden),
            {"k": torch.stack(ks), "v": torch.stack(vs)})
