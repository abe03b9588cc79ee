"""Llama-3.2-Vision-style VLM decoder (the port of `repro.models.vlm`):
groups of (cross_attn_every - 1) self-attention layers followed by one
gated cross-attention layer reading a fixed buffer of projected
image-patch embeddings.

The vision encoder is a stub: `image_embeds` (B, image_tokens, d_model)
arrive precomputed; the projector and the language decoder are real.
Params mirror the reference pytree: `self_groups` stacked (G, n_self, ...)
(the transformer's layers), `xattn_layers` stacked (G, ...), `embed`
(tied: the LM head is its transpose), `img_proj`, `final_ln`. The
cross-attention gates start at zero, so a fresh model's cross-attention
adds exactly nothing. The cache is {"k", "v" (G, n_self, B, W, Hkv, D):
the self-attention KV caches; "img_k", "img_v" (G, B, image_tokens, Hkv,
D): the image K/V, position-independent, projected once at prefill}.
`vlm_decode_step` writes the KV caches in place and reads the image K/V
as they are, so a CUDA graph can capture it.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import shard
from .layers import (NORMS, attention_apply, attention_init, dense_init,
                     layer_views, mlp_apply, mlp_init, sdpa, stack_trees)
from .transformer import (_attn_with_cache, _block, _embed, cache_window,
                          device_pos, layer_init, logits_from_hidden,
                          prefill_kv_cache)


def _xattn_layer_init(gen: torch.Generator, cfg, device) -> dict:
    ninit, _ = NORMS[cfg.norm]
    wd = cfg.weight_dtype
    return {
        "ln1": ninit(cfg.d_model, wd, device),
        "xattn": attention_init(gen, cfg, device),
        "gate_attn": torch.zeros((), dtype=wd, device=device),
        "ln2": ninit(cfg.d_model, wd, device),
        "mlp": mlp_init(gen, cfg, device),
        "gate_mlp": torch.zeros((), dtype=wd, device=device),
    }


def _vlm_groups(cfg) -> int:
    if cfg.num_layers % cfg.cross_attn_every:
        raise ValueError(f"num_layers={cfg.num_layers} is not a whole number "
                         f"of groups of cross_attn_every="
                         f"{cfg.cross_attn_every}")
    return cfg.num_layers // cfg.cross_attn_every


def init_vlm(cfg, gen: torch.Generator, device) -> dict:
    """Random params from the seeded generator `gen` (its own numbers, not
    the reference's jax.random ones), group by group."""
    n_self = cfg.cross_attn_every - 1
    self_groups, x_layers = [], []
    for _ in range(_vlm_groups(cfg)):
        self_groups.append(stack_trees([layer_init(gen, cfg, device)
                                        for _ in range(n_self)]))
        x_layers.append(_xattn_layer_init(gen, cfg, device))
    ninit, _ = NORMS[cfg.norm]
    wd = cfg.weight_dtype
    return {
        "embed": dense_init(gen, cfg.vocab_size, cfg.d_model, wd, device,
                            scale=0.02),
        "img_proj": dense_init(gen, cfg.d_model, cfg.d_model, wd, device),
        "self_groups": stack_trees(self_groups),       # (G, n_self, ...)
        "xattn_layers": stack_trees(x_layers),         # (G, ...)
        "final_ln": ninit(cfg.d_model, wd, device),
    }


def _gate(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """tanh of a gate in its own precision, then cast to the activations'
    (the reference's `jnp.tanh(gate).astype(h.dtype)`)."""
    return torch.tanh(g).to(like.dtype)


def _xattn_block(xp, h, img, cfg):
    _, napply = NORMS[cfg.norm]
    a = attention_apply(xp["xattn"], napply(xp["ln1"], h), cfg, kv_src=img,
                        causal=False, rope=False)
    h = h + _gate(xp["gate_attn"], h) * a
    y = mlp_apply(xp["mlp"], napply(xp["ln2"], h), cfg)
    return h + _gate(xp["gate_mlp"], h) * y


def _project_image(params, image_embeds, like) -> torch.Tensor:
    return torch.matmul(image_embeds.to(like.dtype),
                        params["img_proj"].to(like.dtype))


def _group(gp, xp, h, img, cfg, causal: bool, remat: bool):
    for lp in layer_views(gp, cfg.cross_attn_every - 1):
        h = (checkpoint(_block, lp, h, cfg, use_reentrant=False,
                        sliding_window=cfg.sliding_window, causal=causal)[0]
             if remat else _block(lp, h, cfg,
                                  sliding_window=cfg.sliding_window,
                                  causal=causal)[0])
    return _xattn_block(xp, h, img, cfg)


def vlm_forward(params, cfg, tokens, image_embeds, *, inputs_embeds=None,
                causal: bool = True) -> tuple:
    """Full-sequence forward; returns (hidden, aux = 0). The double-stacked
    self layers are unbound once a forward, group by group (indexing a
    stacked leaf would give every layer a full-stack zero gradient). With
    `cfg.remat` and grad mode on, each group and each of its self layers
    runs under activation checkpointing, as the reference remats both
    bodies."""
    _, napply = NORMS[cfg.norm]
    x = inputs_embeds if inputs_embeds is not None else _embed(params, cfg,
                                                               tokens)
    x = shard(x, "batch", "seq", "d_model")
    img = _project_image(params, image_embeds, x)
    G = _vlm_groups(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for gp, xp in zip(layer_views(params["self_groups"], G),
                      layer_views(params["xattn_layers"], G)):
        x = (checkpoint(_group, gp, xp, x, img, cfg, causal, True,
                        use_reentrant=False) if remat
             else _group(gp, xp, x, img, cfg, causal, False))
    return (napply(params["final_ln"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _forward_embeds(params, cfg, inputs_embeds, image_embeds) -> tuple:
    """The diffusion LM's entry: bidirectional, continuous inputs."""
    return vlm_forward(params, cfg, None, image_embeds,
                       inputs_embeds=inputs_embeds, causal=False)


def vlm_loss(params, cfg, tokens, targets, image_embeds) -> torch.Tensor:
    """The AR training loss, a 0-d fp32 tensor: the next-token NLL."""
    hidden, _ = vlm_forward(params, cfg, tokens, image_embeds)
    logits = logits_from_hidden(params, cfg, hidden).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long()).mean()


def init_vlm_cache(cfg, batch: int, max_len: int, device="cpu") -> dict:
    G, n_self = _vlm_groups(cfg), cfg.cross_attn_every - 1
    W = cache_window(cfg, max_len)
    kv = (G, n_self, batch, W, cfg.num_kv_heads, cfg.head_dim)
    img = (G, batch, cfg.image_tokens, cfg.num_kv_heads, cfg.head_dim)
    act = cfg.activation_dtype
    return {"k": torch.zeros(kv, dtype=act, device=device),
            "v": torch.zeros(kv, dtype=act, device=device),
            "img_k": torch.zeros(img, dtype=act, device=device),
            "img_v": torch.zeros(img, dtype=act, device=device)}


def _img_kv(xp, img, cfg) -> tuple:
    B, T = img.shape[:2]
    a = xp["xattn"]
    k = torch.matmul(img, a["wk"].to(img.dtype))
    v = torch.matmul(img, a["wv"].to(img.dtype))
    if "bk" in a:
        k = k + a["bk"].to(img.dtype)
        v = v + a["bv"].to(img.dtype)
    return (k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim))


def vlm_prefill(params, cfg, tokens, image_embeds, max_len: int) -> tuple:
    """Process a prompt over the image: the self-attention KV caches
    (re-projected from each layer's normed input, as the reference writes
    them) and each cross-attention layer's image K/V, once. Every
    attention goes through the flash_attention kernel op (the self layers
    causal, the cross layers non-causal over the image tokens)."""
    _, napply = NORMS[cfg.norm]
    B, S = tokens.shape
    W = cache_window(cfg, max_len)
    G, n_self = _vlm_groups(cfg), cfg.cross_attn_every - 1
    x = _embed(params, cfg, tokens)
    img = _project_image(params, image_embeds, x)
    pos = torch.arange(S, device=x.device).expand(B, S)
    ks, vs, iks, ivs = [], [], [], []
    for gp, xp in zip(layer_views(params["self_groups"], G),
                      layer_views(params["xattn_layers"], G)):
        gk, gv = [], []
        for lp in layer_views(gp, n_self):
            xn = napply(lp["ln1"], x)
            h2 = x + attention_apply(lp["attn"], xn, cfg, causal=True,
                                     sliding_window=cfg.sliding_window)
            x = h2 + mlp_apply(lp["mlp"], napply(lp["ln2"], h2), cfg)
            kc, vc = prefill_kv_cache(lp["attn"], xn, pos, cfg, W)
            gk.append(kc)
            gv.append(vc)
        x = _xattn_block(xp, x, img, cfg)
        ik, iv = _img_kv(xp, img, cfg)
        ks.append(torch.stack(gk))
        vs.append(torch.stack(gv))
        iks.append(ik)
        ivs.append(iv)
    hidden = napply(params["final_ln"], x[:, -1:])
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "img_k": torch.stack(iks), "img_v": torch.stack(ivs)}
    return logits_from_hidden(params, cfg, hidden), cache


def vlm_decode_step(params, cfg, cache, token, pos) -> tuple:
    """token: (B, 1); pos: an int or a 0-d integer tensor. Returns (logits
    (B, 1, V), cache): the self-attention KV slots written in place; the
    cross-attention is the plain `sdpa` against the fixed image K/V (as
    the reference's), so a decode step launches no port kernel."""
    _, napply = NORMS[cfg.norm]
    x = _embed(params, cfg, token)
    pos = device_pos(pos, x.device)
    W = cache["k"].shape[3]
    B = x.shape[0]
    G, n_self = _vlm_groups(cfg), cfg.cross_attn_every - 1
    hq, hd = cfg.num_heads, cfg.head_dim
    for gp, xp, kg, vg, ik, iv in zip(
            layer_views(params["self_groups"], G),
            layer_views(params["xattn_layers"], G), cache["k"], cache["v"],
            cache["img_k"], cache["img_v"]):
        for lp, kc, vc in zip(layer_views(gp, n_self), kg, vg):
            x = x + _attn_with_cache(lp, napply(lp["ln1"], x), kc, vc, pos,
                                     cfg, W)
            x = x + mlp_apply(lp["mlp"], napply(lp["ln2"], x), cfg)
        # cross-attention against the fixed image K/V
        a = xp["xattn"]
        xn = napply(xp["ln1"], x)
        q = torch.matmul(xn, a["wq"].to(x.dtype))
        if "bq" in a:
            q = q + a["bq"].to(x.dtype)
        o = sdpa(q.reshape(B, 1, hq, hd), ik, iv, causal=False)
        o = torch.matmul(o.reshape(B, 1, hq * hd), a["wo"].to(x.dtype))
        x = x + _gate(xp["gate_attn"], x) * o
        y = mlp_apply(xp["mlp"], napply(xp["ln2"], x), cfg)
        x = x + _gate(xp["gate_mlp"], x) * y
    hidden = napply(params["final_ln"], x)
    return logits_from_hidden(params, cfg, hidden), cache
