"""Whisper-style encoder-decoder, the audio family (the port of
`repro.models.encdec`).

The mel-spectrogram and conv feature extractor is a stub: `audio_embeds`
(B, audio_frames, d_model) arrive precomputed. Encoder: bidirectional
attention with sinusoidal positions, no rope. Decoder: causal
self-attention with rope, then cross-attention to the encoder output.
Params mirror the reference pytree: `enc_layers` and `dec_layers` stacked
(L, ...), `enc_ln`, `final_ln`, `embed` (tied: the LM head is its
transpose). The cache exists only as prefill's output: {"k", "v" (L, B,
W, Hkv, D): the decoder's self-attention KV caches; "xk", "xv" (L, B,
audio_frames, Hkv, D): each layer's cross K/V over the encoder output,
projected once}. `encdec_decode_step` writes the KV caches in place and
reads the cross K/V as they are, so a CUDA graph can capture it.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import shard
from .layers import (NORMS, attention_apply, attention_init, dense_init,
                     layer_views, mlp_apply, mlp_init, sdpa, stack_trees)
from .transformer import (_attn_with_cache, _embed, cache_window,
                          device_pos, logits_from_hidden, prefill_kv_cache)


# -log(1e4) as the reference's fp32 product sees it (a weak-typed Python
# float next to an fp32 array)
_NEG_LOG_1E4 = float(torch.tensor(-math.log(10000.0), dtype=torch.float32))


def _fp32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp32 and held in float64."""
    return x.to(torch.float32).to(torch.float64)


def sinusoids(length: int, d: int, device="cpu") -> torch.Tensor:
    """(length, d) fp32: sin then cos of position x exp(-log(1e4) i /
    (d/2 - 1)), the reference's formula in its order of operations, each
    step computed in float64 and rounded to fp32: the fp32 result correctly
    rounded, the same on every device. (The reference's fp32 exp, and
    torch's, are each up to 1 ulp off in about a tenth of the
    frequencies, and the position multiplies that into the angle.)"""
    half = d // 2
    i = torch.arange(half, dtype=torch.float64, device=device)
    freqs = _fp32(torch.exp(_fp32(_fp32(_NEG_LOG_1E4 * i) / (half - 1))))
    ang = _fp32(torch.arange(length, dtype=torch.float64,
                             device=device)[:, None] * freqs[None])
    return torch.cat([torch.sin(ang), torch.cos(ang)],
                     dim=-1).to(torch.float32)


def _enc_layer_init(gen: torch.Generator, cfg, device) -> dict:
    ninit, _ = NORMS[cfg.norm]
    wd = cfg.weight_dtype
    return {"ln1": ninit(cfg.d_model, wd, device),
            "attn": attention_init(gen, cfg, device),
            "ln2": ninit(cfg.d_model, wd, device),
            "mlp": mlp_init(gen, cfg, device)}


def _dec_layer_init(gen: torch.Generator, cfg, device) -> dict:
    ninit, _ = NORMS[cfg.norm]
    wd = cfg.weight_dtype
    return {"ln1": ninit(cfg.d_model, wd, device),
            "attn": attention_init(gen, cfg, device),
            "lnx": ninit(cfg.d_model, wd, device),
            "xattn": attention_init(gen, cfg, device),
            "ln2": ninit(cfg.d_model, wd, device),
            "mlp": mlp_init(gen, cfg, device)}


def init_encdec(cfg, gen: torch.Generator, device) -> dict:
    """Random params from the seeded generator `gen` (its own numbers, not
    the reference's jax.random ones)."""
    ninit, _ = NORMS[cfg.norm]
    wd = cfg.weight_dtype
    enc = [_enc_layer_init(gen, cfg, device)
           for _ in range(cfg.encoder_layers)]
    dec = [_dec_layer_init(gen, cfg, device) for _ in range(cfg.num_layers)]
    return {
        "embed": dense_init(gen, cfg.vocab_size, cfg.d_model, wd, device,
                            scale=0.02),
        "enc_layers": stack_trees(enc),
        "enc_ln": ninit(cfg.d_model, wd, device),
        "dec_layers": stack_trees(dec),
        "final_ln": ninit(cfg.d_model, wd, device),
    }


def _enc_block(lp, h, cfg):
    _, napply = NORMS[cfg.norm]
    h = h + attention_apply(lp["attn"], napply(lp["ln1"], h), cfg,
                            causal=False, rope=False)
    return h + mlp_apply(lp["mlp"], napply(lp["ln2"], h), cfg)


def encode(params, cfg, audio_embeds) -> torch.Tensor:
    """The encoder over the frames: sinusoidal positions added, then
    non-causal attention layers (the flash_attention kernel op); with
    `cfg.remat` and grad mode on, each layer under activation
    checkpointing."""
    _, napply = NORMS[cfg.norm]
    x = audio_embeds.to(cfg.activation_dtype)
    x = x + sinusoids(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    x = shard(x, "batch", "seq", "d_model")
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layer_views(params["enc_layers"], cfg.encoder_layers):
        x = (checkpoint(_enc_block, lp, x, cfg, use_reentrant=False)
             if remat else _enc_block(lp, x, cfg))
    return napply(params["enc_ln"], x)


def _dec_block(lp, h, enc_out, cfg, *, causal: bool = True):
    _, napply = NORMS[cfg.norm]
    h = h + attention_apply(lp["attn"], napply(lp["ln1"], h), cfg,
                            causal=causal)
    h = h + attention_apply(lp["xattn"], napply(lp["lnx"], h), cfg,
                            kv_src=enc_out, causal=False, rope=False)
    return h + mlp_apply(lp["mlp"], napply(lp["ln2"], h), cfg)


def encdec_forward(params, cfg, tokens, audio_embeds, *, inputs_embeds=None,
                   causal: bool = True) -> tuple:
    """Full-sequence forward (the encoder, then the decoder); returns
    (hidden, aux = 0). With `cfg.remat` and grad mode on, each layer runs
    under activation checkpointing."""
    _, napply = NORMS[cfg.norm]
    enc_out = encode(params, cfg, audio_embeds)
    x = inputs_embeds if inputs_embeds is not None else _embed(params, cfg,
                                                               tokens)
    x = shard(x, "batch", "seq", "d_model")
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layer_views(params["dec_layers"], cfg.num_layers):
        x = (checkpoint(_dec_block, lp, x, enc_out, cfg, causal=causal,
                        use_reentrant=False) if remat
             else _dec_block(lp, x, enc_out, cfg, causal=causal))
    return (napply(params["final_ln"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _forward_embeds(params, cfg, inputs_embeds, audio_embeds) -> tuple:
    """The diffusion LM's entry: a bidirectional decoder over continuous
    inputs (the encoder runs again at every eval, as the reference's)."""
    return encdec_forward(params, cfg, None, audio_embeds,
                          inputs_embeds=inputs_embeds, causal=False)


def encdec_loss(params, cfg, tokens, targets, audio_embeds) -> torch.Tensor:
    """The AR training loss, a 0-d fp32 tensor: the next-token NLL."""
    hidden, _ = encdec_forward(params, cfg, tokens, audio_embeds)
    logits = logits_from_hidden(params, cfg, hidden).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long()).mean()


def _xattn_kv(lp, enc_out, cfg) -> tuple:
    B, T = enc_out.shape[:2]
    a = lp["xattn"]
    k = torch.matmul(enc_out, a["wk"].to(enc_out.dtype))
    v = torch.matmul(enc_out, a["wv"].to(enc_out.dtype))
    if "bk" in a:
        k = k + a["bk"].to(enc_out.dtype)
        v = v + a["bv"].to(enc_out.dtype)
    return (k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim))


def encdec_prefill(params, cfg, tokens, audio_embeds, max_len: int) -> tuple:
    """Encode the frames, process the prompt, and build the cache: the
    decoder's self-attention KV caches (re-projected from each layer's
    normed input, as the reference writes them) and each layer's cross K/V
    over the encoder output. Every full-sequence attention goes through
    the flash_attention kernel op: the encoder's, the decoder's causal
    self-attention and its cross-attention."""
    _, napply = NORMS[cfg.norm]
    enc_out = encode(params, cfg, audio_embeds)
    B, S = tokens.shape
    W = cache_window(cfg, max_len)
    x = _embed(params, cfg, tokens)
    pos = torch.arange(S, device=x.device).expand(B, S)
    ks, vs, xks, xvs = [], [], [], []
    for lp in layer_views(params["dec_layers"], cfg.num_layers):
        xn = napply(lp["ln1"], x)
        x = _dec_block(lp, x, enc_out, cfg)
        kc, vc = prefill_kv_cache(lp["attn"], xn, pos, cfg, W)
        xk, xv = _xattn_kv(lp, enc_out, cfg)
        ks.append(kc)
        vs.append(vc)
        xks.append(xk)
        xvs.append(xv)
    hidden = napply(params["final_ln"], x[:, -1:])
    return (logits_from_hidden(params, cfg, hidden),
            {"k": torch.stack(ks), "v": torch.stack(vs),
             "xk": torch.stack(xks), "xv": torch.stack(xvs)})


def encdec_decode_step(params, cfg, cache, token, pos) -> tuple:
    """token: (B, 1); pos: an int or a 0-d integer tensor. Returns (logits
    (B, 1, V), cache): the self-attention KV slots written in place; the
    cross-attention is the plain `sdpa` against the fixed cross K/V (as
    the reference's), so a decode step launches no port kernel."""
    _, napply = NORMS[cfg.norm]
    x = _embed(params, cfg, token)
    pos = device_pos(pos, x.device)
    W = cache["k"].shape[2]
    B = x.shape[0]
    hq, hd = cfg.num_heads, cfg.head_dim
    for lp, kc, vc, xk, xv in zip(
            layer_views(params["dec_layers"], cfg.num_layers), cache["k"],
            cache["v"], cache["xk"], cache["xv"]):
        x = x + _attn_with_cache(lp, napply(lp["ln1"], x), kc, vc, pos, cfg,
                                 W)
        a = lp["xattn"]
        xn = napply(lp["lnx"], x)
        q = torch.matmul(xn, a["wq"].to(x.dtype))
        if "bq" in a:
            q = q + a["bq"].to(x.dtype)
        o = sdpa(q.reshape(B, 1, hq, hd), xk, xv, causal=False)
        x = x + torch.matmul(o.reshape(B, 1, hq * hd), a["wo"].to(x.dtype))
        x = x + mlp_apply(lp["mlp"], napply(lp["ln2"], x), cfg)
    hidden = napply(params["final_ln"], x)
    return logits_from_hidden(params, cfg, hidden), cache
