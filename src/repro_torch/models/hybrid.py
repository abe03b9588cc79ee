"""SSM and hybrid LMs (the port of `repro.models.hybrid`).

* MambaLM — a pure Mamba2 stack (mamba2-780m).
* Zamba2LM — a Mamba2 backbone with ONE *shared* attention block applied
  after every `cfg.attn_every` SSM layers (zamba2's parameter-shared
  attention, without the per-invocation LoRA deltas of the released
  checkpoints, as the reference's config notes).

Both give the full-sequence forward (training, prefill, the diffusion LM's
eval, which stays causal) and the O(1)-state decode step. Params mirror
the reference pytree: MambaLM's `layers` are stacked (L, ...); zamba2's
`groups` are stacked (n_groups, attn_every, ...), with an optional `tail`
(tail, ...) of the layers past the last whole group, and `shared_attn` is
one block. Caches: MambaLM's {"ssm" (L, B, H, P, N), "conv" (L, B, K - 1,
conv_dim)}; zamba2's {"groups": those states stacked (n_groups,
attn_every, ...), "attn_k" / "attn_v" (n_groups, B, W, Hkv, D): one KV
cache per invocation of the shared block, "tail"}. The decode steps write
every state and the KV caches in place and return the same dict, so a
CUDA graph can capture them.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import shard
from .layers import (NORMS, attention_apply, attention_init, dense_init,
                     layer_views, mlp_apply, mlp_init, stack_trees)
from .ssm import init_mamba_state, mamba2_apply, mamba2_decode, mamba2_init
from .transformer import (_attn_with_cache, _embed, cache_window,
                          device_pos, logits_from_hidden, prefill_kv_cache)


def _ssm_layer_init(gen: torch.Generator, cfg, device) -> dict:
    ninit, _ = NORMS[cfg.norm]
    return {"ln": ninit(cfg.d_model, cfg.weight_dtype, device),
            "mamba": mamba2_init(gen, cfg, device)}


def _ssm_block(lp, h, cfg):
    _, napply = NORMS[cfg.norm]
    return h + mamba2_apply(lp["mamba"], napply(lp["ln"], h), cfg)


def _ssm_stack(layers, x, cfg, n: int, remat: bool = False):
    for lp in layer_views(layers, n):
        x = (checkpoint(_ssm_block, lp, x, cfg, use_reentrant=False) if remat
             else _ssm_block(lp, x, cfg))
    return x


def _ssm_prefill(layers, x, cfg, n: int) -> tuple:
    """The stack over a prompt, and its decode states stacked (n, ...)."""
    _, napply = NORMS[cfg.norm]
    states = []
    for lp in layer_views(layers, n):
        y, st = mamba2_apply(lp["mamba"], napply(lp["ln"], x), cfg,
                             return_state=True)
        x = x + y
        states.append(st)
    return x, stack_trees(states)


def _ssm_decode(layers, states, x, cfg, n: int):
    _, napply = NORMS[cfg.norm]
    for lp, st in zip(layer_views(layers, n), layer_views(states, n)):
        y, _ = mamba2_decode(lp["mamba"], st, napply(lp["ln"], x), cfg)
        x = x + y
    return x


# ---------------------------------------------------------------------------
# MambaLM
# ---------------------------------------------------------------------------

def init_mamba_lm(cfg, gen: torch.Generator, device) -> dict:
    """Random params from the seeded generator `gen` (its own numbers, not
    the reference's jax.random ones)."""
    ninit, _ = NORMS[cfg.norm]
    layers = [_ssm_layer_init(gen, cfg, device)
              for _ in range(cfg.num_layers)]
    return {
        "embed": dense_init(gen, cfg.vocab_size, cfg.d_model,
                            cfg.weight_dtype, device, scale=0.02),
        "layers": stack_trees(layers),
        "final_ln": ninit(cfg.d_model, cfg.weight_dtype, device),
    }


def mamba_forward(params, cfg, tokens, *, inputs_embeds=None) -> tuple:
    """Full-sequence forward (causal); returns (hidden, aux = 0). With
    `cfg.remat` and grad mode on, each layer runs under activation
    checkpointing (the reference's `maybe_remat`)."""
    _, napply = NORMS[cfg.norm]
    x = inputs_embeds if inputs_embeds is not None else _embed(params, cfg,
                                                               tokens)
    x = shard(x, "batch", "seq", "d_model")
    x = _ssm_stack(params["layers"], x, cfg, cfg.num_layers,
                   remat=cfg.remat and torch.is_grad_enabled())
    return (napply(params["final_ln"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _lm_loss(forward, params, cfg, tokens, targets) -> torch.Tensor:
    hidden, _ = forward(params, cfg, tokens)
    logits = logits_from_hidden(params, cfg, hidden).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long()).mean()


def mamba_lm_loss(params, cfg, tokens, targets) -> torch.Tensor:
    """The AR training loss, a 0-d fp32 tensor: the next-token NLL."""
    return _lm_loss(mamba_forward, params, cfg, tokens, targets)


def init_mamba_cache(cfg, batch: int, max_len=None, device="cpu") -> dict:
    return init_mamba_state(cfg, batch, device, lead=(cfg.num_layers,))


def mamba_prefill(params, cfg, tokens, max_len=None) -> tuple:
    """Full-sequence pass that also returns the decode state per layer."""
    _, napply = NORMS[cfg.norm]
    x, cache = _ssm_prefill(params["layers"], _embed(params, cfg, tokens),
                            cfg, cfg.num_layers)
    hidden = napply(params["final_ln"], x[:, -1:])
    return logits_from_hidden(params, cfg, hidden), cache


def mamba_decode_step(params, cfg, cache, token, pos) -> tuple:
    """token: (B, 1). Returns (logits (B, 1, V), cache), the cache updated
    in place (`pos` is not read: the state carries the position)."""
    _, napply = NORMS[cfg.norm]
    x = _ssm_decode(params["layers"], cache, _embed(params, cfg, token), cfg,
                    cfg.num_layers)
    return logits_from_hidden(params, cfg, napply(params["final_ln"], x)), \
        cache


# ---------------------------------------------------------------------------
# zamba2: groups of `attn_every` mamba layers + one shared attention block
# ---------------------------------------------------------------------------

def zamba_groups(cfg) -> tuple:
    """(n_groups, tail): whole groups of attn_every layers, then the rest."""
    n_groups = cfg.num_layers // cfg.attn_every
    return n_groups, cfg.num_layers - n_groups * cfg.attn_every


def init_zamba_lm(cfg, gen: torch.Generator, device) -> dict:
    n_groups, tail = zamba_groups(cfg)
    ninit, _ = NORMS[cfg.norm]
    E = cfg.attn_every
    layers = [_ssm_layer_init(gen, cfg, device)
              for _ in range(cfg.num_layers)]
    grouped = stack_trees([stack_trees(layers[i * E:(i + 1) * E])
                           for i in range(n_groups)])
    wd = cfg.weight_dtype
    p = {
        "embed": dense_init(gen, cfg.vocab_size, cfg.d_model, wd, device,
                            scale=0.02),
        "groups": grouped,
        "shared_attn": {
            "ln1": ninit(cfg.d_model, wd, device),
            "attn": attention_init(gen, cfg, device),
            "ln2": ninit(cfg.d_model, wd, device),
            "mlp": mlp_init(gen, cfg, device),
        },
        "final_ln": ninit(cfg.d_model, wd, device),
    }
    if tail:
        p["tail"] = stack_trees(layers[n_groups * E:])
    return p


def _shared_attn_block(sp, x, cfg):
    _, napply = NORMS[cfg.norm]
    a = attention_apply(sp["attn"], napply(sp["ln1"], x), cfg, causal=True,
                        sliding_window=cfg.sliding_window)
    x = x + a
    return x + mlp_apply(sp["mlp"], napply(sp["ln2"], x), cfg)


def _zamba_group(gp, sp, h, cfg, remat: bool):
    h = _ssm_stack(gp, h, cfg, cfg.attn_every, remat=remat)
    return _shared_attn_block(sp, h, cfg)


def zamba_forward(params, cfg, tokens, *, inputs_embeds=None) -> tuple:
    """Full-sequence forward (causal); returns (hidden, aux = 0). With
    `cfg.remat` and grad mode on, each group and each of its layers runs
    under activation checkpointing, as the reference remats both bodies
    (the tail's layers are not)."""
    _, napply = NORMS[cfg.norm]
    n_groups, tail = zamba_groups(cfg)
    x = inputs_embeds if inputs_embeds is not None else _embed(params, cfg,
                                                               tokens)
    x = shard(x, "batch", "seq", "d_model")
    sp = params["shared_attn"]
    remat = cfg.remat and torch.is_grad_enabled()
    for gp in layer_views(params["groups"], n_groups):
        x = (checkpoint(_zamba_group, gp, sp, x, cfg, True,
                        use_reentrant=False) if remat
             else _zamba_group(gp, sp, x, cfg, False))
    if tail:
        x = _ssm_stack(params["tail"], x, cfg, tail)
    return (napply(params["final_ln"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def zamba_lm_loss(params, cfg, tokens, targets) -> torch.Tensor:
    """The AR training loss, a 0-d fp32 tensor: the next-token NLL."""
    return _lm_loss(zamba_forward, params, cfg, tokens, targets)


def init_zamba_cache(cfg, batch: int, max_len: int, device="cpu") -> dict:
    n_groups, tail = zamba_groups(cfg)
    W = cache_window(cfg, max_len)
    shape = (n_groups, batch, W, cfg.num_kv_heads, cfg.head_dim)
    act = cfg.activation_dtype
    cache = {
        "groups": init_mamba_state(cfg, batch, device,
                                   lead=(n_groups, cfg.attn_every)),
        "attn_k": torch.zeros(shape, dtype=act, device=device),
        "attn_v": torch.zeros(shape, dtype=act, device=device),
    }
    if tail:
        cache["tail"] = init_mamba_state(cfg, batch, device, lead=(tail,))
    return cache


def zamba_decode_step(params, cfg, cache, token, pos) -> tuple:
    """token: (B, 1); pos: an int or a 0-d integer tensor. Returns (logits
    (B, 1, V), cache), every state and KV slot written in place."""
    _, napply = NORMS[cfg.norm]
    n_groups, tail = zamba_groups(cfg)
    x = _embed(params, cfg, token)
    pos = device_pos(pos, x.device)
    sp = params["shared_attn"]
    W = cache["attn_k"].shape[2]
    for gp, gst, kc, vc in zip(layer_views(params["groups"], n_groups),
                               layer_views(cache["groups"], n_groups),
                               cache["attn_k"], cache["attn_v"]):
        x = _ssm_decode(gp, gst, x, cfg, cfg.attn_every)
        x = x + _attn_with_cache(sp, napply(sp["ln1"], x), kc, vc, pos, cfg,
                                 W)
        x = x + mlp_apply(sp["mlp"], napply(sp["ln2"], x), cfg)
    if tail:
        x = _ssm_decode(params["tail"], cache["tail"], x, cfg, tail)
    return logits_from_hidden(params, cfg, napply(params["final_ln"], x)), \
        cache


def zamba_prefill(params, cfg, tokens, max_len: int) -> tuple:
    """Prefill: the full-sequence mamba layers with their states, and each
    invocation of the shared block through the flash_attention kernel op,
    its KV cache re-projected from the block's normed input (the
    reference's rebuild)."""
    _, napply = NORMS[cfg.norm]
    n_groups, tail = zamba_groups(cfg)
    B, S = tokens.shape
    W = cache_window(cfg, max_len)
    x = _embed(params, cfg, tokens)
    sp = params["shared_attn"]
    pos = torch.arange(S, device=x.device).expand(B, S)
    states, ks, vs = [], [], []
    for gp in layer_views(params["groups"], n_groups):
        x, gst = _ssm_prefill(gp, x, cfg, cfg.attn_every)
        xn = napply(sp["ln1"], x)
        x = x + attention_apply(sp["attn"], xn, cfg, causal=True,
                                sliding_window=cfg.sliding_window)
        x = x + mlp_apply(sp["mlp"], napply(sp["ln2"], x), cfg)
        kc, vc = prefill_kv_cache(sp["attn"], xn, pos, cfg, W)
        states.append(gst)
        ks.append(kc)
        vs.append(vc)
    cache = {"groups": stack_trees(states), "attn_k": torch.stack(ks),
             "attn_v": torch.stack(vs)}
    if tail:
        x, cache["tail"] = _ssm_prefill(params["tail"], x, cfg, tail)
    hidden = napply(params["final_ln"], x[:, -1:])
    return logits_from_hidden(params, cfg, hidden), cache
