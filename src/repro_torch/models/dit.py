"""DiT — the eps-network the sampler drives (the port of `repro.models.dit`):
patch projection, adaLN-zero time/class conditioning, a stack of blocks,
and the final adaLN + output projection; `dit_apply_cached` is the
feature-reuse eval (DESIGN.md §12).

Params mirror the reference pytree: `blocks` holds each block parameter
stacked over layers as (L, ...); `dit_apply` loops over them (the
reference's `lax.scan`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.adaln_modulate import ops as adaln_ops
from ..parallel.sharding import shard
from .layers import attention_apply, attention_init, dense_apply, dense_init
from .layers import layer_views as _layers
from .layers import stack_trees as _stack


def timestep_embedding(t: torch.Tensor, dim: int, max_period=10000.0):
    """t: (B,) float in [0, 1]-ish; sinusoidal features (the MLP is outside)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, device=t.device, dtype=torch.float32)
                      / half)
    ang = t[:, None].to(torch.float32) * freqs[None] * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _dit_block_init(gen, cfg, device):
    d = cfg.d_model
    dt = cfg.weight_dtype
    return {
        "attn": attention_init(gen, cfg, device),
        "w1": dense_init(gen, d, cfg.d_ff, dt, device),
        "w2": dense_init(gen, cfg.d_ff, d, dt, device,
                         scale=1.0 / math.sqrt(cfg.d_ff)),
        # adaLN-zero: 6 modulation vectors, zero-init
        "ada": torch.zeros((d, 6 * d), dtype=dt, device=device),
        "ada_b": torch.zeros((6 * d,), dtype=dt, device=device),
    }


def init_dit(cfg, gen: torch.Generator, device, num_classes: int = 0) -> dict:
    """Random DiT params from the seeded generator `gen` (its own numbers,
    not the reference's jax.random ones; `api.params_from_numpy` carries
    the reference's params over for parity)."""
    d = cfg.d_model
    dt = cfg.weight_dtype
    blocks = [_dit_block_init(gen, cfg, device) for _ in range(cfg.num_layers)]
    p = {
        "in_proj": dense_init(gen, cfg.latent_dim, d, dt, device),
        "t_mlp1": dense_init(gen, 256, d, dt, device),
        "t_mlp2": dense_init(gen, d, d, dt, device),
        "blocks": _stack(blocks),
        "final_ada": torch.zeros((d, 2 * d), dtype=dt, device=device),
        "final_ada_b": torch.zeros((2 * d,), dtype=dt, device=device),
        "out_proj": torch.zeros((d, cfg.latent_dim), dtype=dt, device=device),
    }
    if num_classes:
        p["class_embed"] = (0.02 * torch.randn(
            (num_classes + 1, d), generator=gen, device=device,
            dtype=torch.float32)).to(dt)
    return p


def _embed(params, cfg, x_t, t, class_ids):
    """Shared front end: patch projection + adaLN conditioning vector."""
    B = x_t.shape[0]
    act = cfg.activation_dtype
    t = torch.as_tensor(t, dtype=torch.float32, device=x_t.device).expand(B)
    x = torch.matmul(x_t.to(act), params["in_proj"].to(act))
    x = shard(x, "batch", "seq", "d_model")
    c = F.silu(torch.matmul(timestep_embedding(t, 256),
                            params["t_mlp1"].to(torch.float32)))
    c = torch.matmul(c, params["t_mlp2"].to(torch.float32))
    if class_ids is not None and "class_embed" in params:
        c = c + params["class_embed"].to(torch.float32)[class_ids]
    c = F.silu(c).to(x.dtype)
    return x, c


def _block(h, bp, cfg, c, tap=None):
    """One DiT block (the reference's scan body), every modulation through
    the adaln_modulate kernel ops. Every dense site goes through
    `dense_apply`, so a quantized param tree (models/quant.py records)
    routes through the quant_matmul kernel op with no change here. `tap` is
    the calibration hook: None in every sampling path, a per-site absmax
    recorder when models/quant.py replays the forward."""
    adaln = cfg.adaln_backend
    if tap is not None:
        tap("ada", c)
    mod = dense_apply(c, bp["ada"], cfg) + bp["ada_b"].to(h.dtype)
    sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(mod, 6, dim=-1)
    hn = adaln_ops.modulate(h, sh1, sc1, backend=adaln)
    a = attention_apply(bp["attn"], hn, cfg, causal=False, rope=False,
                        tap=tap)
    h = adaln_ops.gate_residual(h, g1, a, backend=adaln)
    hn = adaln_ops.modulate(h, sh2, sc2, backend=adaln)
    if tap is not None:
        tap("mlp_in", hn)
    # jax.nn.gelu defaults to the tanh approximation
    y = F.gelu(dense_apply(hn, bp["w1"], cfg), approximate="tanh")
    if tap is not None:
        tap("mlp_mid", y)
    y = dense_apply(y, bp["w2"], cfg)
    return adaln_ops.gate_residual(h, g2, y, backend=adaln)


def _head(params, cfg, x, c, tap=None):
    """Final adaLN + output projection back to latent width."""
    if tap is not None:
        tap("final_ada", c)
    mod = (dense_apply(c, params["final_ada"], cfg)
           + params["final_ada_b"].to(x.dtype))
    sh, sc = torch.chunk(mod, 2, dim=-1)
    x = adaln_ops.modulate(x, sh, sc, backend=cfg.adaln_backend)
    return torch.matmul(x, params["out_proj"].to(x.dtype))


def dit_apply(params, cfg, x_t, t, class_ids=None):
    """x_t: (B, T, latent_dim); t: scalar or (B,). Returns eps-hat, same
    shape, in the activation dtype."""
    x, c = _embed(params, cfg, x_t, t, class_ids)
    for bp in _layers(params["blocks"], cfg.num_layers):
        x = _block(x, bp, cfg, c)
    return _head(params, cfg, x, c)


def dit_cache_shape(cfg):
    """Per-sample shape of the deep-feature cache (the residual delta of the
    blocks past the cache boundary): one (T, d_model) array per slot."""
    return (cfg.patch_tokens, cfg.d_model)


def dit_apply_cached(params, cfg, x_t, t, class_ids=None, *, cache,
                     reuse=None, cache_block: int, deep: bool = True):
    """DiT eval with a deep-feature cache at a static block boundary.

    cache: (B, T, d_model) — the deep segment's residual delta
        (x_after_all_blocks - x_after_cache_block) recorded at each sample's
        last full eval. Zero-init is safe: the first eval of a trajectory is
        a full one (the table's init row always is).
    reuse: scalar or (B,) flag, 1 = shallow eval (reuse the cached delta and
        recompute only the first `cache_block` blocks and the head), 0 =
        full eval (recompute everything, refresh the cache). None = 0.
    cache_block: static split index k, 1 <= k < num_layers.
    deep: whether the deep blocks [k, L) run. The reference decides this
        on the device (`lax.cond` on any full sample); a CUDA graph cannot
        branch, so the caller decides it on the host from the rows it knows
        the batch runs. Every slot's select reads its own `reuse` flag
        either way: with `deep=True` the numbers are those of the reference
        whatever the flags; `deep=False` is right when every flag is set.

    Returns (eps_hat, new_cache). With reuse 0 everywhere the output is
    bit-identical to `dit_apply`: the shallow and deep loops run the same
    block ops over the same params, and full samples take the deep output
    itself, never a reconstruction through the delta.
    """
    L = int(cfg.num_layers)
    k = int(cache_block)
    if not 1 <= k < L:
        raise ValueError(f"cache_block must be in 1..{L - 1} "
                         f"(num_layers={L}), got {k}")
    x, c = _embed(params, cfg, x_t, t, class_ids)
    layers = _layers(params["blocks"], L)
    for bp in layers[:k]:
        x = _block(x, bp, cfg, c)
    x_k = x
    if deep:
        for bp in layers[k:]:
            x = _block(x, bp, cfg, c)
    B = x_t.shape[0]
    # a host flag becomes a device fill, not a host-to-device copy, so a
    # CUDA graph can capture it (an uncached table's rows pass reuse 0.0)
    reuse = (torch.as_tensor(reuse, dtype=torch.float32,
                             device=x_t.device).expand(B)
             if torch.is_tensor(reuse) else
             torch.full((B,), 0.0 if reuse is None else float(reuse),
                        dtype=torch.float32, device=x_t.device))
    cache = cache.to(x_k.dtype)
    r = (reuse > 0.5).reshape((B,) + (1,) * (x_k.dim() - 1))
    # full slots take the freshly computed deep output and refresh their
    # cache; shallow slots approximate it as x_k + the cached delta and keep
    # their cache
    x_out = torch.where(r, x_k + cache, x)
    new_cache = torch.where(r, cache, x - x_k)
    return _head(params, cfg, x_out, c), new_cache
