"""Shared neural building blocks, float path (the port of `repro.models.layers`).

Params are nested dicts of tensors in the reference's layout: dense
weights are (K, N), so `x @ w` is the reference's einsum "...k,kn->...n".
Init functions draw from a seeded `torch.Generator` in a fixed order (their
own numbers, not the reference's jax.random ones; `api.params_from_numpy`
carries the reference's params over for parity).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as fa_ops
from ..kernels.quant_matmul import ops as qmm_ops
from ..parallel.sharding import shard


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


def stack_trees(trees: list):
    """Per-layer param trees -> one tree of stacked (L, ...) leaves (the
    reference's `jax.tree.map(jnp.stack)`)."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer_views(tree: dict, L: int) -> list:
    """Every layer's params (quant records included) as views of the
    stacked (L, ...) leaves, unbound once (the reference's `lax.scan` over
    layers): under autograd the layers' gradients are then stacked in one
    op, where indexing each layer apart gives each one a zero-filled
    (L, ...) gradient and sums the L of them."""
    cols = {k: layer_views(v, L) if isinstance(v, dict) else torch.unbind(v)
            for k, v in tree.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(L)]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device="cpu") -> dict:
    return {"w": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps=1e-5) -> torch.Tensor:
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * params["w"].to(x.dtype)


def layernorm_init(d: int, dtype, device="cpu") -> dict:
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps=1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    if params:
        y = y * params["w"].to(y.dtype) + params["b"].to(y.dtype)
    return y


def nonparam_ln(params: dict, x: torch.Tensor, eps=1e-5) -> torch.Tensor:
    """OLMo-style non-parametric LayerNorm (no learnable affine)."""
    return layernorm({}, x, eps)


NORMS = {
    "rmsnorm": (rmsnorm_init, rmsnorm),
    "layernorm": (layernorm_init, layernorm),
    "nonparam_ln": (lambda d, dt, device="cpu": {}, nonparam_ln),
}


def make_norm(cfg):
    init, apply = NORMS[cfg.norm]
    return (lambda device="cpu": init(cfg.d_model, cfg.weight_dtype,
                                      device)), apply


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    """theta ** (arange / D) in fp32, then its reciprocal: the reference's
    order of operations (ROADMAP C6)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


# DeepSeek-V2's published YaRN settings besides the factor (its config's
# `rope_scaling`): the context the rope was trained at, the rotation
# counts that bound the interpolation ramp, and the attention
# temperature's `mscale_all_dim` (its `mscale` is the same, so the cos/sin
# factor mscale(mscale) / mscale(mscale_all_dim) is 1)
YARN_ORIGINAL_MAX = 4096
YARN_BETA_FAST = 32.0
YARN_BETA_SLOW = 1.0
YARN_MSCALE_ALL_DIM = 0.707


def yarn_mscale(factor: float, mscale: float = YARN_MSCALE_ALL_DIM) -> float:
    """YaRN's attention temperature factor (DeepSeek-V2's
    `yarn_get_mscale`): 0.1 mscale ln(factor) + 1, or 1 without scaling."""
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_rope(cfg, dim: int, device="cpu") -> torch.Tensor:
    """The inverse frequencies (dim/2,) fp32 of YaRN-scaled rope, as
    DeepSeek-V2 computes them: each frequency interpolated between theta's
    own (extrapolated) and a `rope_yarn_factor`-th of it by a linear ramp
    over the dims whose wavelengths lie between YARN_BETA_FAST and
    YARN_BETA_SLOW rotations of YARN_ORIGINAL_MAX positions."""
    f, base = cfg.rope_yarn_factor, cfg.rope_theta
    pos = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** pos)
    inter = 1.0 / (f * base ** pos)

    def corr_dim(rotations):
        return (dim * math.log(YARN_ORIGINAL_MAX / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr_dim(YARN_BETA_FAST)), 0)
    high = min(math.ceil(corr_dim(YARN_BETA_SLOW)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               freqs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integers. `freqs` (D/2,) in place
    of theta's (YaRN's, `yarn_rope`)."""
    d = x.shape[-1]
    if freqs is None:
        freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs          # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg, device, d_ff=None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.weight_dtype
    p = {}
    if cfg.act == "swiglu":
        p["w_gate"] = dense_init(gen, d, f, dt, device)
    p["w_up"] = dense_init(gen, d, f, dt, device)
    p["w_down"] = dense_init(gen, f, d, dt, device, scale=1.0 / math.sqrt(f))
    return p


def mlp_apply(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.act == "swiglu":
        g = dense_apply(x, params["w_gate"], cfg)
        u = dense_apply(x, params["w_up"], cfg)
        h = F.silu(g) * u
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense_apply(x, params["w_up"], cfg), approximate="tanh")
    h = shard(h, "batch", "seq", "d_ff")
    return dense_apply(h, params["w_down"], cfg)


# ---------------------------------------------------------------------------
# attention (GQA, causal / bidirectional / sliding-window / cross)
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, cfg, device,
                   d_kv_src: Optional[int] = None) -> dict:
    d = cfg.d_model
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.weight_dtype
    d_src = d_kv_src or d
    p = {
        "wq": dense_init(gen, d, hq * hd, dt, device),
        "wk": dense_init(gen, d_src, hkv * hd, dt, device),
        "wv": dense_init(gen, d_src, hkv * hd, dt, device),
        "wo": dense_init(gen, hq * hd, d, dt, device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[name] = torch.zeros((n,), dtype=dt, device=device)
    return p


def _proj_qkv(params: dict, x: torch.Tensor, kv_src: torch.Tensor, cfg,
              tap=None) -> tuple:
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if tap is not None:  # calibration hook (models/quant.py); None in serving
        tap("qkv", x)
    q = dense_apply(x, params["wq"], cfg)
    k = dense_apply(kv_src, params["wk"], cfg)
    v = dense_apply(kv_src, params["wv"], cfg)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    B, S = x.shape[:2]
    Skv = kv_src.shape[1]
    return (q.reshape(B, S, hq, hd), k.reshape(B, Skv, hkv, hd),
            v.reshape(B, Skv, hkv, hd))


def sdpa(q, k, v, *, causal, q_positions=None, kv_positions=None,
         sliding_window=None) -> torch.Tensor:
    """Grouped-query scaled dot-product attention, plain torch (the
    reference computes it in XLA, not in a kernel).

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.
    Masks are built from 1-D positions, so the same code serves prefill
    (Sq == Skv), decode (Sq == 1 against a cache) and cross-attention
    (causal=False)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    logits = logits / math.sqrt(D)
    if causal or sliding_window is not None:
        qp = (q_positions if q_positions is not None
              else torch.arange(Sq, device=q.device))[:, None]     # (Sq, 1)
        kp = (kv_positions if kv_positions is not None
              else torch.arange(Skv, device=q.device))[None, :]    # (1, Skv)
        ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        if causal:
            ok = ok & (kp <= qp)
        if sliding_window is not None:
            ok = ok & (kp > qp - sliding_window)
        logits = torch.where(ok, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(B, Sq, Hq, D)


def chunked_sdpa(q, k, v, *, causal, sliding_window=None,
                 chunk=1024) -> torch.Tensor:
    """`sdpa` over query chunks of `chunk` rows (the reference's lax.scan):
    the logits take O(chunk * Skv) memory instead of O(Sq * Skv), with the
    same softmax. A ragged tail is padded up to the chunk boundary; the
    padded rows carry real past-the-end positions (a causal pad row attends
    to everything, so its softmax stays finite) and are sliced off."""
    B, Sq, Hq, D = q.shape
    Skv = k.shape[1]
    pad = (-Sq) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    kp = torch.arange(Skv, device=q.device)
    outs = []
    for idx in range((Sq + pad) // chunk):
        qpos = idx * chunk + torch.arange(chunk, device=q.device)
        outs.append(sdpa(q[:, idx * chunk:(idx + 1) * chunk], k, v,
                         causal=causal, q_positions=qpos, kv_positions=kp,
                         sliding_window=sliding_window))
    return torch.cat(outs, dim=1)[:, :Sq]


def attention_apply(params: dict, x: torch.Tensor, cfg, *, kv_src=None,
                    causal: bool = True, positions=None, kv_positions=None,
                    sliding_window=None, rope: bool = True,
                    tap=None) -> torch.Tensor:
    """Full-sequence attention (training, prefill without a cache, the
    DiT's and the diffusion LM's bidirectional evals). Rotary embeddings at
    `positions` / `kv_positions` (default 0..S-1) unless `rope=False`. With
    `cfg.attention_chunk` set and a longer sequence, `chunked_sdpa` (plain
    torch, as the reference's XLA form); otherwise the flash_attention
    kernel op, which takes the head-major views of the (B, S, H, D)
    projections as strides, not copies. `tap` is the calibration hook of
    models/quant.py (None everywhere else): it sees the projections' input
    as "qkv" and the attention output as "wo"."""
    kv_src = x if kv_src is None else kv_src
    q, k, v = _proj_qkv(params, x, kv_src, cfg, tap=tap)
    B, S = x.shape[:2]
    if rope:
        pos = (positions if positions is not None else
               torch.arange(S, device=x.device).expand(B, S))
        q = apply_rope(q, pos, cfg.rope_theta)
        Skv = k.shape[1]
        kv_pos = (kv_positions if kv_positions is not None else
                  torch.arange(Skv, device=x.device).expand(B, Skv))
        k = apply_rope(k, kv_pos, cfg.rope_theta)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    chunk = getattr(cfg, "attention_chunk", 0)
    if chunk and q.shape[1] > chunk:
        out = chunked_sdpa(q, k, v, causal=causal,
                           sliding_window=sliding_window, chunk=chunk)
    else:
        out = fa_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=sliding_window,
                               backend=cfg.attention_backend).transpose(1, 2)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    if tap is not None:
        tap("wo", out)
    return dense_apply(out, params["wo"], cfg)
