"""Mamba2 (state-space duality / SSD) block (the port of `repro.models.ssm`):
the chunked parallel form for training and prefill, the O(1) recurrent form
for decode. (Dao & Gu, 2024, arXiv:2405.21060; zamba2's Mamba2 blocks use
the same core.)

Shapes: d_inner = expand * d_model, H = d_inner / head_dim heads, state N,
G groups for B/C (GVA-style). The chunked scan is the within-chunk
quadratic form plus the inter-chunk recurrence on (H, P, N) states, as in
the reference: matmuls and one in-order loop over chunks (the reference's
`lax.scan`). It has no kernel of its own, as the reference has none.

Numerics follow the reference: `A_log` and `dt_bias` are read in fp32,
every other weight in the activation dtype; the scan runs in fp32 and
returns its output and final state in the activation dtype; the decode
state is kept in the activation dtype and rounded to it every token.
`mamba2_decode` writes the new state into the state it is given (views of
the stacked cache), so a CUDA graph can capture the decode step.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel.sharding import shard
from .layers import dense_init, rmsnorm, rmsnorm_init


def mamba2_init(gen: torch.Generator, cfg, device) -> dict:
    d, di = cfg.d_model, cfg.ssm_d_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    dt = cfg.weight_dtype
    conv_dim = di + 2 * G * N
    conv_w = 0.1 * torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                               device=device, dtype=torch.float32)
    return {
        # order: [z (di), x (di), B (G*N), C (G*N), dt (H)]
        "in_proj": dense_init(gen, d, 2 * di + 2 * G * N + H, dt, device),
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H,
                                          device=device)).to(dt),
        "D": torch.ones((H,), dtype=dt, device=device),
        "dt_bias": torch.full((H,), math.log(math.expm1(0.01)), dtype=dt,
                              device=device),
        "out_norm": rmsnorm_init(di, dt, device),
        "out_proj": dense_init(gen, di, d, dt, device),
    }


def _split_proj(params, u, cfg) -> tuple:
    di, G, N = cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state
    zxbcdt = torch.matmul(u, params["in_proj"].to(u.dtype))
    return torch.split(zxbcdt, [di, di + 2 * G * N, cfg.ssm_heads], dim=-1)


def _causal_conv(params, xBC, cfg) -> torch.Tensor:
    """Depthwise causal conv1d, window ssm_conv, then SiLU."""
    K, L = cfg.ssm_conv, xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    w = params["conv_w"].to(xBC.dtype)
    out = sum(pad[:, k:k + L] * w[k] for k in range(K))
    return F.silu(out + params["conv_b"].to(xBC.dtype))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, logaddexp(x, 0), in its form: torch's F.softplus
    returns x itself above a threshold."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., q) -> (..., q, q) lower-triangular cumulative sums
    L[i, j] = sum_{j < k <= i} a_k (and -inf above the diagonal)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, -math.inf)


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)


def ssd_scan(x, dt, A, B, C, D, chunk: int) -> tuple:
    """SSD chunked algorithm.

    x: (b, l, h, p); dt: (b, l, h) (post-softplus, fp32); A: (h,) negative;
    B, C: (b, l, g, n); D: (h,). Returns y: (b, l, h, p) and the final
    state (b, h, p, n), both in x's dtype.

    The reference repeats B and C over the h / g heads of each group; here
    the heads of a group are an axis of their own (r) that B and C
    broadcast over, so C.B is formed once a group, and autograd sums over
    the broadcast (a plain reduction, where the backward of a repeat is an
    index_add)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    orig_l = l
    pad = (-l) % chunk
    if pad:
        # zero-pad: dt=0 rows have decay exp(0)=1 and contribute nothing
        x, dt, B, C = (_pad_seq(t, pad) for t in (x, dt, B, C))
        l = l + pad
    c, q, r = l // chunk, chunk, h // g
    f32 = torch.float32
    Bc = B.reshape(b, c, q, g, n).to(f32)
    Cc = C.reshape(b, c, q, g, n).to(f32)
    dtc = dt.reshape(b, c, q, h)
    a = (dtc * A).to(f32).permute(0, 1, 3, 2)                       # (b,c,h,q)
    xdt = (x.reshape(b, c, q, h, p) * dtc[..., None]).to(f32)       # (b,c,q,h,p)
    xdt = xdt.reshape(b, c, q, g, r, p)

    # 1) within-chunk (quadratic) term
    L = torch.exp(_segsum(a)).reshape(b, c, g, r, q, q)              # (b,c,g,r,i,j)
    CB = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    Ydiag = torch.einsum("bcgrij,bcjgrp->bcigrp", L * CB[:, :, :, None],
                         xdt)

    # 2) chunk states
    a_cum = torch.cumsum(a, dim=-1)                                 # (b,c,h,q)
    a_tot = a_cum[..., -1]                                          # (b,c,h)
    decay_states = torch.exp(a_tot[..., None] - a_cum)              # (b,c,h,q)
    ds = decay_states.reshape(b, c, g, r, q).permute(0, 1, 4, 2, 3)
    states = torch.einsum("bcqgn,bcqgrp->bcgrpn", Bc, xdt * ds[..., None])
    states = states.reshape(b, c, h, p, n)

    # 3) inter-chunk recurrence S_c = exp(a_tot_c) * S_{c-1} + states_c; the
    # state entering chunk c is the one after chunk c - 1 (zeros for c = 0)
    S = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    decay = torch.exp(a_tot)
    S_in = []
    for i in range(c):
        S_in.append(S)
        S = S * decay[:, i, :, None, None] + states[:, i]
    S_in = torch.stack(S_in, 1).reshape(b, c, g, r, p, n)

    # 4) state -> output within each chunk
    Yoff = torch.einsum("bcqgn,bcgrpn->bcqgrp", Cc, S_in)
    ea = torch.exp(a_cum).reshape(b, c, g, r, q).permute(0, 1, 4, 2, 3)
    Yoff = Yoff * ea[..., None]
    y = (Ydiag + Yoff).reshape(b, l, h, p).to(x.dtype)
    y = y + x * D[None, None, :, None].to(x.dtype)
    if pad:
        y = y[:, :orig_l]
    return y, S.to(x.dtype)


def mamba2_apply(params, u, cfg, *, return_state: bool = False):
    """Full-sequence Mamba2 block. u: (B, S, d_model). With `return_state`
    also the decode state after the sequence: {"ssm" (B, H, P, N), "conv"
    (B, ssm_conv - 1, conv_dim)}, the conv window being the last pre-conv
    rows (zero rows in front of a shorter sequence). The reference
    recomputes those rows by a second in_proj; they are sliced here from
    the product already taken, the same values."""
    di, G, N = cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC_raw, dt = _split_proj(params, u, cfg)
    xBC = _causal_conv(params, xBC_raw, cfg)
    x, B, C = torch.split(xBC, [di, G * N, G * N], dim=-1)
    b, l = u.shape[:2]
    dt = softplus(dt.to(torch.float32)
                  + params["dt_bias"].to(torch.float32))
    A = -torch.exp(params["A_log"].to(torch.float32))
    x = shard(x.reshape(b, l, H, P), "batch", "seq", "heads", None)
    y, state = ssd_scan(x, dt, A, B.reshape(b, l, G, N),
                        C.reshape(b, l, G, N), params["D"], cfg.ssm_chunk)
    y = y.reshape(b, l, di)
    y = rmsnorm(params["out_norm"], y * F.silu(z))
    out = torch.matmul(y, params["out_proj"].to(u.dtype))
    if not return_state:
        return out
    K = cfg.ssm_conv
    conv_tail = torch.cat(
        [u.new_zeros((b, max(0, K - 1 - l), xBC.shape[-1])),
         xBC_raw[:, -(K - 1):]], dim=1)
    return out, {"ssm": state, "conv": conv_tail}


def init_mamba_state(cfg, batch: int, device="cpu", lead=()) -> dict:
    """The decode state of `batch` sequences, zeros in the activation
    dtype, with leading axes `lead` (layers, groups) in front."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    act = cfg.activation_dtype
    return {
        "ssm": torch.zeros(tuple(lead) + (batch, H, P, N), dtype=act,
                           device=device),
        "conv": torch.zeros(tuple(lead) + (batch, cfg.ssm_conv - 1,
                                           conv_dim), dtype=act,
                            device=device),
    }


def mamba2_decode(params, state, u_tok, cfg) -> tuple:
    """One-token recurrent update. u_tok: (B, 1, d). Returns (y, state):
    the new SSM state (rounded to the state's dtype) and the shifted conv
    window are copied into `state`'s tensors in place."""
    di, G, N = cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    b, act, f32 = u_tok.shape[0], u_tok.dtype, torch.float32
    z, xBC_raw, dt = _split_proj(params, u_tok, cfg)
    window = torch.cat([state["conv"], xBC_raw], dim=1)     # (B, K, conv_dim)
    # the reference's einsum "bkc,kc->bc": exact products, fp32 sums
    conv = (window.to(f32) * params["conv_w"].to(act).to(f32)).sum(1)
    xBC = F.silu(conv.to(act) + params["conv_b"].to(act))[:, None]
    x, B, C = torch.split(xBC, [di, G * N, G * N], dim=-1)
    x = x.reshape(b, H, P)
    # each group's B and C over its H / G heads (the reference's repeat)
    B = B.reshape(b, G, 1, N).expand(b, G, H // G, N).reshape(b, H, N)
    C = C.reshape(b, G, 1, N).expand(b, G, H // G, N).reshape(b, H, N)
    dt = softplus(dt.to(f32) + params["dt_bias"].to(f32))[:, 0]     # (b, H)
    A = -torch.exp(params["A_log"].to(f32))
    da = torch.exp(dt * A[None])
    S = state["ssm"].to(f32)
    S = S * da[..., None, None] + (x * dt[..., None]).to(f32)[..., None] \
        * B.to(f32)[:, :, None, :]
    y = torch.matmul(S, C.to(f32)[..., None])[..., 0]               # (b, H, P)
    y = y.to(act) + x * params["D"].to(act)[None, :, None]
    y = rmsnorm(params["out_norm"], y.reshape(b, 1, di) * F.silu(z))
    out = torch.matmul(y, params["out_proj"].to(act))
    state["ssm"].copy_(S.to(state["ssm"].dtype))
    state["conv"].copy_(window[:, 1:])
    return out, state
