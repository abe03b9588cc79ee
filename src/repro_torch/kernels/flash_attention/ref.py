"""Plain PyTorch version of blockwise attention (GQA, causal, sliding window)."""

import math

import torch


def _visible(Sq: int, Skv: int, causal: bool, window, device) -> torch.Tensor:
    """(Sq, Skv) bool: key <= query (causal), key > query - window."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return ok


def attention(q, k, v, *, causal=True, window=None, round_p=False,
              scale=None):
    """q, k: (B, Hq|Hkv, S, D); v: (B, Hkv, Skv, Dv), Dv == D or not (MLA's
    192-deep scores over 128-wide values). fp32 softmax, scale 1/sqrt(D)
    unless given; `attention32`'s output rounded to q's dtype."""
    return attention32(q, k, v, causal=causal, window=window,
                       round_p=round_p, scale=scale).to(q.dtype)


def attention32(q, k, v, *, causal=True, window=None, round_p=False,
                scale=None):
    """The fp32 output of `attention`, before its rounding to q's dtype (what
    the kernel's `lse=True` form saves for the backward's Delta).

    `round_p=True` is a yardstick, not a path of the port: P = exp(s -
    rowmax) is rounded once to bf16 before P.V, and the denominator sums
    the unrounded fp32 P. It is what a bf16 kernel that packs P into one
    bf16 operand computes, and the distance a kernel's P.V has to stay well
    inside: the `mma` body splits P into bf16 hi + lo operands and keeps
    its 16 bits. The default keeps P in fp32 (the reference's Pallas kernel
    does too)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, Hkv, group, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32))
    s = s / math.sqrt(D) if scale is None else s * scale
    ok = _visible(Sq, Skv, causal, window, q.device)
    s = torch.where(ok, s, torch.full_like(s, -1e30))
    vf = v.to(torch.float32)
    if round_p:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.einsum("bhgqk,bhkd->bhgqd",
                         p.to(torch.bfloat16).to(torch.float32), vf)
        o = o / p.sum(dim=-1, keepdim=True)
    else:
        o = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(s, dim=-1), vf)
    return o.reshape(B, Hq, Sq, v.shape[3])


def attention_lse(q, k, *, causal=True, window=None):
    """The forward's log-sum-exp (B, Hq, Sq), fp32: logsumexp over the keys
    of the scaled, masked scores (what the kernel saves for the backward)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D).to(torch.float32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32)) / math.sqrt(D)
    ok = _visible(Sq, Skv, causal, window, q.device)
    s = torch.where(ok, s, torch.full_like(s, -1e30))
    return torch.logsumexp(s, dim=-1).reshape(B, Hq, Sq)


def attention_bwd(q, k, v, o, lse, do, *, causal=False, window=None):
    """The gradient of `attention(q, k, v, causal=causal, window=window)`
    written out (FlashAttention-2's backward, not autograd): (dq, dk, dv)
    from the output o (for Delta; the fp32 output before its rounding, as
    the kernel reads it, or the output itself), the forward's log-sum-exp
    `lse` (B, Hq, Sq, fp32) and the output's gradient do. Note the default:
    non-causal. fp32 statistics:

        P  = exp(scale * q k^T - lse), 0 where masked,  Delta = rowsum(do * o)
        dS = P * (do v^T - Delta), 0 where masked
        dq = scale * dS k,   dk = scale * dS^T q,   dv = P^T do

    A query whose every key is masked (a window with Sq > Skv + window - 1)
    has the mean of V as its output, the softmax of equal scores: P = 1 /
    Skv on each key and dS = 0, as autograd through `attention` gives. dk
    and dv of a kv head sum its group's q heads. Each gradient is cast to
    the dtype of its input."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.to(torch.float32).reshape(B, Hkv, G, Sq, D)
    dof = do.to(torch.float32).reshape(B, Hkv, G, Sq, D)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    ok = _visible(Sq, Skv, causal, window, q.device)
    dead = ~ok.any(dim=-1, keepdim=True)
    p = torch.exp(torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
                  - lse.reshape(B, Hkv, G, Sq, 1))
    p = torch.where(ok, p, dead.to(torch.float32) / Skv)
    delta = (dof * o.to(torch.float32).reshape(B, Hkv, G, Sq, D)).sum(
        dim=-1, keepdim=True)
    ds = torch.where(ok, p * (torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
                              - delta), torch.zeros_like(p))
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
