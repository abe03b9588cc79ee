"""Plain PyTorch version of blockwise attention (GQA, causal, sliding window)."""

import math

import torch


def attention(q, k, v, *, causal=True, window=None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D). fp32 softmax, scale 1/sqrt(D)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, Hkv, group, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    s = torch.where(ok, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", w, v.to(torch.float32))
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def attention_lse(q, k, *, causal=True, window=None):
    """The forward's log-sum-exp (B, Hq, Sq), fp32: logsumexp over the keys
    of the scaled, masked scores (what the kernel saves for the backward)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D).to(torch.float32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32)) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    s = torch.where(ok, s, torch.full_like(s, -1e30))
    return torch.logsumexp(s, dim=-1).reshape(B, Hq, Sq)


def attention_bwd(q, k, v, o, lse, do):
    """The gradient of non-causal `attention` with Hq == Hkv written out
    (FlashAttention-2's backward, not autograd): (dq, dk, dv) from the
    output o, the forward's log-sum-exp `lse` (B, H, Sq, fp32) and the
    output's gradient do. fp32 statistics:

        P  = exp(scale * q k^T - lse),   Delta = rowsum(do * o)
        dS = P * (do v^T - Delta)
        dq = scale * dS k,   dk = scale * dS^T q,   dv = P^T do

    each cast to the dtype of its input."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    dof = do.to(torch.float32)
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
                  - lse[..., None])
    delta = (dof * o.to(torch.float32)).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
