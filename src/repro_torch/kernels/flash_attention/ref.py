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
