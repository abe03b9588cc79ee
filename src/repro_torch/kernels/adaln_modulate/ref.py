"""Plain PyTorch version of the fused adaLN-zero modulation (fp32 math)."""

import torch


def modulate(x, shift, scale, eps=1e-5):
    """LN(x) * (1 + scale) + shift. x: (B, T, D); shift/scale: (B, D).

    Layernorm without learnable affine: fp32 mean, then the population
    variance of the centred values (jnp.var), cast back to x.dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    cen = xf - mu
    var = (cen * cen).mean(dim=-1, keepdim=True)
    y = cen * torch.rsqrt(var + eps)
    out = (y * (1.0 + scale.to(torch.float32))[:, None]
           + shift.to(torch.float32)[:, None])
    return out.to(x.dtype)


def gate_residual(resid, gate, y):
    """resid + gate * y — the adaLN-zero gated residual re-entry.
    resid/y: (B, T, D); gate: (B, D)."""
    out = (resid.to(torch.float32)
           + gate.to(torch.float32)[:, None] * y.to(torch.float32))
    return out.to(resid.dtype)
