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


def modulate_bwd(g, x, scale, eps=1e-5):
    """The gradient of `modulate` written out (not autograd): (dx, dshift,
    dscale) from the output's gradient g (B, T, D), x and scale, each in the
    dtype of the input it belongs to. fp32 throughout: the row's mean and
    rstd are recomputed from x, x_hat = (x - mean) * rstd and
    g_hat = g * (1 + scale); then

        dx     = rstd * (g_hat - mean(g_hat) - x_hat * mean(g_hat * x_hat))
        dshift = sum_t g,    dscale = sum_t g * x_hat.
    """
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    cen = xf - mu
    rstd = torch.rsqrt((cen * cen).mean(dim=-1, keepdim=True) + eps)
    xh = cen * rstd
    gf = g.to(torch.float32)
    gh = gf * (1.0 + scale.to(torch.float32))[:, None]
    dx = rstd * (gh - gh.mean(dim=-1, keepdim=True)
                 - xh * (gh * xh).mean(dim=-1, keepdim=True))
    return (dx.to(x.dtype), gf.sum(dim=1).to(scale.dtype),
            (gf * xh).sum(dim=1).to(scale.dtype))


def gate_residual_bwd(g, gate, y):
    """The gradient of `gate_residual` written out: (dresid, dgate, dy) from
    the output's gradient g (B, T, D). dresid = g; dy = gate * g rounded to
    y's dtype; dgate = sum_t g * y in fp32, rounded to gate's dtype."""
    gf = g.to(torch.float32)
    dy = gate.to(torch.float32)[:, None] * gf
    dgate = (gf * y.to(torch.float32)).sum(dim=1)
    return g, dgate.to(gate.dtype), dy.to(y.dtype)
