"""The DiT eps-net (Peebles & Xie 2023, arXiv:2212.09748) as the
configuration files describe it, in plain fp32 PyTorch, and guided UniPC
sampling over it.

    h = patches @ in_proj
    c = silu(silu(temb(1000 t) @ t_mlp1) @ t_mlp2 + class_embed[y])
    per block:  (sh1, sc1, g1, sh2, sc2, g2) = c @ ada + ada_b
                h += g1 * attn(LN(h) * (1 + sc1) + sh1) @ wo
                h += g2 * gelu_tanh((LN(h) * (1 + sc2) + sh2) @ w1) @ w2
    out:        (sh, sc) = c @ final_ada + final_ada_b
                eps = (LN(h) * (1 + sc) + sh) @ out_proj

LN has no affine and eps 1e-5; attention is softmax(q k^T / sqrt(D)) v
over all tokens, per head. The departures from the published DiT that the
configurations list under `assumed` (no positional embedding, no biases
on the projections, eps only) are the model's. Classifier-free guidance
follows DiT: eps = eps_u + w (eps_c - eps_u), the null class the last row
of the class table. A configuration with `quant` is computed with its
quantized sites' weights quantized here again and widened to fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import unipc

LN_EPS = 1e-5


def no_tf32() -> None:
    """fp32 products in fp32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def quantize_channel(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric absmax quantization per output column (absmax over K of
    (..., K, N)), fp32: scale = max(absmax, 1e-12) / qmax, q = round half
    to even of w / scale clipped to +-qmax; returns q * scale in fp32."""
    qmax = float(2 ** (bits - 1) - 1)
    w = w.to(torch.float32)
    amax = w.abs().amax(dim=-2, keepdim=True)
    scale = amax.clamp_min(1e-12) / torch.tensor(qmax, device=w.device)
    q = torch.round(w / scale).clamp(-qmax, qmax)
    return q * scale


def prepare(cfg: dict, params: dict) -> dict:
    """The fp32 weights the reference computes with: the config's quantized
    sites quantized and widened, every other leaf as made."""
    bb = params["backbone"]
    f32 = {k: v.to(torch.float32) for k, v in bb.items()
           if k not in ("blocks",)}
    blocks = {k: v.to(torch.float32) for k, v in bb["blocks"].items()
              if k != "attn"}
    blocks.update({k: v.to(torch.float32)
                   for k, v in bb["blocks"]["attn"].items()})
    q = cfg.get("quant")
    if q:
        if q["granularity"] != "channel":
            raise ValueError("the reference quantizes per channel only")
        for site in q["sites"]:
            tree = f32 if site in f32 else blocks
            tree[site] = quantize_channel(tree[site], q["bits"])
    f32["blocks"] = blocks
    return f32


def _ln(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS)


def _modulate(x, shift, scale):
    return _ln(x) * (1.0 + scale[:, None]) + shift[:, None]


def timestep_features(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, device=t.device, dtype=torch.float32) / half)
    ang = (t.to(torch.float32) * 1000.0)[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def eps(w: dict, cfg: dict, x: torch.Tensor, t: torch.Tensor,
        class_ids) -> torch.Tensor:
    """x: (R, T, C) fp32 patch tokens; t: (R,); class_ids: (R,) or None.
    Returns eps-hat (R, T, C) in fp32."""
    R, T, _ = x.shape
    H, D = cfg["num_heads"], cfg["head_dim"]
    h = x @ w["in_proj"]
    c = F.silu(timestep_features(t) @ w["t_mlp1"]) @ w["t_mlp2"]
    if class_ids is not None:
        c = c + w["class_embed"][class_ids]
    c = F.silu(c)
    b = w["blocks"]
    for layer in range(cfg["num_layers"]):
        mod = c @ b["ada"][layer] + b["ada_b"][layer]
        sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(mod, 6, dim=-1)
        hn = _modulate(h, sh1, sc1)
        q = (hn @ b["wq"][layer]).reshape(R, T, H, D).transpose(1, 2)
        k = (hn @ b["wk"][layer]).reshape(R, T, H, D).transpose(1, 2)
        v = (hn @ b["wv"][layer]).reshape(R, T, H, D).transpose(1, 2)
        p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(D), dim=-1)
        a = (p @ v).transpose(1, 2).reshape(R, T, H * D)
        h = h + g1[:, None] * (a @ b["wo"][layer])
        hn = _modulate(h, sh2, sc2)
        y = F.gelu(hn @ b["w1"][layer], approximate="tanh") @ b["w2"][layer]
        h = h + g2[:, None] * y
    sh, sc = torch.chunk(c @ w["final_ada"] + w["final_ada_b"], 2, dim=-1)
    return _modulate(h, sh, sc) @ w["out_proj"]


def sample(cfg: dict, params: dict, x_T: torch.Tensor, class_ids, w_cfg,
           solver: dict) -> torch.Tensor:
    """Guided (class_ids and w_cfg, (N,) each) or unconditional (None)
    UniPC sampling of the N latents x_T (N, T, C); returns them in
    float64."""
    no_tf32()
    wts = prepare(cfg, params)
    N = x_T.shape[0]
    sched = unipc.schedule_of(solver)
    null = (None if class_ids is None else
            torch.full_like(class_ids, cfg["num_classes"]))
    if w_cfg is not None:
        w_cfg = w_cfg.to(torch.float64).reshape(N, 1, 1)

    def x0_of(x, t):
        tt = torch.full((N,), t, dtype=torch.float32, device=x.device)
        x32 = x.to(torch.float32)
        if class_ids is None:
            e = eps(wts, cfg, x32, tt, None).to(torch.float64)
        else:
            ee = eps(wts, cfg, torch.cat([x32, x32]), torch.cat([tt, tt]),
                     torch.cat([class_ids, null])).to(torch.float64)
            e_c, e_u = ee[:N], ee[N:]
            e = e_u + w_cfg * (e_c - e_u)
        return (x - sched.sigma(t) * e) / sched.alpha(t)

    with torch.no_grad():
        return unipc.sample(x0_of, x_T, solver)
