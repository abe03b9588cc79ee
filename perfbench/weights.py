"""The weights of a cell, made from the seed on the device, in the port's
param layout, in the configuration's param dtype. The program and the
reference are each handed a set made by `make_params` from the same seed,
so neither reads what the other made.

A configuration names its weights under `weights`: `dit` (the default) is
the DiT below; any other name is the module `params/<name>.py`, found by
name, with a `make_params(cfg, seed, device)` of its own.

The DiT's layout is {"backbone": {...}}, each block leaf stacked over
layers as (L, ...). One torch.Generator on the device draws every leaf,
one call a leaf, in a fixed order. Scales: a dense weight N(0, 1) /
sqrt(fan_in), the patch projection a tenth of that, so that the blocks,
and not the patch path, make most of the residual stream, as in a trained
DiT, and every block's attention and adaLN shows in the output. The
adaLN-zero leaves (ada, final_ada and their biases, out_proj), zero in a
fresh DiT, are drawn too: with them at zero the output is exactly zero
and every comparison vacuous. The class embedding is N(0, 1), as large as
the timestep path, so that a wrong class shows in the output.
"""

from __future__ import annotations

import math

import torch

from perfbench import harness

ADA_SCALE = 0.5     # x 1/sqrt(d): shifts, scales and gates of rms ~0.5
ADA_BIAS_SCALE = 0.02
IN_PROJ_SCALE = 0.1  # x 1/sqrt(latent_dim)
ROUNDINGS = {"e4m3": torch.float8_e4m3fn}   # the weight-rounding controls


def make_params(cfg: dict, seed: int, device) -> dict:
    """The configuration's weights from the seed, by the name it gives
    under `weights`."""
    name = cfg.get("weights", "dit")
    if name == "dit":
        return dit_params(cfg, seed, device)
    return harness.module_of("params", name).make_params(cfg, seed, device)


def rounded(params: dict, fmt: str) -> dict:
    """The weight-rounding control, in place: every floating leaf of two or
    more dimensions, read as a stack of (K, N) matrices over its last two,
    rounded to `fmt` (a key of ROUNDINGS) with an fp32 absmax scale per
    output column (over K) and cast back to its own dtype. Any family's
    weights, whatever the program does with them afterwards."""
    low = ROUNDINGS[fmt]
    top = torch.finfo(low).max
    for v in params.values():
        if isinstance(v, dict):
            rounded(v, fmt)
        elif v.dim() >= 2 and v.is_floating_point():
            w = v.to(torch.float32)
            scale = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) / top
            v.copy_((w / scale).to(low).to(torch.float32) * scale)
    return params


def dit_params(cfg: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dt = getattr(torch, cfg["param_dtype"])
    d, f, L = cfg["d_model"], cfg["d_ff"], cfg["num_layers"]
    hd = cfg["num_heads"] * cfg["head_dim"]
    C = cfg["latent_dim"]

    def draw(shape, scale):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dt)

    def dense(k, n, lead=()):
        return draw(lead + (k, n), 1.0 / math.sqrt(k))

    blocks = {
        "attn": {"wq": dense(d, hd, (L,)), "wk": dense(d, hd, (L,)),
                 "wv": dense(d, hd, (L,)), "wo": dense(hd, d, (L,))},
        "w1": dense(d, f, (L,)),
        "w2": dense(f, d, (L,)),
        "ada": draw((L, d, 6 * d), ADA_SCALE / math.sqrt(d)),
        "ada_b": draw((L, 6 * d), ADA_BIAS_SCALE),
    }
    p = {
        "in_proj": draw((C, d), IN_PROJ_SCALE / math.sqrt(C)),
        "t_mlp1": dense(256, d),
        "t_mlp2": dense(d, d),
        "blocks": blocks,
        "final_ada": draw((d, 2 * d), ADA_SCALE / math.sqrt(d)),
        "final_ada_b": draw((2 * d,), ADA_BIAS_SCALE),
        "out_proj": dense(d, C),
    }
    if cfg["conditional"]:
        # the last row is the null class of classifier-free guidance
        p["class_embed"] = draw((cfg["num_classes"] + 1, d), 1.0)
    return {"backbone": p}
