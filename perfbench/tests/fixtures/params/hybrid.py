"""A hybrid configuration's weights: the port's own initialisation of the
file's ModelConfig from the seed, with the diffusion head's out_proj
drawn, N(0, 1) / sqrt(d_model): the port's is zero, which makes every eps
zero and every comparison vacuous."""

import math

import torch

from perfbench import harness


def make_params(cfg: dict, seed: int, device) -> dict:
    from repro_torch.models import api

    pcfg = harness.port_config(cfg)
    p = api.init_params(pcfg, int(seed), device)
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    d, C = pcfg.d_model, pcfg.latent_dim
    out = torch.randn((d, C), generator=gen, device=device,
                      dtype=torch.float32)
    p["diffusion_head"]["out_proj"] = (out / math.sqrt(d)).to(
        pcfg.weight_dtype)
    return p
