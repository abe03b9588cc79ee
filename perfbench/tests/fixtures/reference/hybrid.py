"""A hybrid configuration's reference: the port's eps-net at the file's
widths in fp32 (the plain versions of its kernels, on the CPU), sampled
by the benchmark's UniPC. Unguided, as the port's diffusion LM is."""

import dataclasses

import torch

from perfbench import harness
from perfbench.reference import unipc


def sample(cfg: dict, params: dict, x_T: torch.Tensor, class_ids, w_cfg,
           solver: dict) -> torch.Tensor:
    from repro_torch.models import api

    pcfg = dataclasses.replace(harness.port_config(cfg), dtype="float32")
    net = api.eps_network(pcfg)
    sched = unipc.schedule_of(solver)
    N = x_T.shape[0]

    def x0_of(x, t):
        tt = torch.full((N,), t, dtype=torch.float32, device=x.device)
        e = net(params, x.to(torch.float32), tt, {}).to(torch.float64)
        return (x - sched.sigma(t) * e) / sched.alpha(t)

    with torch.no_grad():
        return unipc.sample(x0_of, x_T, solver)
