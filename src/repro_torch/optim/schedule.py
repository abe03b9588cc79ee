"""Learning-rate schedules (the port of `repro.optim.schedule`), computed in
float32 on the step tensor's device, as the reference computes them."""

from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """Linear warmup then cosine decay to floor * peak."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(1, warmup_steps)
        frac = torch.clamp((step - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        # the fp32 angle's cosine rounded once from float64: torch's fp32
        # cos can sit an ulp off the rounded value, and 1 + cos near the end
        # of the decay would lift that to several ulps of the rate
        cos_a = torch.cos((math.pi * frac).to(torch.float64)).to(torch.float32)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + cos_a))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def constant(lr_value: float):
    return lambda step: torch.full((), lr_value, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)
