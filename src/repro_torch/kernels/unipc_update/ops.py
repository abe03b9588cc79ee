"""Public wrapper for the fused UniPC update: device dispatch + shape plumbing
(the port of `repro/kernels/unipc_update/ops.py`)."""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref
from ..dispatch import use_kernel


def weighted_combine(terms: torch.Tensor, weights: torch.Tensor,
                     backend: Optional[str] = None) -> torch.Tensor:
    """terms: (K, *shape); weights: (K,) or (K, B). Returns sum_k w_k * terms[k].

    For batched states (B, ...) the kernel runs over the (K, B, N) view, a
    reshape of contiguous trailing dims. Per-slot (K, B) weights give every
    batch row its own weight column and need terms shaped (K, B, ...).
    `backend="plain"` pins the plain version (kernels/dispatch.py).
    """
    shape = terms.shape[1:]
    K = terms.shape[0]
    per_slot = weights.ndim == 2
    if per_slot and (len(shape) < 2 or shape[0] != weights.shape[1]):
        raise ValueError(
            f"per-slot weights (K, B)={tuple(weights.shape)} need terms shaped "
            f"(K, B, ...); got terms {tuple(terms.shape)}")
    if not use_kernel(backend, terms):
        return ref.weighted_combine(terms, weights)
    B = shape[0] if len(shape) >= 2 else 1
    out = kernel.fused_combine_batched(terms.reshape(K, B, -1), weights)
    return out.reshape(shape)
