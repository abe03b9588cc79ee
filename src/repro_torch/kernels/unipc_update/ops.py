"""Public wrappers of the fused UniPC update: device dispatch + shape plumbing
(the port of `repro/kernels/unipc_update/ops.py`, and the sampler row's
predictor and corrector built on the same kernel)."""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref
from ..dispatch import use_kernel
from .ref import pack_weight_rows  # noqa: F401  (the row table's layout)


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


def unipc_row_predict(x: torch.Tensor, E: torch.Tensor, rows: torch.Tensor,
                      idx, sign: float,
                      backend: Optional[str] = None) -> torch.Tensor:
    """The predictor of one sampler row: x_pred from the state x (B, ...),
    the eval ring E (K + 1, B, ...), newest first, and row `idx` of the
    packed weight table `rows` (`pack_weight_rows`), clipped to it. `idx` is
    a 0-d (every sample on the same row) or per-slot (B,) int64 tensor; the
    kernel reads it on the card, so a CUDA graph of the row replays the row
    the tensor holds. `sign` is the table's prediction sign.
    `backend="plain"` pins the plain version (kernels/dispatch.py)."""
    if not use_kernel(backend, x):
        return ref.unipc_row_predict(x, E, rows, idx, sign)
    return kernel.unipc_row_predict(x, E, rows, idx, sign)


def unipc_row_correct(x: torch.Tensor, E: torch.Tensor, e_new: torch.Tensor,
                      x_pred: torch.Tensor, rows: torch.Tensor, idx,
                      sign: float, backend: Optional[str] = None) -> tuple:
    """The corrector of the same row: (x_next, E_next) from the row's eval
    e_new (E's dtype) and the predictor's x_pred, and the ring rotated to
    [e_new, E[:-1]] as a new tensor. Operands as `unipc_row_predict`."""
    if not use_kernel(backend, x):
        return ref.unipc_row_correct(x, E, e_new, x_pred, rows, idx, sign)
    return kernel.unipc_row_correct(x, E, e_new, x_pred, rows, idx, sign)
