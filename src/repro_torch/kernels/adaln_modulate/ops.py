"""Public wrapper for the fused adaLN modulation: device dispatch (the port of
`repro/kernels/adaln_modulate/ops.py`; the kernels take any D and T, so
there is no padding to do)."""

from __future__ import annotations

from typing import Optional

from . import kernel, ref
from ..dispatch import use_kernel


def modulate(x, shift, scale, *, eps=1e-5, backend: Optional[str] = None):
    """LN(x) * (1 + scale) + shift in one pass. x: (B, T, D); shift/scale:
    (B, D). `backend="plain"` pins the plain version (kernels/dispatch.py)."""
    if not use_kernel(backend, x):
        return ref.modulate(x, shift, scale, eps=eps)
    return kernel.adaln_modulate(x, shift, scale, eps=eps)


def gate_residual(resid, gate, y, *, backend: Optional[str] = None):
    """resid + gate * y in one pass. resid/y: (B, T, D); gate: (B, D)."""
    if not use_kernel(backend, resid):
        return ref.gate_residual(resid, gate, y)
    return kernel.gate_residual(resid, gate, y)
