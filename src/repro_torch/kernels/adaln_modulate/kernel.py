"""Binding of `csrc/adaln_modulate.cu`, the Hopper kernels that replace
`repro/kernels/adaln_modulate/kernel.py:adaln_modulate` and `:gate_residual`."""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from ..dispatch import LAUNCHES, require_cuda

MAX_D = 8 * 1024  # VPT * MAX_ROW_THREADS in the source


@functools.cache
def _launchers():
    lib = build.library("adaln_modulate")
    mod, gate = lib.adaln_modulate, lib.gate_residual
    mod.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    gate.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]
    mod.restype = gate.restype = ctypes.c_int
    return mod, gate


def _check_rows(name, x, *conds):
    """x: contiguous (B, T, D); conds: (B, D) rows with unit column stride
    and one shared row stride, all of x's dtype. Returns that row stride."""
    require_cuda(name, x, *conds)
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (B, T, D) tensor, "
                         f"got shape {tuple(x.shape)}")
    B, _, D = x.shape
    if D > MAX_D:
        raise ValueError(f"{name}: D <= {MAX_D}, got {D}")
    row_stride = conds[0].stride(0)
    for c in conds:
        if c.dtype != x.dtype:
            raise ValueError(f"{name}: dtypes differ ({c.dtype} vs {x.dtype})")
        if (tuple(c.shape) != (B, D) or c.stride(1) != 1
                or c.stride(0) != row_stride):
            raise ValueError(f"{name}: conditioning rows must be (B, D) = "
                             f"({B}, {D}) with unit column stride and a "
                             f"shared row stride; got {tuple(c.shape)} "
                             f"strides {c.stride()}")
    return row_stride


def adaln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LN(x) * (1 + scale) + shift in one pass; x (B, T, D) fp32/bf16."""
    stride = _check_rows("adaln_modulate", x, shift, scale)
    B, T, D = x.shape
    out = torch.empty_like(x)
    rc = _launchers()[0](x.data_ptr(), shift.data_ptr(), scale.data_ptr(),
                         out.data_ptr(), B, T, D, stride, eps,
                         build.dtype_code(x.dtype), build.stream_of(x))
    build.check(rc, "adaln_modulate")
    LAUNCHES["adaln_modulate"] += 1
    return out


def gate_residual(resid: torch.Tensor, gate: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """resid + gate * y in one pass; resid/y (B, T, D), gate (B, D)."""
    stride = _check_rows("gate_residual", resid, gate)
    if y.shape != resid.shape or y.dtype != resid.dtype or not y.is_contiguous():
        raise ValueError(f"gate_residual: y must match resid "
                         f"{tuple(resid.shape)} {resid.dtype} and be "
                         f"contiguous; got {tuple(y.shape)} {y.dtype}")
    require_cuda("gate_residual", resid, y)
    B, T, D = resid.shape
    if B > 65535 or T * D > 2**31 - 1:
        raise ValueError(f"gate_residual: B <= 65535 and T*D < 2^31; got "
                         f"{tuple(resid.shape)}")
    out = torch.empty_like(resid)
    rc = _launchers()[1](resid.data_ptr(), gate.data_ptr(), y.data_ptr(),
                         out.data_ptr(), B, T, D, stride,
                         build.dtype_code(resid.dtype), build.stream_of(resid))
    build.check(rc, "gate_residual")
    LAUNCHES["gate_residual"] += 1
    return out
