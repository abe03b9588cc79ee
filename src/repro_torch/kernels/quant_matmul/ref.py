"""Plain PyTorch version of the quantized matmul, and the quantization
helpers (the port of `repro/kernels/quant_matmul/ref.py`).

Symmetric absmax quantization:

* weights — per output channel (one fp32 scale per output column, absmax
  over the contraction axis K of `(..., K, N)`) or per tensor (one scale per
  weight matrix, broadcast to the channel shape). Stored in an int8
  container (int4 tiers clip to +/-7 inside it) or as fp8 e4m3.
* activations — an optional static per-tensor scale calibrated by
  `models/quant.py`; `sa=None` leaves the activations floating (W8A16).

Rounding is the reference's: divide in fp32, round half to even, clip, then
store. Every divisor is a tensor on the operand's device, so the division
is a true fp32 division on the card too (PyTorch turns a division by a host
scalar into a multiplication by its reciprocal there).

`matmul` is the core every path agrees on: both operands widened to fp32,
fp32 accumulation, then `* scale`.
"""

from __future__ import annotations

import torch

GRANULARITIES = ("channel", "tensor")

_QMAX = {8: 127.0, 4: 7.0}    # symmetric integer ranges
FP8_MAX = 448.0               # e4m3 saturates at +/-448
ACT_QMAX = 127.0
_TINY = 1e-12                 # floor for absmax-derived scales
FP8 = torch.float8_e4m3fn


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def quantize(w: torch.Tensor, *, bits: int = 8, granularity: str = "channel",
             fmt: str = "int"):
    """w: (..., K, N) float -> (qw, scale) with scale (..., N) fp32.

    channel: absmax over K, one scale per output column; tensor: absmax over
    (K, N) per leading index, broadcast to (..., N). `fmt="fp8"` stores e4m3
    weights (`bits` is ignored); otherwise an int8 container holding
    `bits`-bit values."""
    if granularity not in GRANULARITIES:
        raise ValueError(f"granularity must be one of {GRANULARITIES}, "
                         f"got {granularity!r}")
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=-2)                               # (..., N)
    if granularity == "tensor":
        amax = amax.amax(dim=-1, keepdim=True).expand(amax.shape).contiguous()
    if fmt == "fp8":
        scale = amax.clamp_min(_TINY) / _f32(FP8_MAX, wf)
        return (wf / scale[..., None, :]).to(FP8), scale
    if bits not in _QMAX:
        raise ValueError(f"bits must be one of {sorted(_QMAX)}, got {bits}")
    qmax = _QMAX[bits]
    scale = amax.clamp_min(_TINY) / _f32(qmax, wf)
    q = torch.round(wf / scale[..., None, :])
    return q.clamp(-qmax, qmax).to(torch.int8), scale


def dequantize(qw: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(qw (..., K, N), scale (..., N)) -> fp32 weights."""
    return qw.to(torch.float32) * scale[..., None, :].to(torch.float32)


def quantize_act(x: torch.Tensor, sa) -> torch.Tensor:
    """Static-scale symmetric activation quantization: x float -> int8."""
    q = torch.round(x.to(torch.float32) / _f32(sa, x))
    return q.clamp(-ACT_QMAX, ACT_QMAX).to(torch.int8)


def matmul(x: torch.Tensor, qw: torch.Tensor,
           scale: torch.Tensor) -> torch.Tensor:
    """(x (M, K) @ qw (K, N)) * scale (N,), fp32 (M, N). x is float (W8A16)
    or int8 (W8A8, with the activation scale already folded into `scale`);
    qw is int8 or fp8."""
    acc = torch.matmul(x.to(torch.float32), qw.to(torch.float32))
    return acc * scale.to(torch.float32)[None, :]


def fold_act(x2: torch.Tensor, ws: torch.Tensor, sa=None):
    """(x2, ws) as the matmul core takes them: fp32 scales and, with a
    static activation scale `sa` (W8A8), x2 quantized to int8 and `sa`
    folded into the scales, so every path computes (x_q @ qw) * (sa * ws)."""
    scale = ws.to(torch.float32)
    if sa is None:
        return x2, scale
    return quantize_act(x2, sa), scale * _f32(sa, scale)


def quant_matmul(x, qw, ws, *, sa=None):
    """The full plain path over a weight record: quantizes the activations
    when `sa` is given, then the fp32 core. x: (..., K) -> (..., N) in
    x's dtype."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2, scale = fold_act(x.reshape(-1, K), ws, sa)
    return matmul(x2, qw, scale).to(x.dtype).reshape(*lead, qw.shape[-1])
