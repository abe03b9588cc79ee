"""Backend dispatch shared by the kernel ops wrappers, and their launch counts.

A wrapper runs its Hopper kernel on a CUDA tensor and its plain PyTorch
version (`ref.py`) on a CPU tensor. The device decides, never a failure:
there is no fallback from a kernel to the plain version. `backend` is
``None`` (by the tensor's device, the default everywhere) or ``"plain"``:
the plain version on any device, pinned explicitly by the parity runs that
hold a kernel against it on the card.

`LAUNCHES[name]` counts the kernel launches of each wrapper; it is bumped
right where the kernel is launched and nowhere else.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

BACKENDS = ("plain",)
LAUNCHES: Counter = Counter()


def use_kernel(backend: Optional[str], t: torch.Tensor) -> bool:
    """True to launch the kernel on `t`, False for the plain version."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend must be None or one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend == "plain":
        return False
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise RuntimeError(f"no kernel or plain path for device {t.device}")
    return False


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The checks every kernel wrapper shares: one CUDA device, contiguous
    last dimension handled by the caller."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on the same CUDA "
                             f"device; got {[str(x.device) for x in tensors]}")
