"""Backend dispatch shared by the kernel ops wrappers, and their launch counts.

A wrapper runs its Hopper kernel on a CUDA tensor and its plain PyTorch
version (`ref.py`) on a CPU tensor. The device decides, never a failure:
there is no fallback from a kernel to the plain version. `backend` is
``None`` (by the tensor's device, the default everywhere) or ``"plain"``:
the plain version on any device, pinned explicitly by the parity runs that
hold a kernel against it on the card.

`LAUNCHES[name]` counts the kernel launches of each wrapper executed on the
device. An eager call bumps it right where the kernel is launched and
nowhere else. Under a CUDA graph (`engine/graphs.py`) the count is
"captured x replays": `recording()` moves the bumps of a capture, which
launches nothing, into the graph's own counter, and each replay adds that
counter to `LAUNCHES`. So a run counts the same whether it ran eagerly or
as a replay.
"""

from __future__ import annotations

from collections import Counter
from contextlib import contextmanager
from typing import Iterator, Optional

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


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Grad mode is on and an operand requires grad: a kernel call must then
    go through its autograd Function (or refuse, where it has no
    backward)."""
    return torch.is_grad_enabled() and any(
        getattr(t, "requires_grad", False) for t in tensors)


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where a kernel without a backward would be asked for a
    gradient: its output would come back detached, and a loss built on it
    would train nothing behind it without an error."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an operand requires "
            f"grad with grad mode on; run it under torch.no_grad(), detach "
            f"the operands, or pin the plain version (backend=\"plain\")")


@contextmanager
def recording() -> Iterator[Counter]:
    """Collect the launches bumped inside the block into a counter of their
    own and take them back out of `LAUNCHES`: a CUDA graph capture records
    its kernels without running them."""
    before = Counter(LAUNCHES)
    captured: Counter = Counter()
    try:
        yield captured
    finally:
        captured.update(LAUNCHES - before)
        LAUNCHES.clear()
        LAUNCHES.update(before)
