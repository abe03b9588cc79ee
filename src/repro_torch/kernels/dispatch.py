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

While an operation count is active (`COUNT`, set by
`analysis/opcount.py`), each wrapper reports one `Cost` a call to it
(`COUNT.kernel`): the kernel's work, on whichever route the call takes. The
count does not see the route's own aten ops (a kernel is a ctypes call it
could not see anyway), so one call counts the same when the kernel runs on
the card, when the plain version runs on the CPU, and on the meta device.
A wrapper tests `COUNT` where it launches and, with no count active, goes
straight to its route.
"""

from __future__ import annotations

from collections import Counter
from contextlib import contextmanager
from typing import Iterator, NamedTuple, Optional

import torch

BACKENDS = ("plain",)
LAUNCHES: Counter = Counter()
COUNT = None          # the active operation count (opcount.OpCount), or None


class Cost(NamedTuple):
    """What one kernel call must do at the least: its operations, the bytes
    it must move (each input read once, each output written once) and the
    dtype whose peak rate bounds the operations. `matmul`: the operations
    are products of the kind an operation count of a whole run counts (the
    reference's HLO dots, `torch.utils.flop_counter`'s formulas); an
    elementwise kernel's are not, as no elementwise op's are."""
    flops: float
    bytes: float
    dtype: torch.dtype
    matmul: bool = False


def nbytes(*ts: torch.Tensor) -> int:
    """The bytes of the elements of each tensor (a view's, not its
    storage's)."""
    return sum(t.numel() * t.element_size() for t in ts)


def laid_out_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`t` in the layout the kernel gives its output (`torch.empty_like(
    like)`): the plain version's result off the card while a count is
    active, so the ops after the call (a view there, a copy after a
    contiguous result) are those that follow the kernel's."""
    if COUNT is None or t.stride() == like.stride():
        return t
    return torch.empty_like(like).copy_(t)


def use_kernel(backend: Optional[str], t: torch.Tensor) -> bool:
    """True to launch the kernel on `t`, False for the plain version. A
    meta tensor (shapes only: the dry run, `launch/dryrun.py`) takes the
    plain version, which computes nothing there."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend must be None or one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend == "plain":
        return False
    if t.device.type == "cuda":
        return True
    if t.device.type not in ("cpu", "meta"):
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
