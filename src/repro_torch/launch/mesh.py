"""Meshes for the port (the counterpart of `repro/launch/mesh.py`).
Functions, not module constants: importing this module touches no CUDA.

The port's mesh is its own small class, `Mesh`: the ordered axis sizes
(`shape`, a dict as in JAX) and either a tuple of `torch.device`s, one a
position in row-major order, or None. None is an abstract mesh, the
counterpart of `jax.sharding.AbstractMesh`: the production meshes (16 x 16
chips, or 2 pods of them) are abstract, and the dry run sums per-chip bytes
on them with `parallel.sharding.NamedSharding.shard_shape`.

It is not a `torch.distributed.DeviceMesh`. A DeviceMesh needs a process
group with one rank per device, and one card cannot host the 256 or 512
ranks of the production meshes; a process group is also process-wide state
that would leak between tests running in one process. One card's concrete
mesh is 1x1 (`make_host_mesh`), where every placement holds the whole
tensor.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..engine.engine import resolve_device


class Mesh:
    """Ordered axis sizes, and the devices at their positions (None for an
    abstract mesh)."""

    def __init__(self, shape: dict, devices: Optional[tuple] = None):
        self.shape = dict(shape)
        self.devices = None if devices is None else tuple(
            _indexed(d) for d in devices)
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a {tuple(self.shape.values())} mesh needs "
                             f"{self.size} devices, got {len(self.devices)}")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        axes = ", ".join(f"{k}: {v}" for k, v in self.shape.items())
        where = "abstract" if self.devices is None else str(
            [str(d) for d in self.devices])
        return f"Mesh({axes}; {where})"


def _indexed(device) -> torch.device:
    """`device` as a tensor on it reports its device: "cuda" is the
    current card's index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips with a leading 'pod'
    axis. Abstract: no card holds it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(dict(zip(axes, shape)))


def make_host_mesh(device="cuda") -> Mesh:
    """The 1x1 mesh over one device, with the production axis names: the
    CUDA card unless the caller names another device ("cpu", as the tests
    do, or "meta"). With no card and no device named it raises, as the
    entry points do; it never quietly takes the CPU."""
    return Mesh({"data": 1, "model": 1}, (resolve_device(device),))


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1
