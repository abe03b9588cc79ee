"""Logical-axis sharding (the port of `repro.parallel.sharding`): models
annotate tensors with *logical* axis names; a rules table maps those to mesh
axes. Outside a mesh context everything is a no-op, so the same model code
runs in single-device tests and in the dry run on a production mesh.

Two standard rule sets:

* TRAIN_RULES — batch over (pod, data); FSDP: one weight dim over data;
  tensor-parallel dims (d_ff / vocab / experts / heads) over model.
* SERVE_RULES — batch over (pod, data); weights sharded over model only
  (replicated over data), KV-cache batch over data, long-context KV sequence
  over data when batch is too small to occupy the axis.

What one card does with a mesh. The reference's `shard` is
`with_sharding_constraint`: it tells XLA's SPMD partitioner where each block
of a tensor lives. One card has no partitioner and one device, so every
placement holds the whole tensor: `shard` checks the annotation (the rank,
as the reference asserts it, and that the tensor lies on the mesh's device)
and returns the tensor itself, and a run under any rules computes the same
bits as the run without them. With no context active, `shard` is one
thread-local lookup, nothing more (host-bound paths call it per layer). It
neither syncs nor allocates, so it may run inside a CUDA graph capture.

The spec arithmetic (`normalize_axes`, `_axis_len`, the dedupe of axes an
earlier dimension claimed, dropping an entry whose extent does not divide
its dimension) lives in `resolve_spec` alone; `shard_spec` and
`launch/specs._guard` both call it. `PartitionSpec` and `NamedSharding` are
small counterparts of JAX's: `NamedSharding.shard_shape` gives a chip's
block of an array, which the dry run sums into per-chip bytes on an
abstract production mesh (`launch/mesh.py`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

_state = threading.local()


TRAIN_RULES = {
    "model": "model",
    "batch": ("pod", "data"),
    "seq": None,
    "d_model": None,
    "heads": "model",
    "kv_heads": "model",
    "d_ff": "model",
    "vocab": "model",
    "experts": None,          # expert weights: d_ff dim is TP; experts stacked
    "expert_cap": ("pod", "data"),
    "fsdp": "data",           # second weight dim (ZeRO-3 style)
    "kv_seq": None,
    "state": None,
}

SERVE_RULES = {
    "model": "model",
    "batch": ("pod", "data"),
    "seq": None,
    "d_model": None,
    "heads": "model",
    "kv_heads": "model",
    "d_ff": "model",
    "vocab": "model",
    "experts": None,
    "expert_cap": ("pod", "data"),
    "fsdp": None,             # weights replicated over data at serve time
    "kv_seq": None,
    "state": None,
}

LONG_SERVE_RULES = dict(SERVE_RULES, batch=None, kv_seq=("pod", "data"))

# sequence parallelism: residual activations sharded over the model axis
# along *sequence*; when 'seq' and a tensor dim would claim the same mesh
# axis in one annotation, the first occurrence keeps it
SEQ_PARALLEL_TRAIN_RULES = dict(TRAIN_RULES, seq="model")

# decode caches whose kv-head count does not divide the model axis shard
# the cache *sequence* over it instead (kv_heads keeps precedence where it
# divides; the dedupe drops the later claim)
KV_SEQ_SERVE_RULES = dict(SERVE_RULES, kv_seq="model")


class PartitionSpec(tuple):
    """`jax.sharding.PartitionSpec`: one entry a dimension, each None
    (replicated), a mesh axis name, or a tuple of names (the dimension split
    over their product, the first name major). Trailing dimensions without
    an entry are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _entry_axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


class NamedSharding:
    """A spec over a mesh (the port's `launch.mesh.Mesh`, concrete or
    abstract), checked as JAX checks it: every axis named is the mesh's and
    claimed by one dimension at most."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        used = set()
        for entry in self.spec:
            for a in _entry_axes(entry):
                if a not in mesh.shape:
                    raise ValueError(f"axis {a!r} of {self.spec} is not in "
                                     f"the mesh {tuple(mesh.shape)}")
                if a in used:
                    raise ValueError(f"{self.spec} claims axis {a!r} twice")
                used.add(a)

    def shard_shape(self, global_shape) -> tuple:
        """One chip's block of an array of `global_shape`: a dimension
        split over axes a, b has size dim / (|a| |b|). Raises where the
        product does not divide the dimension, as JAX does."""
        global_shape = tuple(global_shape)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"{self.spec} has more entries than the "
                             f"{len(global_shape)} dims of {global_shape}")
        out = []
        for i, dim in enumerate(global_shape):
            n = 1
            for a in _entry_axes(self.spec[i] if i < len(self.spec)
                                 else None):
                n *= self.mesh.shape[a]
            if dim % n:
                raise ValueError(f"{self.spec} splits dim {i} of "
                                 f"{global_shape} {n} ways")
            out.append(dim // n)
        return tuple(out)

    def __repr__(self):
        return f"NamedSharding(mesh={self.mesh!r}, spec={self.spec!r})"


@contextlib.contextmanager
def sharding_rules(mesh, rules: Optional[dict], drop_axes=()):
    """Activate (mesh, rules) for `shard()` calls inside model code, for
    this thread; the previous context comes back on exit.

    drop_axes: logical axes to force-replicate for this context (e.g.
    'heads' for archs whose head count doesn't divide the model axis)."""
    eff = None
    if rules is not None:
        eff = dict(rules)
        for ax in drop_axes:
            eff[ax] = None
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, eff)
    try:
        yield
    finally:
        _state.ctx = prev


def current_mesh():
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def logical_spec(*logical_axes) -> Optional[PartitionSpec]:
    ctx = getattr(_state, "ctx", None)
    if not ctx or ctx[1] is None:
        return None
    _, rules = ctx
    return P(*[rules.get(a) if a is not None else None for a in logical_axes])


def normalize_axes(mesh, axes):
    """Keep only axes present in this mesh (single-pod meshes have no 'pod')."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    kept = tuple(a for a in axes if a in mesh.shape)
    return kept or None


def _axis_len(mesh, axes) -> int:
    axes = normalize_axes(mesh, axes)
    if axes is None:
        return 1
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def resolve_spec(mesh, rules: dict, shape, logical_axes) -> PartitionSpec:
    """The spec of an array of `shape` annotated with `logical_axes` under
    (mesh, rules): each name mapped through `rules`; axes absent from the
    mesh, or claimed by an earlier dimension, dropped; an entry whose extent
    does not divide its dimension dropped whole (replicated), which is what
    lets archs with awkward head counts (qwen2: 14 heads on a 16-way model
    axis) shard the rest. Entries are tuples of axis names or None."""
    out = []
    used = set()
    for dim, name in zip(shape, logical_axes):
        axes = normalize_axes(mesh, rules.get(name) if name is not None
                              else None)
        if axes is not None:
            axes = tuple(a for a in axes if a not in used) or None
        if axes is not None and dim % _axis_len(mesh, axes) != 0:
            axes = None
        if axes is not None:
            used.update(axes)
        out.append(axes)
    return P(*out)


def shard_spec(x, *logical_axes) -> Optional[PartitionSpec]:
    """The spec the reference's `shard` would constrain `x` to under the
    active context (None without a mesh and rules), after its checks: the
    rank, as the reference asserts it, and that `x` lies on a device of a
    concrete mesh (an abstract mesh places nothing)."""
    ctx = getattr(_state, "ctx", None)
    if not ctx or ctx[0] is None or ctx[1] is None:
        return None
    mesh, rules = ctx
    assert len(logical_axes) == x.dim(), (logical_axes, tuple(x.shape))
    if mesh.devices is not None and x.device not in mesh.devices:
        raise ValueError(f"a tensor on {x.device} under a mesh of "
                         f"{mesh.devices}")
    return resolve_spec(mesh, rules, x.shape, logical_axes)


def shard(x, *logical_axes):
    """The reference's sharding constraint by logical axis names. On one
    card every placement holds the whole tensor, so `x` comes back as it is:
    with no context after one thread-local lookup, under one after
    `shard_spec`'s checks."""
    if getattr(_state, "ctx", None) is None:
        return x
    shard_spec(x, *logical_axes)
    return x


def named_sharding(mesh, *logical_axes, rules: dict) -> NamedSharding:
    return NamedSharding(
        mesh, P(*[rules.get(a) if a is not None else None for a in logical_axes])
    )
