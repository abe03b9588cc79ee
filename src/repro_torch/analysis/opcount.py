"""Operations and bytes of one eager run (the counterpart of
`repro/analysis/hlo.py`).

The reference lowers a step to XLA HLO and walks its text, scaling each
while body by its trip count. Eager torch has no HLO: `analyze` runs the
function once under a `TorchDispatchMode` and sees every aten op as it
runs, so a layer loop counts each layer because each layer runs. It keeps
`hlo.py`'s job and its output keys:

- `flops`: the operations of every matmul-like op (mm, bmm, addmm,
  baddbmm, convolution, ...) by `torch.utils.flop_counter`'s formulas, the
  same 2*M*N*K as `hlo.py:_dot_flops`; `flops_by_dtype` splits them by the
  dtype of the operands, whose peak bounds them on the card.
- `hbm_bytes`: `hlo.py`'s traffic proxy: each op that is not a view reads
  its operands once and writes its result once. Eager torch fuses nothing,
  so this is the unfused traffic, what the run moves as written.
- `min_bytes`: the compulsory traffic, used for bounds: every storage the
  run reads and did not create (params, inputs, a cache) once (a gather
  such as an embedding lookup counts the rows it takes), the bytes of the
  outputs it creates, and every in-place write to a storage it did not
  create (the decode cache `index_copy_` writes; a cache it hands back is
  not written again).
- `collectives`: {"_total": 0.0}: one card has no link.

The kernels are ctypes calls that no dispatch mode can see. Each kernel op
wrapper reports its `Cost` to `kernels/dispatch.COUNT` instead (its
operations counted where they are products, as attention's and the
quantized matmul's are, its bytes always), on
whichever route the call takes, and the route's own ops (the plain
version's, or the kernel's output allocations) are not counted. A call
therefore counts the same when the kernel runs on the card, when the plain
version runs on the CPU, and on the meta device, where nothing runs at
all (`launch/dryrun.py`). A CUDA graph replay runs no op a dispatch mode
could see, so counts are taken of eager runs only.

It also measures what the dry run's memory estimate needs: the largest
live set of the storages the run created (`peak_live_bytes`), the bytes of
its outputs, and the storages saved for backward (`saved_bytes`).
"""

from __future__ import annotations

import weakref
from collections import Counter, defaultdict
from contextlib import contextmanager

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import dispatch
from ..kernels.dispatch import nbytes as _nbytes

aten = torch.ops.aten

# in-place ops that write their mutated operand without reading it
_WRITE_ONLY = {aten.copy_, aten.index_copy_, aten.index_put_, aten.fill_,
               aten.zero_, aten.scatter_}
# ops that read only the rows they gather from their first operand
_GATHERS = {aten.embedding, aten.index, aten.index_select, aten.gather}
# allocations: they write nothing
_ALLOCS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
           aten.new_empty_strided}


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _dtype_name(d: torch.dtype) -> str:
    return str(d).replace("torch.", "")


class OpCount(TorchDispatchMode):
    """The counts of everything run inside the `with` block."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: dict = defaultdict(float)
        self.hbm_bytes = 0.0
        self.write_bytes = 0.0
        self.kernels: Counter = Counter()
        self._read: dict = {}        # storage it did not create -> bytes read
        # each storage the run created, by a weak reference that also keeps
        # its address from being reused by a later storage during the count
        self._created: dict = {}
        self._saved: dict = {}       # storage saved for backward -> bytes
        self._paused = False
        self._pending: list = []     # (weakref, storage) made inside a kernel
        self._live: dict = {}        # created storage -> [bytes, live tensors]
        self._refs: dict = {}        # id -> weakref of a tracked tensor
        self._unseen: set = set()    # live storages no tracked tensor holds
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._hooks = None

    def __enter__(self):
        if dispatch.COUNT is not None:
            raise RuntimeError("an operation count is already active")
        dispatch.COUNT = self
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)
        self._hooks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._hooks.__exit__(*exc)
            dispatch.COUNT = None

    # -- the kernels' reports (kernels/dispatch.COUNT) -------------------
    @contextmanager
    def kernel(self, name: str, cost: dispatch.Cost, inputs: tuple):
        """One kernel call: its cost counted, its route's ops not. What the
        route creates joins the live set only if it is still alive when the
        call returns (its outputs, and what it saves for backward), so the
        plain version's intermediates (attention's S x S scores) weigh no
        more than the kernel's registers."""
        if self._paused:
            yield
            return
        self.kernels[name] += 1
        if cost.matmul:
            self.flops_by_dtype[_dtype_name(cost.dtype)] += cost.flops
        self.hbm_bytes += cost.bytes
        for t in _tensors(inputs):
            self._note_read(t, t.untyped_storage().nbytes())
        self._paused, self._pending = True, []
        try:
            yield
        finally:
            self._paused = False
            for ref, k in self._pending:
                t = ref()
                if t is not None:
                    self._track(t, k)
            self._pending = []

    # -- the aten ops -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._unseen:
            self._sweep()
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        in_keys = {_key(t) for t in ins}
        for t in outs:
            k = _key(t)
            if k not in in_keys and k not in self._created:
                self._created[k] = StorageWeakRef(t.untyped_storage())
            if k in self._created:
                if self._paused:
                    self._pending.append((weakref.ref(t), k))
                else:
                    self._track(t, k)
        if not self._paused:
            self._count(func, args, kwargs, ins, outs, out)
        return out

    def _count(self, func, args, kwargs, ins, outs, out):
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops_by_dtype[_dtype_name(ins[0].dtype)] += float(
                flop_registry[packet](*args, **kwargs, out_val=out))
        if func.is_view or packet in _ALLOCS:
            return
        self.hbm_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        schema = func._schema.arguments
        values = list(args) + [kwargs.get(a.name) for a in schema[len(args):]]
        written = set()
        for a, v in zip(schema, values):
            if (a.alias_info is not None and a.alias_info.is_write
                    and isinstance(v, torch.Tensor)):
                written.add(id(v))
                if _key(v) not in self._created:
                    self.write_bytes += self._write_bytes(packet, v, args)
        for t in ins:
            if id(t) in written and packet in _WRITE_ONLY:
                continue
            gathered = packet in _GATHERS and t is args[0]
            self._note_read(t, _nbytes(outs[0]) if gathered
                            else t.untyped_storage().nbytes())

    @staticmethod
    def _write_bytes(packet, dst, args) -> int:
        if packet is aten.index_copy_:
            return _nbytes(args[3])
        if packet is aten.index_put_:
            return _nbytes(args[2])
        return _nbytes(dst)

    def _note_read(self, t: torch.Tensor, nbytes: int):
        k = _key(t)
        if k in self._created:
            return
        full = t.untyped_storage().nbytes()
        self._read[k] = min(full, self._read.get(k, 0) + nbytes)

    # -- memory -------------------------------------------------------------
    def _track(self, t: torch.Tensor, k: int):
        ent = self._live.get(k)
        if ent is None:
            ent = self._live[k] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += ent[0]
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        ent[1] += 1

        def dead(ref, k=k):
            self._refs.pop(id(ref), None)
            e = self._live.get(k)
            if e is not None:
                e[1] -= 1
                if e[1] == 0:
                    # the storage may outlive its last tracked tensor (a
                    # view made inside torch, or the tensor still being
                    # torn down): freed once its weak reference expires
                    self._unseen.add(k)

        ref = weakref.ref(t, dead)
        self._refs[id(ref)] = ref

    def _sweep(self):
        for k in list(self._unseen):
            e = self._live.get(k)
            if e is None or e[1] > 0:
                self._unseen.discard(k)
            elif self._created[k].expired():
                self._unseen.discard(k)
                self.live_bytes -= e[0]
                del self._live[k]

    def _pack(self, t: torch.Tensor):
        k = _key(t)
        if k in self._created:
            self._saved.setdefault(k, t.untyped_storage().nbytes())
        return t

    def result(self, out) -> dict:
        seen, out_bytes = set(), 0
        for t in _tensors(out):   # what it returns of its own making
            if id(t) not in seen and _key(t) in self._created:
                seen.add(id(t))
                out_bytes += _nbytes(t)
        return {
            "flops": float(sum(self.flops_by_dtype.values())),
            "flops_by_dtype": dict(self.flops_by_dtype),
            "hbm_bytes": self.hbm_bytes,
            "min_bytes": float(sum(self._read.values()) + self.write_bytes
                               + out_bytes),
            "collectives": {"_total": 0.0},
            "kernels": dict(self.kernels),
            "output_bytes": out_bytes,
            "peak_live_bytes": self.peak_live_bytes,
            "saved_bytes": sum(self._saved.values()),
        }


def analyze(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once and count it (the module docstring
    says what each key holds)."""
    count = OpCount()
    with count:
        out = fn(*args, **kwargs)
    return count.result(out)
