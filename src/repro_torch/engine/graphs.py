"""CUDA graphs of the engine's run functions: the port's counterpart of the
reference's `jax.jit` and `donate_argnums`.

A run function is captured once per signature of input shapes and dtypes
into a `torch.cuda.CUDAGraph` over static input buffers, and every later
call copies its inputs in and replays it. A replay runs the captured
kernels on the captured buffers with no Python, torch dispatch or ctypes
in between, which is what the eager loop spends most of its wall on.

* `graph_run` — `SamplerEngine.build`'s whole-trajectory run: one graph of
  all its rows per (x_T, model_kwargs) signature; each call returns a fresh
  copy of the graph's output, so two results never alias.
* `StepGraphs` — a `StepProgram`'s `step` and `step_flight`: the slot
  state (and the meta) are static buffers updated in place by the replay
  (`EagerSteps` runs the same calls eagerly, for the CPU and `jit=False`).
  With `donate=True` the step returns those buffers and the state passed
  in counts as consumed, as with the reference's donation; `init_state`,
  `init_meta` and `init_g` hand them out, so a caller that always replaces
  its references with the returned ones pays no copy. `donate=False`
  copies the inputs in and returns clones.

What must hold for a replay to be right: the operands a capture saw are
the ones replayed (adaLN's and quant_matmul's plans read pointer
alignment, the wgmma body bakes its TMA maps into the launch), so a graph
is keyed by shape and owns its inputs, and the wired weights are never
reallocated after capture. The first call runs the function once eagerly
on a side stream before capturing (libraries load, kernels set their
shared-memory limits, cuBLAS makes its handle), and those launches count
as eager ones in `kernels.dispatch.LAUNCHES`; a replay adds what the
capture recorded. A capture that fails raises with its cause: nothing here
falls back to an eager run.

While a `torch.profiler` records, the host's part of a replay is ranges on
its timeline (`obs.trace.live`): ``engine.launch`` around every graph
launch, and in `graph_run` ``engine.copy_in`` (the inputs into the static
buffers) and ``engine.copy_out`` (the output's copy) around it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..kernels import dispatch
from ..obs import trace


@contextlib.contextmanager
def readback_sync(device: torch.device):
    """A designed wait on the card: the serving scheduler's flight-event
    waits, its depth-1 fence and the device meta desync recovery reads, and
    the one readback of a quality-probe replay or of a tuner candidate's
    score. They run with torch's sync debug mode off, so a caller that runs
    under `torch.cuda.set_sync_debug_mode("error")` is told of every other
    sync (a serving tick makes none)."""
    if torch.device(device).type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def graphed(jit: bool, device: torch.device) -> bool:
    """Whether a run function is captured: `jit` on a CUDA device. On the
    CPU `jit=True` runs the eager loop; the device decides, as for the
    kernels' dispatch."""
    return bool(jit) and torch.device(device).type == "cuda"


class Graph:
    """`fn(*inputs)` captured once into a CUDA graph over the tensors
    `inputs`, which become its static buffers. `warmup(*inputs)` runs
    eagerly on a side stream first and must leave `inputs` as they were."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 warmup: Callable):
        self.inputs = tuple(inputs)
        device = self.inputs[0].device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warmup(*self.inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream(device)
        with dispatch.recording() as launches:
            try:
                with torch.cuda.graph(self.graph):
                    self.outputs = fn(*self.inputs)
            except Exception as err:
                # torch's capture context does not restore the stream when
                # the capture fails; its CUDA generator stays in capture
                # mode too, so the process should draw no random numbers
                # on the card after this
                torch.cuda.set_stream(stream)
                raise RuntimeError(
                    f"CUDA graph capture failed ({type(err).__name__}: "
                    f"{err}); the engine does not fall back to an eager run "
                    f"on the card — build with jit=False for that") from err
        self.launches = launches

    def replay(self):
        """Run the graph on what its static buffers hold now; returns its
        static outputs, which the next replay overwrites."""
        with trace.live("engine.launch"):
            self.graph.replay()
        dispatch.LAUNCHES.update(self.launches)
        return self.outputs


def _signature(tensors: Sequence[Tuple[str, torch.Tensor]]) -> tuple:
    return tuple((name, tuple(t.shape), t.dtype) for name, t in tensors)


def _same_buffer(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype
            and a.device == b.device)


def graph_run(run: Callable, warmup: Callable,
              device: torch.device) -> Callable:
    """`run(x_T, **model_kwargs) -> x0` as CUDA graph replays, captured at
    the first call for each signature of x_T and the (tensor) model kwargs.
    `warmup` takes the same arguments and runs a part of `run` eagerly (one
    row is enough to load and size every kernel the graph holds)."""
    graphs: Dict[tuple, Graph] = {}

    def replay(x_T: torch.Tensor, **model_kwargs) -> torch.Tensor:
        names = sorted(model_kwargs)
        args = [("x_T", x_T)] + [(k, model_kwargs[k]) for k in names]
        for name, t in args:
            if not torch.is_tensor(t):
                raise TypeError(f"a graphed run takes tensors; {name} is "
                                f"{type(t).__name__}")
        key = _signature(args)
        g = graphs.get(key)
        if g is None:
            static = [torch.empty(t.shape, dtype=t.dtype,
                                  device=device).copy_(t) for _, t in args]
            g = graphs[key] = Graph(
                lambda x, *kw: run(x, **dict(zip(names, kw))), static,
                lambda x, *kw: warmup(x, **dict(zip(names, kw))))
        else:
            with trace.live("engine.copy_in"):
                for s, (_, t) in zip(g.inputs, args):
                    s.copy_(t)
        out = g.replay()
        with trace.live("engine.copy_out"):
            return out.clone()

    return replay


class StepGraphs:
    """The static buffers and graphs of one step program (see the module
    docstring). Buffers are keyed by role, shape and dtype; graphs by which
    step and the signature of their inputs."""

    def __init__(self, device: torch.device, donate: bool):
        self.device = torch.device(device)
        self.donate = donate
        self.buffers: Dict[tuple, torch.Tensor] = {}
        self.graphs: Dict[tuple, Graph] = {}

    def handout(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The static buffer of `t`'s role and shape, set to `t`'s values:
        `t` itself the first time (donating programs; others hand out `t`,
        unregistered). A buffer a graph has captured is never replaced."""
        if not self.donate:
            return t
        key = (name, tuple(t.shape), t.dtype)
        s = self.buffers.get(key)
        if s is None:
            self.buffers[key] = t
            return t
        return s.copy_(t)

    def _static(self, name: str, t: torch.Tensor) -> torch.Tensor:
        key = (name, tuple(t.shape), t.dtype)
        s = self.buffers.get(key)
        if s is None:
            s = self.buffers[key] = torch.empty(t.shape, dtype=t.dtype,
                                                device=self.device)
            s.copy_(t)
        elif not _same_buffer(s, t):
            s.copy_(t)
        return s

    def capture(self, kind: str, fn: Callable,
                inputs: Sequence[Tuple[str, Optional[torch.Tensor]]],
                n_state: int) -> Graph:
        """The graph of `fn` on `inputs`' signature, captured now if it is
        new (the inputs are copied into the static buffers, the state is
        left as it was); see `call` for the arguments."""
        present = [(n, t) for n, t in inputs if t is not None]
        names = [n for n, _ in present]
        statics = [self._static(n, t) for n, t in present]
        key = (kind,) + _signature(present)
        g = self.graphs.get(key)
        if g is None:
            def body(*static):
                outs = fn(dict(zip(names, static)))
                for s, new in zip(static[:n_state], outs[:n_state]):
                    s.copy_(new)
                return tuple(static[:n_state]) + tuple(outs[n_state:])

            g = self.graphs[key] = Graph(
                body, statics, lambda *static: fn(dict(zip(names, static))))
        return g

    def call(self, kind: str, fn: Callable,
             inputs: Sequence[Tuple[str, Optional[torch.Tensor]]],
             n_state: int) -> tuple:
        """Replay `fn` on `inputs` (named tensors; None leaves a name out),
        capturing it first for a new signature. `fn(named: dict)` returns
        the new values of the first `n_state` inputs (the slot state),
        then any further outputs. The replay writes the state in place;
        returns (state..., further outputs...), the further outputs as
        fresh tensors."""
        outs = self.capture(kind, fn, inputs, n_state).replay()
        state = outs[:n_state]
        if not self.donate:
            state = tuple(s.clone() for s in state)
        return tuple(state) + tuple(o.clone() for o in outs[n_state:])


class EagerSteps:
    """`StepGraphs.call` without a graph: runs `fn` now; with `donate`
    writes the new state into the tensors passed in and returns those."""

    def __init__(self, donate: bool):
        self.donate = donate

    def capture(self, kind, fn, inputs, n_state) -> None:
        """Nothing to capture: an eager step runs when it is called."""

    def call(self, kind: str, fn: Callable,
             inputs: Sequence[Tuple[str, Optional[torch.Tensor]]],
             n_state: int) -> tuple:
        outs = fn({n: t for n, t in inputs if t is not None})
        state = outs[:n_state]
        if self.donate:
            state = tuple(old.copy_(new) for (_, old), new
                          in zip(inputs[:n_state], state))
        return tuple(state) + tuple(outs[n_state:])
