"""Plan scoring: trajectory discrepancy against a high-NFE reference run (the
port of `repro.tuning.objective`).

Following the paper's own Fig. 4c protocol — and the solver-search line of
work (Liu et al. 2023; DC-Solver) — a candidate plan is scored by how close
its terminal state lands to a fine-grid reference trajectory started from
the same probe latents, through the same network:

    d(plan) = || x0_plan - x0_ref ||_2 / || x0_ref ||_2

over a fixed probe batch. Lower is better; orderings track the paper's FID
orderings at matched NFE.

The scorer is built for search throughput. Candidate tables share one shape
per NFE (plans pad their weight columns to MAX_ORDER-1), so ONE runner
serves every candidate: per NFE it keeps the packed row table
(`core.unipc.pack_step_rows`) in static device buffers, and scoring a
candidate copies its packed rows into them and runs again. On the card the
run is a CUDA graph over those buffers — the reference's jit with the table
as a traced argument — captured once per NFE and replayed for every
candidate, so no candidate captures anything:

* uncached: one graph of the whole trajectory;
* cached (feature reuse): a graph cannot take the reference's branch over
  the deep blocks, so the runner replays a graph of one row with the deep
  blocks or one without, chosen per row by the host from the candidate's
  `cache_reuse` column (at most two captures per NFE); the row index is a
  device counter the graphs advance.

The tables go in through pinned memory and non-blocking copies; the score's
one readback of the terminal states is its only host sync.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.coeffs import SolverTable, augment_step_rows
from ..core.unipc import (deep_rows, pack_step_rows, rows_on, run_rows,
                          step_fn_over_packed)
from ..engine import graphs
from .plans import SolverPlan


def _pinned(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor ready for a non-blocking copy to `device`."""
    return t.pin_memory() if device.type == "cuda" else t


class _Runner:
    """The objective's runner: per table shape (one per NFE), the packed
    table's static buffers, the step over them and, on the card, its CUDA
    graphs. `captures` counts the graphs captured, `builds` the table
    shapes served, and `last` holds the last candidate's terminal states
    (host numpy)."""

    def __init__(self, model_fn: Callable, x_T: torch.Tensor, *, sign: float,
                 fused_update: bool, cached: bool,
                 cache_zeros: Optional[Callable]):
        self.model_fn = model_fn
        self.x_T = x_T
        self.sign = sign
        self.fused_update = fused_update
        self.cached = cached
        self.cache_zeros = cache_zeros
        self.device = x_T.device
        self.graphed = self.device.type == "cuda"
        self.entries: Dict[tuple, dict] = {}
        self.captures = 0
        self.last: Optional[np.ndarray] = None

    @property
    def builds(self) -> int:
        """Table shapes served (the reference's jit cache size)."""
        return len(self.entries)

    def __call__(self, rows_np: dict) -> np.ndarray:
        rows_h, cols_h, col_keys = pack_step_rows(rows_on(rows_np, "cpu"))
        key = (tuple(rows_h.shape), tuple(col_keys))
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = self._build(rows_h, cols_h, col_keys)
        entry["rows"].copy_(_pinned(rows_h, self.device), non_blocking=True)
        entry["cols"].copy_(_pinned(cols_h, self.device), non_blocking=True)
        x0 = (self._run_cached(entry, deep_rows(rows_np)) if self.cached
              else self._run(entry))
        with graphs.readback_sync(self.device):
            # a copy: on the CPU, .cpu() is the state buffer itself, which
            # the next candidate overwrites
            self.last = x0.cpu().numpy().copy()
        return self.last

    def _build(self, rows_h, cols_h, col_keys) -> dict:
        dev = self.device
        rows = torch.empty_like(rows_h, device=dev)
        cols = torch.empty_like(cols_h, device=dev)
        step = step_fn_over_packed(self.model_fn, rows, cols, col_keys,
                                   sign=self.sign,
                                   fused_update=self.fused_update,
                                   cached=self.cached)
        ring = (rows.shape[1] - 7) // 2 + 1
        entry = {"rows": rows, "cols": cols, "step": step, "ring": ring,
                 "n_rows": rows.shape[0], "graphs": {}}
        if self.cached:
            x = self.x_T
            entry["state"] = (
                torch.empty_like(x),
                torch.zeros((ring,) + tuple(x.shape), dtype=x.dtype,
                            device=dev),
                self.cache_zeros(x.shape[0], dev))
            entry["idx"] = torch.zeros((), dtype=torch.int64, device=dev)
        return entry

    def _graph(self, entry: dict, kind, fn: Callable, inputs, warmup):
        g = entry["graphs"].get(kind)
        if g is None:
            # the table buffers must hold a table before the warm-up reads
            # them; they do: the caller copied the candidate's in first
            g = entry["graphs"][kind] = graphs.Graph(fn, inputs, warmup)
            self.captures += 1
        return g

    def _run(self, entry: dict) -> torch.Tensor:
        """The whole trajectory from x_T over the table in the buffers."""
        step, n, ring = entry["step"], entry["n_rows"], entry["ring"]
        if not self.graphed:
            return run_rows(step, n, self.x_T, ring=ring)
        g = self._graph(entry, "run",
                        lambda x: run_rows(step, n, x, ring=ring),
                        [self.x_T.clone()],
                        lambda x: run_rows(step, 1, x, ring=ring))
        return g.replay()

    def _run_cached(self, entry: dict, deep: list) -> torch.Tensor:
        """The cached trajectory: rows one at a time, each in the graph with
        or without the deep blocks as the candidate's reuse column says,
        over state buffers reset for this candidate."""
        x, E, C = state = entry["state"]
        idx, step = entry["idx"], entry["step"]
        x.copy_(self.x_T)
        E.zero_()
        C.zero_()
        idx.zero_()

        def row(deep_j):
            def body(*st):
                out = step(st, idx, deep=deep_j)
                for s, new in zip(st, out):
                    s.copy_(new)
                idx.add_(1)
                return st[0]
            return body

        for d in deep:
            if not self.graphed:
                row(d)(*state)
                continue
            self._graph(entry, ("row", d), row(d), state,
                        lambda *st, d=d: step(st, idx, deep=d)).replay()
        return x


@dataclass
class PlanObjective:
    """Callable plan -> discrepancy, over one model and probe batch.

    model_fn: the engine-wrapped model ((x, t, **cols) -> prediction of the
        plan's type) — `SamplerEngine.model_fn(spec, tab)` or any (x, t)
        callable for analytic DPMs.
    x_T: (B, *sample) probe latents (fixed across candidates), a tensor on
        the device the runner runs on.
    x_ref: (B, *sample) reference terminal states for the same latents.
    sign/prediction: the plan family's table convention (data-pred unipc by
        default).
    """

    model_fn: Callable
    x_T: torch.Tensor
    x_ref: np.ndarray
    sign: float = 1.0
    prediction: str = "data"
    fused_update: bool = True
    # feature reuse: a cached engine's model_fn returns (pred, cache) and the
    # runner's carry grows the (B, *cache_shape) cache state — candidate
    # plans may then schedule shallow steps via their cache_reuse column
    cached: bool = False
    cache_shape: Optional[tuple] = None
    cache_dtype: str = "float32"
    # ONE runner serves every candidate: per table shape (one per NFE) its
    # static buffers and graphs (see the module docstring)
    _runner: Optional[_Runner] = None
    evals: int = 0

    def score_table(self, tab: SolverTable) -> float:
        if self._runner is None:
            self._runner = self._make_runner()
        x0 = self._runner(augment_step_rows(tab))
        self.evals += 1
        return float(np.linalg.norm(x0 - self.x_ref)
                     / max(np.linalg.norm(self.x_ref), 1e-12))

    def __call__(self, plan: SolverPlan, noise_schedule) -> float:
        if plan.prediction != self.prediction:
            raise ValueError(
                f"objective wraps a {self.prediction}-prediction model; "
                f"plan is {plan.prediction}-prediction")
        return self.score_table(plan.compile(noise_schedule))

    def _make_runner(self) -> _Runner:
        cache_zeros = None
        if self.cached:
            shape, dtype = tuple(self.cache_shape), getattr(torch,
                                                            self.cache_dtype)

            def cache_zeros(batch, device):
                return torch.zeros((batch,) + shape, dtype=dtype,
                                   device=device)
        return _Runner(self.model_fn, self.x_T, sign=self.sign,
                       fused_update=self.fused_update, cached=self.cached,
                       cache_zeros=cache_zeros)


class QuantParityError(RuntimeError):
    """A tuned quantized plan failed its parity budget (DESIGN.md §14).

    Raised by `quant_parity_gate` when the tuned plan's trajectory
    discrepancy — measured against the *fp32* reference trajectory — exceeds
    `slack` times what the fp32 hand-set baseline achieves at the same NFE
    budget. The tier is over-quantized for this arch/budget; the plan must
    not be emitted."""


def quant_parity_gate(tuned: float, fp32_anchor: float, *, slack: float,
                      quant: str, context: str = "") -> float:
    """Enforce the quantized tier's parity budget; returns the ratio.

    `tuned` is the tuned quantized plan's discrepancy vs the fp32
    reference; `fp32_anchor` is the fp32 baseline plan's discrepancy vs the
    same reference (same probe latents, same budget). Both are measured
    against the SAME x_ref, so the ratio isolates what quantization costs
    on top of the solver's own truncation error."""
    where = f" ({context})" if context else ""
    ratio = tuned / max(fp32_anchor, 1e-12)
    if ratio > slack:
        raise QuantParityError(
            f"quant tier {quant!r} failed its parity gate{where}: tuned "
            f"discrepancy {tuned:.6f} is {ratio:.2f}x the fp32 baseline "
            f"{fp32_anchor:.6f} (budget {slack}x) — the tier is "
            f"over-quantized for this arch/budget; not emitting the plan")
    return ratio


def _on(engine, x_T) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x_T) if not torch.is_tensor(x_T)
                           else x_T, dtype=torch.float32).to(engine.device)


def reference_trajectory(engine, spec, x_T, *, ref_nfe: int = 64,
                         ref_order: int = 3) -> np.ndarray:
    """Terminal states of the high-NFE UniPC-`ref_order` reference run from
    `x_T` — the converged trajectory candidates are measured against. It
    depends only on (engine, x_T, ref_nfe, ref_order), so callers tuning
    several NFE budgets compute it once and pass it to `make_objective`."""
    ref_spec = replace(spec.resolve(), solver="unipc", nfe=ref_nfe,
                       order=ref_order, prediction=None).resolve()
    x0 = engine.build(ref_spec)(_on(engine, x_T))
    with graphs.readback_sync(engine.device):
        return x0.cpu().numpy()


def make_objective(engine, spec, x_T, *, ref_nfe: int = 64,
                   ref_order: int = 3,
                   x_ref: Optional[np.ndarray] = None) -> PlanObjective:
    """Build a PlanObjective over a `SamplerEngine`.

    The reference is the engine's own run at `ref_nfe` UniPC-`ref_order`
    steps (same network, same conditioning knobs as `spec`), computed here
    unless a precomputed `x_ref` (see `reference_trajectory`) is supplied.
    `spec` supplies the prediction type and model wrapping; its nfe/order are
    irrelevant here.
    """
    spec = spec.resolve()
    if spec.cfg_scale or spec.thresholding:
        # candidate plan tables carry no per-eval model columns; guided /
        # thresholded tuning would score a different program than it serves
        raise ValueError("plan tuning scores unconditional trajectories; "
                         "tune with cfg_scale=0 and thresholding off")
    x_T = _on(engine, x_T)
    if x_ref is None:
        x_ref = reference_trajectory(engine, spec, x_T, ref_nfe=ref_nfe,
                                     ref_order=ref_order)
    tab = engine.compile(spec)
    model = engine.model_fn(spec, tab)
    cached = bool(spec.cache_block)
    cs = engine.cache_spec if cached else None
    return PlanObjective(model_fn=model, x_T=x_T, x_ref=np.asarray(x_ref),
                         sign=float(tab.sign), prediction=tab.prediction,
                         fused_update=spec.fused_update, cached=cached,
                         cache_shape=tuple(cs.shape) if cached else None,
                         cache_dtype=cs.dtype if cached else "float32")
