"""Solver-quality telemetry: serving-time trajectory-discrepancy probe (the
port of `repro.obs.probe`).

The tuning stack scores plans offline against a high-NFE reference run
(`tuning/objective.py`); this module moves the same measurement into
serving. A `QualityProbe` deterministically samples a fraction of COMPLETED
requests, replays each one's initial latent through a high-NFE UniPC
reference runner (fp32, unquantized, uncached — the converged trajectory),
and records the served latent's relative discrepancy

    d = || x0_served - x0_ref ||_2 / max(|| x0_ref ||_2, 1e-12)

as per-tier gauges/histograms in the metrics registry. An over-quantized or
over-cached tier that passed its tune-time parity gate but drifts in
production is then visible in the serving metrics, not only at tune time.

Cost model: each probed request pays one `ref_nfe`-eval batch-1 reference
run on the host thread, which is why the probe is opt-in
(`--probe-fraction 0`, the default, never builds it) and why selection is a
deterministic hash of the rid — the same trace probes the same requests at
every pipeline depth, keeping probe metrics inside the deterministic
snapshot slice.

On the card the reference runner is a per-slot `StepProgram` of the
reference engine: its step is captured once as a CUDA graph and replayed
once a row, the row index read from a device arange, so a probe captures
nothing new and its only host sync is the readback of x_ref.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import Callable, List, Optional

import numpy as np
import torch

PROBE_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0)


def _to_device(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host array on `like`'s device in `like`'s dtype, sent without a
    host sync: through pinned memory and a non-blocking copy on the card
    (torch's caching host allocator keeps the pinned block until the copy
    has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(like.dtype)
    if like.device.type == "cuda":
        t = t.pin_memory()
    return t.to(like.device, non_blocking=True)


def build_reference_fn(engine, spec, *, ref_nfe: int = 64,
                       ref_order: int = 3) -> Callable:
    """A high-NFE reference runner with per-request conditioning.

    `tuning.objective.reference_trajectory` serves the unconditional tuning
    path (`engine.build` on the reference spec); serving requests also carry
    per-request guidance scales and conditioning extras (class ids), so this
    runner steps a per-slot `StepProgram` of the reference spec — the same
    mechanism the serving step program uses: the guidance scale is per-slot
    state times the table's guidance profile, the extras per-slot columns.

    `engine` must be wired fp32 / quant="none" / cache_block=0 (the
    reference measures the solver+schedule, not the serving engine's
    precision tricks); the spec handshake in `model_fn` enforces it.
    Returns `reference(x_T, g=None, extras=None) -> np.ndarray` over a
    (B, *sample) batch; `g` is one scalar guidance scale for the batch
    (None -> the spec's nominal), `extras` maps conditioning keys to scalars
    or (B,) arrays.

    The program's buffers (state, guidance, extras) are kept per batch size
    and extras keys; a call writes them in place, zeroes the eval ring and
    steps rows 0..ref_nfe, each a replay of the one captured step graph on
    the card. The runner counts its captures in `reference.captures`.
    """
    ref_spec = dc_replace(spec.resolve(), solver="unipc", nfe=ref_nfe,
                          order=ref_order, prediction=None,
                          eval_dtype="float32", quant="none",
                          cache_block=0).resolve()
    program = engine.build_step(ref_spec)
    n_rows = program.n_rows
    nominal = float(ref_spec.cfg_scale or 0.0)
    dev = program.device
    row_ids = torch.arange(n_rows, device=dev)
    slots: dict = {}

    def buffers(x: np.ndarray, extras: dict):
        key = (x.shape, tuple(sorted(extras)))
        if key not in slots:
            B = x.shape[0]
            state = program.init_state(B, x.shape[1:])
            ex = program.init_extras(
                B, {k: np.asarray(v).reshape(-1)[0].item()
                    for k, v in extras.items()})
            g = program.init_g(B) if program.uses_cfg else None
            slots[key] = (state, g, ex, row_ids[:, None].expand(n_rows, B))
        return slots[key]

    def reference(x_T, g=None, extras=None):
        from ..engine.graphs import readback_sync

        x = np.asarray(x_T, np.float32)
        extras = dict(extras or {})
        state, gbuf, ex, idx = buffers(x, extras)
        state[0].copy_(_to_device(x, state[0]))
        for e in state[1:]:
            e.zero_()
        if gbuf is not None:
            gbuf.fill_(nominal if g is None else float(g))
        for k, v in extras.items():
            a = np.asarray(v)
            if a.ndim == 0:
                ex[k].fill_(a.item())
            else:
                ex[k].copy_(_to_device(a, ex[k]))
        for j in range(n_rows):
            state = program.step(state, idx[j], gbuf, ex or None)
        with readback_sync(dev):
            # a copy: on the CPU, .cpu() is the state buffer itself, which
            # the next call overwrites
            return state[0].cpu().numpy().copy()

    def captures() -> int:
        return (0 if program.step_graphs is None
                else len(program.step_graphs.graphs))

    reference.captures = captures
    reference.program = program
    return reference


def probe_selected(rid: int, fraction: float, salt: int = 0) -> bool:
    """Deterministic rid -> [0, 1) hash against the probe fraction: the same
    requests are probed on every run / pipeline depth of the same trace
    (Knuth multiplicative hash; no RNG state, no draw-order dependence)."""
    if fraction <= 0.0:
        return False
    if fraction >= 1.0:
        return True
    u = ((int(rid) * 2654435761 + int(salt) * 40503) % (1 << 32)) / (1 << 32)
    return u < fraction


class QualityProbe:
    """Replay sampled completions against the reference runner.

    reference_fn: `build_reference_fn`'s closure (or any
        (x_T, g, extras) -> x0_ref batch callable).
    fraction: probability a completed rid is probed (deterministic in rid).
    registry: optional `obs.metrics.MetricsRegistry` receiving, per tier
        label: `probe_requests` (counter), `probe_discrepancy` (last-value
        gauge), `probe_discrepancy_hist` (histogram over PROBE_BUCKETS).
    tracer: optional `obs.trace.Tracer`; each probe emits an instant event
        carrying rid / tier / discrepancy.
    max_probes: hard cap on replays per run (the probe is a sampled
        diagnostic, not a second serving workload).
    """

    def __init__(self, reference_fn: Callable, fraction: float,
                 registry=None, tracer=None, salt: int = 0,
                 max_probes: Optional[int] = None):
        if not (0.0 <= fraction <= 1.0):
            raise ValueError(f"probe fraction must be in [0, 1], "
                             f"got {fraction}")
        self.reference_fn = reference_fn
        self.fraction = float(fraction)
        self.registry = registry
        self.tracer = tracer
        self.salt = int(salt)
        self.max_probes = max_probes
        self.results: List[dict] = []

    def selected(self, rid: int) -> bool:
        if self.max_probes is not None and len(self.results) >= self.max_probes:
            return False
        return probe_selected(rid, self.fraction, self.salt)

    def observe(self, req, completion, x_T) -> Optional[float]:
        """Measure one completion's discrepancy (caller pre-filters with
        `selected`); returns d, or None if the rid was not sampled."""
        if not self.selected(completion.rid):
            return None
        x_T = np.asarray(x_T)[None]
        x_ref = np.asarray(self.reference_fn(
            x_T, g=req.cfg_scale, extras=req.extras))[0]
        served = np.asarray(completion.latent, np.float32)
        d = float(np.linalg.norm(served - x_ref)
                  / max(float(np.linalg.norm(x_ref)), 1e-12))
        tier = completion.tier or "default"
        self.results.append({"rid": completion.rid, "tier": tier,
                             "discrepancy": d,
                             "eval_cost": completion.eval_cost})
        if self.registry is not None:
            lbl = {"tier": tier}
            self.registry.counter(
                "probe_requests", lbl,
                help="completed requests replayed by the quality probe").inc()
            self.registry.gauge(
                "probe_discrepancy", lbl,
                help="latest trajectory discrepancy vs the high-NFE "
                     "reference").set(d)
            self.registry.histogram(
                "probe_discrepancy_hist", PROBE_BUCKETS, lbl,
                help="trajectory discrepancy distribution").observe(d)
        if self.tracer is not None:
            self.tracer.instant("probe", cat="quality",
                                args={"rid": completion.rid, "tier": tier,
                                      "discrepancy": d})
        return d

    def summary(self) -> dict:
        """{tier: {count, mean, max}} over everything probed so far."""
        by_tier: dict = {}
        for r in self.results:
            by_tier.setdefault(r["tier"], []).append(r["discrepancy"])
        return {t: {"count": len(ds),
                    "mean": float(np.mean(ds)),
                    "max": float(np.max(ds))}
                for t, ds in sorted(by_tier.items())}
