"""Deterministic fault injection for the serving loop (DESIGN.md §16; the
port's copy of `repro.serving.faults`, numpy only).

Chaos testing only proves something when the chaos is reproducible: a
`FaultPlan` is a frozen, seedable description of exactly which faults fire
where, so two runs of the same plan over the same trace produce the same
event ledger, the same sheds and retries, and — for every request a fault
never touched — bit-identical latents to the clean run. The scheduler
threads the plan through a `FaultInjector`, which arms each fault once
(unless sticky) and records what actually fired.

Three fault kinds, one per failure class the resilience layer handles:

* `NanFault` — poison request `rid`'s slot latent with NaN just before the
  eval of step `step`, exercising the on-device finite-check + the
  degraded-tier retry path. Because the DiT's attention and normalization
  are per-sample, a poisoned slot never contaminates its batch-mates: the
  clean requests in the same batch still finish bit-identical to a
  fault-free run.
* `MetaFault` — corrupt the on-device row counter of a busy slot at tick
  `tick`, desynchronizing the authoritative device bookkeeping from the
  host's predicted completion schedule, exercising desync recovery.
* `SkewFault` — shift the admission clock by `delta` at tick `tick`,
  exercising TTL/deadline expiry without a real slow consumer.

Faults are injected by the scheduler between admission and dispatch, on
device state, through two tiny in-place updates — the step program and its
CUDA graphs are never altered, so what the chaos tests exercise is the real
serving path under the real program.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class NanFault:
    """Poison request `rid`'s latent before its step `step` eval."""

    rid: int
    step: int = 0
    sticky: bool = False   # re-fire on every retry attempt (exhaustion tests)


@dataclass(frozen=True)
class MetaFault:
    """Bump the device row counter of slot `slot` (lowest busy slot when
    None) by `delta` at tick `tick`, forcing a host/device desync."""

    tick: int
    slot: Optional[int] = None
    delta: int = 1


@dataclass(frozen=True)
class SkewFault:
    """Shift the admission clock by `delta` tick-units at tick `tick`."""

    tick: int
    delta: float = 0.0


@dataclass(frozen=True)
class FaultPlan:
    """An immutable set of faults to inject into one serving run."""

    nans: Tuple[NanFault, ...] = ()
    metas: Tuple[MetaFault, ...] = ()
    skews: Tuple[SkewFault, ...] = ()

    def __bool__(self) -> bool:
        return bool(self.nans or self.metas or self.skews)

    def describe(self) -> str:
        parts = ([f"nan:rid={f.rid},step={f.step}"
                  + (",sticky=1" if f.sticky else "") for f in self.nans]
                 + [f"meta:tick={f.tick}"
                    + (f",slot={f.slot}" if f.slot is not None else "")
                    + (f",delta={f.delta}" if f.delta != 1 else "")
                    for f in self.metas]
                 + [f"skew:tick={f.tick},delta={f.delta:g}"
                    for f in self.skews])
        return ";".join(parts) if parts else "none"

    @classmethod
    def seeded(cls, seed: int, *, n_requests: int, nfe: int,
               n_nan: int = 1, n_meta: int = 0, n_skew: int = 0,
               horizon: Optional[int] = None) -> "FaultPlan":
        """Draw a reproducible plan: `n_nan` poisoned (rid, step) pairs,
        `n_meta` desyncs and `n_skew` clock skews over the first `horizon`
        ticks (default: n_requests * nfe, the serial-service bound)."""
        rng = np.random.default_rng(seed)
        horizon = int(horizon if horizon is not None
                      else max(1, n_requests * nfe))
        nans = tuple(NanFault(rid=int(rng.integers(n_requests)),
                              step=int(rng.integers(nfe)))
                     for _ in range(n_nan))
        metas = tuple(MetaFault(tick=int(rng.integers(1, horizon + 1)))
                      for _ in range(n_meta))
        skews = tuple(SkewFault(tick=int(rng.integers(1, horizon + 1)),
                                delta=float(rng.integers(1, nfe + 1)))
                      for _ in range(n_skew))
        return cls(nans=nans, metas=metas, skews=skews)


def parse_fault_spec(spec: str) -> FaultPlan:
    """Parse the `--inject-faults` CLI string: semicolon-separated clauses
    `kind:key=val,key=val`, e.g.

        nan:rid=2,step=1;meta:tick=6;skew:tick=3,delta=9

    `seed:value[,n_nan=..,n_meta=..,n_skew=..,requests=..,nfe=..]` draws a
    `FaultPlan.seeded` plan instead (requests/nfe required)."""
    spec = (spec or "").strip()
    if not spec or spec == "none":
        return FaultPlan()
    nans: List[NanFault] = []
    metas: List[MetaFault] = []
    skews: List[SkewFault] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        kind, _, body = clause.partition(":")
        kind = kind.strip()
        kv = {}
        first = None
        for part in body.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                k, v = part.split("=", 1)
                kv[k.strip()] = v.strip()
            elif first is None:
                first = part
        try:
            if kind == "nan":
                nans.append(NanFault(rid=int(kv["rid"]),
                                     step=int(kv.get("step", 0)),
                                     sticky=bool(int(kv.get("sticky", 0)))))
            elif kind == "meta":
                slot = kv.get("slot")
                metas.append(MetaFault(tick=int(kv["tick"]),
                                       slot=None if slot is None
                                       else int(slot),
                                       delta=int(kv.get("delta", 1))))
            elif kind == "skew":
                skews.append(SkewFault(tick=int(kv["tick"]),
                                       delta=float(kv["delta"])))
            elif kind == "seed":
                plan = FaultPlan.seeded(
                    int(first if first is not None else kv["value"]),
                    n_requests=int(kv["requests"]), nfe=int(kv["nfe"]),
                    n_nan=int(kv.get("n_nan", 1)),
                    n_meta=int(kv.get("n_meta", 0)),
                    n_skew=int(kv.get("n_skew", 0)))
                nans.extend(plan.nans)
                metas.extend(plan.metas)
                skews.extend(plan.skews)
            else:
                raise KeyError(kind)
        except (KeyError, ValueError) as e:
            raise ValueError(
                f"bad fault clause {clause!r} (expected e.g. "
                f"'nan:rid=2,step=1', 'meta:tick=6', 'skew:tick=3,delta=9', "
                f"'seed:7,requests=8,nfe=4'): {e}") from None
    return FaultPlan(nans=tuple(nans), metas=tuple(metas),
                     skews=tuple(skews))


@dataclass
class FaultInjector:
    """Arms a `FaultPlan` for one run: each fault fires at most once (NaN
    faults marked sticky re-fire on every attempt), and everything that
    fired is appended to `ledger` in firing order — the deterministic
    record the chaos tests compare across runs."""

    plan: FaultPlan
    ledger: List[tuple] = field(default_factory=list)

    def __post_init__(self):
        self._nan_fired: set = set()
        self._meta_fired: set = set()
        self._skew_fired: set = set()

    def take_nan(self, rid: int, step: int) -> Optional[NanFault]:
        """The NaN fault due for (rid, step) right now, or None."""
        for f in self.plan.nans:
            if f.rid != rid or f.step != step:
                continue
            key = (f.rid, f.step)
            if not f.sticky and key in self._nan_fired:
                continue
            self._nan_fired.add(key)
            return f
        return None

    def take_meta(self, tick: int) -> Optional[MetaFault]:
        """The meta-corruption fault due at `tick` (first executed tick
        at-or-after its scheduled tick), or None."""
        for i, f in enumerate(self.plan.metas):
            if tick >= f.tick and i not in self._meta_fired:
                self._meta_fired.add(i)
                return f
        return None

    def take_skew(self, tick: int) -> float:
        """Total admission-clock shift due by `tick` (0.0 when none). Skews
        fire at the first admission at-or-after their tick — admission does
        not happen every tick, and a skew must not be lost to that."""
        delta = 0.0
        for i, f in enumerate(self.plan.skews):
            if tick >= f.tick and i not in self._skew_fired:
                self._skew_fired.add(i)
                delta += f.delta
        return delta
