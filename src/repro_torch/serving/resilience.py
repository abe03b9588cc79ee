"""Serving resilience policy: overload control, validation retry, recovery
(the port's copy of `repro.serving.resilience`; framework-free).

This module is pure policy — small frozen dataclasses the `SlotScheduler`
consults on its hot path (DESIGN.md §16). The mechanisms live in the
scheduler itself; everything here is declarative so a config can be built
once, validated against the compiled `StepProgram`, logged, and reproduced.

Failure taxonomy the config covers:

* **Bad output** — a finished latent containing NaN/Inf, flagged on device
  by the coded `step_flight` done mask (`engine.compiler.DONE_NONFINITE`).
  Policy: re-admit the request (same seed, same x_T) up to `max_retries`
  times, walking the `fallback` chain toward safer tiers; exhaustion emits
  a failed `Completion` (ok=False) instead of shipping NaNs.
* **Overload** — more arrivals than the fleet drains. Policy: bound the
  admission queue at `max_queue` and shed past it, either rejecting new
  submissions outright (a typed `Rejection` back to the traffic source) or
  first remapping them to a cheaper tier once the queue passes
  `degrade_watermark`. Queued requests can additionally carry a TTL
  (per-request or `default_ttl`): a request whose deadline passed before a
  slot freed up is expired at admission time rather than served late.
* **Desync** — the host's predicted completion schedule disagreeing with
  the authoritative on-device `meta` counters (a lying step override, a
  corrupted counter, a host-side bug). Policy `recovery='recover'`: drain the
  pipeline, re-derive the host mirrors from device state, requeue affected
  requests, keep serving; `recovery='raise'` keeps the pre-resilience hard
  RuntimeError as the escape hatch for tests and debugging.

The defaults are deliberately inert: an unbounded queue, no TTL, no
retries, recovery enabled. A scheduler built with `ResilienceConfig()`
is bit-identical to one built before this layer existed as long as no
fault fires.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace
from typing import Optional, Tuple

REJECT_QUEUE_FULL = "queue_full"
REJECT_EXPIRED = "expired"
FAIL_NONFINITE = "nonfinite"


@dataclass(frozen=True)
class Rejection:
    """A request the scheduler refused to serve, returned to the traffic
    source by `SlotScheduler.submit` (queue_full) or recorded at admission
    (expired). Together with `Completion`s, rejections partition every
    submitted request: submitted == completed + rejected, the invariant
    `server.run_trace` metrics are derived under."""

    rid: int
    reason: str              # REJECT_QUEUE_FULL | REJECT_EXPIRED
    arrival: float
    clock: float             # when the decision was made (tick-clock units)
    tier: Optional[str] = None


@dataclass(frozen=True)
class ResilienceConfig:
    """Scheduler resilience policy. All defaults are inert (pre-resilience
    behavior); see the module docstring for the taxonomy each knob covers."""

    # -- overload control --
    max_queue: Optional[int] = None      # bound on queued requests; None =
                                         # unbounded (the legacy deque)
    shed_policy: str = "reject"          # 'reject' | 'degrade' past the bound
    degrade_watermark: Optional[int] = None  # queue depth at which 'degrade'
                                             # starts remapping tiers; None =
                                             # max_queue (only when full)
    degrade_tier: Optional[str] = None   # tier shed requests are remapped to
    default_ttl: Optional[float] = None  # admission deadline (tick-clock
                                         # units past arrival) for requests
                                         # without their own Request.ttl
    # -- output validation / retry --
    max_retries: int = 0                 # re-admissions after a non-finite
                                         # latent before emitting ok=False
    fallback: Tuple[str, ...] = ()       # safer-tier chain walked on retry;
                                         # () = retry on the same tier
    # -- desync recovery --
    recovery: str = "recover"            # 'recover' | 'raise'
    max_recoveries: int = 8              # recoveries before giving up: a
                                         # persistently lying step program
                                         # must not recover forever


DEFAULT_RESILIENCE = ResilienceConfig()


def validate_resilience(cfg: ResilienceConfig, program) -> ResilienceConfig:
    """Check a config against the compiled program it will police and
    return it normalized (degrade_watermark defaulted). Raises ValueError
    on contradictions — bad tier names, watermark past the queue bound —
    at construction time, never mid-serve."""
    if cfg.shed_policy not in ("reject", "degrade"):
        raise ValueError(f"shed_policy must be 'reject' or 'degrade', "
                         f"got {cfg.shed_policy!r}")
    if cfg.recovery not in ("recover", "raise"):
        raise ValueError(f"recovery must be 'recover' or 'raise', "
                         f"got {cfg.recovery!r}")
    if cfg.max_queue is not None and cfg.max_queue < 1:
        raise ValueError(f"max_queue must be >= 1, got {cfg.max_queue}")
    if cfg.max_retries < 0:
        raise ValueError(f"max_retries must be >= 0, got {cfg.max_retries}")
    if cfg.max_recoveries < 1:
        raise ValueError(f"max_recoveries must be >= 1, "
                         f"got {cfg.max_recoveries}")
    if cfg.default_ttl is not None and cfg.default_ttl <= 0:
        raise ValueError(f"default_ttl must be > 0, got {cfg.default_ttl}")
    # tier names must resolve against the program's bank — resolve_tier
    # raises the precise error (unknown tier / single-plan program)
    for t in cfg.fallback:
        program.resolve_tier(t)
    if cfg.shed_policy == "degrade":
        if cfg.degrade_tier is None:
            raise ValueError("shed_policy='degrade' needs degrade_tier")
        program.resolve_tier(cfg.degrade_tier)
    if cfg.degrade_watermark is None and cfg.shed_policy == "degrade":
        cfg = dc_replace(cfg, degrade_watermark=(
            cfg.max_queue if cfg.max_queue is not None else 0))
    if (cfg.degrade_watermark is not None and cfg.max_queue is not None
            and cfg.degrade_watermark > cfg.max_queue):
        raise ValueError(
            f"degrade_watermark ({cfg.degrade_watermark}) past max_queue "
            f"({cfg.max_queue}): shedding would reject before it degrades")
    return cfg


def fallback_tier(cfg: ResilienceConfig, tier: Optional[str]) -> Optional[str]:
    """The tier a failed request retries on: the next entry of the fallback
    chain after its current tier (entering at the head if the tier is not on
    the chain, parking at the tail once reached). An empty chain retries on
    the same tier — the right default for transient faults."""
    chain = cfg.fallback
    if not chain:
        return tier
    if tier not in chain:
        return chain[0]
    i = chain.index(tier)
    return chain[min(i + 1, len(chain) - 1)]
