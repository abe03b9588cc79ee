"""Continuous-batching diffusion serving (the port of `repro.serving`,
DESIGN.md §9, §13, §16).

`scheduler.SlotScheduler` drives a `StepProgram` over a fixed set of batch
slots: requests queue, admit on any free slot, step per slot through the
solver table, and emit their latent the tick they finish, read back as a
trailing stream of pipelined ticks. `server` adds the Poisson / trace
request generators, the trace runner and the serving metrics (throughput,
p50/p95 latency, slot occupancy, evals-per-latent).

`resilience` + `faults` make the loop survivable: bounded admission with
typed rejections and TTL expiry, on-device output validation with
degraded-tier retry, host/device desync recovery, and a deterministic
fault-injection harness that proves all of it under chaos.
"""

from .faults import (FaultInjector, FaultPlan, MetaFault, NanFault,
                     SkewFault, parse_fault_spec)
from .resilience import (DEFAULT_RESILIENCE, Rejection, ResilienceConfig,
                         fallback_tier, validate_resilience)
from .scheduler import Completion, Request, SlotScheduler
from .server import (ServeMetrics, load_trace, poisson_requests, run_trace,
                     save_trace)

__all__ = [
    "Request", "Completion", "SlotScheduler",
    "ServeMetrics", "poisson_requests", "load_trace", "save_trace",
    "run_trace",
    "ResilienceConfig", "DEFAULT_RESILIENCE", "Rejection",
    "fallback_tier", "validate_resilience",
    "FaultPlan", "FaultInjector", "NanFault", "MetaFault", "SkewFault",
    "parse_fault_spec",
]
