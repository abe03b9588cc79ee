"""Solver-plan autotuner (the port of `repro.tuning`, DESIGN.md §10).

UniPC's accuracy at extreme few-step budgets hinges on per-step choices the
paper fixes by hand: timestep placement, UniP order, UniC on/off, B(h)
variant. This package makes those choices *data*:

* `plans`     — `SolverPlan`, the per-step decision vector; lowers through
                the same `build_unipc_schedule` path as every hand-set
                table; JSON (de)serialization; tier-keyed plan banks.
* `objective` — scores a plan by trajectory discrepancy against a high-NFE
                reference run (no FID model needed); one runner keeps each
                NFE's packed table in static buffers, so on the card every
                candidate replays the same CUDA graphs and none captures.
* `search`    — deterministic coordinate descent with a beam over the mixed
                discrete/continuous space.

Serving integration lives in `engine.SamplerEngine.build_bank`: tuned plans
stack into one row-gatherable table (`core.stack_step_rows`) that a single
`StepProgram` serves as fast/balanced/quality tiers.
"""

from .objective import (PlanObjective, QuantParityError, make_objective,
                        quant_parity_gate, reference_trajectory)
from .plans import SolverPlan, load_bank, save_bank
from .search import (CachedSearchResult, SearchConfig, SearchResult,
                     tune_cached_plan, tune_plan)

__all__ = [
    "SolverPlan", "save_bank", "load_bank",
    "PlanObjective", "make_objective", "reference_trajectory",
    "QuantParityError", "quant_parity_gate",
    "SearchConfig", "SearchResult", "tune_plan",
    "CachedSearchResult", "tune_cached_plan",
]
