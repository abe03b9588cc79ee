"""Sampling engine: compile a spec to a weight table, run it by rows, as
CUDA graph replays on the card.

Importing this package populates the solver registry (`SOLVERS`): each
entry pairs a per-step weight-table compiler with its python-loop
reference.
"""

from .specs import SOLVERS, EngineSpec, SolverDef, default_tier_specs, solver_def
from .compiler import (DONE_IDLE, DONE_NONFINITE, DONE_OK, apply_model_cols,
                       build_loop, compile_table, flag_done,
                       step_guidance_profile)
from .engine import CacheSpec, SamplerEngine, StepProgram, resolve_device

__all__ = ["SOLVERS", "EngineSpec", "SolverDef", "solver_def",
           "default_tier_specs", "CacheSpec", "SamplerEngine", "StepProgram",
           "resolve_device", "compile_table", "build_loop",
           "step_guidance_profile", "apply_model_cols", "flag_done",
           "DONE_IDLE", "DONE_OK", "DONE_NONFINITE"]
