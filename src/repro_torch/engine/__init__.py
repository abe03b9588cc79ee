"""Sampling engine: compile a spec to a weight table, run it by rows.

Importing this package populates the solver registry (`SOLVERS`).
"""

from .specs import SOLVERS, EngineSpec, SolverDef, solver_def
from .compiler import apply_model_cols, compile_table, step_guidance_profile
from .engine import SamplerEngine, StepProgram

__all__ = ["SOLVERS", "EngineSpec", "SolverDef", "solver_def",
           "SamplerEngine", "StepProgram", "compile_table",
           "step_guidance_profile", "apply_model_cols"]
