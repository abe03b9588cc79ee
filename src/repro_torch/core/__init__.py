"""UniPC core: host coefficient tables, the row-loop sampler, and the
python-loop solvers (UniPC and every compared baseline)."""

from .coeffs import (SolverTable, UniPCSchedule, augment_step_rows, bh_value,
                     build_unipc_schedule, default_order_schedule,
                     eval_cost_rows, stack_step_rows, unipc_weights)
from .solver import CorrectorConfig, Grid, GridSolver, History, unified_step
from .unipc import (UniPC, UniPCSinglestep, make_unipc_schedule,
                    step_fn_over_rows, unipc_sample_scan, unipc_step_fn)
from .baselines import DDIM, DEIS, DPMSolverPP, DPMSolverSinglestep, PNDM

__all__ = [
    "UniPC", "UniPCSinglestep", "SolverTable", "UniPCSchedule",
    "unipc_sample_scan", "unipc_step_fn", "step_fn_over_rows",
    "augment_step_rows", "stack_step_rows", "eval_cost_rows",
    "make_unipc_schedule",
    "build_unipc_schedule", "default_order_schedule", "unipc_weights",
    "bh_value", "unified_step", "Grid", "GridSolver", "History",
    "CorrectorConfig", "DDIM", "DPMSolverPP", "DPMSolverSinglestep", "PNDM",
    "DEIS",
]
