"""UniPC core: host coefficient tables and the row-loop sampler."""

from .coeffs import (SolverTable, UniPCSchedule, augment_step_rows,
                     build_unipc_schedule, stack_step_rows)
from .unipc import (make_unipc_schedule, step_fn_over_rows, unipc_sample_scan,
                    unipc_step_fn)

__all__ = ["SolverTable", "UniPCSchedule", "augment_step_rows",
           "build_unipc_schedule", "stack_step_rows", "make_unipc_schedule",
           "step_fn_over_rows", "unipc_sample_scan", "unipc_step_fn"]
