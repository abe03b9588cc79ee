from .schedules import NoiseSchedule, VPLinear, timestep_grid
from .process import eps_to_x0
from .guidance import cfg_model_fused, dynamic_threshold, guidance_schedule

__all__ = ["NoiseSchedule", "VPLinear", "timestep_grid", "eps_to_x0",
           "cfg_model_fused", "dynamic_threshold", "guidance_schedule"]
