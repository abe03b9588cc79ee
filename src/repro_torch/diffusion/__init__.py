from .schedules import EDMSchedule, NoiseSchedule, VPCosine, VPLinear, timestep_grid
from .process import (diffusion_loss, draw_t_noise, eps_to_x0, q_sample,
                      wrap_model, x0_to_eps)
from .guidance import (cfg_model, cfg_model_fused, dynamic_threshold,
                       guidance_schedule, guided_data_model)
from .gaussian import GaussianDPM, MixtureDPM, empirical_order

__all__ = ["NoiseSchedule", "VPLinear", "VPCosine", "EDMSchedule",
           "timestep_grid", "eps_to_x0", "x0_to_eps", "q_sample",
           "diffusion_loss", "draw_t_noise",
           "wrap_model", "cfg_model", "cfg_model_fused", "dynamic_threshold",
           "guidance_schedule", "guided_data_model", "GaussianDPM",
           "MixtureDPM", "empirical_order"]
