"""Per-step weight-table compilers (the port of `repro.engine.compiler`,
UniPC's native table only), the per-eval model columns, and the flight
step's coded done mask."""

from __future__ import annotations

from dataclasses import replace as dc_replace

import numpy as np
import torch

from ..core.coeffs import SolverTable, build_unipc_schedule
from ..diffusion.guidance import guidance_schedule
from ..diffusion.schedules import timestep_grid
from .specs import EngineSpec, SolverDef, register, solver_def


def compile_table(spec: EngineSpec, noise_schedule) -> SolverTable:
    """Resolve the spec against the registry and compile its weight table."""
    spec = spec.resolve()
    return solver_def(spec.solver).compile(spec, noise_schedule)


def apply_model_cols(tab: SolverTable, spec: EngineSpec) -> SolverTable:
    """Return `tab` with the spec's per-eval model columns attached: the
    guidance-scale schedule `g` and the dynamic-thresholding percentile
    `tq`. The input table is not mutated."""
    spec = spec.resolve()
    n_evals = len(tab.timesteps)
    cols = dict(tab.model_cols or {})
    if spec.cfg_scale:
        cols["g"] = guidance_schedule(spec.cfg_scale, n_evals,
                                      spec.cfg_schedule, spec.cfg_scale_end)
    if spec.thresholding:
        if tab.prediction != "data":
            raise ValueError("dynamic thresholding clips the x0 "
                             "prediction; use a data-prediction solver")
        cols["tq"] = guidance_schedule(spec.threshold_percentile, n_evals)
    return dc_replace(tab, model_cols=cols)


def step_guidance_profile(tab: SolverTable, spec: EngineSpec) -> np.ndarray:
    """(M+1,) guidance profile for the per-slot step path, host-side float64:
    the compiled `g` column normalized by the spec's nominal scale. The
    effective per-slot scale at row i is `g_slot * profile[i]`."""
    cols = tab.model_cols or {}
    if "g" not in cols or not spec.cfg_scale:
        raise ValueError("guidance profile needs a table compiled with "
                         "cfg_scale != 0")
    return np.asarray(cols["g"], np.float64) / float(spec.cfg_scale)


def _compile_unipc(spec: EngineSpec, noise_schedule) -> SolverTable:
    t, lam, alpha, sigma = timestep_grid(noise_schedule, spec.nfe, spec.spacing)
    return build_unipc_schedule(
        lambdas=lam, alphas=alpha, sigmas=sigma, timesteps=t,
        order=spec.order, prediction=spec.prediction, variant=spec.variant,
        use_corrector=spec.use_corrector,
        corrector_at_last=spec.corrector_at_last,
        lower_order_final=spec.lower_order_final,
    )


register(SolverDef(name="unipc", prediction="data", compile=_compile_unipc,
                   corrector_default=True))


# The flight step's done mask (DESIGN.md §16): a coded int32 per slot, not
# a boolean, so a slot that finished with a non-finite latent is told apart
# from one that finished well, on the device, with no host read.

DONE_IDLE = 0        # slot not finishing this tick (idle or mid-flight)
DONE_OK = 1          # slot finished; latent is finite
DONE_NONFINITE = 2   # slot finished; latent contains NaN/Inf


def finite_slots(x: torch.Tensor) -> torch.Tensor:
    """(B,) bool: True where every element of slot b of `x` is finite."""
    return torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)


def flag_done(done: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The coded (B,) int32 done mask from a boolean one and the slots'
    latents (DONE_* above)."""
    code = torch.where(finite_slots(x), DONE_OK, DONE_NONFINITE)
    return torch.where(done, code, DONE_IDLE).to(torch.int32)
