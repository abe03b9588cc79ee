"""Per-step weight-table compilers (the port of `repro.engine.compiler`,
UniPC's native table only)."""

from __future__ import annotations

from dataclasses import replace as dc_replace

import numpy as np

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
    guidance-scale schedule `g`. The input table is not mutated."""
    spec = spec.resolve()
    cols = dict(tab.model_cols or {})
    if spec.cfg_scale:
        cols["g"] = guidance_schedule(spec.cfg_scale, len(tab.timesteps),
                                      spec.cfg_schedule, spec.cfg_scale_end)
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
