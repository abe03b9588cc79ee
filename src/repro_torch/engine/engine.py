"""SamplerEngine: spec -> weight table -> row-loop sampler, with fused CFG
(the port of `repro.engine.engine`).

    engine = SamplerEngine(schedule, eps=eps_fn, eps_stacked=stacked_fn,
                           device="cuda")
    x0 = engine.build(EngineSpec(nfe=10, cfg_scale=2.0))(x_T)

`build` is the whole-trajectory path (one uniform batch); `build_step`
compiles the same table into a per-slot `StepProgram`, the continuous-
batching step where every slot gathers its own table row and guidance
scale. CFG runs as ONE batched network call per row — cond and uncond
stacked along the batch — with the guidance scale riding the table as a
per-eval column. The reference's jit and buffer donation have no
counterpart here: the step returns fresh state tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace
from typing import Callable, Optional, Tuple

import torch

from ..core.coeffs import SolverTable, augment_step_rows
from ..core.unipc import rows_on, run_rows, step_fn_over_rows, unipc_step_fn
from ..diffusion.guidance import cfg_model_fused
from ..diffusion.process import eps_to_x0
from ..diffusion.schedules import NoiseSchedule
from .compiler import apply_model_cols, compile_table, step_guidance_profile
from .specs import EngineSpec


@dataclass
class StepProgram:
    """A per-slot step program — what a serving loop drives.

    step(state, idx[, g, extras]) -> state advances every slot by one table
    row: `state = (x, E)` with x (B, *sample) and E the (K+1, B, *sample)
    eval ring, `idx` (B,) the per-slot row index (0 = init row; idle slots
    park there), `g` (B,) the per-slot guidance scale (cfg programs only)
    and `extras` per-slot model keyword arguments (class ids). One batched
    model eval per call. A request admitted at tick tau into a zeroed slot
    and stepped through rows 0..n_rows-1 reproduces the uniform `build()`
    run for its own (seed, class, cfg-scale).
    """

    step: Callable
    n_rows: int          # ticks per request
    spec: EngineSpec
    uses_cfg: bool
    ring: int            # eval-ring slots carried per sample, K + 1
    device: torch.device

    def init_state(self, slots: int, sample_shape: Tuple[int, ...],
                   dtype=torch.float32):
        """Zeroed slot state: every slot idle on the init row."""
        shape = tuple(sample_shape)
        return (torch.zeros((slots,) + shape, dtype=dtype, device=self.device),
                torch.zeros((self.ring, slots) + shape, dtype=dtype,
                            device=self.device))

    def init_g(self, slots: int) -> torch.Tensor:
        """Per-slot guidance scales, seeded with the spec's nominal scale."""
        return torch.full((slots,), float(self.spec.cfg_scale or 0.0),
                          dtype=torch.float32, device=self.device)


@dataclass
class SamplerEngine:
    """Sampling engine over one eps-network on one device.

    eps:         (x, t, **extra) -> eps-hat (the cond branch).
    eps_stacked: (xx, t, **extra) -> eps-hat on a 2B batch whose
                 conditioning is [cond; null] — required for cfg_scale != 0.
    quant:       "none" or the models.quant tier the wired eps-net's params
                 were quantized for (`launch.sample.build_engine(quant=...)`
                 sets it); `model_fn`, and so `build` and `build_step`,
                 reject specs that disagree.
    """

    schedule: NoiseSchedule
    eps: Callable
    eps_stacked: Optional[Callable] = None
    device: torch.device = torch.device("cpu")
    quant: str = "none"

    def compile(self, spec: EngineSpec) -> SolverTable:
        """Compile the spec's weight table and attach its per-eval model
        columns (the guidance schedule)."""
        spec = spec.resolve()
        return apply_model_cols(compile_table(spec, self.schedule), spec)

    def model_fn(self, spec: EngineSpec, tab: SolverTable) -> Callable:
        """Wrap the eps-net into the table's prediction type, consuming the
        per-eval model column `g`; further keyword arguments (per-slot class
        ids) pass through to the eps-net."""
        spec = spec.resolve()
        if spec.quant != self.quant:
            raise ValueError(
                f"spec.quant={spec.quant!r} but this engine's eps-net was "
                f"wired for {self.quant!r}; the quantized param tree is "
                f"baked into the net — pass the same quant to build_engine "
                f"and the EngineSpec")
        if spec.cfg_scale:
            if self.eps_stacked is None:
                raise ValueError("cfg_scale != 0 needs eps_stacked (a 2B "
                                 "cond+uncond batched eps-net)")
            eps = cfg_model_fused(self.eps_stacked)
        else:
            eps = lambda x, t, g=None, **extra: self.eps(x, t, **extra)
        schedule = self.schedule

        def model(x, t, g=None, **extra):
            e = eps(x, t, g, **extra)
            if tab.prediction == "noise":
                return e
            return eps_to_x0(schedule, x, t, e)

        return model

    def build(self, spec: EngineSpec,
              table: Optional[SolverTable] = None) -> Callable:
        """spec -> run(x_T, **model_kwargs) -> x0, the uniform sampler.
        `model_kwargs` (e.g. class_ids for a per-request-conditioned
        engine) reach the eps-net on every row. The step and its device
        table are built here, once; a run only loops over the rows."""
        spec = spec.resolve()
        tab = table if table is not None else self.compile(spec)
        step, n_rows = unipc_step_fn(self.model_fn(spec, tab), tab,
                                     device=self.device,
                                     fused_update=spec.fused_update)
        ring = tab.w_pred.shape[1] + 1

        def run(x_T, **model_kwargs):
            return run_rows(step, n_rows, x_T, ring=ring,
                            model_kwargs=model_kwargs or None)

        return run

    def build_step(self, spec: EngineSpec) -> StepProgram:
        """spec -> StepProgram: the per-slot step function for continuous
        batching. The same table rows `build` runs uniformly, gathered per
        slot; the guidance scale becomes per-slot state (times the table's
        schedule profile) so every request carries its own cfg scale."""
        spec = spec.resolve()
        tab = self.compile(spec)
        uses_cfg = bool(spec.cfg_scale)
        model = self.model_fn(spec, tab)
        step_tab = tab
        prof = None
        if uses_cfg:
            # the absolute g column is replaced by per-slot state x the
            # schedule profile; the core step must not gather it
            prof = torch.as_tensor(step_guidance_profile(tab, spec),
                                   dtype=torch.float32).to(self.device)
            step_tab = dc_replace(tab, model_cols={
                k: v for k, v in (tab.model_cols or {}).items() if k != "g"})
        rows_np = augment_step_rows(step_tab)
        n_rows = len(rows_np["t"])
        core_step = step_fn_over_rows(model, rows_on(rows_np, self.device),
                                      sign=tab.sign,
                                      fused_update=spec.fused_update)

        def step(state, idx, g=None, extras=None):
            # a host index crosses to the card here, one blocking copy a
            # tick: the serving scheduler, which keeps it there, is not
            # ported yet
            idx = torch.as_tensor(idx, device=self.device).long()
            kw = dict(extras) if extras else {}
            if uses_cfg:
                gs = (torch.full(idx.shape, float(spec.cfg_scale),
                                 dtype=torch.float32, device=self.device)
                      if g is None else torch.as_tensor(
                          g, dtype=torch.float32, device=self.device))
                kw["g"] = gs * prof[idx.clamp(0, n_rows - 1)]
            return core_step(state, idx, model_kwargs=kw or None)

        return StepProgram(step=step, n_rows=n_rows, spec=spec,
                           uses_cfg=uses_cfg,
                           ring=rows_np["w_pred"].shape[-1] + 1,
                           device=torch.device(self.device))

