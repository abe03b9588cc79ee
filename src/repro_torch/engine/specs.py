"""Engine specs and the solver registry (the port of `repro.engine.specs`).

Every multistep solver is a per-step weight table over one shared state
update, so the whole zoo compiles to the one row-loop sampler. A
`SolverDef` pairs that compiler with its python-loop reference (the
`GridSolver` subclass the tests compare against); `SOLVERS` maps a solver
name to it.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional

EVAL_DTYPES = ("float32", "bfloat16")

SOLVERS: Dict[str, "SolverDef"] = {}


def not_yet_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to repro_torch")


@dataclass(frozen=True)
class EngineSpec:
    """Everything `SamplerEngine.build` needs to produce a run function."""

    solver: str = "unipc"
    nfe: int = 10
    order: int = 3
    prediction: Optional[str] = None   # None -> the solver's default
    variant: str = "bh2"               # B(h) variant
    spacing: str = "logsnr"
    lower_order_final: bool = True
    # corrector: UniPC's own, or the method-agnostic UniC bolt-on (Table 2)
    # for any other multistep solver. None -> solver default (on for unipc).
    use_corrector: Optional[bool] = None
    corrector_order: Optional[int] = None  # None -> solver-matched UniC-p
    corrector_at_last: bool = False
    # classifier-free guidance, fused into one batched eval per row
    cfg_scale: float = 0.0
    cfg_schedule: str = "constant"     # constant | linear | cosine
    cfg_scale_end: Optional[float] = None
    # Imagen-style dynamic thresholding of the x0 prediction, a per-eval
    # table column like the guidance scale (data prediction only)
    thresholding: bool = False
    threshold_percentile: float = 0.995
    # execution: False pins the combine's plain PyTorch version
    fused_update: bool = True
    # feature reuse (DESIGN.md §12): the static DiT block boundary of a
    # cached eval (0 = no cache). Like eval_dtype a contract: the engine
    # must be wired for the same boundary (`build_engine(cache_block=...)`)
    cache_block: int = 0
    # the eps-net's eval precision (DESIGN.md §11): solver state, combine
    # weights and the eps <-> x0 conversion stay fp32 either way. A
    # contract like `quant`: the engine must be wired for it
    # (`build_engine(eval_dtype=...)`), and `model_fn` rejects a mismatch.
    eval_dtype: str = "float32"
    # quantized denoiser tier: "none" or a models.quant.QUANT_MODES name
    # ("w8a16", "w8a8", "fp8a16", "w4a16"). A contract, not a switch: the
    # engine must be wired with a matching quantized param tree
    # (`build_engine(quant=...)`), and `model_fn` rejects a mismatch.
    quant: str = "none"

    def resolve(self) -> "EngineSpec":
        """Fill solver-dependent defaults; validate against the registry."""
        sd = solver_def(self.solver)
        out = self
        if out.eval_dtype not in EVAL_DTYPES:
            raise ValueError(f"eval_dtype must be 'float32' or 'bfloat16', "
                             f"got {out.eval_dtype!r}")
        if out.quant != "none":
            # import here: specs stays importable without the models package
            from ..models.quant import quant_spec
            quant_spec(out.quant)  # raises on unknown tier names
        if out.cache_block < 0:
            raise ValueError(f"cache_block must be >= 0, got "
                             f"{out.cache_block}")
        if out.cache_block and out.cfg_scale:
            raise ValueError(
                "feature reuse (cache_block > 0) serves unconditional "
                "programs only: the fused-CFG eval stacks cond+uncond into "
                "one 2B batch, which would need a 2B cache ring — tune and "
                "serve cached plans with cfg_scale=0")
        if out.prediction is None:
            out = replace(out, prediction=sd.prediction)
        elif sd.fixed_prediction and out.prediction != sd.prediction:
            raise ValueError(
                f"solver {sd.name!r} is {sd.prediction}-prediction only, "
                f"got prediction={out.prediction!r}")
        if out.use_corrector is None:
            out = replace(out, use_corrector=sd.corrector_default)
        if out.use_corrector and sd.singlestep:
            raise ValueError(
                f"UniC bolt-on is grid-anchored; singlestep solver "
                f"{sd.name!r} compiles with use_corrector=False")
        if out.corrector_order is None:
            out = replace(out, corrector_order=sd.unic_order(out))
        return out


@dataclass(frozen=True)
class SolverDef:
    """One registry entry: a weight-table compiler plus its loop reference.

    compile(spec, noise_schedule) -> SolverTable  (host-side float64 rows)
    loop(spec, noise_schedule, model_fn) -> sample_fn(x_T)  (GridSolver path)
    """

    name: str
    prediction: str                    # default prediction type
    compile: Callable
    loop: Callable
    fixed_prediction: bool = True
    singlestep: bool = False
    corrector_default: bool = False
    # UniC-p order matched to the solver (Table 2), as a function of the spec
    default_corrector_order: Optional[Callable] = None

    def unic_order(self, spec: EngineSpec) -> int:
        if self.default_corrector_order is None:
            return spec.order
        return self.default_corrector_order(spec)


def register(sd: SolverDef) -> SolverDef:
    SOLVERS[sd.name] = sd
    return sd


def solver_def(name: str) -> SolverDef:
    if name not in SOLVERS:
        raise KeyError(f"unknown solver {name!r}; registered: "
                       f"{sorted(SOLVERS)}")
    return SOLVERS[name]


def default_tier_specs(**common) -> Dict[str, EngineSpec]:
    """Hand-set quality-tier specs for plan-bank serving: one deployment,
    three NFE budgets. `common` overrides shared knobs (cfg_scale, ...) on
    every tier."""
    tiers = {
        "fast": EngineSpec(solver="unipc", nfe=5, order=2),
        "balanced": EngineSpec(solver="unipc", nfe=8, order=3),
        "quality": EngineSpec(solver="unipc", nfe=16, order=3),
    }
    return {k: replace(v, **common) for k, v in tiers.items()}
