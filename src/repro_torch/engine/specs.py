"""Engine specs and the solver registry (the port of `repro.engine.specs`).

Every multistep solver is a per-step weight table over one shared state
update; `SOLVERS` maps a solver name to its table compiler. The port's
registry holds `unipc` alone; the rest of the reference's zoo is not yet
ported.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional

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
    use_corrector: Optional[bool] = None  # None -> solver default (on)
    corrector_at_last: bool = False
    # classifier-free guidance, fused into one batched eval per row
    cfg_scale: float = 0.0
    cfg_schedule: str = "constant"     # constant | linear | cosine
    cfg_scale_end: Optional[float] = None
    thresholding: bool = False         # not yet ported: raises
    # execution: False pins the combine's plain PyTorch version
    fused_update: bool = True
    eval_dtype: str = "float32"        # only float32 is ported
    # quantized denoiser tier: "none" or a models.quant.QUANT_MODES name
    # ("w8a16", "w8a8", "fp8a16", "w4a16"). A contract, not a switch: the
    # engine must be wired with a matching quantized param tree
    # (`build_engine(quant=...)`), and `model_fn` rejects a mismatch.
    quant: str = "none"

    def resolve(self) -> "EngineSpec":
        """Fill solver-dependent defaults; validate against the registry."""
        sd = solver_def(self.solver)
        out = self
        if out.eval_dtype != "float32":
            raise not_yet_ported(f"eval_dtype={out.eval_dtype!r}")
        if out.thresholding:
            raise not_yet_ported("dynamic thresholding")
        if out.quant != "none":
            # import here: specs stays importable without the models package
            from ..models.quant import quant_spec
            quant_spec(out.quant)  # raises on unknown tier names
        if out.prediction is None:
            out = replace(out, prediction=sd.prediction)
        if out.use_corrector is None:
            out = replace(out, use_corrector=sd.corrector_default)
        return out


@dataclass(frozen=True)
class SolverDef:
    """One registry entry: compile(spec, noise_schedule) -> SolverTable."""

    name: str
    prediction: str                    # default prediction type
    compile: Callable
    corrector_default: bool = False


def register(sd: SolverDef) -> SolverDef:
    SOLVERS[sd.name] = sd
    return sd


def solver_def(name: str) -> SolverDef:
    if name not in SOLVERS:
        raise not_yet_ported(f"solver {name!r} (ported: {sorted(SOLVERS)})")
    return SOLVERS[name]
