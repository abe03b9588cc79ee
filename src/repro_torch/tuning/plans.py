"""Solver plans: the searchable per-step decision vector (the port of
`repro.tuning.plans`, numpy only).

A `SolverPlan` pins every choice the paper fixes by hand at a given NFE
budget — where each timestep lands, the UniP order used at each step,
whether the UniC corrector runs, and which B(h) variant builds the weights —
as plain data. Lowering a plan reuses the exact machinery hand-set UniPC
tables lower through (`core.coeffs.build_unipc_schedule` with per-step
order / variant / corrector schedules), so a tuned plan is *just a better
weight table*: the fused scan, the per-slot step function, and the serving
scheduler all execute it unchanged.

Timestep placement is parametrized in normalized log-SNR coordinates:
`knots` are the M-1 interior grid positions u_i in (0, 1), strictly
increasing, with lambda_i = lam_T + u_i (lam_eps - lam_T). Uniform knots
reproduce the 'logsnr' spacing exactly, so the default plan for an
`EngineSpec` compiles bit-identically to the registry's UniPC table — the
search starts from the paper's baseline, not beside it.

Plans (and tier-keyed *banks* of plans) serialize to JSON. Floats round-trip
exactly through `json` (repr-based), so load(save(plan)) compiles to a
bit-identical table, and a plan compiles to the reference's table bit for
bit (`tests/test_torch_cache.py`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

import numpy as np

from ..core.coeffs import (BH_VARIANTS, PREDICTION_TYPES, SolverTable,
                           build_unipc_schedule, default_order_schedule)

PLAN_KIND = "solver-plan"
BANK_KIND = "plan-bank"
SEARCH_VARIANTS = ("bh1", "bh2")   # the searchable B(h) choices (Table 1)
MAX_ORDER = 3


@dataclass
class SolverPlan:
    """Per-step decision vector for one NFE budget.

    nfe: M steps (M+1 grid points, M+1 model evals through the scan).
    knots: (M-1,) interior grid positions in (0,1), strictly increasing.
    orders: (M,) UniP order per step (warm-up clamp min(p_i, i) applies at
        lowering, as everywhere else).
    corrector: (M,) UniC on/off per step.
    variants: (M,) B(h) variant per step.
    cache_depth: optional (M,) feature-reuse depth per step (DESIGN.md §12):
        0 = full eval, k > 0 = shallow eval recomputing only the first k DiT
        blocks and reusing the cached deep features. The cache boundary is
        static in the compiled program, so every nonzero entry must be the
        same k (`cache_block`). None = the plan has no cache axis at all and
        serves on uncached engines unchanged.
    meta: provenance — search budget, objective values, arch, reference NFE.
    """

    nfe: int
    knots: List[float]
    orders: List[int]
    corrector: List[bool]
    variants: List[str]
    prediction: str = "data"
    cache_depth: Optional[List[int]] = None
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        self.validate()

    def validate(self) -> "SolverPlan":
        M = self.nfe
        if M < 1:
            raise ValueError(f"plan needs nfe >= 1, got {M}")
        if self.prediction not in PREDICTION_TYPES:
            raise ValueError(f"unknown prediction {self.prediction!r}")
        if len(self.knots) != M - 1:
            raise ValueError(f"plan nfe={M} needs {M - 1} knots, "
                             f"got {len(self.knots)}")
        u = np.asarray(self.knots, np.float64)
        if len(u) and not (np.all(np.diff(np.concatenate([[0.0], u, [1.0]]))
                                  > 0)):
            raise ValueError("knots must be strictly increasing in (0, 1)")
        for name, seq in (("orders", self.orders),
                          ("corrector", self.corrector),
                          ("variants", self.variants)):
            if len(seq) != M:
                raise ValueError(f"plan nfe={M} needs {M} {name}, "
                                 f"got {len(seq)}")
        if not all(1 <= o <= MAX_ORDER for o in self.orders):
            raise ValueError(f"orders must be in 1..{MAX_ORDER}, "
                             f"got {self.orders}")
        if not all(v in BH_VARIANTS for v in self.variants):
            raise ValueError(f"variants must be in {BH_VARIANTS}, "
                             f"got {self.variants}")
        if self.cache_depth is not None:
            if len(self.cache_depth) != M:
                raise ValueError(f"plan nfe={M} needs {M} cache_depth "
                                 f"entries, got {len(self.cache_depth)}")
            if not all(int(d) >= 0 for d in self.cache_depth):
                raise ValueError(f"cache_depth entries must be >= 0, "
                                 f"got {self.cache_depth}")
            ks = {int(d) for d in self.cache_depth if d}
            if len(ks) > 1:
                raise ValueError(
                    f"the cache boundary is static in the compiled program: "
                    f"all nonzero cache_depth entries must share one k, "
                    f"got {sorted(ks)}")
        return self

    @property
    def cache_block(self) -> int:
        """The plan's static cache boundary (0 = no shallow steps)."""
        if not self.cache_depth:
            return 0
        return max(int(d) for d in self.cache_depth)

    # -- lowering ------------------------------------------------------------
    def grid(self, noise_schedule):
        """(t, lam, alpha, sigma) arrays for this plan's knot placement."""
        lam_T = float(noise_schedule.lam(noise_schedule.T))
        lam_0 = float(noise_schedule.lam(noise_schedule.t_eps))
        u = np.concatenate([[0.0], np.asarray(self.knots, np.float64), [1.0]])
        lams = lam_T + u * (lam_0 - lam_T)
        ts = noise_schedule.t_of_lam(lams)
        ts = np.asarray(ts, np.float64)
        # recompute lambda from t so the table's grid is self-consistent with
        # the schedule's own lam(t) (exactly as timestep_grid does)
        lams = noise_schedule.lam(ts)
        return ts, lams, noise_schedule.alpha(ts), noise_schedule.sigma(ts)

    def compile(self, noise_schedule) -> SolverTable:
        """Lower the plan to the solver-agnostic weight table.

        The table width is padded to MAX_ORDER-1 difference columns no matter
        the plan's own max order, so every candidate a search proposes shares
        one shape signature — the tuner's runner never captures anew — and
        stacked plan banks need no per-tier padding.
        """
        t, lam, alpha, sigma = self.grid(noise_schedule)
        tab = build_unipc_schedule(
            lambdas=lam, alphas=alpha, sigmas=sigma, timesteps=t,
            order=MAX_ORDER, prediction=self.prediction,
            variant=self.variants[0],
            order_schedule=[min(o, MAX_ORDER) for o in self.orders],
            variant_schedule=list(self.variants),
            corrector_schedule=[bool(c) for c in self.corrector],
        )
        if self.cache_depth is not None:
            # the per-eval reuse flag as a model column: row 0 (the init
            # eval) is always full — it seeds the cache — followed by one
            # 0/1 per body step. Attached even when every step is full so a
            # candidate's table shape is stable across a cache search.
            tab.model_cols = dict(tab.model_cols or {})
            tab.model_cols["cache_reuse"] = np.asarray(
                [0.0] + [1.0 if d else 0.0 for d in self.cache_depth],
                np.float64)
        return tab

    def eval_cost(self, n_blocks: int) -> float:
        """Evals-per-latent: total model-eval cost of the plan's M+1 evals in
        full-eval units, counting each shallow step as cache_block/n_blocks
        (`core.coeffs.eval_cost_rows` over the lowered table agrees)."""
        full = self.nfe + 1
        if not self.cache_depth or not n_blocks:
            return float(full)
        shallow = sum(1 for d in self.cache_depth if d)
        return float(full - shallow * (1.0 - self.cache_block / n_blocks))

    # -- construction --------------------------------------------------------
    @staticmethod
    def default(nfe: int, *, order: int = 3, prediction: str = "data",
                variant: str = "bh2", use_corrector: bool = True,
                corrector_at_last: bool = False,
                lower_order_final: bool = True) -> "SolverPlan":
        """The hand-set UniPC-`order` policy as a plan: uniform log-SNR
        knots, the paper's warm-up order schedule, corrector on every step
        but the last. Compiles to the same table `EngineSpec(solver="unipc")`
        does (modulo the fixed MAX_ORDER column padding)."""
        M = nfe
        u = (np.arange(1, M, dtype=np.float64) / M).tolist()
        orders = default_order_schedule(M, order, lower_order_final)
        corr = [use_corrector and (corrector_at_last or i < M)
                for i in range(1, M + 1)]
        return SolverPlan(nfe=M, knots=u, orders=list(orders), corrector=corr,
                          variants=[variant] * M, prediction=prediction)

    @staticmethod
    def from_spec(spec) -> "SolverPlan":
        """Default plan matching a resolved unipc `EngineSpec`."""
        spec = spec.resolve()
        if spec.solver != "unipc":
            raise ValueError(f"plans parametrize the unipc decision space; "
                             f"got solver={spec.solver!r}")
        return SolverPlan.default(
            spec.nfe, order=spec.order, prediction=spec.prediction,
            variant=spec.variant, use_corrector=spec.use_corrector,
            corrector_at_last=spec.corrector_at_last,
            lower_order_final=spec.lower_order_final)

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        d = {"kind": PLAN_KIND, "version": 1, "nfe": self.nfe,
             "prediction": self.prediction,
             "knots": [float(u) for u in self.knots],
             "orders": [int(o) for o in self.orders],
             "corrector": [bool(c) for c in self.corrector],
             "variants": list(self.variants), "meta": dict(self.meta)}
        if self.cache_depth is not None:
            d["cache_depth"] = [int(c) for c in self.cache_depth]
        return d

    @staticmethod
    def from_dict(d: dict) -> "SolverPlan":
        if d.get("kind") != PLAN_KIND:
            raise ValueError(f"not a solver plan: kind={d.get('kind')!r}")
        cd = d.get("cache_depth")
        return SolverPlan(nfe=int(d["nfe"]), knots=list(d["knots"]),
                          orders=list(d["orders"]),
                          corrector=list(d["corrector"]),
                          variants=list(d["variants"]),
                          prediction=d.get("prediction", "data"),
                          cache_depth=None if cd is None else list(cd),
                          meta=dict(d.get("meta", {})))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @staticmethod
    def load(path: str) -> "SolverPlan":
        with open(path) as f:
            return SolverPlan.from_dict(json.load(f))

    def with_meta(self, **kw) -> "SolverPlan":
        return replace(self, meta={**self.meta, **kw})


# -- plan banks --------------------------------------------------------------


def save_bank(path: str, plans: Dict[str, SolverPlan]) -> None:
    """Serialize a tier-keyed bank of plans ({'fast': plan, ...})."""
    with open(path, "w") as f:
        json.dump({"kind": BANK_KIND, "version": 1,
                   "tiers": {k: p.to_dict() for k, p in plans.items()}},
                  f, indent=1)


def load_bank(path: str) -> Dict[str, SolverPlan]:
    with open(path) as f:
        d = json.load(f)
    if d.get("kind") != BANK_KIND:
        raise ValueError(f"not a plan bank: kind={d.get('kind')!r} "
                         f"(expected {BANK_KIND!r})")
    return {k: SolverPlan.from_dict(v) for k, v in d["tiers"].items()}
