"""Plan search: coordinate descent with a beam over the decision space (the
port's copy of `repro.tuning.search`; numpy only).

The space is small but mixed (continuous knots x discrete orders /
corrector mask / B(h) variants) and the objective is cheap-but-not-free (one
compiled trajectory per candidate), which is exactly the regime where
gradient-free coordinate moves win: sweep the per-step coordinates in a
fixed deterministic order, propose every alternative value for discrete
coordinates and a few relative shifts for knots, score candidates, and keep
the top-`beam` plans as the frontier for the next coordinate. Rounds repeat
the sweep from the improved frontier; the search stops on budget exhaustion
or a sweep with no accepted improvement.

Everything is deterministic given the config — no RNG — so a tuned plan is
reproducible from (model, probe seed, SearchConfig) alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

import numpy as np

from .objective import PlanObjective
from .plans import MAX_ORDER, SEARCH_VARIANTS, SolverPlan


@dataclass
class SearchConfig:
    budget: int = 80          # max objective evaluations (incl. the init)
    beam: int = 2             # frontier width
    rounds: int = 3           # max coordinate sweeps
    knot_fracs: Tuple[float, ...] = (0.25, 0.5)   # +- fraction of the
                              # neighbor gap proposed per knot move
    search_orders: bool = True
    search_corrector: bool = True
    search_variants: bool = True
    search_knots: bool = True
    knot_margin: float = 0.05  # keep u_i at least this fraction of the gap
                               # away from its neighbors (monotonicity)


@dataclass
class SearchResult:
    plan: SolverPlan          # the winner (meta carries the scores)
    score: float
    baseline: float           # score of the initial plan
    evals: int
    history: List[Tuple[float, str]] = field(default_factory=list)
    # (score, move) per accepted improvement, in order


def _knot_moves(plan: SolverPlan, i: int, cfg: SearchConfig):
    """Candidate positions for interior knot i (0-based into plan.knots)."""
    u = np.concatenate([[0.0], np.asarray(plan.knots, np.float64), [1.0]])
    j = i + 1                           # index into the padded grid
    lo, hi = u[j - 1], u[j + 1]
    out = []
    for frac in cfg.knot_fracs:
        for sgn in (-1.0, 1.0):
            cand = u[j] + sgn * frac * (hi - lo) / 2.0
            lo_m = lo + cfg.knot_margin * (hi - lo)
            hi_m = hi - cfg.knot_margin * (hi - lo)
            cand = float(np.clip(cand, lo_m, hi_m))
            if abs(cand - u[j]) > 1e-12:
                out.append(cand)
    return sorted(set(out))


def _canonical_key(plan: SolverPlan) -> str:
    """Dedup key on the plan's *lowered* decision content: orders are
    clamped by the warm-up rule min(p_i, i) exactly as at table build, so
    decision vectors that compile to the same table share one beam slot."""
    d = plan.to_dict()
    d["orders"] = [min(o, i + 1) for i, o in enumerate(d["orders"])]
    d.pop("meta", None)
    return repr(d)


def _mutations(plan: SolverPlan, coord: Tuple[str, int], cfg: SearchConfig):
    """All candidate plans differing from `plan` at one coordinate. Order
    candidates that the warm-up clamp maps onto the current effective order
    are skipped — they'd lower to a bit-identical table and waste evals."""
    kind, i = coord
    out = []
    if kind == "order":
        eff = min(plan.orders[i], i + 1)
        for o in range(1, MAX_ORDER + 1):
            if o != plan.orders[i] and min(o, i + 1) != eff:
                orders = list(plan.orders)
                orders[i] = o
                out.append((replace(plan, orders=orders),
                            f"order[{i}]={o}"))
    elif kind == "corr":
        corr = list(plan.corrector)
        corr[i] = not corr[i]
        out.append((replace(plan, corrector=corr),
                    f"corr[{i}]={int(corr[i])}"))
    elif kind == "variant":
        for v in SEARCH_VARIANTS:
            if v != plan.variants[i]:
                var = list(plan.variants)
                var[i] = v
                out.append((replace(plan, variants=var),
                            f"variant[{i}]={v}"))
    elif kind == "knot":
        for cand in _knot_moves(plan, i, cfg):
            knots = list(plan.knots)
            knots[i] = cand
            out.append((replace(plan, knots=knots),
                        f"knot[{i}]={cand:.4f}"))
    return out


def _coordinates(plan: SolverPlan, cfg: SearchConfig):
    """Deterministic sweep order: decisions with the coarsest effect first
    (orders), then corrector mask, knots, variants — per step, early steps
    first (where few-step error is born)."""
    M = plan.nfe
    coords = []
    if cfg.search_orders:
        coords += [("order", i) for i in range(M)]
    if cfg.search_corrector:
        coords += [("corr", i) for i in range(M)]
    if cfg.search_knots:
        coords += [("knot", i) for i in range(M - 1)]
    if cfg.search_variants:
        coords += [("variant", i) for i in range(M)]
    return coords


def tune_plan(objective: PlanObjective, noise_schedule,
              init: SolverPlan, config: Optional[SearchConfig] = None,
              verbose: bool = False) -> SearchResult:
    """Coordinate-descent + beam search from `init` (usually the hand-set
    UniPC baseline via `SolverPlan.from_spec`). Scores never regress: the
    returned plan is the best scored candidate, which is `init` itself if no
    mutation improved on it."""
    cfg = config or SearchConfig()
    evals_left = cfg.budget
    # the objective is deterministic, so already-scored candidates (same
    # lowered table — the beam-dedup key) are memo hits costing no budget
    memo = {}

    def score(p: SolverPlan) -> float:
        nonlocal evals_left
        k = _canonical_key(p)
        if k not in memo:
            evals_left -= 1
            memo[k] = objective(p, noise_schedule)
        return memo[k]

    d0 = score(init)
    beam: List[Tuple[float, SolverPlan]] = [(d0, init)]
    history: List[Tuple[float, str]] = [(d0, "init")]
    for rnd in range(cfg.rounds):
        improved = False
        for coord in _coordinates(init, cfg):
            pool = list(beam)
            for base_score, base in beam:
                for cand, move in _mutations(base, coord, cfg):
                    if evals_left <= 0:
                        break
                    d = score(cand)
                    pool.append((d, cand))
                    if d < beam[0][0]:
                        improved = True
                        history.append((d, move))
                        if verbose:
                            print(f"  round {rnd} {move}: "
                                  f"{beam[0][0]:.5f} -> {d:.5f}")
                if evals_left <= 0:
                    break
            # keep the top-`beam` distinct plans (stable under score ties;
            # distinct = distinct lowered tables, not decision vectors)
            pool.sort(key=lambda sp: sp[0])
            seen, kept = set(), []
            for d, p in pool:
                k = _canonical_key(p)
                if k not in seen:
                    seen.add(k)
                    kept.append((d, p))
                if len(kept) == cfg.beam:
                    break
            beam = kept
            if evals_left <= 0:
                break
        if evals_left <= 0 or not improved:
            break
    best_score, best = beam[0]
    best = best.with_meta(objective=best_score, baseline=d0,
                          evals=cfg.budget - evals_left,
                          beam=cfg.beam, rounds=cfg.rounds)
    return SearchResult(plan=best, score=best_score, baseline=d0,
                        evals=cfg.budget - evals_left, history=history)


@dataclass
class CachedSearchResult:
    """A jointly tuned (solver schedule, cache schedule) plan plus the
    no-cache anchor it is constrained against."""

    plan: SolverPlan            # the cached winner (cache_depth set)
    score: float                # its trajectory discrepancy
    uncached_plan: SolverPlan   # the phase-1 winner with every eval full
    uncached_score: float       # the no-cache tuned discrepancy (the anchor)
    evals: int
    history: List[Tuple[float, str]] = field(default_factory=list)


def tune_cached_plan(objective: PlanObjective, noise_schedule,
                     init: SolverPlan, config: Optional[SearchConfig] = None,
                     *, cache_block: int, slack: float = 1.1,
                     verbose: bool = False) -> CachedSearchResult:
    """Joint solver + cache-schedule search (DESIGN.md §12).

    The cache axis cannot ride the plain score-descent acceptance rule:
    a shallow eval never *improves* trajectory discrepancy, it buys eval
    cost — so pure descent would keep (or revert to) the all-full schedule.
    The search therefore runs the cache coordinate under a constrained
    acceptance: flips to shallow are kept while the score stays within
    `slack` x the no-cache tuned anchor, and each round keeps the flip that
    degrades the score least (greedy coordinate descent on the cache mask).

    Phases, all through the objective's one cached runner:
      1. `tune_plan` over the solver axes with an all-full cache column —
         the no-cache anchor the acceptance constraint (and `guard.py`'s
         1.1x gate) measures against.
      2. Greedy shallow flips at boundary `cache_block` under the slack
         constraint, until no step can be flipped without breaching it.
      3. A final solver-axis sweep from the cached plan (`rounds=1`): the
         solver schedule re-adapts to the cheaper eval trace. Scores never
         regress in `tune_plan`, so the constraint survives phase 3.

    `objective` must wrap a cache-wired engine (`make_objective` over a
    `build_engine(cache_block=...)` engine); `init` is the usual hand-set
    baseline plan.
    """
    if cache_block < 1:
        raise ValueError(f"tune_cached_plan needs cache_block >= 1, "
                         f"got {cache_block}")
    if not objective.cached:
        raise ValueError("objective is not cache-wired; build it from an "
                         "engine constructed with build_engine(cache_block=...)")
    cfg = config or SearchConfig()
    M = init.nfe
    # phase 1 — solver axes, all evals full. The zero cache column keeps
    # every candidate on the cached runner's one table shape.
    base = tune_plan(objective, noise_schedule,
                     replace(init, cache_depth=[0] * M), cfg, verbose=verbose)
    anchor_plan, anchor = base.plan, base.score
    plan, score, evals = anchor_plan, anchor, base.evals
    history = list(base.history)
    # phase 2 — greedy constrained flips on the cache mask
    while True:
        best_flip = None
        for i in range(M):
            if plan.cache_depth[i]:
                continue
            cd = list(plan.cache_depth)
            cd[i] = cache_block
            d = objective(replace(plan, cache_depth=cd), noise_schedule)
            evals += 1
            if d <= slack * anchor and (best_flip is None
                                        or d < best_flip[0]):
                best_flip = (d, i, cd)
        if best_flip is None:
            break
        score, i, cd = best_flip
        plan = replace(plan, cache_depth=cd)
        history.append((score, f"cache[{i}]={cache_block}"))
        if verbose:
            print(f"  cache[{i}]={cache_block}: {score:.5f} "
                  f"(anchor {anchor:.5f}, slack {slack})")
    # phase 3 — let the solver schedule re-adapt to the cache schedule
    if any(plan.cache_depth):
        polish = tune_plan(objective, noise_schedule, plan,
                           replace(cfg, rounds=1), verbose=verbose)
        plan, score = polish.plan, polish.score
        evals += polish.evals
        history += polish.history[1:]
    plan = plan.with_meta(objective=score, cache_anchor=anchor,
                          cache_block=cache_block, cache_slack=slack,
                          evals=evals)
    return CachedSearchResult(plan=plan, score=score,
                              uncached_plan=anchor_plan,
                              uncached_score=anchor, evals=evals,
                              history=history)
