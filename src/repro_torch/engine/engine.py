"""SamplerEngine: spec -> weight table -> row-loop sampler, with fused CFG
(the port of `repro.engine.engine`).

    engine = SamplerEngine(schedule, eps=eps_fn,
                           eps_stacked=stacked_fn,    # for cfg_scale != 0
                           eps_uncond=uncond_fn)      # for the loop reference
    x0 = engine.build(EngineSpec(solver="dpmpp", order=3, nfe=10,
                                 cfg_scale=2.0))(x_T)

Every solver of the zoo (`SOLVERS`) compiles to the same row table, so
`build` runs each of them through the one row loop; `build_loop` is the
python-loop reference of the same spec.

`build` is the whole-trajectory path (one uniform batch); `build_step`
compiles the same table into a per-slot `StepProgram`, the continuous-
batching step where every slot gathers its own table row and guidance
scale, and `build_bank` stacks several plans into one such program. CFG
runs as ONE batched network call per row — cond and uncond stacked along
the batch — with the guidance scale and the dynamic-thresholding
percentile riding the table as per-eval columns. Feature reuse (DESIGN.md
§12) wires a cached eps-net (`eps_cached` + `CacheSpec`): the slot state
grows a deep-feature cache, and which rows reuse it is a table column.

The engine runs on the card unless it is asked for the CPU. There,
`jit=True` (the default) captures each run function into CUDA graphs and
replays them (`graphs.py`, the counterpart of the reference's `jax.jit`),
and `donate=True` updates a step program's slot state in place, as the
reference's buffer donation does. `jit=False` runs the eager loop, the
parity path.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.coeffs import (SolverTable, augment_step_rows, eval_cost_rows,
                           stack_step_rows)
from ..core.unipc import (deep_rows, rows_on, run_rows, step_fn_over_rows,
                          unipc_run_fns)
from ..diffusion.guidance import cfg_model, cfg_model_fused, dynamic_threshold
from ..diffusion.process import eps_to_x0
from ..diffusion.schedules import NoiseSchedule
from ..parallel.sharding import shard
from . import graphs
from .compiler import (apply_model_cols, build_loop, compile_table,
                       flag_done, step_guidance_profile)
from .specs import SOLVERS, EngineSpec


def resolve_device(device) -> torch.device:
    """The engine's and the entry points' device: CUDA unless the caller
    asks for the CPU. Raises when CUDA is asked for and there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the port runs on the "
                           "card by default — pass device='cpu' (--device "
                           "cpu) to run the plain PyTorch path on the CPU")
    return device


def _shard_state(state: tuple) -> tuple:
    """The slot state annotated over the batch axis under the active
    sharding rules (the reference's SERVE_RULES path): x (B, ...), the ring
    E (K+1, B, ...), the cache C (B, ...). The identity on one card, and
    pure host code, so a captured step graph launches the same kernels."""
    x, E = state[:2]
    x = shard(x, "batch", *([None] * (x.dim() - 1)))
    E = shard(E, None, "batch", *([None] * (E.dim() - 2)))
    if len(state) == 2:
        return x, E
    C = state[2]
    return x, E, shard(C, "batch", *([None] * (C.dim() - 1)))


@dataclass(frozen=True)
class CacheSpec:
    """Shape contract for the feature-reuse cache (DESIGN.md §12).

    `shape` is the per-sample cache layout ((patch_tokens, d_model) for the
    DiT's deep-feature delta), `block` the static boundary the wired cached
    eps-net was built with (the first `block` of `n_blocks` blocks
    recompute on shallow evals). The engine checks every spec's
    `cache_block` against `block`, as it does `eval_dtype`, so the net-side
    closure and the engine-side state cannot silently disagree.
    """

    shape: Tuple[int, ...]
    block: int
    n_blocks: int
    dtype: str = "float32"

    def zeros(self, slots: int, device="cpu") -> torch.Tensor:
        return torch.zeros((slots,) + tuple(self.shape),
                           dtype=getattr(torch, self.dtype), device=device)


@dataclass
class StepProgram:
    """A per-slot step program — what a serving loop drives.

    step(state, idx[, g, extras]) -> state advances every slot by one table
    row: `state = (x, E)` with x (B, *sample) and E the (K+1, B, *sample)
    eval ring — or `(x, E, C)` for feature-reuse programs, C the (B,
    *cache) deep-feature cache, which lives and is updated with the rest of
    the slot state — `idx` (B,) the per-slot row index (0 = init row; idle slots
    park there), `g` (B,) the per-slot guidance scale (cfg programs only)
    and `extras` per-slot model keyword arguments (class ids). One batched
    model eval per call. A request admitted at tick tau into a zeroed slot
    and stepped through rows 0..n_rows-1 reproduces the uniform `build()`
    run for its own (seed, class, cfg-scale).

    step_flight(state, meta[, g, extras]) -> (state, meta, done) keeps the
    per-slot bookkeeping on the device as `meta`, a (4, B) int32 tensor of
    [row, offset, budget, busy] rows (`init_meta`). The program derives each
    slot's table index from its own counters (`offset + row` while busy,
    the parked init row otherwise), advances them, and returns the coded
    int32 done mask (`compiler.DONE_*`): the tick a busy slot runs its last
    budgeted row, with an on-device finite check of its latent. The host
    never builds an index: it scatters admissions into `meta` and reads the
    done mask back.

    With `donate=True` both steps write the slot state (and the meta) in
    place and return those tensors; the state passed in is consumed.
    `init_state`, `init_meta`, `init_g` and `init_extras` hand out the
    buffers a graphed program replays on (`graphs.StepGraphs`);
    `capture_flight` captures `step_flight`'s graphs without running a
    tick (the reference's ahead-of-time compile).

    A cached program's steps take `deep=` (default True): False replays a
    graph without the deep blocks, right when every slot runs a reuse row
    (`row_reuse`, the host copy of the table's reuse column). The host
    decides it from its own bookkeeping; each slot's select still reads its
    own flag on the device, so a wrong `deep=True` changes no number.
    """

    step: Callable
    n_rows: int          # total table rows (single plan: ticks per request)
    table: SolverTable   # single-plan programs; first tier's table for banks
    spec: EngineSpec
    uses_cfg: bool
    ring: int            # eval-ring slots carried per sample, K + 1
    device: torch.device
    step_flight: Optional[Callable] = None
    # plan banks (`SamplerEngine.build_bank`): tier name -> (row_offset,
    # n_rows) span in the stacked table. None for single-plan programs.
    tiers: Optional[Dict[str, Tuple[int, int]]] = None
    # feature reuse: the cache contract (None for uncached programs), the
    # per-row eval cost (n_rows,) in fractions of a full denoiser eval, and
    # the host copy of the reuse column (n_rows,) bool
    cache: Optional[CacheSpec] = None
    row_cost: Optional[np.ndarray] = None
    row_reuse: Optional[np.ndarray] = None
    capture_flight: Optional[Callable] = None
    # the static buffers and graphs of a program captured on the card
    step_graphs: Optional[graphs.StepGraphs] = None

    def _handout(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return (t if self.step_graphs is None
                else self.step_graphs.handout(name, t))

    def resolve_tier(self, tier: Optional[str]) -> Tuple[int, int]:
        """(row_offset, rows_to_run) for a request's tier tag. Single-plan
        programs take untagged requests only; bank programs require a tag."""
        if self.tiers is None:
            if tier is not None:
                raise ValueError(
                    f"request tagged tier={tier!r} but the step program was "
                    f"compiled from a single plan; build it with "
                    f"SamplerEngine.build_bank")
            return 0, self.n_rows
        if tier is None:
            raise ValueError(f"this program is a plan bank; tag requests "
                             f"with tier= one of {sorted(self.tiers)}")
        if tier not in self.tiers:
            raise ValueError(f"unknown tier {tier!r}; this plan bank serves "
                             f"{sorted(self.tiers)}")
        return self.tiers[tier]

    def span_cost(self, offset: int, n: int) -> float:
        """Total eval cost (full-eval units) of rows offset..offset+n-1 — a
        request's evals-per-latent when (offset, n) is its tier span."""
        if self.row_cost is None:
            return float(n)
        return float(np.sum(self.row_cost[offset:offset + n]))

    def tier_eval_cost(self, tier: Optional[str]) -> float:
        """Evals-per-latent for a tier tag (or the whole single-plan span)."""
        return self.span_cost(*self.resolve_tier(tier))

    def init_state(self, slots: int, sample_shape: Tuple[int, ...],
                   dtype=torch.float32):
        """Zeroed slot state: every slot idle on the init row (and a zeroed
        cache for feature-reuse programs)."""
        shape = tuple(sample_shape)
        state = (self._handout("x", torch.zeros(
                     (slots,) + shape, dtype=dtype, device=self.device)),
                 self._handout("E", torch.zeros(
                     (self.ring, slots) + shape, dtype=dtype,
                     device=self.device)))
        if self.cache is None:
            return state
        return state + (self._handout("C", self.cache.zeros(slots,
                                                             self.device)),)

    def init_extras(self, slots: int, values: dict) -> dict:
        """Per-slot model keyword arguments (class ids): one (slots,) column
        per key, int32 for integer values, float32 otherwise, each a buffer
        a graphed program replays on."""
        out = {}
        for k, v in values.items():
            dt = (torch.int32 if np.issubdtype(np.asarray(v).dtype,
                                               np.integer)
                  else torch.float32)
            out[k] = self._handout(f"extra:{k}", torch.full(
                (slots,), v, dtype=dt, device=self.device))
        return out

    def init_g(self, slots: int) -> torch.Tensor:
        """Per-slot guidance scales, seeded with the spec's nominal scale."""
        return self._handout("g", torch.full(
            (slots,), float(self.spec.cfg_scale or 0.0), dtype=torch.float32,
            device=self.device))

    def init_meta(self, slots: int) -> torch.Tensor:
        """Zeroed slot counters for `step_flight`: a (4, slots) int32 tensor
        of [row, offset, budget, busy] rows on the program's device. Every
        slot starts idle (busy 0, parked on the init row); budget is seeded
        with the whole table so an un-admitted slot never trips the done
        mask."""
        meta = torch.zeros((4, slots), dtype=torch.int32, device=self.device)
        meta[2] = self.n_rows
        return self._handout("meta", meta)


class CountedRun:
    """`SamplerEngine.build`'s run function, `run(x_T, **model_kwargs) ->
    x0`, with a count of the eps-net evaluations its calls have made, eager
    or graphed: `evals` the rows that run the whole network, and under a
    feature-reuse plan `shallow_evals` the rows that reuse the deep
    blocks' cache, each the rows a call evaluates times the calls returned;
    `elided_evals` the last rows a call ends on their predictor alone
    (`core.unipc.unipc_run_fns`), one a call where the table's last
    corrector is off. `counters` are the eps-net's own program counters,
    kept on the device and added to inside the graph
    (`obs.counters.DeviceCounters`, the engine's; None without them): a
    dropless MoE's rows routed to each expert."""

    def __init__(self, fn: Callable, deep_rows: int, shallow_rows: int,
                 elided_rows: int, counters=None):
        self.fn = fn
        self.counters = counters
        self.deep_rows = deep_rows
        self.shallow_rows = shallow_rows
        self.elided_rows = elided_rows
        self.evals = 0
        self.shallow_evals = 0
        self.elided_evals = 0

    def __call__(self, x_T: torch.Tensor, **model_kwargs) -> torch.Tensor:
        x0 = self.fn(x_T, **model_kwargs)
        self.evals += self.deep_rows
        self.shallow_evals += self.shallow_rows
        self.elided_evals += self.elided_rows
        return x0


@dataclass
class SamplerEngine:
    """Sampling engine over one eps-network on one device.

    eps:         (x, t, **extra) -> eps-hat (the cond branch).
    eps_stacked: (xx, t, **extra) -> eps-hat on a 2B batch whose
                 conditioning is [cond; null] — required for cfg_scale != 0.
    eps_uncond:  (x, t) -> eps-hat with null conditioning — only needed for
                 `build_loop`'s guided reference (sequential, two evals a
                 step).
    device:      the card unless "cpu" is asked for (`resolve_device`).
    quant:       "none" or the models.quant tier the wired eps-net's params
                 were quantized for (`launch.sample.build_engine(quant=...)`
                 sets it); `model_fn`, and so `build` and `build_step`,
                 reject specs that disagree.
    eval_dtype:  the precision the wired eps-net computes in
                 (`build_engine(eval_dtype=...)` sets it when it casts the
                 net); `model_fn` rejects specs that disagree, so the
                 net-side cast and the engine-side fp32 boundary cannot
                 silently desynchronize.
    eps_cached:  (x, t, cache, reuse, deep=True, **extra) -> (eps-hat,
                 cache'), the feature-reuse eval, with `cache_spec` its
                 contract (`build_engine(cache_block=...)` wires both);
                 needed by specs with cache_block > 0.
    counters:    the wired eps-net's device counters
                 (`obs.counters.DeviceCounters`), handed to `build`'s runs.
    """

    schedule: NoiseSchedule
    eps: Callable
    eps_stacked: Optional[Callable] = None
    eps_uncond: Optional[Callable] = None
    device: Union[str, torch.device] = "cuda"
    quant: str = "none"
    eval_dtype: str = "float32"
    eps_cached: Optional[Callable] = None
    cache_spec: Optional[CacheSpec] = None
    counters: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def compile(self, spec: EngineSpec,
                table: Optional[SolverTable] = None) -> SolverTable:
        """Compile the spec's weight table (or take `table`, an externally
        lowered one) and attach its per-eval model columns (the guidance
        schedule, the thresholding percentile)."""
        spec = spec.resolve()
        tab = table if table is not None else compile_table(spec,
                                                            self.schedule)
        return apply_model_cols(tab, spec)

    def model_fn(self, spec: EngineSpec, tab: SolverTable) -> Callable:
        """Wrap the eps-net into the table's prediction type, consuming the
        per-eval model columns `g` and `tq`; further keyword arguments
        (per-slot class ids) pass through to the eps-net.

        `spec.eval_dtype` is the network-eval precision boundary (DESIGN.md
        §11): for a reduced precision the state is cast down into the
        eps-net and the prediction back up to fp32, so solver state,
        combine weights and the eps <-> x0 conversion stay fp32."""
        spec = spec.resolve()
        if spec.eval_dtype != self.eval_dtype:
            raise ValueError(
                f"spec.eval_dtype={spec.eval_dtype!r} but this engine's "
                f"eps-net was wired for {self.eval_dtype!r}; pass the same "
                f"eval_dtype to build_engine and the EngineSpec")
        if spec.quant != self.quant:
            raise ValueError(
                f"spec.quant={spec.quant!r} but this engine's eps-net was "
                f"wired for {self.quant!r}; the quantized param tree is "
                f"baked into the net — pass the same quant to build_engine "
                f"and the EngineSpec")
        if spec.cache_block:
            return self._cached_model_fn(spec, tab)
        if "cache_reuse" in (tab.model_cols or {}):
            raise ValueError(
                "this table carries a cache_reuse column (a cached plan) but "
                "spec.cache_block=0; build the engine and spec with the "
                "plan's cache_block so its shallow steps actually reuse the "
                "feature cache instead of silently paying full evals")
        if spec.cfg_scale:
            if self.eps_stacked is None:
                raise ValueError("cfg_scale != 0 needs eps_stacked (a 2B "
                                 "cond+uncond batched eps-net)")
            eps = cfg_model_fused(self.eps_stacked)
        else:
            eps = lambda x, t, g=None, **extra: self.eps(x, t, **extra)
        if spec.eval_dtype != "float32":
            eval_dtype = getattr(torch, spec.eval_dtype)
            inner = eps
            eps = lambda x, t, g=None, **extra: inner(
                x.to(eval_dtype), t, g, **extra).to(torch.float32)
        schedule = self.schedule

        def model(x, t, g=None, tq=None, **extra):
            e = eps(x, t, g, **extra)
            if tab.prediction == "noise":
                return e
            x0 = eps_to_x0(schedule, x, t, e)
            if tq is not None:
                x0 = dynamic_threshold(x0, tq)
            return x0

        return model

    def _cached_model_fn(self, spec: EngineSpec, tab: SolverTable) -> Callable:
        """The feature-reuse model wrapper: (x, t, cache, cache_reuse=...,
        tq=..., deep=True, **extra) -> (prediction, cache'). `cache_reuse`
        arrives from the table's `cache_reuse` column when the plan
        schedules shallow steps; a plain registry table has no such column
        and every eval runs full (reuse 0) — the bit-identity parity
        path."""
        if self.eps_cached is None or self.cache_spec is None:
            raise ValueError(
                f"spec.cache_block={spec.cache_block} but this engine has no "
                f"cached eps-net; wire one with "
                f"build_engine(cache_block={spec.cache_block})")
        if spec.cache_block != self.cache_spec.block:
            raise ValueError(
                f"spec.cache_block={spec.cache_block} but the engine's "
                f"cached eps-net was wired for cache boundary "
                f"{self.cache_spec.block}; the boundary is baked into the "
                f"compiled program — pass the same cache_block to "
                f"build_engine and the EngineSpec")
        eps_cached = self.eps_cached
        if spec.eval_dtype != "float32":
            eval_dtype = getattr(torch, spec.eval_dtype)
            inner = eps_cached

            def eps_cached(x, t, cache, reuse, deep=True, **extra):
                e, c = inner(x.to(eval_dtype), t, cache, reuse, deep=deep,
                             **extra)
                return e.to(torch.float32), c
        schedule = self.schedule

        def model(x, t, cache, cache_reuse=None, tq=None, deep=True,
                  **extra):
            reuse = 0.0 if cache_reuse is None else cache_reuse
            e, cache = eps_cached(x, t, cache, reuse, deep=deep, **extra)
            if tab.prediction == "noise":
                return e, cache
            x0 = eps_to_x0(schedule, x, t, e)
            if tq is not None:
                x0 = dynamic_threshold(x0, tq)
            return x0, cache

        return model

    def build(self, spec: EngineSpec, jit: bool = True,
              table: Optional[SolverTable] = None) -> CountedRun:
        """spec -> run(x_T, **model_kwargs) -> x0, the uniform sampler.
        `model_kwargs` (e.g. class_ids for a per-request-conditioned
        engine) reach the eps-net on every row. The step and its device
        table are built here, once. On the card with `jit`, a run is one
        CUDA graph replay of all its rows (`graphs.graph_run`); otherwise
        it loops over the rows eagerly. Where the table's last corrector is
        off, a run ends on that row's predictor and skips its eval, whose
        result nothing reads: the same output, one eval fewer. `run.evals`
        (and `run.shallow_evals`, `run.elided_evals`) count the
        evaluations its calls made (and skipped)."""
        spec = spec.resolve()
        tab = table if table is not None else self.compile(spec)
        cached = bool(spec.cache_block)
        step, tail, n_rows = unipc_run_fns(self.model_fn(spec, tab), tab,
                                           device=self.device,
                                           fused_update=spec.fused_update,
                                           cached=cached)
        ring = tab.w_pred.shape[1] + 1
        # a cached run carries its cache from a zeroed one; each row holds
        # the deep blocks only where the table's reuse column says a full
        # eval (the host knows every row of a uniform run)
        deep = deep_rows(augment_step_rows(tab)) if cached else None
        cache_spec = self.cache_spec

        def rows(n, x_T, kw):
            cache0 = (cache_spec.zeros(x_T.shape[0], x_T.device) if cached
                      else None)
            # only a call over the whole table ends on the tail: the
            # graph's one-row warm-up evaluates, so it loads every kernel
            return run_rows(step, n, x_T, ring=ring, model_kwargs=kw or None,
                            cache0=cache0, deep=deep,
                            tail=tail if n == n_rows else None)

        def run(x_T, **model_kwargs):
            return rows(n_rows, x_T, model_kwargs)

        elided = int(tail is not None)
        evaluated = (deep if cached else [True] * n_rows)[:n_rows - elided]
        if graphs.graphed(jit, self.device):
            run = graphs.graph_run(
                run, lambda x_T, **kw: rows(1, x_T, kw), self.device)
        return CountedRun(run, sum(evaluated),
                          len(evaluated) - sum(evaluated), elided,
                          counters=self.counters)

    def build_step(self, spec: EngineSpec, jit: bool = True,
                   table: Optional[SolverTable] = None,
                   donate: bool = True) -> StepProgram:
        """spec -> StepProgram: the per-slot step function for continuous
        batching. The same table rows `build` runs uniformly, gathered per
        slot; the guidance scale becomes per-slot state (times the table's
        schedule profile) so every request carries its own cfg scale."""
        spec = spec.resolve()
        tab = table if table is not None else self.compile(spec)
        return self._step_program({"_": (spec, tab)}, tiers=False, jit=jit,
                                  donate=donate)

    def build_bank(self, tier_specs: Dict[str, EngineSpec],
                   tables: Optional[Dict[str, SolverTable]] = None,
                   jit: bool = True, donate: bool = True) -> StepProgram:
        """Compile several plans into ONE servable step program.

        tier_specs: {tier_name: EngineSpec} in serving-priority order; tiers
        may differ in order and NFE budget (and `tables` entries may replace
        the registry compile per tier) but share prediction type, guidance
        scale, `fused_update`, `eval_dtype` and `quant`: one program, one
        model wrapper, one eval ring. The stacked row table
        (`core.coeffs.stack_step_rows`) gives each tier a contiguous row
        span; `StepProgram.tiers` maps tier -> (offset, n_rows)."""
        if not tier_specs:
            raise ValueError("build_bank needs at least one tier spec")
        stray = set(tables or {}) - set(tier_specs)
        if stray:
            raise ValueError(f"tables carry tiers {sorted(stray)} not in "
                             f"tier_specs {sorted(tier_specs)}; a typo'd "
                             f"key would silently serve the untuned "
                             f"registry table")
        items = {}
        for name, tspec in tier_specs.items():
            tspec = tspec.resolve()
            items[name] = (tspec, self.compile(tspec,
                                               table=(tables or {}).get(name)))
        return self._step_program(items, tiers=True, jit=jit, donate=donate)

    def _step_program(self, items, tiers: bool, jit: bool,
                      donate: bool) -> StepProgram:
        """Shared lowering for build_step (single plan) and build_bank."""
        names = list(items)
        spec0, tab0 = items[names[0]]
        uses_cfg = bool(spec0.cfg_scale)
        cached = bool(spec0.cache_block)
        for name, (s, t) in items.items():
            if bool(s.cfg_scale) != uses_cfg or (
                    uses_cfg and float(s.cfg_scale) != float(spec0.cfg_scale)):
                raise ValueError(
                    f"bank tiers must share the nominal guidance scale; tier "
                    f"{name!r} has cfg_scale={s.cfg_scale}, expected "
                    f"{spec0.cfg_scale} (per-request scales stay free)")
            if s.fused_update != spec0.fused_update:
                raise ValueError("bank tiers must agree on fused_update")
            if s.eval_dtype != spec0.eval_dtype:
                raise ValueError("bank tiers must agree on eval_dtype (one "
                                 "compiled program, one model wrapper)")
            if s.quant != spec0.quant:
                raise ValueError(
                    f"bank tiers must agree on quant (one quantized param "
                    f"tree serves the whole program); tier {name!r} has "
                    f"quant={s.quant!r}, expected {spec0.quant!r}")
            if s.cache_block != spec0.cache_block:
                raise ValueError(
                    f"bank tiers must agree on cache_block (the boundary is "
                    f"static in the compiled eps-net); tier {name!r} has "
                    f"cache_block={s.cache_block}, expected "
                    f"{spec0.cache_block}")
            if not cached and "cache_reuse" in (t.model_cols or {}):
                raise ValueError(
                    f"tier {name!r} carries a cached plan (cache_reuse "
                    f"column) but the bank specs have cache_block=0; set "
                    f"cache_block on every tier spec (and the engine) to "
                    f"serve it")
        model = self.model_fn(spec0, tab0)
        profs, step_tabs = [], {}
        for name, (s, t) in items.items():
            if uses_cfg:
                # the absolute g column is replaced by per-slot state x the
                # schedule profile; the core step must not gather it
                profs.append(step_guidance_profile(t, s))
                t = dc_replace(t, model_cols={
                    k: v for k, v in (t.model_cols or {}).items() if k != "g"})
            if cached and "cache_reuse" not in (t.model_cols or {}):
                # a bank may mix cached plans with plain tiers: a tier
                # without a reuse schedule runs every eval full (an all-zero
                # column), keeping the stacked tables' column sets equal
                t = dc_replace(t, model_cols={
                    **(t.model_cols or {}),
                    "cache_reuse": np.zeros(len(t.timesteps))})
            step_tabs[name] = t
        rows_np, spans = stack_step_rows(step_tabs)
        n_rows = len(rows_np["t"])
        dev = self.device
        core_step = step_fn_over_rows(model, rows_on(rows_np, dev),
                                      sign=tab0.sign,
                                      fused_update=spec0.fused_update,
                                      cached=cached)
        row_cost = row_reuse = None
        if cached:
            row_cost = eval_cost_rows(rows_np, cache_block=spec0.cache_block,
                                      n_blocks=self.cache_spec.n_blocks)
            row_reuse = ~np.asarray(deep_rows(rows_np))
        n_state = 3 if cached else 2
        prof = (torch.as_tensor(np.concatenate(profs),
                                dtype=torch.float32).to(dev)
                if uses_cfg else None)
        nominal = float(spec0.cfg_scale or 0.0)

        def apply(state, idx, g, extras, deep):
            kw = dict(extras) if extras else {}
            if uses_cfg:
                gs = (torch.full(idx.shape, nominal, dtype=torch.float32,
                                 device=dev) if g is None else g)
                kw["g"] = gs * prof.index_select(0, idx.clamp(0, n_rows - 1))
            state = core_step(_shard_state(state), idx,
                              model_kwargs=kw or None, deep=deep)
            return _shard_state(state)

        def flight(state, meta, g, extras, deep):
            # the slot's table index comes from its own counters, never
            # from the host
            row, off, budget, busy = meta.unbind(0)
            live = busy > 0
            idx = torch.where(live, off + row, 0).long()
            state = apply(state, idx, g, extras, deep)
            row = row + 1
            done = live & (row >= budget)
            live = live & ~done
            # finished and idle slots park on the init row (idx 0, an
            # identity update) until the readback collects their latent
            meta = torch.stack([torch.where(live, row, 0),
                                torch.where(live, off, 0), budget,
                                live.to(torch.int32)])
            return state, meta, flag_done(done, state[0])

        def inputs(state, lead, g, extras):
            g = (None if g is None or not uses_cfg else
                 torch.as_tensor(g, dtype=torch.float32, device=dev))
            names = ("x", "E", "C")[:n_state]
            return (list(zip(names, state)) + [lead, ("g", g)]
                    + [(f"extra:{k}", v) for k, v in sorted(
                        (extras or {}).items())])

        def split(named):
            extras = {k[6:]: v for k, v in named.items()
                      if k.startswith("extra:")}
            state = tuple(named[k] for k in ("x", "E", "C")[:n_state])
            return state, named.get("g"), extras or None

        # a cached program has two graphs of each step, keyed apart: with
        # the deep blocks and without
        def kind(name, deep):
            return name if deep or not cached else name + "-shallow"

        def step_fn(deep):
            def fn(named):
                state, g, extras = split(named)
                return apply(state, named["idx"], g, extras, deep)
            return fn

        def flight_fn(deep):
            def fn(named):
                state, g, extras = split(named)
                state, meta, done = flight(state, named["meta"], g, extras,
                                           deep)
                return state + (meta, done)
            return fn

        sgraphs = (graphs.StepGraphs(dev, donate)
                   if graphs.graphed(jit, dev) else None)
        runner = sgraphs or graphs.EagerSteps(donate)

        def step(state, idx, g=None, extras=None, deep=True):
            idx = torch.as_tensor(idx, device=dev).long()
            return runner.call(kind("step", deep), step_fn(deep),
                               inputs(state, ("idx", idx), g, extras),
                               n_state)

        def step_flight(state, meta, g=None, extras=None, deep=True):
            *state, meta, done = runner.call(
                kind("flight", deep), flight_fn(deep),
                inputs(state, ("meta", meta), g, extras), n_state + 1)
            return tuple(state), meta, done

        def capture_flight(state, meta, g=None, extras=None):
            for deep in ((True, False) if cached and row_reuse.any()
                         else (True,)):
                runner.capture(kind("flight", deep), flight_fn(deep),
                               inputs(state, ("meta", meta), g, extras),
                               n_state + 1)

        return StepProgram(step=step, step_flight=step_flight, n_rows=n_rows,
                           table=tab0, spec=spec0, uses_cfg=uses_cfg,
                           ring=rows_np["w_pred"].shape[-1] + 1,
                           device=dev, tiers=dict(spans) if tiers else None,
                           cache=self.cache_spec if cached else None,
                           row_cost=row_cost, row_reuse=row_reuse,
                           capture_flight=capture_flight,
                           step_graphs=sgraphs)

    def build_loop(self, spec: EngineSpec) -> Callable:
        """The python-loop GridSolver reference for the same spec: the same
        math on the same grid, sequential CFG (two evals a step), the
        constant guidance schedule only. The returned function exposes
        its solver as `.solver` (`.solver.model.nfe` after a run)."""
        spec = spec.resolve()
        if spec.cfg_scale and spec.cfg_schedule != "constant":
            raise ValueError("loop reference supports constant cfg only")
        eps = self.eps
        if spec.cfg_scale:
            if self.eps_uncond is None:
                raise ValueError("loop reference with cfg needs eps_uncond")
            eps = cfg_model(self.eps, self.eps_uncond, spec.cfg_scale)
        schedule = self.schedule
        if spec.prediction == "noise":
            if spec.thresholding:
                raise ValueError("thresholding needs a data-prediction solver")
            model = eps
        else:
            def model(x, t):
                x0 = eps_to_x0(schedule, x, t, eps(x, t))
                if spec.thresholding:
                    x0 = dynamic_threshold(x0, spec.threshold_percentile)
                return x0
        return build_loop(spec, self.schedule, model)

    @staticmethod
    def solvers():
        """Registered solver names (the --solver choices)."""
        return sorted(SOLVERS)
