"""UniPC: the python-loop solvers and the production row-loop sampler (the
port of `repro.core.unipc`).

* `UniPC` — multistep UniPC on the GridSolver loop: any order, custom
  order schedules (Table 4), UniC-oracle (Table 3), both prediction types
  and every B(h) variant. The reference semantics.
* `UniPCSinglestep` — the singlestep variant (Section 3.4).
* the row-loop sampler below, what the engine runs.

`step_fn_over_rows` executes one table row per sample — a scalar row index
for the whole batch (one iteration of the uniform sampler) or a per-slot
(B,) index (the continuous-batching step). `unipc_sample_scan` is a Python
loop over rows 0..M with a uniform device index, the reference's
`lax.scan`. A row's predictor and corrector are the `unipc_update` row ops,
one kernel launch each.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..kernels.unipc_update import ops as row_ops
from .coeffs import (UniPCSchedule, augment_step_rows, build_unipc_schedule,
                     default_order_schedule)
from .solver import CorrectorConfig, Grid, GridSolver, History, unified_step


class UniPC(GridSolver):
    """Multistep UniPC-p (Alg. 5-8). Predictor order = `order`; with the
    corrector enabled the order of accuracy is order+1 (Thm 3.1)."""

    def __init__(
        self,
        model_fn,
        grid: Grid,
        *,
        order: int = 3,
        prediction: str = "data",
        variant: str = "bh2",
        order_schedule: Optional[Sequence[int]] = None,
        lower_order_final: bool = True,
    ):
        super().__init__(model_fn, grid)
        self.order = order
        self.prediction = prediction
        self.variant = variant
        M = len(grid)
        self.order_schedule = (
            list(order_schedule)
            if order_schedule is not None
            else default_order_schedule(M, order, lower_order_final)
        )

    def predict(self, i, x, hist: History):
        g = self.grid
        p_i = min(self.order_schedule[i - 1], i)
        m0 = hist.at_lam(g.lam[i - 1])
        pts = hist.last(p_i - 1, before_lam=float(g.lam[i - 1]))
        points = [(lam, e) for lam, _, e in reversed(pts)]
        return unified_step(
            x, m0, points,
            lam_s=g.lam[i - 1], lam_t=g.lam[i],
            alpha_s=g.alpha[i - 1], alpha_t=g.alpha[i],
            sigma_s=g.sigma[i - 1], sigma_t=g.sigma[i],
            prediction=self.prediction, variant=self.variant,
        )

    def corrector_config(self, **kw) -> CorrectorConfig:
        """UniC matched to this predictor's order/variant."""
        return CorrectorConfig(order=self.order, variant=self.variant, **kw)

    def sample_pc(self, x_T, *, oracle: bool = False, use_corrector: bool = True):
        """Full UniPC = UniP + UniC with per-step order from the schedule."""
        if not use_corrector:
            return self.sample(x_T, corrector=None)
        return self.sample(x_T, corrector=_ScheduledCorrector(self, oracle))


class _ScheduledCorrector(CorrectorConfig):
    """Corrector whose order follows the predictor's per-step order schedule
    (UniC-p_i after UniP-p_i, Alg. 5). GridSolver._correct consults order_at()."""

    def __init__(self, solver: UniPC, oracle: bool):
        super().__init__(order=solver.order, variant=solver.variant, oracle=oracle)
        self._solver = solver

    def order_at(self, i: int) -> int:
        return min(self._solver.order_schedule[i - 1], i)


class UniPCSinglestep(GridSolver):
    """Singlestep UniPC-p (p = 2 or 3): intermediate points at r in (0,1),
    estimated with lower-order unified steps; costs p NFE per grid step."""

    def __init__(self, model_fn, grid: Grid, noise_schedule, *, order: int = 2,
                 prediction: str = "data", variant: str = "bh2"):
        assert order in (2, 3)
        super().__init__(model_fn, grid)
        self.order = order
        self.prediction = prediction
        self.variant = variant
        self.noise_schedule = noise_schedule
        self.r_inner = [0.5] if order == 2 else [1.0 / 3.0, 2.0 / 3.0]

    def predict(self, i, x, hist: History):
        g = self.grid
        lam_s, lam_t = float(g.lam[i - 1]), float(g.lam[i])
        h = lam_t - lam_s
        m0 = hist.at_lam(g.lam[i - 1])
        # walk the intermediate points, each estimated with all points so far
        points = []
        sched = self.noise_schedule
        for r in self.r_inner:
            lam_m = lam_s + r * h
            t_m = float(sched.t_of_lam(lam_m))
            a_m, s_m = float(sched.alpha(t_m)), float(sched.sigma(t_m))
            x_m = unified_step(
                x, m0, points,
                lam_s=lam_s, lam_t=lam_m,
                alpha_s=g.alpha[i - 1], alpha_t=a_m,
                sigma_s=g.sigma[i - 1], sigma_t=s_m,
                prediction=self.prediction, variant=self.variant,
            )
            e_m = self.model(x_m, t_m)
            hist.push(lam_m, t_m, e_m)
            points.append((lam_m, e_m))
        return unified_step(
            x, m0, points,
            lam_s=lam_s, lam_t=lam_t,
            alpha_s=g.alpha[i - 1], alpha_t=g.alpha[i],
            sigma_s=g.sigma[i - 1], sigma_t=g.sigma[i],
            prediction=self.prediction, variant=self.variant,
        )


# ---------------------------------------------------------------------------
# The production path: the row loop over the static weight table
# ---------------------------------------------------------------------------


def make_unipc_schedule(schedule, num_steps, *, order=3, prediction="data",
                        variant="bh2", spacing="logsnr", use_corrector=True,
                        corrector_at_last=False, order_schedule=None,
                        lower_order_final=True) -> UniPCSchedule:
    from ..diffusion.schedules import timestep_grid

    t, lam, alpha, sigma = timestep_grid(schedule, num_steps, spacing)
    return build_unipc_schedule(
        lambdas=lam, alphas=alpha, sigmas=sigma, timesteps=t,
        order=order, prediction=prediction, variant=variant,
        use_corrector=use_corrector, corrector_at_last=corrector_at_last,
        order_schedule=order_schedule, lower_order_final=lower_order_final,
    )


def rows_on(rows_np: dict, device, dtype=torch.float32) -> dict:
    """An augmented (or stacked) numpy row dict as device tensors."""
    return {k: torch.as_tensor(v).to(device=device, dtype=dtype)
            for k, v in rows_np.items()}


def unipc_step_fn(model_fn: Callable, sched: UniPCSchedule, *, device,
                  fused_update: bool = True, dtype=torch.float32,
                  cached: bool = False):
    """(step, n_rows) over `coeffs.augment_step_rows(sched)` — the init row
    (identity transfer, eval at timesteps[0]) then the M body rows. See
    `step_fn_over_rows` for the step's contract."""
    step, _, n_rows = unipc_run_fns(model_fn, sched, device=device,
                                    fused_update=fused_update, dtype=dtype,
                                    cached=cached)
    return step, n_rows


def unipc_run_fns(model_fn: Callable, sched: UniPCSchedule, *, device,
                  fused_update: bool = True, dtype=torch.float32,
                  cached: bool = False):
    """(step, tail, n_rows): `unipc_step_fn`'s step and, over the same
    device table, `tail((x, E, ...), idx) -> x_pred`, the last row's
    predictor alone, for a run that ends there (`run_rows(..., tail=...)`):
    the same row op on the same packed row as the step's, so the run's
    output is bit-equal to stepping every row, with one eval fewer. `tail`
    is None where the last row corrects (`tail_elided`)."""
    rows_np = augment_step_rows(sched)
    rows, model_cols, col_keys = pack_step_rows(rows_on(rows_np, device,
                                                        dtype))
    step = step_fn_over_packed(model_fn, rows, model_cols, col_keys,
                               sign=sched.sign, fused_update=fused_update,
                               cached=cached)
    if not tail_elided(rows_np):
        return step, None, len(rows_np["t"])
    backend = None if fused_update else "plain"

    def tail(carry, idx):
        return row_ops.unipc_row_predict(carry[0], carry[1], rows, idx,
                                         sched.sign, backend=backend)

    return step, tail, len(rows_np["t"])


def deep_rows(rows_np: dict) -> list:
    """Per row of an augmented (or stacked) row dict: whether a cached eval
    of that row runs the deep blocks (every row without a set
    `mc_cache_reuse` flag). The host's copy of the reuse column, which
    decides what a CUDA graph of the row holds."""
    reuse = rows_np.get("mc_cache_reuse")
    n = len(rows_np["t"])
    if reuse is None:
        return [True] * n
    return [bool(r <= 0.5) for r in np.asarray(reuse, np.float64)]


def tail_elided(rows_np: dict) -> bool:
    """Whether a whole-trajectory run of an augmented row dict may end on
    its last row's predictor: that row's corrector is off (no
    `corrector_at_last`), so its output is x_pred + 0 * (x_corr - x_pred)
    and its eval feeds only the ring, which no later row reads."""
    return float(rows_np["use_c"][-1]) == 0.0


def pack_step_rows(tab: dict) -> tuple:
    """(rows, model_cols, col_keys) of an augmented (or stacked) row dict of
    tensors: the weight columns as the `unipc_update` row ops' packed
    (n_rows, 7 + 2K) table, the model's columns — `t`, then the `mc_*`
    columns in `col_keys` order — as one (n_rows, 1 + len(col_keys))
    tensor. Packed on the host, the two are what a runner over static
    buffers copies in to serve another table of the same shape."""
    col_keys = sorted(k for k in tab if k.startswith("mc_"))
    rows = row_ops.pack_weight_rows(tab)
    model_cols = torch.stack([tab["t"]] + [tab[k] for k in col_keys], dim=1)
    return rows, model_cols, col_keys


def step_fn_over_rows(model_fn: Callable, tab: dict, *, sign: float,
                      fused_update: bool = True, cached: bool = False):
    """The per-row step over an explicit row table of device tensors.

    `step((x, E), idx, model_kwargs=None) -> (x, E)`: x is the (B, ...)
    state, E the (K+1, B, ...) eval ring, newest first. `idx` is a scalar
    (every sample runs the same row) or a (B,) tensor (per-slot rows: the
    combine takes per-slot (K+2, B) weight columns and the model sees
    per-sample timesteps and columns). Indices are clipped to the table, so
    idle slots park on the init row, an identity update. Warm-up is data:
    zero-padded weight rows over a zeroed ring. `model_kwargs` are passed to
    the model on top of the table's per-eval `mc_*` columns.

    `cached=True` is the feature-reuse contract (DESIGN.md §12): the carry
    is (x, E, C), C the per-slot deep-feature cache, and
    `model_fn(x, t, cache=C, deep=deep, **cols) -> (pred, C')`. The table's
    `mc_cache_reuse` column reaches the model as `cache_reuse`, gathered per
    slot on the device like every model column; `step(..., deep=False)`
    tells the model that every slot runs a reuse row (see
    `models.dit.dit_apply_cached`).

    The table is packed once (`pack_step_rows`) and the step reads the
    packed tensors (`step_fn_over_packed`). A row gathers the model's
    columns with `idx` and runs the predictor, the model and the corrector;
    an index already on the device is not copied, so a row makes no host
    sync. `fused_update=False` pins the row ops' plain PyTorch version (the
    reference's inline jnp form), kept for parity runs.
    """
    return step_fn_over_packed(model_fn, *pack_step_rows(tab), sign=sign,
                               fused_update=fused_update, cached=cached)


def step_fn_over_packed(model_fn: Callable, rows: torch.Tensor,
                        model_cols: torch.Tensor, col_keys, *, sign: float,
                        fused_update: bool = True, cached: bool = False):
    """`step_fn_over_rows`' step over an already packed table
    (`pack_step_rows`). The step reads `rows` and `model_cols` where they
    lie on every call, so a caller that writes another table of the same
    shape into them in place (the tuner's runner, between CUDA graph
    replays) steps that table next."""
    n_rows = rows.shape[0]
    backend = None if fused_update else "plain"

    def step(carry, idx, model_kwargs=None, deep=True):
        x, E = carry[0], carry[1]
        idx = torch.as_tensor(idx, device=x.device).long()
        cols = model_cols.index_select(
            0, idx.clamp(0, n_rows - 1).reshape(-1)).reshape(idx.shape + (-1,))
        extras = {k[3:]: cols[..., i + 1] for i, k in enumerate(col_keys)}
        if model_kwargs:
            extras = {**extras, **model_kwargs}
        x_pred = row_ops.unipc_row_predict(x, E, rows, idx, sign,
                                           backend=backend)
        if cached:
            e_new, C = model_fn(x_pred, cols[..., 0], cache=carry[2],
                                deep=deep, **extras)
        else:
            e_new = model_fn(x_pred, cols[..., 0], **extras)
        # corrector (re-uses e_new; no extra NFE)
        out = row_ops.unipc_row_correct(x, E, e_new.to(E.dtype), x_pred, rows,
                                        idx, sign, backend=backend)
        return out + (C,) if cached else out

    return step


def run_rows(step: Callable, n_rows: int, x_T: torch.Tensor, *, ring: int,
             dtype=torch.float32, model_kwargs=None, cache0=None,
             deep=None, tail=None) -> torch.Tensor:
    """Rows 0..n_rows-1 of `step` from x_T over a zeroed eval ring of `ring`
    slots; returns the final state. Row j's index is a 0-d view of one
    device arange, so no row copies an index from the host. `cache0` is the
    zeroed deep-feature cache of a cached step (it rides the carry), and
    `deep` its per-row host flags (`deep_rows`; None = every row deep).
    `tail` (`unipc_run_fns`) takes the last row's place: the run returns
    that row's predictor and evaluates nothing there."""
    row_ids = torch.arange(n_rows, device=x_T.device)
    carry = (x_T.to(dtype),
             torch.zeros((ring,) + tuple(x_T.shape), dtype=dtype,
                         device=x_T.device))
    carry += (cache0,) if cache0 is not None else ()
    for j in range(n_rows - (tail is not None)):
        carry = step(carry, row_ids[j], model_kwargs,
                     deep=True if deep is None else deep[j])
    if tail is not None:
        return tail(carry, row_ids[n_rows - 1])
    return carry[0]


def unipc_sample_scan(model_fn: Callable, x_T: torch.Tensor,
                      sched: UniPCSchedule, *, fused_update: bool = True,
                      dtype=torch.float32, model_kwargs=None,
                      cache0=None) -> torch.Tensor:
    """Multistep UniPC as a loop over rows 0..M of the augmented table with a
    uniform index (row 0 is the init eval at timesteps[0] over a zeroed
    ring). model_fn(x, t, **cols) -> prediction of `sched.prediction` type;
    `sched.model_cols` entries and `model_kwargs` (per-call conditioning,
    e.g. class ids) are passed to it as keyword arguments. One model eval
    per row; the corrector re-uses it.

    `cache0` opts into the feature-reuse contract (DESIGN.md §12): the
    zeroed (B, *cache_shape) deep-feature cache and a cached `model_fn`
    ((x, t, cache=..., deep=..., **cols) -> (pred, cache)); the cache rides
    the carry, and a row whose reuse flag is set runs no deep block. Zero
    init is safe because the table's init row is always a full eval."""
    cached = cache0 is not None
    step, n_rows = unipc_step_fn(model_fn, sched, device=x_T.device,
                                 fused_update=fused_update, dtype=dtype,
                                 cached=cached)
    return run_rows(step, n_rows, x_T, ring=sched.w_pred.shape[1] + 1,
                    dtype=dtype, model_kwargs=model_kwargs, cache0=cache0,
                    deep=deep_rows(augment_step_rows(sched)) if cached
                    else None)


def sample_step_fn(sched: UniPCSchedule, fused_update: bool = True):
    """One full UniPC sampling trajectory over `sched`, as a function of
    (model_fn, x_T, **kw): `unipc_sample_scan` with the schedule and the
    update bound (the reference's closure for the dry run's sampling
    workload)."""
    return partial(unipc_sample_scan, sched=sched, fused_update=fused_update)
