"""The production UniPC sampler: a row loop over the static weight table
(the port of `repro.core.unipc`'s scan path; the python-loop `UniPC`
reference solvers are not ported).

`step_fn_over_rows` executes one table row per sample — a scalar row index
for the whole batch (one iteration of the uniform sampler) or a per-slot
(B,) index (the continuous-batching step). `unipc_sample_scan` is a Python
loop over rows 0..M with a uniform device index, the reference's
`lax.scan`. A row's predictor and corrector are the `unipc_update` row ops,
one kernel launch each.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels.unipc_update import ops as row_ops
from .coeffs import UniPCSchedule, augment_step_rows, build_unipc_schedule


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
                  fused_update: bool = True, dtype=torch.float32):
    """(step, n_rows) over `coeffs.augment_step_rows(sched)` — the init row
    (identity transfer, eval at timesteps[0]) then the M body rows. See
    `step_fn_over_rows` for the step's contract."""
    rows_np = augment_step_rows(sched)
    step = step_fn_over_rows(model_fn, rows_on(rows_np, device, dtype),
                             sign=sched.sign, fused_update=fused_update)
    return step, len(rows_np["t"])


def step_fn_over_rows(model_fn: Callable, tab: dict, *, sign: float,
                      fused_update: bool = True):
    """The per-row step over an explicit row table of device tensors.

    `step((x, E), idx, model_kwargs=None) -> (x, E)`: x is the (B, ...)
    state, E the (K+1, B, ...) eval ring, newest first. `idx` is a scalar
    (every sample runs the same row) or a (B,) tensor (per-slot rows: the
    combine takes per-slot (K+2, B) weight columns and the model sees
    per-sample timesteps and columns). Indices are clipped to the table, so
    idle slots park on the init row, an identity update. Warm-up is data:
    zero-padded weight rows over a zeroed ring. `model_kwargs` are passed to
    the model on top of the table's per-eval `mc_*` columns.

    The table is packed once: its weight columns into the `unipc_update`
    row ops' (n_rows, 7 + 2K) table, the model's columns (`t`, `mc_*`)
    into one more. A row gathers the model's columns with `idx` and runs
    the predictor, the model and the corrector; an index already on the
    device is not copied, so a row makes no host sync.
    `fused_update=False` pins the row ops' plain PyTorch version (the
    reference's inline jnp form), kept for parity runs.
    """
    col_keys = sorted(k for k in tab if k.startswith("mc_"))
    n_rows = tab["t"].shape[0]
    backend = None if fused_update else "plain"
    rows = row_ops.pack_weight_rows(tab)
    model_cols = torch.stack([tab["t"]] + [tab[k] for k in col_keys], dim=1)

    def step(carry, idx, model_kwargs=None):
        x, E = carry
        idx = torch.as_tensor(idx, device=x.device).long()
        cols = model_cols.index_select(
            0, idx.clamp(0, n_rows - 1).reshape(-1)).reshape(idx.shape + (-1,))
        extras = {k[3:]: cols[..., i + 1] for i, k in enumerate(col_keys)}
        if model_kwargs:
            extras = {**extras, **model_kwargs}
        x_pred = row_ops.unipc_row_predict(x, E, rows, idx, sign,
                                           backend=backend)
        e_new = model_fn(x_pred, cols[..., 0], **extras).to(E.dtype)
        # corrector (re-uses e_new; no extra NFE)
        return row_ops.unipc_row_correct(x, E, e_new, x_pred, rows, idx, sign,
                                         backend=backend)

    return step


def run_rows(step: Callable, n_rows: int, x_T: torch.Tensor, *, ring: int,
             dtype=torch.float32, model_kwargs=None) -> torch.Tensor:
    """Rows 0..n_rows-1 of `step` from x_T over a zeroed eval ring of `ring`
    slots; returns the final state. Row j's index is a 0-d view of one
    device arange, so no row copies an index from the host."""
    row_ids = torch.arange(n_rows, device=x_T.device)
    carry = (x_T.to(dtype),
             torch.zeros((ring,) + tuple(x_T.shape), dtype=dtype,
                         device=x_T.device))
    for j in range(n_rows):
        carry = step(carry, row_ids[j], model_kwargs)
    return carry[0]


def unipc_sample_scan(model_fn: Callable, x_T: torch.Tensor,
                      sched: UniPCSchedule, *, fused_update: bool = True,
                      dtype=torch.float32, model_kwargs=None) -> torch.Tensor:
    """Multistep UniPC as a loop over rows 0..M of the augmented table with a
    uniform index (row 0 is the init eval at timesteps[0] over a zeroed
    ring). model_fn(x, t, **cols) -> prediction of `sched.prediction` type;
    `sched.model_cols` entries and `model_kwargs` (per-call conditioning,
    e.g. class ids) are passed to it as keyword arguments. One model eval
    per row; the corrector re-uses it."""
    step, n_rows = unipc_step_fn(model_fn, sched, device=x_T.device,
                                 fused_update=fused_update, dtype=dtype)
    return run_rows(step, n_rows, x_T, ring=sched.w_pred.shape[1] + 1,
                    dtype=dtype, model_kwargs=model_kwargs)
