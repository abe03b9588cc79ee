"""The production UniPC sampler: a row loop over the static weight table
(the port of `repro.core.unipc`'s scan path; the python-loop `UniPC`
reference solvers are not ported).

`step_fn_over_rows` executes one table row per sample — a scalar row index
for the whole batch (one iteration of the uniform sampler) or a per-slot
(B,) index (the continuous-batching step). `unipc_sample_scan` is a Python
loop over rows 0..M with a uniform index, the reference's `lax.scan`.
Both combines of a row go through the `unipc_update` kernel op.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels.unipc_update import ops as combine_ops
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

    `fused_update=False` pins the combine's plain PyTorch version (the
    reference's inline jnp form), kept for parity runs.
    """
    col_keys = sorted(k for k in tab if k.startswith("mc_"))
    n_rows = tab["t"].shape[0]
    backend = None if fused_update else "plain"

    def combine(terms, weights):
        return combine_ops.weighted_combine(terms, weights, backend=backend)

    def step(carry, idx, model_kwargs=None):
        x, E = carry
        idx = torch.as_tensor(idx, device=x.device).long().clamp(0, n_rows - 1)
        per_slot = idx.ndim == 1
        row = {k: v[idx] for k, v in tab.items()}

        def wstack(base_x, base_m0, w_prev, w_new=None):
            # scalar rows: (K,) weights; per-slot rows: (B, K) -> (K, B)
            scale = row["out_scale"][..., None] if per_slot else row["out_scale"]
            parts = [base_x[None], base_m0[None],
                     torch.movedim(sign * scale * w_prev, -1, 0)]
            if w_new is not None:
                parts.append((sign * row["out_scale"] * w_new)[None])
            return torch.cat(parts, dim=0)

        m0 = E[0]
        diffs = E[1:] - m0[None]
        extras = {k[3:]: row[k] for k in col_keys}
        if model_kwargs:
            extras = {**extras, **model_kwargs}
        # predictor
        terms = torch.cat([x[None], m0[None], diffs], dim=0)
        x_pred = combine(terms, wstack(row["base_x"], row["base_m0"],
                                       row["w_pred"]))
        e_new = model_fn(x_pred, row["t"], **extras).to(E.dtype)
        # corrector (re-uses e_new; no extra NFE)
        d_new = e_new - m0
        terms_c = torch.cat([terms, d_new[None]], dim=0)
        x_corr = combine(terms_c, wstack(row["base_x_c"], row["base_m0_c"],
                                         row["w_corr_prev"], row["w_corr_new"]))
        use_c = (row["use_c"].reshape((-1,) + (1,) * (x.ndim - 1))
                 if per_slot else row["use_c"])
        x_next = x_pred + use_c * (x_corr - x_pred)
        E_next = torch.cat([e_new[None], E[:-1]], dim=0)
        return x_next, E_next

    return step


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
    K = sched.w_pred.shape[1]
    carry = (x_T.to(dtype),
             torch.zeros((K + 1,) + tuple(x_T.shape), dtype=dtype,
                         device=x_T.device))
    for j in range(n_rows):
        carry = step(carry, j, model_kwargs)
    return carry[0]
