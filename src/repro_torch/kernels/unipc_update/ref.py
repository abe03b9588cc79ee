"""Plain PyTorch versions of the fused UniPC update: the weighted combine,
and the predictor and corrector of one sampler row over a packed row
table, composed of torch ops and the plain combine as the reference's row
(`repro/core/unipc.py:step_fn_over_rows`) composes them."""

import torch

# the packed row table's columns (csrc/unipc_update.cu: RowColumn), then
# w_pred's K columns, then w_corr_prev's K
ROW_FIXED = ("base_x", "base_m0", "base_x_c", "base_m0_c", "use_c",
             "out_scale", "w_corr_new")


def weighted_combine(terms: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """terms: (K, *shape); weights: (K,) or per-slot (K, B). Returns
    sum_k w_k * terms[k] as an fp32 axpy chain in the kernel's order (per
    batch row for per-slot weights), cast to the terms' dtype."""
    w = weights.to(torch.float32)
    if w.ndim == 2:  # (K, B) per-slot columns over (K, B, ...) terms
        w = w.reshape(w.shape + (1,) * (terms.ndim - w.ndim))
    acc = w[0] * terms[0].to(torch.float32)
    for k in range(1, terms.shape[0]):
        acc = acc + w[k] * terms[k].to(torch.float32)
    return acc.to(terms.dtype)


def pack_weight_rows(tab: dict) -> torch.Tensor:
    """The weight columns of a step table (`coeffs.augment_step_rows` on the
    device) as one (n_rows, 7 + 2K) tensor in the table's dtype: ROW_FIXED,
    then w_pred's K columns, then w_corr_prev's."""
    return torch.cat([tab[k][:, None] for k in ROW_FIXED]
                     + [tab["w_pred"], tab["w_corr_prev"]], dim=1)


def _gather_row(rows: torch.Tensor, idx) -> tuple:
    """({column: value}, per_slot) of row `idx` of a packed table, clipped to
    it: scalar columns 0-d (or (B,) per slot), w_pred and w_corr_prev (K,)
    (or (B, K))."""
    n_rows, cols = rows.shape
    K = (cols - len(ROW_FIXED)) // 2
    idx = torch.as_tensor(idx, device=rows.device).long().clamp(0, n_rows - 1)
    r = rows.index_select(0, idx.reshape(-1)).reshape(idx.shape + (cols,))
    row = {k: r[..., i] for i, k in enumerate(ROW_FIXED)}
    row["w_pred"] = r[..., len(ROW_FIXED):len(ROW_FIXED) + K]
    row["w_corr_prev"] = r[..., len(ROW_FIXED) + K:]
    return row, idx.ndim == 1


def _wstack(row, per_slot, sign, base_x, base_m0, w_prev, w_new=None):
    # scalar rows: (K,) weights; per-slot rows: (B, K) -> (K, B)
    scale = row["out_scale"][..., None] if per_slot else row["out_scale"]
    parts = [base_x[None], base_m0[None],
             torch.movedim(sign * scale * w_prev, -1, 0)]
    if w_new is not None:
        parts.append((sign * row["out_scale"] * w_new)[None])
    return torch.cat(parts, dim=0)


def _terms(x, E):
    m0 = E[0]
    diffs = E[1:] - m0[None]
    return torch.cat([x[None], m0[None], diffs], dim=0), m0


def unipc_row_predict(x: torch.Tensor, E: torch.Tensor, rows: torch.Tensor,
                      idx, sign: float) -> torch.Tensor:
    """x_pred of row `idx`: the combine of [x, m0, E[1:] - m0] (m0 = E[0])
    with [base_x, base_m0, sign * out_scale * w_pred]. x: (B, ...) state, E:
    (K + 1, B, ...) eval ring, newest first; rows: the packed table; idx: a
    scalar or per-slot (B,) row index."""
    row, per_slot = _gather_row(rows, idx)
    terms, _ = _terms(x, E)
    return weighted_combine(terms, _wstack(row, per_slot, sign, row["base_x"],
                                           row["base_m0"], row["w_pred"]))


def unipc_row_correct(x: torch.Tensor, E: torch.Tensor, e_new: torch.Tensor,
                      x_pred: torch.Tensor, rows: torch.Tensor, idx,
                      sign: float) -> tuple:
    """(x_next, E_next) of row `idx`: x_corr combines the predictor's terms
    and d_new = e_new - m0 with [base_x_c, base_m0_c, sign * out_scale *
    w_corr_prev, sign * out_scale * w_corr_new]; x_next = x_pred + use_c *
    (x_corr - x_pred); E_next = [e_new, E[:-1]], a new tensor."""
    row, per_slot = _gather_row(rows, idx)
    terms, m0 = _terms(x, E)
    d_new = e_new - m0
    terms_c = torch.cat([terms, d_new[None]], dim=0)
    x_corr = weighted_combine(terms_c, _wstack(
        row, per_slot, sign, row["base_x_c"], row["base_m0_c"],
        row["w_corr_prev"], row["w_corr_new"]))
    use_c = (row["use_c"].reshape((-1,) + (1,) * (x.ndim - 1))
             if per_slot else row["use_c"])
    x_next = x_pred + use_c * (x_corr - x_pred)
    E_next = torch.cat([e_new[None], E[:-1]], dim=0)
    return x_next, E_next
