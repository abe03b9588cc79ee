"""UniPC coefficient computation (host-side, float64).

Everything here depends only on the timestep grid (through lambda = log(alpha/sigma))
and the solver hyper-parameters — never on data. We therefore compute all
coefficients in numpy float64 at schedule-build time and feed the sampling
sampler a static per-step coefficient table. This is numerically safer (the
phi/psi recursions cancel catastrophically in float32) and keeps tiny linear
solves and host syncs out of the device loop. The module is a copy of
`repro.core.coeffs` (numpy only), held bit-equal to it by the tests.

Unified weight convention
-------------------------
Every solver update in this repo is expressed as

    noise pred: x_t = (a_t/a_s) x_s - s_t (e^h - 1) m0 - s_t * sum_m w_m D_m
    data  pred: x_t = (s_t/s_s) x_s + a_t (1 - e^{-h}) m0 + a_t * sum_m w_m D_m

with D_m = model(point_m) - m0.  For UniPC, w_m = B(h) * a_m / r_m where
a = R^{-1} phi / B (Thm 3.1); for UniPC_v, w_m = (sum_n h varphi_{n+1}(h) A[n,m]) / r_m
with A = C_p^{-1} (App. C). Both reduce to a single per-difference weight vector,
which is what `unipc_weights` returns.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .phi import varphi, psi

BH_VARIANTS = ("bh1", "bh2", "vary")
PREDICTION_TYPES = ("noise", "data")


def semilinear_coeffs(h: float, alpha_s: float, alpha_t: float,
                      sigma_s: float, sigma_t: float, prediction: str):
    """(base_x, base_m0) of the order-1 semilinear (DDIM) transfer — the base
    every unified update (and UniC corrector row) is built on."""
    if prediction == "noise":
        return alpha_t / alpha_s, -sigma_t * math.expm1(h)
    return sigma_t / sigma_s, alpha_t * (-math.expm1(-h))


def bh_value(h: float, variant: str, prediction: str) -> float:
    """B(h), sign-normalized so B(h) = h + O(h^2) for BOTH prediction types.

    The official implementation works in hh = -h for data prediction with a
    matching sign flip in its rhs vector; our rhs (`_rhs_vector`, psi on +h)
    keeps the +h convention, so B must too — for exact solves the sign cancels
    anyway, but the degenerate a_1 = 0.5 shortcut (App. F) depends on it.
    B1(h) = h; B2(h) = e^h - 1 (noise) / 1 - e^{-h} (data)."""
    if variant == "bh1":
        return h
    if variant == "bh2":
        return math.expm1(h) if prediction == "noise" else -math.expm1(-h)
    raise ValueError(f"no explicit B(h) for variant {variant!r}")


def _rhs_vector(q: int, h: float, prediction: str) -> np.ndarray:
    """b_n = h * n! * varphi_{n+1}(h)  (noise)  or  h * n! * psi_{n+1}(h)  (data),
    i.e. phi_n / h^{n-1}: we divide row n of R_p(h) by h^{n-1} so the Vandermonde
    system is in powers of r alone (better conditioned, h-free matrix)."""
    fn = varphi if prediction == "noise" else psi
    return np.array(
        [h * math.factorial(n) * float(fn(n + 1, h)) for n in range(1, q + 1)],
        dtype=np.float64,
    )


def unipc_weights(r: np.ndarray, h: float, variant: str, prediction: str,
                  degenerate_a1: bool = True) -> np.ndarray:
    """Per-difference weights w_m (length len(r)) for the unified update.

    r: the relative log-SNR offsets r_m = (lambda_{s_m} - lambda_{t_{i-1}})/h_i,
       all distinct and nonzero (negative for previous points, 1 for the
       corrector's current point).

    degenerate_a1: for the single-point systems (UniP-2 / UniC-1) the paper
    (App. F) and the official implementation use the fixed solution a_1 = 0.5
    instead of the exact solve. This is what makes B_1(h) and B_2(h)
    *empirically distinguishable* (Table 1): with exact solves, B(h) cancels —
    w = B * R^{-1}(phi/B) = R^{-1} phi — and all variants coincide.
    """
    r = np.asarray(r, dtype=np.float64)
    q = len(r)
    if q == 0:
        return np.zeros((0,), dtype=np.float64)
    if q == 1 and degenerate_a1 and variant != "vary":
        return np.array([0.5 * bh_value(h, variant, prediction)]) / r
    R = np.vander(r, N=q, increasing=True).T  # R[n-1, m] = r_m^{n-1}
    if variant == "vary":
        # UniPC_v (App. C): per-point weights w solve C_p w = h*varphi_{n+1}(h)
        # with C[n-1, m] = r_m^{n-1} / n!  (A_p = C_p^{-1} is h-independent).
        fn = varphi if prediction == "noise" else psi
        C = R / np.array([[math.factorial(n)] for n in range(1, q + 1)])
        hphi = np.array([h * float(fn(n + 1, h)) for n in range(1, q + 1)])
        w = np.linalg.solve(C, hphi)
    else:
        b = _rhs_vector(q, h, prediction)
        B = bh_value(h, variant, prediction)
        a = np.linalg.solve(R, b / B)
        w = B * a
    return w / r


def default_order_schedule(num_steps: int, order: int, lower_order_final: bool = True):
    """Predictor order p_i per step (1-indexed steps i=1..M), as in Alg. 5/7
    (warm-up p_i = min(p, i)) with the DPM-Solver++ style lower-order-final."""
    orders = []
    for i in range(1, num_steps + 1):
        p_i = min(order, i)
        if lower_order_final:
            p_i = min(p_i, num_steps - i + 1)
        orders.append(max(1, p_i))
    return orders


@dataclass
class UniPCSchedule:
    """Static per-step weight table consumed by the scan-based sampler.

    Despite the name this is the *solver-agnostic* table format: every
    multistep solver in the zoo (and the singlestep ones, on an expanded grid)
    compiles to rows of this table — see `repro.engine`. UniPC is simply the
    solver whose rows `build_unipc_schedule` emits.

    All arrays are float64 numpy; the sampler casts once. M = number of steps.
    The difference-weight width K = w_pred.shape[1] (order-1 for UniPC; the
    sampler derives its eval-ring size from it, not from `order`).
    """

    lambdas: np.ndarray           # (M+1,) half log-SNR at t_0..t_M
    alphas: np.ndarray            # (M+1,)
    sigmas: np.ndarray            # (M+1,)
    order: int
    prediction: str
    variant: str
    # per-step (M,) / (M, K) / (M,) tables:
    base_x: np.ndarray = field(default=None)       # coeff on x_{i-1}
    base_m0: np.ndarray = field(default=None)      # coeff on m0
    w_pred: np.ndarray = field(default=None)       # (M, K) predictor diff weights (0-padded)
    w_corr_prev: np.ndarray = field(default=None)  # (M, K) corrector prev-diff weights
    w_corr_new: np.ndarray = field(default=None)   # (M,) corrector current-diff weight
    use_corrector: np.ndarray = field(default=None)  # (M,) 0/1
    out_scale: np.ndarray = field(default=None)    # sigma_t (noise) / alpha_t (data) per step
    sign: float = field(default=None)              # -1 noise, +1 data
    timesteps: np.ndarray = field(default=None)    # (M+1,) t grid (for the model)
    orders: list = field(default=None)
    # corrector base coefficients: UniC is always the *semilinear* base plus
    # difference terms, which coincides with the predictor's base for UniPC /
    # DDIM / DPM-Solver++ but not for e.g. DEIS (whose predictor folds the
    # quadrature weights into base_m0). None -> same as base_x / base_m0.
    base_x_corr: np.ndarray = field(default=None)  # (M,)
    base_m0_corr: np.ndarray = field(default=None)  # (M,)
    # per-eval model columns: {name: (M+1,) array} fed to model_fn as keyword
    # arguments (row 0 at the initial eval, row i at step i's eval). Used by
    # the engine for guidance-scale schedules and thresholding percentiles.
    model_cols: dict = field(default=None)


# The engine refers to the table by its role, not by the solver that named it.
SolverTable = UniPCSchedule


def augment_step_rows(sched: UniPCSchedule) -> dict:
    """The row-gatherable step table: one numpy float64 array per column, each
    with M+1 rows indexable by a per-slot step index.

    Row 0 is the *init row* — an identity transfer (base_x = 1, every other
    weight 0, corrector off) whose model eval lands at timesteps[0]. A slot
    whose ring buffer has been zeroed and which executes rows 0, 1, ..., M on
    consecutive ticks reproduces the uniform scan exactly: the init row pushes
    e_0 into the ring, and the zero-padded weight rows of the early body rows
    null the still-empty ring slots, so a freshly admitted slot warms up at
    low effective order as data, never as shape (DESIGN.md §2, §9).

    Model columns (guidance scale, thresholding percentile) keep their native
    (M+1,) per-eval layout — row i is the column value at eval i.
    """
    base_x_c = sched.base_x_corr if sched.base_x_corr is not None else sched.base_x
    base_m0_c = sched.base_m0_corr if sched.base_m0_corr is not None else sched.base_m0

    def aug(v, head):
        v = np.asarray(v, np.float64)
        head_row = np.full((1,) + v.shape[1:], head, np.float64)
        return np.concatenate([head_row, v], axis=0)

    rows = dict(
        base_x=aug(sched.base_x, 1.0), base_m0=aug(sched.base_m0, 0.0),
        base_x_c=aug(base_x_c, 1.0), base_m0_c=aug(base_m0_c, 0.0),
        w_pred=aug(sched.w_pred, 0.0), w_corr_prev=aug(sched.w_corr_prev, 0.0),
        w_corr_new=aug(sched.w_corr_new, 0.0),
        use_c=aug(sched.use_corrector, 0.0), out_scale=aug(sched.out_scale, 0.0),
        t=np.asarray(sched.timesteps, np.float64),
    )
    for k, v in (sched.model_cols or {}).items():
        rows[f"mc_{k}"] = np.asarray(v, np.float64)
    return rows


def eval_cost_rows(rows: dict, *, cache_block: int = 0,
                   n_blocks: int = 0) -> np.ndarray:
    """Per-row model-eval cost as a fraction of one full denoiser eval.

    `rows` is an augmented (or stacked) step-row dict. Without feature reuse
    every row costs 1.0 — the NFE floor. With a cache boundary, rows whose
    `mc_cache_reuse` column is set run only the first `cache_block` of
    `n_blocks` DiT blocks, so they cost cache_block / n_blocks. (The patch
    embed, conditioning MLP and final layer run on every eval and are
    excluded from the fraction — the accounting is per block, DESIGN.md
    §12.) Summing a request's row span gives its evals-per-latent.
    """
    n = len(rows["t"])
    cost = np.ones(n, np.float64)
    if cache_block and n_blocks and "mc_cache_reuse" in rows:
        reuse = np.asarray(rows["mc_cache_reuse"], np.float64)
        cost = np.where(reuse > 0.5, cache_block / n_blocks, 1.0)
    return cost


def stack_step_rows(tables: dict) -> tuple:
    """Concatenate several tables' augmented step rows into one plan bank.

    tables: {tier_name: UniPCSchedule}, iterated in insertion order. Returns
    (rows, tiers) where `rows` is one row-gatherable dict exactly like
    `augment_step_rows` emits — every tier's init row + body rows stacked
    along axis 0, difference-weight columns zero-padded to the widest tier —
    and `tiers` maps tier name to its (row_offset, n_rows) span. A slot that
    executes rows offset..offset+n_rows-1 runs that tier's trajectory; row 0
    (the first tier's init row) stays the identity parking row for idle
    slots.

    Every table must share prediction type, sign, and model-column keys (the
    step function closes over one sign and gathers one column set); mixed
    banks of that kind fail loudly here rather than miscompute.
    """
    if not tables:
        raise ValueError("plan bank needs at least one tier table")
    items = list(tables.items())
    _, first = items[0]
    cols0 = sorted((first.model_cols or {}).keys())
    for name, t in items[1:]:
        if t.prediction != first.prediction or t.sign != first.sign:
            raise ValueError(
                f"plan-bank tiers must share prediction type; tier {name!r} "
                f"is {t.prediction}-prediction, expected {first.prediction}")
        if sorted((t.model_cols or {}).keys()) != cols0:
            raise ValueError(
                f"plan-bank tiers must share model columns; tier {name!r} "
                f"has {sorted((t.model_cols or {}).keys())}, expected {cols0}")
    K = max(t.w_pred.shape[1] for _, t in items)
    tiers, stacked, offset = {}, [], 0
    for name, t in items:
        rows = augment_step_rows(t)
        for key in ("w_pred", "w_corr_prev"):
            pad = K - rows[key].shape[1]
            if pad:
                rows[key] = np.pad(rows[key], ((0, 0), (0, pad)))
        n = len(rows["t"])
        tiers[name] = (offset, n)
        offset += n
        stacked.append(rows)
    keys = stacked[0].keys()
    return ({k: np.concatenate([r[k] for r in stacked], axis=0) for k in keys},
            tiers)


def build_unipc_schedule(
    *,
    lambdas: np.ndarray,
    alphas: np.ndarray,
    sigmas: np.ndarray,
    timesteps: np.ndarray,
    order: int = 3,
    prediction: str = "data",
    variant: str = "bh2",
    use_corrector: bool = True,
    corrector_at_last: bool = False,
    order_schedule=None,
    lower_order_final: bool = True,
    variant_schedule=None,
    corrector_schedule=None,
) -> UniPCSchedule:
    """Precompute every scalar/vector the multistep UniPC scan needs.

    Buffer convention inside the sampler: E[k] holds the model output at point
    t_{i-1-k}; predictor differences at step i use r_m = (lam[i-1-m] - lam[i-1])/h
    for m = 1..p_i-1 and D_m = E[m] - E[0]; the corrector appends r = 1 with
    D = model(x_pred, t_i) - E[0]. (Alg. 5-8.)

    The schedules generalize the paper's hand-set policy into a searchable
    per-step decision vector (`repro.tuning`): `order_schedule` the UniP order
    per step, `variant_schedule` the B(h) variant per step, and
    `corrector_schedule` a per-step 0/1 UniC mask overriding the
    `use_corrector`/`corrector_at_last` policy. All default to the paper's
    fixed choices, under which the emitted table is unchanged.
    """
    assert prediction in PREDICTION_TYPES and variant in BH_VARIANTS
    lambdas = np.asarray(lambdas, dtype=np.float64)
    M = len(lambdas) - 1
    if order_schedule is None:
        order_schedule = default_order_schedule(M, order, lower_order_final)
    assert len(order_schedule) == M
    if variant_schedule is None:
        variant_schedule = [variant] * M
    assert len(variant_schedule) == M
    assert all(v in BH_VARIANTS for v in variant_schedule)
    if corrector_schedule is not None:
        assert len(corrector_schedule) == M
    max_prev = max(1, order - 1) if order > 1 else 1
    # allocate with at least one column so the ring shape is static even for order 1
    w_pred = np.zeros((M, max(1, order - 1)))
    w_corr_prev = np.zeros((M, max(1, order - 1)))
    w_corr_new = np.zeros((M,))
    base_x = np.zeros((M,))
    base_m0 = np.zeros((M,))
    out_scale = np.zeros((M,))
    use_c = np.zeros((M,))
    for i in range(1, M + 1):
        h = float(lambdas[i] - lambdas[i - 1])
        p_i = min(order_schedule[i - 1], i)
        v_i = variant_schedule[i - 1]
        # previous-point offsets r_m, m=1..p_i-1  (points t_{i-1-m})
        r_prev = np.array(
            [(lambdas[i - 1 - m] - lambdas[i - 1]) / h for m in range(1, p_i)],
            dtype=np.float64,
        )
        wp = unipc_weights(r_prev, h, v_i, prediction)
        w_pred[i - 1, : len(wp)] = wp
        # corrector: previous offsets + r=1 for the current point
        r_corr = np.concatenate([r_prev, [1.0]])
        wc = unipc_weights(r_corr, h, v_i, prediction)
        w_corr_prev[i - 1, : len(wc) - 1] = wc[:-1]
        w_corr_new[i - 1] = wc[-1]
        if corrector_schedule is not None:
            corr_here = bool(corrector_schedule[i - 1])
        else:
            corr_here = use_corrector and (corrector_at_last or i < M)
        use_c[i - 1] = 1.0 if corr_here else 0.0
        base_x[i - 1], base_m0[i - 1] = semilinear_coeffs(
            h, alphas[i - 1], alphas[i], sigmas[i - 1], sigmas[i], prediction)
        out_scale[i - 1] = sigmas[i] if prediction == "noise" else alphas[i]
    return UniPCSchedule(
        lambdas=lambdas,
        alphas=np.asarray(alphas, dtype=np.float64),
        sigmas=np.asarray(sigmas, dtype=np.float64),
        order=order,
        prediction=prediction,
        variant=variant,
        base_x=base_x,
        base_m0=base_m0,
        w_pred=w_pred,
        w_corr_prev=w_corr_prev,
        w_corr_new=w_corr_new,
        use_corrector=use_c,
        out_scale=out_scale,
        sign=-1.0 if prediction == "noise" else 1.0,
        timesteps=np.asarray(timesteps, dtype=np.float64),
        orders=list(order_schedule),
    )
