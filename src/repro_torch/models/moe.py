"""Mixture-of-Experts block: top-k routing with capacity-bucketed dispatch
(the port of `repro.models.moe`), or dropless dispatch sorted by expert
(`moe_apply_dropless`, DeepSeek-V2's), with shared experts.

Dispatch is scatter-based (position-in-expert via cumsum) into per-expert
buffers (E, C, d_model) with C = ceil(k * N / E * capacity_factor); dropped
tokens fall through the residual connection. Expert FFNs run as one einsum
over stacked expert weights. Aux losses: Switch-style load balance plus the
router z-loss.

`moe_apply_shard_map` is the reference's MoE block under `shard_map` on a
mesh (the model takes it when `cfg.moe_shard_map` is set and a mesh is
active): every shard dispatches its own tokens into its own buffers, with
its own capacity, so its result differs from `moe_apply`'s on a mesh of
more than one data shard. One card runs what the shard map computes, one
shard after another, on the device `x` is on:

* the batch is split over the mesh's data axes ("pod", "data"), in mesh
  order;
* for each data shard and each model shard j of the expert hidden dim f,
  `_moe_local` runs on `w_gate[..., f_j]`, `w_up[..., f_j]` and
  `w_down[:, f_j, :]`;
* the partial outputs are summed over the model shards in index order (the
  reference's `psum`), and aux is the mean over all shards (its `pmean`).

On a 1x1 mesh this is one call of `_moe_local`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.grouped_mm import ops as gmm_ops
from ..obs import trace
from ..parallel.sharding import shard
from .layers import dense_init, mlp_apply, mlp_init


def moe_init(gen: torch.Generator, cfg, device) -> dict:
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    E = cfg.num_experts
    dt = cfg.weight_dtype
    scale = 1.0 / math.sqrt(d)

    def normal(shape, s):
        return (s * torch.randn(shape, generator=gen, device=device,
                                dtype=torch.float32)).to(dt)

    p = {
        "router": dense_init(gen, d, E, dt, device, scale=0.02),
        "w_gate": normal((E, d, f), scale),
        "w_up": normal((E, d, f), scale),
        "w_down": normal((E, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.num_shared_experts:
        # the shared experts as one SwiGLU of their summed width
        p["shared"] = mlp_init(gen, cfg, device,
                               d_ff=cfg.num_shared_experts * f)
    return p


def one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """`jax.nn.one_hot`: idx (...) -> (..., n) of `dtype`, by comparison (no
    range check, so no host sync on the card)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest along the last axis, ties broken
    toward the lower index as `jax.lax.top_k` does (`torch.topk` promises no
    order among ties; bf16 router logits over 40 experts do tie): the first
    k of a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params: dict, xf: torch.Tensor, cfg) -> tuple:
    """xf: (N, d) -> (probs (N, k), idx (N, k), aux_loss). The top-k
    probabilities renormalised to sum to 1 where `cfg.norm_topk_prob`;
    with `cfg.router_fp32` the logits are the product of fp32 x and fp32
    weights."""
    if cfg.router_fp32:
        logits = torch.matmul(xf.to(torch.float32),
                              params["router"].to(torch.float32))
    else:
        logits = torch.matmul(xf, params["router"].to(xf.dtype))
    logits = logits.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, cfg.experts_per_token)
    if cfg.norm_topk_prob:
        top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    # Switch load-balance loss + z-loss
    E = cfg.num_experts
    me = torch.mean(probs, dim=0)                                 # mean prob
    ce = torch.mean(one_hot(top_i[:, 0], E, torch.float32), dim=0)
    lb = E * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return top_p, top_i, lb + 1e-3 * z


def moe_apply(params: dict, x: torch.Tensor, cfg) -> tuple:
    """x: (B, S, d). Returns (y, aux_loss).

    moe_dispatch_groups == 0: one position-in-expert cumsum over all N*k
    dispatch slots and one (E, C, d) buffer. == G: the tokens split into G
    groups, positions counted within each group into (G, E, C/G, d)
    buffers (the reference's shard-aligned dispatch)."""
    B, S, d = x.shape
    N = B * S
    k = cfg.experts_per_token
    E = cfg.num_experts
    G = cfg.moe_dispatch_groups or 1
    if N % G:
        raise ValueError(f"moe_dispatch_groups={G} must divide the {N} "
                         f"tokens")
    n = N // G
    C = max(1, int(math.ceil(k * n / E * cfg.capacity_factor)))
    xf = x.reshape(N, d)
    top_p, top_i, aux = _route(params, xf, cfg)

    # position-in-expert within each dispatch group (G=1 -> global)
    flat_e = top_i.reshape(G, n * k)
    oh = one_hot(flat_e, E, torch.int32)                           # (G, n*k, E)
    pos = (torch.cumsum(oh, dim=1) * oh).sum(-1) - 1               # (G, n*k)
    keep = pos < C
    slot = torch.where(keep, pos, torch.full_like(pos, C))          # C = trash
    x_rep = torch.repeat_interleave(xf.reshape(G, n, d), k, dim=1)  # (G, n*k, d)

    gi = torch.arange(G, device=x.device)[:, None].expand(G, n * k)
    # kept slots are unique and only the trash slot C is written more than
    # once (with zeros), so a plain indexed store gives the reference's
    # scatter-add onto zeros whatever order the writes land in
    buf = torch.zeros((G, E, C + 1, d), dtype=x.dtype, device=x.device)
    buf[gi, flat_e, slot] = torch.where(keep[..., None], x_rep,
                                        torch.zeros_like(x_rep))
    buf = shard(buf, "expert_cap", "experts", None, "d_model")

    h_g = torch.einsum("gecd,edf->gecf", buf, params["w_gate"].to(x.dtype))
    h_u = torch.einsum("gecd,edf->gecf", buf, params["w_up"].to(x.dtype))
    h = F.silu(h_g) * h_u
    h = shard(h, "expert_cap", "experts", None, "d_ff")
    out_buf = torch.einsum("gecf,efd->gecd", h, params["w_down"].to(x.dtype))

    y_rep = out_buf[gi, flat_e, slot] * keep[..., None]
    y = (y_rep.reshape(N, k, d)
         * top_p.to(x.dtype).reshape(N, k, 1)).sum(dim=1)
    return y.reshape(B, S, d), aux


def moe_apply_dropless(params: dict, x: torch.Tensor, cfg,
                       counter: torch.Tensor = None) -> tuple:
    """x: (B, S, d). Returns (y, aux_loss): every token through each of its
    k experts, none dropped.

    The N k (token, choice) rows are sorted by expert (a stable sort, so
    each expert's rows keep token order), the expert sizes counted and
    summed into offsets on the device, and each SwiGLU product is one
    grouped matmul over the sorted rows (`kernels/grouped_mm`): no host
    sync, so a CUDA graph captures the layer. Each row's SwiGLU activation
    is scaled by its routing weight before the down product (which is
    linear, so this is the weighted sum of the experts' outputs); the rows
    go back to (token, choice) order by a gather and each token's k sum
    in fp32, rounded once to x's dtype. The shared experts
    (`params["shared"]`) add their SwiGLU of every token. `counter` (E,)
    int64, where given, gains the rows routed to each expert."""
    B, S, d = x.shape
    N, k, E = B * S, cfg.experts_per_token, cfg.num_experts
    xf = x.reshape(N, d)
    with trace.live("moe.route"):
        top_p, top_i, aux = _route(params, xf, cfg)
        flat = top_i.reshape(N * k)
        order = torch.argsort(flat, stable=True)
        counts = torch.zeros(E, dtype=torch.int64, device=x.device)
        counts.scatter_add_(0, flat, torch.ones_like(flat))
        offs = torch.cumsum(counts, 0).to(torch.int32)
        if counter is not None:
            counter.add_(counts)
        rows = xf[order // k]
        weight = top_p.reshape(N * k)[order]
    with trace.live("moe.experts"):
        h = F.silu(gmm_ops.grouped_mm(rows, params["w_gate"], offs))
        h = h.mul_(gmm_ops.grouped_mm(rows, params["w_up"], offs)).mul_(
            weight[:, None])
        out = gmm_ops.grouped_mm(h, params["w_down"], offs)
        shared = (mlp_apply(params["shared"], xf, cfg) if "shared" in params
                  else None)
    with trace.live("moe.combine"):
        back = torch.empty_like(order)
        back[order] = torch.arange(N * k, device=x.device)
        y = out[back].reshape(N, k, d).sum(dim=1, dtype=torch.float32)
        y = y.to(x.dtype)
        if shared is not None:
            y = y + shared
    return y.reshape(B, S, d), aux


def moe_apply_shard_map(params: dict, x: torch.Tensor, cfg, mesh,
                        data_axes=("pod", "data"),
                        model_axis: str = "model") -> tuple:
    """The reference's shard-mapped MoE block on `mesh` (the port's
    `launch.mesh.Mesh`, concrete or abstract), run shard by shard (see the
    module docstring); returns the same (y, aux) contract as `moe_apply`."""
    data_axes = tuple(a for a in data_axes if a in mesh.shape)
    n_data = math.prod(mesh.shape[a] for a in data_axes)
    n_model = mesh.shape[model_axis]
    B = x.shape[0]
    f = params["w_gate"].shape[-1]
    if B % n_data or f % n_model:
        raise ValueError(f"batch {B} over {n_data} data shards, hidden {f} "
                         f"over {n_model} model shards: both must divide")
    b, fs = B // n_data, f // n_model
    ys, auxs = [], []
    for i in range(n_data):
        xs = x[i * b:(i + 1) * b]
        y = None
        for j in range(n_model):
            cols = slice(j * fs, (j + 1) * fs)
            y_j, aux = _moe_local(params["router"], params["w_gate"][..., cols],
                                  params["w_up"][..., cols],
                                  params["w_down"][:, cols, :], xs, cfg)
            y = y_j if y is None else y + y_j
            auxs.append(aux)
        ys.append(y)
    return torch.cat(ys), torch.stack(auxs).mean()


def _moe_local(w_router, w_gate, w_up, w_down, x: torch.Tensor, cfg) -> tuple:
    """One shard's dispatch and expert FFN: the router over its own tokens,
    capacity C from its own N, partial sums over its slice of f."""
    B, S, d = x.shape
    N = B * S
    k, E = cfg.experts_per_token, cfg.num_experts
    C = max(1, int(math.ceil(k * N / E * cfg.capacity_factor)))
    xf = x.reshape(N, d)
    top_p, top_i, aux = _route({"router": w_router}, xf, cfg)

    flat_e = top_i.reshape(N * k)
    oh = one_hot(flat_e, E, torch.int32)
    pos = (torch.cumsum(oh, dim=0) * oh).sum(-1) - 1
    keep = pos < C
    slot = torch.where(keep, pos, torch.full_like(pos, C))
    x_rep = torch.repeat_interleave(xf, k, dim=0)
    # kept slots are unique, only the trash slot C repeats (with zeros): an
    # indexed store is the reference's scatter-add onto zeros
    buf = torch.zeros((E, C + 1, d), dtype=x.dtype, device=x.device)
    buf[flat_e, slot] = torch.where(keep[:, None], x_rep,
                                    torch.zeros_like(x_rep))
    h = (F.silu(torch.einsum("ecd,edf->ecf", buf, w_gate.to(x.dtype)))
         * torch.einsum("ecd,edf->ecf", buf, w_up.to(x.dtype)))
    out_buf = torch.einsum("ecf,efd->ecd", h, w_down.to(x.dtype))
    y_rep = out_buf[flat_e, slot] * keep[:, None]
    y = (y_rep.reshape(N, k, d)
         * top_p.to(x.dtype).reshape(N, k, 1)).sum(dim=1)
    return y.reshape(B, S, d), aux


def moe_decode_apply(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Decode-time MoE (B, 1, d): tiny token count — every expert applied to
    every token, combined by one-hot routing weights (k active a token)."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    top_p, top_i, _ = _route(params, xf, cfg)
    comb = torch.einsum("nk,nke->ne", top_p,
                        one_hot(top_i, cfg.num_experts, torch.float32)
                        ).to(x.dtype)
    # the reference's einsums "nd,edf->nef" and "nef,efd->ned" as batched
    # matmuls over the experts, (E, n, f) and (E, n, d): they read the
    # stacked expert weights in their stored layout, where torch.einsum
    # copies (E, d, f) into its contraction layout on every call
    h_g = torch.matmul(xf, params["w_gate"].to(x.dtype))
    h_u = torch.matmul(xf, params["w_up"].to(x.dtype))
    h = F.silu(h_g) * h_u
    out = torch.matmul(h, params["w_down"].to(x.dtype))
    y = torch.einsum("end,ne->nd", out, comb)
    return y.reshape(B, S, d)
