"""Mixture-of-Experts block: top-k routing with capacity-bucketed dispatch
(the port of `repro.models.moe`).

Dispatch is scatter-based (position-in-expert via cumsum) into per-expert
buffers (E, C, d_model) with C = ceil(k * N / E * capacity_factor); dropped
tokens fall through the residual connection. Expert FFNs run as one einsum
over stacked expert weights. Aux losses: Switch-style load balance plus the
router z-loss.

The reference's `moe_apply_shard_map` needs a mesh, which the port does not
have yet (ROADMAP item 12): with no mesh the reference takes `moe_apply`
whatever `cfg.moe_shard_map` says, and so does the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import dense_init


def moe_init(gen: torch.Generator, cfg, device) -> dict:
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    E = cfg.num_experts
    dt = cfg.weight_dtype
    scale = 1.0 / math.sqrt(d)

    def normal(shape, s):
        return (s * torch.randn(shape, generator=gen, device=device,
                                dtype=torch.float32)).to(dt)

    return {
        "router": dense_init(gen, d, E, dt, device, scale=0.02),
        "w_gate": normal((E, d, f), scale),
        "w_up": normal((E, d, f), scale),
        "w_down": normal((E, f, d), 1.0 / math.sqrt(f)),
    }


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
    """xf: (N, d) -> (probs (N, k), idx (N, k), aux_loss)."""
    logits = torch.matmul(xf, params["router"].to(xf.dtype))
    logits = logits.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, cfg.experts_per_token)
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

    h_g = torch.einsum("gecd,edf->gecf", buf, params["w_gate"].to(x.dtype))
    h_u = torch.einsum("gecd,edf->gecf", buf, params["w_up"].to(x.dtype))
    h = F.silu(h_g) * h_u
    out_buf = torch.einsum("gecf,efd->gecd", h, params["w_down"].to(x.dtype))

    y_rep = out_buf[gi, flat_e, slot] * keep[..., None]
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
