"""AdamW with decoupled weight decay and global-norm gradient clipping (the
port of `repro.optim.adamw`, plain torch on nested dicts of tensors).

The arithmetic is the reference's, in its order: the global norm over every
leaf, the clip, fp32 moments, the bias corrections from a float32 step, `u =
m_hat / (sqrt(v_hat) + eps) + wd * p` and `p - lr * u` cast back to p's
dtype. `torch.optim.AdamW` orders these differently, so it is not used.
Like the reference, `update` returns new params and moments and leaves its
inputs alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in sorted key order (`jax.tree.leaves`)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32, on the params' device
    m: dict
    v: dict


@dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        device = tree_leaves(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          z, tree_map(torch.clone, z))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        step = state.step + 1
        if self.clip_norm:
            gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                                for g in tree_leaves(grads)))
            scale = torch.clamp(self.clip_norm / (gn + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        m = tree_map(lambda mm, g: self.b1 * mm + (1 - self.b1)
                     * g.to(torch.float32), state.m, grads)
        v = tree_map(lambda vv, g: self.b2 * vv + (1 - self.b2)
                     * torch.square(g.to(torch.float32)), state.v, grads)
        bc1 = 1 - self.b1 ** step.to(torch.float32)
        bc2 = 1 - self.b2 ** step.to(torch.float32)
        lr = self._lr(step)

        def upd(p, mm, vv):
            u = (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps)
            u = u + self.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype)

        new_params = tree_map(upd, params, m, v)
        return new_params, AdamWState(step, m, v)
