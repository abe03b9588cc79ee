"""Roofline model of one NVIDIA H100 (the counterpart of
`repro/analysis/roofline.py`, whose constants are a TPU v5e's).

Hardware model: the H100 SXM's published rates (NVIDIA's data sheet, dense,
no sparsity, at the full 700 W power limit): 3.35e12 bytes/s of HBM, 989e12
FLOP/s in bf16 and fp16, 1979e12 in fp8 and int8, 67e12 in fp32 outside
the tensor cores (the port keeps TF32 off), 80 GB of HBM. These are the
only copies of these constants in the repository: `chip_smoke.py` imports
them.

The TPU had one peak; this card has one per dtype, so a `Roofline` takes
its operations split by the dtype of their operands and its compute term
is sum_dtype flops[dtype] / peak[dtype]:

    compute_s    = sum_d flops_by_dtype[d] / PEAK_FLOPS[d]
    memory_s     = hbm_bytes / HBM_BYTES_PER_S
    collective_s = 0 (one card has no link)

`flops` stays the total, and `row()` keeps the reference's keys.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12, torch.int8: 1979e12,
              torch.float8_e4m3fn: 1979e12}
DEVICE_BYTES = 80e9
MFU_PEAK = PEAK_FLOPS[torch.bfloat16]   # the denominator of every MFU


def as_dtype(d) -> torch.dtype:
    """A torch dtype from itself or its name ("bfloat16")."""
    return d if isinstance(d, torch.dtype) else getattr(torch, d)


def peak_flops(d) -> float:
    """The card's peak rate for operations on operands of dtype `d`."""
    d = as_dtype(d)
    if d not in PEAK_FLOPS:
        raise KeyError(f"no published H100 peak for {d}")
    return PEAK_FLOPS[d]


@dataclass
class Roofline:
    flops_by_dtype: dict          # dtype (or its name) -> operations
    hbm_bytes: float
    # per-chip collective bytes come from an SPMD partitioner's program
    # (the reference reads XLA's); one card has none, so this stays 0
    collective_bytes: float = 0.0
    chips: int = 1
    model_flops: float = 0.0       # whole model (6ND / 2ND)

    @property
    def flops(self):
        return float(sum(self.flops_by_dtype.values()))

    @property
    def compute_s(self):
        return sum(f / peak_flops(d) for d, f in self.flops_by_dtype.items())

    @property
    def memory_s(self):
        return self.hbm_bytes / HBM_BYTES_PER_S

    @property
    def collective_s(self):
        if self.collective_bytes:
            raise ValueError("one card has no link: collective traffic "
                             "needs an SPMD partitioner's per-chip program")
        return 0.0

    @property
    def bottleneck(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self):
        """Optimistic (fully-overlapped) step time = max of the terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self):
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self):
        """Model-FLOPs utilization at the optimistic step time."""
        denom = self.step_time_s * self.chips * MFU_PEAK
        return self.model_flops / denom if denom else 0.0

    def row(self):
        return dict(
            compute_s=self.compute_s, memory_s=self.memory_s,
            collective_s=self.collective_s, bottleneck=self.bottleneck,
            flops_per_chip=self.flops, hbm_bytes_per_chip=self.hbm_bytes,
            collective_bytes_per_chip=self.collective_bytes,
            model_flops=self.model_flops,
            useful_ratio=self.useful_flops_ratio,
            mfu=self.mfu,
            flops_by_dtype={str(as_dtype(d)).replace("torch.", ""): f
                            for d, f in self.flops_by_dtype.items()},
        )


def kernel_bound(cost) -> tuple:
    """(ms, "bytes" or "operations"): the least time of one kernel call on
    this card, from its `cost` (kernels/dispatch.Cost: the operations, the
    bytes each input read once and each output written once, the dtype
    whose peak bounds the operations), and which of the two sets it."""
    r = Roofline({cost.dtype: cost.flops}, cost.bytes)
    return (r.step_time_s * 1e3,
            "bytes" if r.memory_s >= r.compute_s else "operations")


def model_flops_train(cfg, tokens: int) -> float:
    """6 * N_active * D (dense) with MoE using active params only."""
    return 6.0 * active_params(cfg) * tokens


def model_flops_decode(cfg, tokens: int) -> float:
    return 2.0 * active_params(cfg) * tokens


def model_flops_sample(cfg, evals: int, rows: int) -> float:
    """The model FLOPs of `evals` eps-net evals of `rows` rows each: 2
    N_active a token, except a DiT's adaLN projections (6 d^2 a layer,
    counted per token in `active_params`), which run once a row on the
    conditioning vector and count once a row here."""
    adaln = (6.0 * cfg.num_layers * cfg.d_model ** 2
             if cfg.family == "dit" else 0.0)
    per_row = (active_params(cfg) - adaln) * cfg.patch_tokens + adaln
    return evals * rows * 2.0 * per_row


def active_params(cfg) -> float:
    """Parameter count with only the routed-active experts counted."""
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    emb = V * d
    # ssm/hybrid/vlm/audio implementations reuse the embedding as the output
    # head (no separate lm_head); dense/moe honor cfg.tie_embeddings
    tied = cfg.tie_embeddings or cfg.family in ("ssm", "hybrid", "vlm", "audio")
    n = emb if tied else 2 * emb
    if cfg.family in ("dense", "moe", "vlm"):
        hd = cfg.head_dim * (cfg.num_heads + 2 * cfg.num_kv_heads) * d \
            + cfg.num_heads * cfg.head_dim * d
        if cfg.num_experts:
            fe = cfg.moe_d_ff or f
            mlp = 3 * d * fe * cfg.experts_per_token + d * cfg.num_experts
        else:
            mlp = 3 * d * f if cfg.act == "swiglu" else 2 * d * f
        per_layer = hd + mlp
        n += L * per_layer
        if cfg.family == "vlm":
            n += d * d  # projector
    elif cfg.family == "audio":
        attn = 4 * d * d
        mlp = 2 * d * f
        n += cfg.encoder_layers * (attn + mlp) + L * (2 * attn + mlp)
    elif cfg.family in ("ssm", "hybrid"):
        di = cfg.ssm_d_inner
        G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        per = d * (2 * di + 2 * G * N + H) + di * d
        n += L * per
        if cfg.family == "hybrid":
            n += 4 * d * d + 3 * d * f  # one shared attention block
    elif cfg.family == "dit":
        n += L * (4 * d * d + 2 * d * cfg.d_ff + 6 * d * d)
    return float(n)
