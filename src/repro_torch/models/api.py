"""Per-family model API, DiT family (the port's slice of `repro.models.api`)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..diffusion.process import draw_t_noise, q_sample
from ..diffusion.schedules import VPLinear
from .dit import dit_apply, dit_apply_cached, init_dit

NUM_CLASSES = 1000  # init_params allocates NUM_CLASSES + 1 embeddings; the
                    # extra row is the CFG null class


def _require_dit(cfg: ModelConfig):
    if cfg.family != "dit":
        raise NotImplementedError(f"family {cfg.family!r} is not yet ported "
                                  f"(only the dit family is)")


def init_params(cfg: ModelConfig, seed: int = 0, device="cpu") -> dict:
    """Random params from a seeded torch.Generator on `device`."""
    _require_dit(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {"backbone": init_dit(cfg, gen, device, num_classes=NUM_CLASSES)}


def _record_leaf(a: np.ndarray, device) -> torch.Tensor:
    """A leaf of a quant record as stored: int8 stays int8, fp8 e4m3 (an
    ml_dtypes array, which torch.as_tensor rejects) crosses as its bytes,
    scales stay fp32."""
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(np.array(a).view(np.uint8)).view(
            torch.float8_e4m3fn).to(device)
    if a.dtype == np.int8:
        return torch.from_numpy(np.array(a)).to(device)
    return torch.from_numpy(np.array(a)).to(device=device,
                                            dtype=torch.float32)


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The port's params from the reference's `init_params` pytree given as
    nested dicts of numpy arrays (stacked (L, ...) blocks, (K, N) dense
    layout, class_embed (NUM_CLASSES + 1, d)). Same layout, same values.
    A tree the reference has quantized (`models.quant.quantize_params`)
    carries its records {"qw", "ws"[, "sa"]} over at their stored dtypes;
    every other leaf is cast to the config's weight dtype."""
    _require_dit(cfg)
    w1 = tree["backbone"]["blocks"]["w1"]
    depth = np.shape(w1["qw"] if isinstance(w1, dict) else w1)[0]
    if depth != cfg.num_layers:
        raise ValueError(f"blocks are stacked over {depth} layers, cfg has "
                         f"num_layers={cfg.num_layers}")

    def conv(node):
        if isinstance(node, dict) and "qw" in node:
            return {k: _record_leaf(np.asarray(v), device)
                    for k, v in node.items()}
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.as_tensor(np.asarray(node)).to(device=device,
                                                     dtype=cfg.weight_dtype)

    return conv(tree)


def params_to(params: dict, device) -> dict:
    """The same params on `device` (no copy where they already are)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


def _is_record(node) -> bool:
    return isinstance(node, dict) and "qw" in node


def cast_params_for_eval(params, eval_dtype: str):
    """Pre-cast every float param leaf to the serving eval dtype (DESIGN.md
    §11.3) once, so reduced-precision serving halves the params' reads
    instead of casting at use. Non-float leaves and quant records
    ({"qw", "ws"[, "sa"]}) pass through."""
    dt = getattr(torch, eval_dtype)

    def conv(node):
        if _is_record(node):
            return node
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return node.to(dt) if node.is_floating_point() else node

    return conv(params)


# the leaves the DiT casts to the activation dtype at each use
# (`layers.dense_apply`'s `w.to(x.dtype)` and the casts of `dit.py`);
# t_mlp1, t_mlp2 and class_embed are read in fp32 and stay as they are
_CAST_AT_USE = {
    "in_proj": None, "final_ada": None, "final_ada_b": None, "out_proj": None,
    "blocks": {"w1": None, "w2": None, "ada": None, "ada_b": None,
               "attn": {"wq": None, "wk": None, "wv": None, "wo": None}},
}


def cast_weights_once(cfg: ModelConfig, params) -> dict:
    """The weights kept once: `params` with one copy in the activation
    dtype of each leaf the DiT would otherwise cast at every use, so the
    per-use `.to()` is a no-op and launches nothing. The values are those
    the per-use cast gives, so the samples are bit-identical. Quant records
    and the leaves read in fp32 are shared, not copied."""
    _require_dit(cfg)
    act = cfg.activation_dtype

    def conv(node, sel):
        if sel is None:
            return node if _is_record(node) else node.to(act)
        return {k: conv(v, sel[k]) if k in sel else v
                for k, v in node.items()}

    return {**params, "backbone": conv(params["backbone"], _CAST_AT_USE)}


def calibrate_and_quantize(cfg: ModelConfig, params, quant, *, schedule=None,
                           nfe: int = 6, calib_batch: int = 2, seed: int = 0):
    """The quantized path (models/quant.py): calibrate and install records.

    `quant` is a tier name of models.quant.QUANT_MODES ("w8a16", "w8a8",
    ...) or a QuantSpec. Weight scales are the weights' own per-channel (or
    per-tensor) absmax; a8 tiers also record per-site activation absmax
    over `calib_batch` probe trajectories on the params' device (same seed,
    same scales). Returns (cfg', params', info): cfg' carries the spec and
    is what eps_network should be built from."""
    from .quant import calibrate_act_stats, quant_spec, quantize_params

    spec = quant_spec(quant) if isinstance(quant, str) else quant
    stats = None
    if spec.act_bits == 8:
        stats = calibrate_act_stats(cfg, params, schedule=schedule, nfe=nfe,
                                    batch=calib_batch, seed=seed)
    qparams = quantize_params(cfg, params, spec, act_stats=stats)
    cfg = dataclasses.replace(cfg, quant=spec)
    return cfg, qparams, {"spec": spec, "act_stats": stats}


def eps_network(cfg: ModelConfig) -> Callable:
    """(params, x_t (B, S, L), t, batch) -> eps-hat — what UniPC samples from."""
    _require_dit(cfg)
    return lambda p, x_t, t, batch: dit_apply(
        p["backbone"], cfg, x_t, t, batch.get("class_ids"))


def eps_network_cached(cfg: ModelConfig, cache_block: int) -> Callable:
    """Feature-reuse eps-net (DESIGN.md §12), dit family only:

        (params, x_t, t, batch, cache, reuse, deep=True) -> (eps-hat, cache')

    `cache` is the (B, T, d_model) deep-feature delta state (see
    `dit.dit_apply_cached`), `reuse` the per-sample shallow-eval flag and
    `deep` the host's word on whether any sample runs a full eval. The
    `cache_block` boundary is static; which steps reuse the cache is data
    (a per-step table column)."""
    if cfg.family != "dit":
        raise ValueError(f"feature-reuse eval needs the dit family (residual "
                         f"block stack); arch {cfg.arch_id!r} is family "
                         f"{cfg.family!r}")

    def f(params, x_t, t, batch, cache, reuse, deep=True):
        return dit_apply_cached(params["backbone"], cfg, x_t, t,
                                batch.get("class_ids"), cache=cache,
                                reuse=reuse, cache_block=cache_block,
                                deep=deep)

    return f


def diffusion_loss_fn(cfg: ModelConfig, schedule=None) -> Callable:
    """(params, batch, rng) -> the DiT's diffusion loss, a 0-d fp32 tensor:
    mean((eps_hat - noise)^2) over x_t = q_sample(latents, t, noise). `rng`
    is a torch.Generator or the (t, noise) pair (`draw_t_noise`). Only the
    dit family is ported; the diffusion-LM rounding loss of the token
    families waits for them (ROADMAP item 12)."""
    _require_dit(cfg)
    schedule = schedule or VPLinear()
    net = eps_network(cfg)

    def loss(params, batch, rng):
        x0 = batch["latents"]
        t, noise = draw_t_noise(schedule, x0, rng)
        x_t = q_sample(schedule, x0, t, noise)
        eps_hat = net(params, x_t, t, batch)
        # both widened first: a bf16 eps_hat would keep the difference bf16
        return torch.mean((eps_hat.to(torch.float32)
                           - noise.to(torch.float32)) ** 2)

    return loss


def train_loss(cfg: ModelConfig, objective: str = "ar") -> Callable:
    if objective == "ar":
        raise NotImplementedError(
            "the autoregressive objective (ar_loss) is not yet ported to "
            "repro_torch (ROADMAP item 12); objective='diffusion' is")
    return diffusion_loss_fn(cfg)
