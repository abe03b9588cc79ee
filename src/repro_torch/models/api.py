"""Per-family model API (the port of `repro.models.api`): the dit family
and the token families: the decoder-only dense and MoE transformers, the
SSM stack (Mamba2 / SSD), the hybrid (Mamba2 with zamba2's shared
attention block), the vlm (llama-vision's gated cross-attention over
image embeddings) and the audio encoder-decoder (whisper).

    init_params(cfg, seed, device)              -> params
    train_loss(cfg, objective)(params, batch, rng) -> scalar loss
                                                   ('ar' | 'diffusion')
    eps_network(cfg)(params, x_t, t, batch)     -> eps-hat (UniPC's model)
    init_cache(cfg, batch, max_len, device)     -> cache
    prefill_fn(cfg)(params, batch, max_len)     -> (logits, cache)
    decode_fn(cfg)(params, cache, tok, pos)     -> (logits, cache)

`batch` is a dict: tokens / targets always; `image_embeds` (vlm) and
`audio_embeds` (audio), the stub frontends' outputs; latents and class ids
(dit). The token families' eps-net is the diffusion-LM head over the
backbone from its input embeddings (`models/diffusion_lm.py`, DESIGN.md
§7.1): the transformers, the vlm and the audio decoder run
bidirectionally (the vlm's and the audio model's conditioned on
`batch`'s embeddings), the SSM and hybrid backbones stay causal as the
reference's do. Their diffusion objective is embedding-space diffusion
over the learned token latents, the eps loss plus an alpha^2-weighted
rounding cross-entropy. The audio family has no `init_cache`: its cache
comes from prefill, as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..diffusion.process import draw_t_noise, q_sample
from ..diffusion.schedules import VPLinear
from . import encdec, hybrid, transformer, vlm
from .diffusion_lm import diffusion_lm_apply, init_diffusion_head
from .dit import dit_apply, dit_apply_cached, init_dit
from .layers import dense_init

NUM_CLASSES = 1000  # init_params allocates NUM_CLASSES + 1 embeddings; the
                    # extra row is the CFG null class


class _TokenLM(NamedTuple):
    """The module functions of one token family's LM, and the batch key of
    the frontend embeddings its loss, prefill and diffusion-LM eval take
    after the tokens (None: none)."""
    init: Callable
    lm_loss: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    cond: Optional[str] = None


def _audio_cache(cfg, batch, max_len, device="cpu"):
    raise ValueError("audio cache comes from encdec_prefill")


_TRANSFORMER = _TokenLM(transformer.init_lm, transformer.lm_loss,
                        transformer.init_cache, transformer.prefill,
                        transformer.decode_step)
_TOKEN_LMS = {
    "dense": _TRANSFORMER, "moe": _TRANSFORMER,
    "ssm": _TokenLM(hybrid.init_mamba_lm, hybrid.mamba_lm_loss,
                    hybrid.init_mamba_cache, hybrid.mamba_prefill,
                    hybrid.mamba_decode_step),
    "hybrid": _TokenLM(hybrid.init_zamba_lm, hybrid.zamba_lm_loss,
                       hybrid.init_zamba_cache, hybrid.zamba_prefill,
                       hybrid.zamba_decode_step),
    "vlm": _TokenLM(vlm.init_vlm, vlm.vlm_loss, vlm.init_vlm_cache,
                    vlm.vlm_prefill, vlm.vlm_decode_step, "image_embeds"),
    "audio": _TokenLM(encdec.init_encdec, encdec.encdec_loss, _audio_cache,
                      encdec.encdec_prefill, encdec.encdec_decode_step,
                      "audio_embeds"),
}
TOKEN_FAMILIES = tuple(_TOKEN_LMS)


def frontend_key(cfg: ModelConfig) -> Optional[str]:
    """The batch key of the frontend embeddings a token family's LM reads
    ("image_embeds" for the vlm, "audio_embeds" for the audio family), or
    None."""
    lm = _TOKEN_LMS.get(cfg.family)
    return None if lm is None else lm.cond


def _cond(cfg: ModelConfig, batch: dict) -> tuple:
    """The frontend embeddings the family's functions take after the
    tokens: (batch[key],) or ()."""
    key = frontend_key(cfg)
    return () if key is None else (batch[key],)


def _require(cfg: ModelConfig, families=("dit",) + TOKEN_FAMILIES,
             what: str = "the family"):
    if cfg.family not in families:
        raise ValueError(f"{what} of family {cfg.family!r}: no such family "
                         f"here ({', '.join(families)})")


def init_params(cfg: ModelConfig, seed: int = 0, device="cpu") -> dict:
    """Random params from a seeded torch.Generator on `device`: the
    backbone, then (token families with `latent_dim`) the diffusion head
    and the token latents. On the meta device (shapes and dtypes only, no
    allocation: `launch/specs.abstract_params`) the generator is a CPU one,
    as a meta generator does not exist."""
    _require(cfg)
    meta = torch.device(device).type == "meta"
    gen = torch.Generator(device="cpu" if meta else device).manual_seed(seed)
    if cfg.family == "dit":
        return {"backbone": init_dit(cfg, gen, device,
                                     num_classes=NUM_CLASSES)}
    p = {"backbone": _TOKEN_LMS[cfg.family].init(cfg, gen, device)}
    if cfg.latent_dim:
        p["diffusion_head"] = init_diffusion_head(cfg, gen, device)
        p["token_latents"] = dense_init(gen, cfg.vocab_size, cfg.latent_dim,
                                        cfg.weight_dtype, device, scale=1.0)
    return p


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


def _stacked_depth(tree: dict, cfg: ModelConfig) -> tuple:
    """(what the backbone stacks, how many layers it holds) of a reference
    tree: the dit's (L, ...) `blocks`, the transformers' and the SSM
    stack's (L, ...) `layers`, the hybrid's (n_groups, attn_every, ...)
    `groups` and (tail, ...) `tail`, the vlm's (G, cross_attn_every - 1,
    ...) `self_groups` and (G, ...) `xattn_layers`, the audio model's
    (num_layers, ...) `dec_layers` (its `enc_layers` checked here)."""
    bk = tree["backbone"]
    if cfg.family == "dit":
        probe = bk["blocks"]["w1"]
        return "blocks", np.shape(probe["qw"] if isinstance(probe, dict)
                                  else probe)[0]
    if cfg.family == "ssm":
        return "layers", np.shape(bk["layers"]["mamba"]["in_proj"])[0]
    if cfg.family == "hybrid":
        g, e = np.shape(bk["groups"]["mamba"]["in_proj"])[:2]
        if e != cfg.attn_every:
            raise ValueError(f"groups are stacked {e} layers a group, cfg "
                             f"has attn_every={cfg.attn_every}")
        tail = (np.shape(bk["tail"]["mamba"]["in_proj"])[0] if "tail" in bk
                else 0)
        return "groups and tail", g * e + tail
    if cfg.family == "vlm":
        g, n = np.shape(bk["self_groups"]["attn"]["wq"])[:2]
        x = np.shape(bk["xattn_layers"]["xattn"]["wq"])[0]
        if n != cfg.cross_attn_every - 1 or x != g:
            raise ValueError(f"self_groups are stacked ({g}, {n}) and "
                             f"xattn_layers {x}; cfg has cross_attn_every="
                             f"{cfg.cross_attn_every}")
        return "self_groups and xattn_layers", g * cfg.cross_attn_every
    if cfg.family == "audio":
        e = np.shape(bk["enc_layers"]["attn"]["wq"])[0]
        if e != cfg.encoder_layers:
            raise ValueError(f"enc_layers are stacked over {e} layers, cfg "
                             f"has encoder_layers={cfg.encoder_layers}")
        return "dec_layers", np.shape(bk["dec_layers"]["attn"]["wq"])[0]
    return "layers", np.shape(bk["layers"]["attn"]["wq"])[0]


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The port's params from the reference's `init_params` pytree given as
    nested dicts of numpy arrays. Same layout, same values: for the dit
    family stacked (L, ...) `blocks`, (K, N) dense layout, class_embed
    (NUM_CLASSES + 1, d); for the transformer families stacked (L, ...)
    `layers` of ln1 / attn / ln2 / mlp|moe, `embed`, `final_ln`, an
    optional `lm_head`; for the ssm family stacked (L, ...) `layers` of ln
    / mamba; for the hybrid family `groups` of them stacked (n_groups,
    attn_every, ...), an optional `tail` (tail, ...) and `shared_attn`;
    for the vlm `self_groups` (G, cross_attn_every - 1, ...), `xattn_layers`
    (G, ...) with their 0-d gates, `img_proj`; for the audio family
    `enc_layers`, `dec_layers`, `enc_ln`; and the diffusion leaves (`diffusion_head`, `token_latents`). A tree
    the reference has quantized (`models.quant.quantize_params`, dit only)
    carries its records {"qw", "ws"[, "sa"]} over at their stored dtypes;
    every other leaf is cast to the config's weight dtype."""
    _require(cfg)
    stack, depth = _stacked_depth(tree, cfg)
    if depth != cfg.num_layers:
        raise ValueError(f"{stack} are stacked over {depth} layers, cfg has "
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


# the leaves each family casts to the activation dtype at each use
# (`layers.dense_apply`'s `w.to(x.dtype)` and the casts of the model code);
# None selects a whole subtree. The DiT reads t_mlp1, t_mlp2 and
# class_embed in fp32; the transformer backbone casts every leaf (the
# embedding table, tied or not, the norms, the router and the experts
# included); a Mamba2 layer reads A_log and dt_bias in fp32 and casts the
# rest; the diffusion head reads t_mlp1 and t_mlp2 in fp32, and the token
# latents are the training loss's; a vlm's cross-attention layer reads its
# two 0-d gates in their own precision (tanh, then the cast) and casts the
# rest, as every other vlm leaf; the audio model casts every backbone leaf
_MAMBA_LAYER = {"ln": None, "mamba": {
    "in_proj": None, "conv_w": None, "conv_b": None, "D": None,
    "out_norm": None, "out_proj": None}}
_HEAD = {"in_proj": None, "out_proj": None}
_CAST_AT_USE = {
    "dit": {"backbone": {
        "in_proj": None, "final_ada": None, "final_ada_b": None,
        "out_proj": None,
        "blocks": {"w1": None, "w2": None, "ada": None, "ada_b": None,
                   "attn": {"wq": None, "wk": None, "wv": None,
                            "wo": None}}}},
    "token": {"backbone": None, "diffusion_head": _HEAD},
    "ssm": {"backbone": {"embed": None, "final_ln": None,
                         "layers": _MAMBA_LAYER},
            "diffusion_head": _HEAD},
    "hybrid": {"backbone": {"embed": None, "final_ln": None,
                            "groups": _MAMBA_LAYER, "tail": _MAMBA_LAYER,
                            "shared_attn": None},
               "diffusion_head": _HEAD},
    "vlm": {"backbone": {"embed": None, "img_proj": None, "final_ln": None,
                         "self_groups": None,
                         "xattn_layers": {"ln1": None, "xattn": None,
                                          "ln2": None, "mlp": None}},
            "diffusion_head": _HEAD},
}


def cast_weights_once(cfg: ModelConfig, params) -> dict:
    """The weights kept once: `params` with one copy in the activation
    dtype of each leaf the model would otherwise cast at every use, so the
    per-use `.to()` is a no-op and launches nothing (for a tied embedding,
    the whole table on every decode step otherwise). The values are those
    the per-use cast gives, so the results are bit-identical. Quant records
    and the leaves read in fp32 are shared, not copied."""
    _require(cfg)
    act = cfg.activation_dtype

    def conv(node, sel):
        if sel is None:
            if isinstance(node, dict) and not _is_record(node):
                return {k: conv(v, None) for k, v in node.items()}
            return node if _is_record(node) else node.to(act)
        return {k: conv(v, sel[k]) if k in sel else v
                for k, v in node.items()}

    sel = _CAST_AT_USE.get(cfg.family, _CAST_AT_USE["token"])
    return conv(params, sel)


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


def _backbone_forward(cfg: ModelConfig) -> Callable:
    """(backbone params, inputs_embeds, batch) -> (hidden, aux), the
    diffusion LM's backbone eval: the transformers bidirectional, the SSM
    stack and the hybrid causal by construction (the reference's), the vlm
    and the audio decoder bidirectional over batch["image_embeds"] /
    batch["audio_embeds"] (the audio model encodes them at every eval, as
    the reference's does)."""
    if cfg.family == "ssm":
        return lambda bk, e, b: hybrid.mamba_forward(bk, cfg, None,
                                                     inputs_embeds=e)
    if cfg.family == "hybrid":
        return lambda bk, e, b: hybrid.zamba_forward(bk, cfg, None,
                                                     inputs_embeds=e)
    if cfg.family == "vlm":
        return lambda bk, e, b: vlm._forward_embeds(bk, cfg, e,
                                                    b["image_embeds"])
    if cfg.family == "audio":
        return lambda bk, e, b: encdec._forward_embeds(bk, cfg, e,
                                                       b["audio_embeds"])
    return lambda bk, e, b: transformer.forward(bk, cfg, None, causal=False,
                                                inputs_embeds=e)


def eps_network(cfg: ModelConfig) -> Callable:
    """(params, x_t (B, S, L), t, batch) -> eps-hat — what UniPC samples from.
    The dit family's DiT; the token families' diffusion-LM head over the
    backbone from `inputs_embeds` (`_backbone_forward`, which reads a vlm's
    or an audio model's embeddings from `batch`)."""
    _require(cfg)
    if cfg.family == "dit":
        return lambda p, x_t, t, batch: dit_apply(
            p["backbone"], cfg, x_t, t, batch.get("class_ids"))
    fwd = _backbone_forward(cfg)

    def f(params, x_t, t, batch):
        return diffusion_lm_apply(params["diffusion_head"],
                                  lambda e: fwd(params["backbone"], e, batch),
                                  cfg, x_t, t)

    return f


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
    """(params, batch, rng) -> the diffusion loss, a 0-d fp32 tensor:
    mean((eps_hat - noise)^2) over x_t = q_sample(x0, t, noise), x0 the
    DiT's `latents` or, for the token families, the token latents of
    `batch["tokens"]` (in the activation dtype, the noise cast to it). The
    token families add the rounding loss (Diffusion-LM): the fp32
    cross-entropy of x0_hat = (x_t - sigma eps_hat) / alpha against the
    token latents, weighted by alpha^2 and normalised by its mean. `rng` is
    a torch.Generator or the (t, noise) pair (`draw_t_noise`)."""
    _require(cfg, what="the diffusion loss")
    schedule = schedule or VPLinear()
    net = eps_network(cfg)

    def loss(params, batch, rng):
        if cfg.family == "dit":
            x0 = batch["latents"]
        else:
            x0 = params["token_latents"].to(cfg.activation_dtype)[
                batch["tokens"]]
        t, noise = draw_t_noise(schedule, x0, rng)
        x_t = q_sample(schedule, x0, t, noise)
        eps_hat = net(params, x_t, t, batch)
        # both widened first: a bf16 eps_hat would keep the difference bf16
        mse = torch.mean((eps_hat.to(torch.float32)
                          - noise.to(torch.float32)) ** 2)
        if cfg.family == "dit":
            return mse
        # the rounding loss anchors the latent space, weighted by alpha_t^2:
        # at high noise x0_hat amplifies the residual by 1 / alpha and the
        # unweighted cross-entropy is pure variance
        a, s = schedule.alpha_sigma_torch(t)
        bshape = (-1,) + (1,) * (x0.ndim - 1)
        x0_hat = (x_t - s.reshape(bshape) * eps_hat) / a.reshape(bshape)
        logits = torch.einsum("bsl,vl->bsv", x0_hat.to(torch.float32),
                              params["token_latents"].to(torch.float32))
        logp = torch.log_softmax(logits, dim=-1)
        ce = -torch.gather(logp, -1, batch["tokens"][..., None].long())
        w = (a * a).reshape(bshape)
        return mse + torch.mean(w * ce) / torch.mean(w)

    return loss


def ar_loss(cfg: ModelConfig) -> Callable:
    """(params, batch, rng) -> the autoregressive objective of the token
    families on batch["tokens"] and batch["targets"] (and a vlm's or an
    audio model's embeddings; `rng` is taken and not used):
    `transformer.lm_loss`, `hybrid.mamba_lm_loss`, `hybrid.zamba_lm_loss`,
    `vlm.vlm_loss` or `encdec.encdec_loss`. The dit family has no such
    objective (ValueError, as the reference's)."""
    if cfg.family == "dit":
        raise ValueError(f"the dit family has no autoregressive objective; "
                         f"arch {cfg.arch_id!r} trains with "
                         f"objective='diffusion'")
    _require(cfg, TOKEN_FAMILIES, "the autoregressive objective")
    lm_loss = _TOKEN_LMS[cfg.family].lm_loss

    def loss(params, batch, rng):
        return lm_loss(params["backbone"], cfg, batch["tokens"],
                       batch["targets"], *_cond(cfg, batch))

    return loss


def train_loss(cfg: ModelConfig, objective: str = "ar") -> Callable:
    return ar_loss(cfg) if objective == "ar" else diffusion_loss_fn(cfg)


# ---------------------------------------------------------------------------
# serving (token families)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cpu"):
    """The decode cache: the transformers' stacked KV caches, the SSM
    stack's per-layer states, the hybrid's states and one KV cache per
    invocation of its shared block (`models/hybrid.py`), the vlm's KV
    caches and image K/V (`models/vlm.py`). The audio family's comes from
    prefill only (ValueError, as the reference's)."""
    _require(cfg, TOKEN_FAMILIES, "the decode cache")
    return _TOKEN_LMS[cfg.family].init_cache(cfg, batch, max_len, device)


def prefill_fn(cfg: ModelConfig) -> Callable:
    """(params, batch, max_len) -> (last-position logits, cache); `batch`
    holds the prompts as "tokens" and a vlm's or an audio model's
    embeddings."""
    _require(cfg, TOKEN_FAMILIES, "prefill")
    prefill = _TOKEN_LMS[cfg.family].prefill

    def f(params, batch, max_len):
        return prefill(params["backbone"], cfg, batch["tokens"],
                       *_cond(cfg, batch), max_len)

    return f


def decode_fn(cfg: ModelConfig) -> Callable:
    """(params, cache, token (B, 1), pos) -> (logits, cache), the cache
    updated in place."""
    _require(cfg, TOKEN_FAMILIES, "decode")
    step = _TOKEN_LMS[cfg.family].decode_step

    def f(params, cache, token, pos):
        return step(params["backbone"], cfg, cache, token, pos)

    return f
