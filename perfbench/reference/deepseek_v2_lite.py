"""DeepSeek-V2-Lite (arXiv:2405.04434; the configuration file's published
keys) as a diffusion-LM eps-net, in plain fp32 PyTorch (TF32 off), and
unguided UniPC sampling over it.

    h   = x @ in_proj + silu(temb(1000 t) @ t_mlp1) @ t_mlp2
    per layer l:
        h += MLA(RMSNorm(h))
        h += SwiGLU(RMSNorm(h))                   (l < first_k_dense_replace)
          or sum over the top 6 experts e of p_e SwiGLU_e(RMSNorm(h))
             + SwiGLU_shared(RMSNorm(h))           (the MoE layers)
    eps = RMSNorm(h) @ out_proj

MLA, per head (no q LoRA):

    q = h W_q = [q_nope (128), q_pe (64)]
    c, k_pe = split(h W_kv_a, [512, 64]);  c = RMSNorm(c)
    kv = c W_kv_b = [k_nope (128), v (128)]
    q_pe, k_pe = YaRN-RoPE(q_pe), YaRN-RoPE(k_pe)   (k_pe one head, shared)
    o = softmax(([q_nope, q_pe] . [k_nope, k_pe]) * 192^-0.5 m^2) v,
        m = 0.1 mscale_all_dim ln(factor) + 1;  out = o W_o

YaRN as DeepSeek-V2 computes it: each inverse frequency theta^(-2i/64)
blended with a factor-th of it by a linear ramp over the dims between
the correction dims of beta_fast and beta_slow rotations of the original
4096 positions; cos and sin times mscale(mscale) / mscale(mscale_all_dim).
The router: softmax over the 64 experts of fp32 logits, the greedy top 6,
not renormalised (`norm_topk_prob` false), times `routed_scaling_factor`.
Every token reaches its 6 experts (a loop over the experts here). RMSNorm
eps `rms_norm_eps`. Attention is bidirectional over the positions 0..S-1.

Departures from the published model (the configuration's `assumed`): the
diffusion-LM head in place of the embedding and LM head (continuous
latents of 64 in and out, a timestep MLP of 256 sinusoidal features), and
the rope pairs (i, i + 32) of the 64 rope dims, where the released
weights pair (2i, 2i + 1). Generation is UniPC over the eps-net, not
autoregressive decoding. The weights are read in their stored dtype and
each layer's widened to fp32 where it is used.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import unipc
from .dit import no_tf32, timestep_features


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn(cfg: dict, S: int, device) -> tuple:
    """(cos, sin) of the rope heads at positions 0..S-1, (S, 32) each, and
    the softmax scale."""
    rs = cfg["rope_scaling"]
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    factor, orig = float(rs["factor"]), rs["original_max_position_embeddings"]
    i2 = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** i2
    inter = 1.0 / (factor * base ** i2)

    def corr_dim(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(corr_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    inv_freq = inter * ramp + extra * (1 - ramp)
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] \
        * inv_freq[None]
    m = (yarn_mscale(factor, rs["mscale"])
         / yarn_mscale(factor, rs["mscale_all_dim"]))
    scale = (cfg["qk_nope_head_dim"] + dim) ** -0.5
    if rs.get("mscale_all_dim"):
        scale *= yarn_mscale(factor, rs["mscale_all_dim"]) ** 2
    return torch.cos(ang) * m, torch.sin(ang) * m, scale


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (..., S, 64): each pair (i, i + 32) rotated by position's angle."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def f32(tree: dict, layer: int) -> dict:
    """One layer's weights of a stacked (L, ...) tree, widened to fp32."""
    return {k: f32(v, layer) if isinstance(v, dict)
            else v[layer].to(torch.float32) for k, v in tree.items()}


def mla(h, a, cfg, cos, sin, scale):
    R, S, _ = h.shape
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv = cfg["v_head_dim"]
    q = (h @ a["wq"]).reshape(R, S, H, dn + dr).transpose(1, 2)
    ckv = h @ a["wkv_a"]
    c = rms(ckv[..., :r], a["kv_norm"]["w"], cfg["rms_norm_eps"])
    kv = (c @ a["wkv_b"]).reshape(R, S, H, dn + dv).transpose(1, 2)
    q_pe = rope(q[..., dn:], cos, sin)
    k_pe = rope(ckv[..., r:], cos, sin)[:, None]          # (R, 1, S, 64)
    scores = (q[..., :dn] @ kv[..., :dn].transpose(-1, -2)
              + q_pe @ k_pe.transpose(-1, -2))
    p = torch.softmax(scores * scale, dim=-1)
    o = (p @ kv[..., dn:]).transpose(1, 2).reshape(R, S, H * dv)
    return o @ a["wo"]


def moe(x, m, cfg, record=None):
    """x (N, d): the routed experts' weighted sum, a loop over the experts,
    plus the shared experts. `record`, a list, gains each token's experts."""
    logits = x @ m["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"]:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    else:
        top_p = top_p * cfg["routed_scaling_factor"]
    if record is not None:
        record.append(top_i)
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel():
            out = swiglu(x[tok], m["w_gate"][e], m["w_up"][e],
                         m["w_down"][e])
            y.index_add_(0, tok, top_p[tok, slot, None] * out)
    s = m["shared"]
    return y + swiglu(x, s["w_gate"], s["w_up"], s["w_down"])


def eps(params: dict, cfg: dict, x: torch.Tensor, t: torch.Tensor,
        record=None) -> torch.Tensor:
    """x: (R, S, C) fp32 latents; t: (R,). Returns eps-hat (R, S, C) in
    fp32. `record`, a list, gains the experts of every MoE layer."""
    R, S, _ = x.shape
    eps_ = cfg["rms_norm_eps"]
    head = {k: v.to(torch.float32) for k, v in params["diffusion_head"].items()}
    bb = params["backbone"]
    cos, sin, scale = yarn(cfg, S, x.device)
    c = F.silu(timestep_features(t) @ head["t_mlp1"]) @ head["t_mlp2"]
    h = x @ head["in_proj"] + c[:, None]
    k = cfg["first_k_dense_replace"]
    for layer in range(cfg["num_hidden_layers"]):
        w = (f32(bb["dense_layers"], layer) if layer < k
             else f32(bb["layers"], layer - k))
        h = h + mla(rms(h, w["ln1"]["w"], eps_), w["attn"], cfg, cos, sin,
                    scale)
        hn = rms(h, w["ln2"]["w"], eps_)
        if layer < k:
            y = swiglu(hn, w["mlp"]["w_gate"], w["mlp"]["w_up"],
                       w["mlp"]["w_down"])
        else:
            y = moe(hn.reshape(R * S, -1), w["moe"], cfg,
                    record).reshape(R, S, -1)
        h = h + y
        del w
    h = rms(h, bb["final_ln"]["w"].to(torch.float32), eps_)
    return h @ head["out_proj"]


def sample(cfg: dict, params: dict, x_T: torch.Tensor, class_ids, w_cfg,
           solver: dict) -> torch.Tensor:
    """Unconditional UniPC sampling of the N latents x_T (N, S, C); returns
    them in float64."""
    no_tf32()
    N = x_T.shape[0]
    sched = unipc.schedule_of(solver)

    def x0_of(x, t):
        tt = torch.full((N,), t, dtype=torch.float32, device=x.device)
        e = eps(params, cfg, x.to(torch.float32), tt).to(torch.float64)
        return (x - sched.sigma(t) * e) / sched.alpha(t)

    with torch.no_grad():
        return unipc.sample(x0_of, x_T, solver)
