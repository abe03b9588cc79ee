"""DeepSeek-V2-Lite's weights in the port's layout, drawn on the device from
the seed, leaf by leaf and layer by layer (the largest draw in fp32 is one
layer's 64 experts of one projection, 0.74 GB), then held in the file's
param dtype: no fp32 copy of the model exists.

Only what the eps-net reads is drawn: the diffusion head and the backbone's
layers and final norm (no token embedding, LM head or token latents).
Every leaf is drawn, the norms' weights too (1 + N(0, 0.1)), and the
diffusion head's out_proj, which the port initialises to zero: with it at
zero every eps is zero and every comparison vacuous. A dense weight is
N(0, 1) / sqrt(fan_in); the router's too, so its logits are of order 1 and
its top 6 of 64 well spread.

    backbone   dense_layers (1, ...): ln1, attn, ln2, mlp {w_gate, w_up,
               w_down}; layers (26, ...): ln1, attn, ln2, moe {router,
               w_gate, w_up (E, d, f), w_down (E, f, d), shared {w_gate,
               w_up, w_down}}; final_ln
    attn       wq (d, H (nope + rope)), wkv_a (d, rank + rope), kv_norm,
               wkv_b (rank, H (nope + v)), wo (H v, d)
    diffusion_head  in_proj (C, d), t_mlp1 (256, d), t_mlp2 (d, d),
               out_proj (d, C)
"""

from __future__ import annotations

import math

import torch

NORM_SCALE = 0.1
TIMESTEP_FEATURES = 256


def make_params(cfg: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dt = getattr(torch, cfg["param_dtype"])
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    r, dn = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
    dr, dv = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    E, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs = cfg["n_shared_experts"] * f
    k = cfg["first_k_dense_replace"]
    L = cfg["num_hidden_layers"] - k
    C = cfg["latent_dim"]

    def draw(shape, scale, shift=0.0):
        """(n, *shape) in the param dtype, drawn one (*shape) slice at a
        time: N(shift, scale)."""
        out = torch.empty(shape, dtype=dt, device=device)
        for i in range(shape[0]):
            w = torch.randn(shape[1:], generator=gen, device=device,
                            dtype=torch.float32)
            out[i] = w.mul_(scale).add_(shift)
        return out

    def dense(n, fan_in, fan_out, lead=()):
        return draw((n,) + lead + (fan_in, fan_out), 1.0 / math.sqrt(fan_in))

    def norm(n, width):
        return {"w": draw((n, width), NORM_SCALE, 1.0)}

    def layers(n, moe):
        p = {
            "ln1": norm(n, d),
            "attn": {"wq": dense(n, d, H * (dn + dr)),
                     "wkv_a": dense(n, d, r + dr),
                     "kv_norm": norm(n, r),
                     "wkv_b": dense(n, r, H * (dn + dv)),
                     "wo": dense(n, H * dv, d)},
            "ln2": norm(n, d),
        }
        if moe:
            p["moe"] = {"router": dense(n, d, E),
                        "w_gate": dense(n, d, f, (E,)),
                        "w_up": dense(n, d, f, (E,)),
                        "w_down": dense(n, f, d, (E,)),
                        "shared": {"w_gate": dense(n, d, fs),
                                   "w_up": dense(n, d, fs),
                                   "w_down": dense(n, fs, d)}}
        else:
            width = cfg["intermediate_size"]
            p["mlp"] = {"w_gate": dense(n, d, width),
                        "w_up": dense(n, d, width),
                        "w_down": dense(n, width, d)}
        return p

    def one(shape, scale):
        return draw((1,) + shape, scale)[0]

    head = {"in_proj": one((C, d), 1.0 / math.sqrt(C)),
            "t_mlp1": one((TIMESTEP_FEATURES, d),
                          1.0 / math.sqrt(TIMESTEP_FEATURES)),
            "t_mlp2": one((d, d), 1.0 / math.sqrt(d)),
            "out_proj": one((d, C), 1.0 / math.sqrt(d))}
    backbone = {"dense_layers": layers(k, moe=False),
                "layers": layers(L, moe=True),
                "final_ln": {"w": draw((1, d), NORM_SCALE, 1.0)[0]}}
    return {"backbone": backbone, "diffusion_head": head}
