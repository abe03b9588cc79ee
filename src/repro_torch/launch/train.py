"""Training launcher (the port of `repro.launch.train`): the DiT's diffusion
objective and the token families' (dense, MoE, SSM, hybrid, vlm, audio) AR
and diffusion-LM objectives, on the card unless `device="cpu"` /
`--device cpu` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dit-cifar \\
        --objective diffusion --steps 20 --batch 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --objective ar --steps 20 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
        --objective diffusion --steps 20 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \\
        --full --objective ar --steps 20 --batch 8 --seq 384

On the card the forward runs through the port's kernels and their
backward kernels (each op's autograd Function): the DiT through adaLN,
gate_residual and attention, the token families through attention
(causal for the AR loss, bidirectional for the diffusion LM, GQA and
sliding windows as configured), zamba2's shared block through causal
attention for both, the vlm's cross-attention and the audio model's
encoder and cross-attention non-causal; the dense products, norms, activations, the MoE
dispatch, the Mamba2 blocks' SSD scan and the losses are plain torch under
autograd, as the
reference leaves them to XLA. Params stay fp32 masters: the models cast
each weight to the activation dtype at use, so gradients reach the
masters through the cast. The step runs eagerly (one CUDA graph of the
whole step is a later option, ROADMAP §A).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from ..checkpoint import ckpt
from ..configs.registry import get_config
from ..data.synthetic import (TokenStream, class_ids, frontend_embeds,
                              latent_images)
from ..engine.engine import resolve_device
from ..models import api
from ..optim import AdamW, tree_leaves, tree_map, warmup_cosine


def make_train_step(cfg, objective, opt):
    """step(params, opt_state, batch, rng) -> (params, opt_state, loss): the
    loss and its gradient by autograd, then `opt.update`. `params` are
    plain tensors; the step differentiates through leaf copies that share
    their storage and hands back new params that require no grad. A leaf
    the loss does not read (the diffusion head under the AR loss) gets a
    zero gradient, as jax.grad gives it."""
    loss_fn = api.train_loss(cfg, objective)

    def step(params, opt_state, batch, rng):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(leaves, batch, rng)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = dict(zip(map(id, flat), (
            torch.zeros_like(p) if g is None else g
            for p, g in zip(flat, grads))))
        grads = tree_map(lambda p: grads[id(p)], leaves)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return step


def build_batch_fn(cfg, batch_size, seq_len, seed=0, device="cpu"):
    """i -> the i-th batch on `device`, the reference's synthetic data
    (numpy, bit-equal): the DiT's latents and class ids as fp32 and int64
    tensors; the token families' `TokenStream` block (tokens, targets) as
    int64 tensors, with a vlm's or an audio model's stub embeddings of
    seed + i as fp32 tensors."""
    if cfg.family == "dit":
        def fn(i):
            return {"latents": torch.from_numpy(latent_images(
                        batch_size, cfg.patch_tokens, cfg.latent_dim,
                        seed + i)).to(device),
                    "class_ids": torch.from_numpy(class_ids(
                        batch_size, seed=seed + i)).long().to(device)}
        return fn
    stream = TokenStream(cfg.vocab_size, seq_len, batch_size, seed)

    def fn(i):
        b = {k: torch.from_numpy(v).long().to(device)
             for k, v in stream.block(i).items()}
        b.update({k: torch.from_numpy(v).to(device) for k, v in
                  frontend_embeds(cfg, batch_size, seed + i).items()})
        return b

    return fn


def train(arch: str, *, reduced=True, objective="ar", steps=100, batch=8,
          seq=128, lr=3e-4, ckpt_dir=None, ckpt_every=0, log_every=10,
          seed=0, log_file=None, device="cuda"):
    """Train from `api.init_params(cfg, seed)`; returns (params, history).

    The reference's arguments and defaults. Each diffusion step draws t and
    the noise from one torch.Generator seeded with `seed` on `device` (not
    the reference's jax.random numbers: parity runs monkeypatch
    `api.init_params` and the per-step `step_rng`); the AR loss draws
    nothing, and `step_rng` is called all the same. `history` holds
    {"step", "loss", "elapsed_s"} every `log_every` steps and at the last;
    a logged step reads its loss back. The params come back as plain
    tensors that require no grad, ready for `sample(params=...)`."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    params = api.init_params(cfg, seed, device)
    opt = AdamW(lr=warmup_cosine(lr, min(20, steps // 10 + 1), steps))
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, objective, opt)
    batch_fn = build_batch_fn(cfg, batch, seq, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    history = []
    t0 = time.time()
    for i in range(steps):
        params, opt_state, loss = step_fn(params, opt_state, batch_fn(i),
                                          step_rng(gen, i))
        if i % log_every == 0 or i == steps - 1:
            loss_v = float(loss)
            history.append({"step": i, "loss": loss_v,
                            "elapsed_s": round(time.time() - t0, 1)})
            print(f"step {i:5d} loss {loss_v:.4f}")
        if ckpt_dir and ckpt_every and i and i % ckpt_every == 0:
            ckpt.save(ckpt_dir, {"params": params}, step=i)
    if ckpt_dir:
        ckpt.save(ckpt_dir, {"params": params}, step=steps)
    if log_file:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        Path(log_file).write_text(json.dumps(history, indent=1))
    return params, history


def step_rng(gen: torch.Generator, i: int):
    """The draws of step i: the run's generator itself (the loss draws t,
    then the noise, from it)."""
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--objective", default="ar", choices=["ar", "diffusion"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    scale = ap.add_mutually_exclusive_group()
    scale.add_argument("--reduced", action="store_true",
                       help="reduced CPU-scale config (the default)")
    scale.add_argument("--full", action="store_true",
                       help="full config (default: reduced CPU-scale)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain PyTorch path")
    args = ap.parse_args(argv)
    train(args.arch, reduced=not args.full, objective=args.objective,
          steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          log_file=args.log_file, device=args.device)


if __name__ == "__main__":
    main()
