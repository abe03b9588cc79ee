#!/usr/bin/env python3
"""Training-step walls of the port on the card, to compare two checkouts
(or two backward bodies) on one card, one run after the other.

    python3 step_walls.py                      # this checkout's port
    python3 step_walls.py --src OTHER/src      # another checkout's port
    python3 step_walls.py --attention-bwd mma  # the attention backward held
                                               # to its mma.sync body
    python3 step_walls.py --runs dit-i256      # only the DiT's step
    python3 step_walls.py --runs none          # the kernel calls alone

Three steps through launch.train at full width, as chip_smoke.py's phases
10 (b), 12 (b) and 14 (e) run them: dit-i256's diffusion step (20 steps at
batch 8), qwen2-0.5b's AR step (20 at 8 x 512) and whisper-small's AR
step (10 at 8 x 384). Each prints the median wall after the first step
(host clock to a sync), the device-timeline split (CUDA events), and one
step under torch.profiler (device time by kind, the share of the wall with
no kernel running, each port kernel's time in the path). Then the
backward kernels' host cost a call (100 eager calls back to back) and
device time (100 calls in a CUDA graph) at the shapes those steps give
them, and the bf16 attention forward's device time at every bf16 shape of
PERF.md's kernel table. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

RUNS = [  # label, arch, objective, chip_smoke's settings, profiled step
    ("dit-i256 diffusion", "dit-i256", "diffusion",
     dict(steps=20, batch=8, seq=256), 10),
    ("qwen2-0.5b AR", "qwen2-0.5b", "ar", dict(steps=20, batch=8, seq=512),
     10),
    ("whisper-small AR", "whisper-small", "ar",
     dict(steps=10, batch=8, seq=384), 5),
]
# (label, B, Hq, Hkv, Sq, Skv, D, causal): the attention backward's shapes
# in those steps
ATTENTION = [("dit-i256", 8, 16, 16, 256, 256, 72, False),
             ("qwen2-0.5b AR", 8, 14, 2, 512, 512, 64, True),
             ("whisper encoder", 8, 12, 12, 1500, 1500, 64, False),
             ("whisper cross-attention", 8, 12, 12, 384, 1500, 64, False)]
# (label, B, Hq, Hkv, Sq, Skv, D, causal, window): the bf16 attention
# forward's shapes in PERF.md's kernel table (chip_smoke.py's phases 3, 11,
# 13 and 14)
FORWARD = [("dit-i256 serving", 16, 16, 16, 256, 256, 72, False, None),
           ("qwen2-0.5b prefill", 8, 14, 2, 512, 512, 64, True, None),
           ("qwen2-0.5b diffusion LM", 8, 14, 2, 64, 64, 64, False, None),
           ("granite prefill", 4, 24, 8, 256, 256, 64, True, None),
           ("olmo-1b prefill", 8, 16, 16, 512, 512, 128, True, None),
           ("window 64", 8, 14, 2, 300, 300, 64, True, 64),
           ("zamba2 prefill", 8, 32, 32, 512, 512, 112, True, None),
           ("zamba2 diffusion LM", 8, 32, 32, 64, 64, 112, True, None),
           ("whisper encoder", 8, 12, 12, 1500, 1500, 64, False, None),
           ("whisper cross-attention", 8, 12, 12, 384, 1500, 64, False,
            None),
           ("llama-vision prefill", 8, 64, 8, 512, 512, 128, True, None),
           ("llama-vision cross-attention", 8, 64, 8, 512, 1600, 128, False,
            None),
           ("whisper diffusion LM", 8, 12, 12, 64, 1500, 64, False, None),
           ("llama-vision diffusion LM", 8, 64, 8, 64, 1600, 128, False,
            None)]
# backward kernels of earlier checkouts, named so that a run of one (--src)
# splits its step's device time as this checkout's does
EARLIER_BWD_KERNELS = ("gate_bwd_kernel",)


def backward_calls(dev) -> dict:
    import chip_smoke
    from repro_torch.kernels.adaln_modulate import kernel as ak
    from repro_torch.kernels.flash_attention import kernel as fk

    g = torch.Generator(device=dev).manual_seed(0)

    def heads(B, S, H, D):
        return (torch.randn(B, S, H, D, generator=g, device=dev)
                .bfloat16().transpose(1, 2))

    out = {}
    for label, B, Hq, Hkv, Sq, Skv, D, causal in ATTENTION:
        q, do = heads(B, Sq, Hq, D), heads(B, Sq, Hq, D)
        k, v = heads(B, Skv, Hkv, D), heads(B, Skv, Hkv, D)
        _, lse, o32 = fk.flash_attention(q, k, v, causal=causal, lse=True)

        def call():
            return fk.flash_attention_bwd(q, k, v, o32, lse, do,
                                          causal=causal)
        out[f"flash_attention_bwd {label}"] = dict(
            body=fk.plan_bwd(q, k, v, do)["body"],
            host_call_ms=chip_smoke.host_call_ms(call),
            ms=chip_smoke.device_ms(call))
    x, gr, y = (torch.randn(8, 256, 1152, generator=g, device=dev)
                .bfloat16() for _ in range(3))
    mod6 = torch.randn(8, 6 * 1152, generator=g, device=dev).bfloat16()
    scale, gate = mod6[:, 1152:2304], mod6[:, 2304:3456]

    def mod():
        return ak.modulate_bwd(gr, x, scale)

    def gate_bwd():
        return ak.gate_residual_bwd(gr, gate, y)
    for name, call in (("adaln_modulate_bwd dit-i256", mod),
                       ("gate_residual_bwd dit-i256", gate_bwd)):
        out[name] = dict(host_call_ms=chip_smoke.host_call_ms(call),
                         ms=chip_smoke.device_ms(call))
    for label, B, Hq, Hkv, Sq, Skv, D, causal, window in FORWARD:
        q = heads(B, Sq, Hq, D)
        k, v = heads(B, Skv, Hkv, D), heads(B, Skv, Hkv, D)
        out[f"flash_attention {label}"] = dict(ms=chip_smoke.device_ms(
            lambda: fk.flash_attention(q, k, v, causal=causal,
                                       window=window)))
        del q, k, v
    for name, row in out.items():
        print(f"  {name}: {row}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the port's src directory (default: this one)")
    ap.add_argument("--attention-bwd", choices=("planned", "mma"),
                    default="planned")
    ap.add_argument("--runs", nargs="+", default=[r[1] for r in RUNS],
                    choices=[r[1] for r in RUNS] + ["none"],
                    help="the archs whose steps run (default: all three; "
                         "none: the kernel calls alone)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_walls.py: no CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk

    kind, names = chip_smoke.TRAIN_KINDS[0]
    chip_smoke.TRAIN_KINDS = ((kind, names + EARLIER_BWD_KERNELS),
                              ) + chip_smoke.TRAIN_KINDS[1:]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; port from {args.src}; attention backward "
          f"{args.attention_bwd}")
    build.build()
    dev = torch.device("cuda")
    body = (chip_smoke.bwd_body(fk, "mma") if args.attention_bwd == "mma"
            else contextlib.nullcontext())
    result = dict(card=smi, src=args.src, attention_bwd=args.attention_bwd,
                  steps={})
    with body:
        for label, arch, objective, shape, profile_at in RUNS:
            if arch not in args.runs:
                continue
            print(f"-- {label}")
            run = chip_smoke.token_train_run(dev, arch, objective, {},
                                             profile_at=profile_at, **shape)
            o = run["out"]
            prof = o["profile"] or {}
            result["steps"][label] = dict(
                median_step_s=o["median_step_s"], step_walls_s=o["step_walls_s"],
                phase_ms=o["phase_ms"], launches=o["launches"],
                profiled_wall_s=prof.get("wall_s"),
                idle_share_of_wall=prof.get("idle_share_of_wall"),
                device_busy_ms=prof.get("device_busy_ms"),
                by_kind=prof.get("by_kind"))
            del run
            chip_smoke.free_graphs()
        print("-- the kernels alone")
        result["calls"] = backward_calls(dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
