#!/usr/bin/env python3
"""Training-step walls of the port on the card, to compare two checkouts
(or two backward bodies) on one card, one run after the other.

    python3 step_walls.py                      # this checkout's port
    python3 step_walls.py --src OTHER/src      # another checkout's port
    python3 step_walls.py --attention-bwd mma  # the attention backward held
                                               # to its mma.sync body

Three steps through launch.train at full width, as chip_smoke.py's phases
10 (b), 12 (b) and 14 (e) run them: dit-i256's diffusion step (20 steps at
batch 8), qwen2-0.5b's AR step (20 at 8 x 512) and whisper-small's AR
step (10 at 8 x 384). Each prints the median wall after the first step
(host clock to a sync), the device-timeline split (CUDA events), and one
step under torch.profiler (device time by kind, the share of the wall with
no kernel running). Then the backward kernels' host cost a call (100 eager
calls back to back) and device time (100 calls in a CUDA graph) at the
shapes those steps give them. The last line is one JSON object.
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
    x, gr = (torch.randn(8, 256, 1152, generator=g, device=dev).bfloat16()
             for _ in range(2))
    scale = torch.randn(8, 6 * 1152, generator=g,
                        device=dev).bfloat16()[:, 1152:2304]

    def mod():
        return ak.modulate_bwd(gr, x, scale)
    out["adaln_modulate_bwd dit-i256"] = dict(
        host_call_ms=chip_smoke.host_call_ms(mod),
        ms=chip_smoke.device_ms(mod))
    for name, row in out.items():
        print(f"  {name}: {row}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the port's src directory (default: this one)")
    ap.add_argument("--attention-bwd", choices=("planned", "mma"),
                    default="planned")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_walls.py: no CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk

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
        print("-- the backward kernels alone")
        result["calls"] = backward_calls(dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
