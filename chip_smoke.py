#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (`src/repro_torch`).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits non-zero):
  1. device — the card, its power limit, torch/CUDA versions; TF32 off.
  2. build  — nvcc builds every kernel of the main path from `csrc/`.
  3. kernels — each kernel against its plain PyTorch version at the main
     path's shapes and at edge shapes, each case labelled with the body
     the wrapper's plan() chose, timed on the device (a CUDA graph of many
     calls, replayed between CUDA events) beside its bound, its plain
     version and one PyTorch library call; the wrapper's host cost per
     call is reported apart. adaln_modulate, gate_residual and the adaLN
     sites of quant_matmul are also timed on buffers rotated past the 50
     MB L2, as the main path finds them. unipc_update's sampler-row ops
     (predictor and corrector) are held bit-equal to their plain versions
     at fp32 at the main path's state, and a whole row with a stub eps-net is
     measured in three forms (the row ops; the earlier composition of torch
     ops around two combine launches, fed a host index; the plain-pinned
     row): launches, syncs and device ms per row from torch.profiler, host
     ms per row, and device ms in a CUDA graph where the row can be
     captured.
  4. main path — guided UniPC sampling of full-width dit-i256 (28 blocks,
     d_model 1152, 16 heads of dim 72, bf16 activations, fp32 params, the
     bf16 weights kept once) through `repro_torch.launch.sample.sample`,
     whose run is a CUDA graph (one eager warm-up row, the capture, one
     replay): launch counts of the call, kernel vs plain-pinned latents,
     wall and peak memory. Then one engine's graph against its eager loop:
     a replay alone counted (22 / 627 / 616 / 308 launches: captured x
     replays), its latents bit-equal to the eager loop's and to
     sample()'s, a later replay leaving an earlier result alone; the eager
     loop and one replay under torch.cuda.set_sync_debug_mode("error");
     the first-call (capture included), replay and eager walls, medians of
     5 in turns; torch.profiler's split (device time by kernel and kind,
     bfloat16_copy casts, share of the wall with no kernel running) of the
     eager loop and of the replay; the weights kept once against the
     per-use casts (latents bit-equal, bfloat16_copy launches, peak
     memory); a full-width eval_dtype="bfloat16" run within 1e-2 of the
     default path; and reduced-size card vs CPU checks (dit-i256, and
     qwen2-0.5b's diffusion LM).
  5. serving step — four requests admitted at staggered ticks into a
     per-slot `StepProgram` at full width (fp32 activations), and a fifth
     re-admitted into the slot the first one freed (over its stale eval
     ring and class id), through `step` (a host index) from its graph;
     the same requests and one with a NaN in its x_T through
     `step_flight` from its graph, the meta on the card and only the done
     mask read back (each within SERVE_TOL of its batch-1 uniform run,
     bit-equal to the eager step_flight, the NaN one DONE_NONFINITE); a
     bank of `default_tier_specs(cfg_scale=2.0)` serving tagged requests,
     each within SERVE_TOL of its tier's uniform run; one uniform run held
     against the plain-pinned path at fp32.
  6. quantized main path — phase 4's sampling with the w8a16 tier
     (`sample(quant="w8a16")` through its graph: 197 quant_matmul launches
     per eval), launch counts and kernel vs plain-pinned latents, drift
     from phase 4's latents, quantized weight bytes; one engine's replay
     counted (2167 quant_matmul launches) and bit-equal to its eager loop,
     its walls and profile split as in phase 4; w8a8 (calibrated on the
     card), fp8a16 and w4a16 at depth 4, each against its plain-pinned run;
     a w8a16 per-slot `StepProgram` at fp32 against its uniform runs.
  7. solver zoo — phase 4's run with DDIM + UniC-1, DPM-Solver++ 3M +
     UniC-3, PNDM + UniC-4 (K = 3: a ring of 4, six corrector terms),
     DEIS-3 + UniC-3 (a corrector base that is not the predictor's) and
     DPM-Solver 3S (noise prediction, the expanded grid: 9 rows + init,
     per-row out_scale, no corrector): the row ops bit-equal to their
     plain versions on each table at fp32; each engine's replay counted
     (2 row-op launches a row, the DiT's per-eval counts times the rows)
     and bit-equal to its eager loop, no host sync, its latents within
     MAIN_TOL of the plain-pinned run, the replay wall a median of 5; the
     python-loop references (sequential CFG) of DPM-Solver++ 3M + UniC and
     DPM-Solver 3S at NFE 12 against the engine at fp32 (<= LOOP_TOL); and
     `sample(solver="dpmpp", order=3)`, counted and bit-equal to an
     engine replay.
  8. serving at full width — dit-i256 (bf16, the weights kept once)
     served through `repro_torch.launch.serve.serve_diffusion`: (a) 8
     slots, UniPC-3, NFE 10, cfg 2.0, a `poisson_requests` trace of 24 at
     0.5 a tick, each with its own class: depths 1, 2 and 3 bit-identical
     (latents, completion order, tick metrics), 4 completions bit-equal
     to their own uniform runs, one tick's replay counted (one
     eval's 57 / 56 / 28 and 2 row ops), the depth-2 trace again under
     torch.cuda.set_sync_debug_mode("error") (the readback event waits
     turn it off by design), under torch.profiler, and the admission and
     readback ops timed, the readback's two copies also alone on the
     card; (b) cache_block 14, unguided: a plan with
     cache_depth all 0 bit-equal to the uncached program, a shallow plan
     finite and off the uncached run, its ticks counted (a shallow tick
     29 / 28 / 14) and both graphs' replays timed; (c) the depth-2 trace
     with a NaN and a desync fault, every latent bit-equal to (a)'s, the
     event ledger printed; (d) a short w8a16 trace, 197 quant_matmul a
     tick.
  9. observability and the tuner — dit-i256 at full width: (a) phase 8
     (a)'s depth-2 trace again through serve_diffusion with trace_out,
     metrics_out (a row every 8 ticks) and the probe (fraction 0.25 of
     the completions, at most 4, against UniPC-3 at NFE 64): latents,
     completion order and tick metrics bit-identical to phase 8 (a)'s
     untraced run, both artifacts valid, `obsreport --check` passing, each
     probe's discrepancy, the probe time kept out of the tick phases, at
     most one probe capture, one probe replay again alone under
     set_sync_debug_mode("error") (bit-equal discrepancy); the tracer's
     host-counter cost against DESIGN.md §15.5's 5% of a tick; the traced
     trace with the probe off under set_sync_debug_mode("error"). (b)
     `launch.tune.tune` with train_steps=0 at NFE 8, reference NFE 48,
     batch 4, budget 24, one round: one capture for the NFE, tuned <=
     baseline, three plans scored in a row (under sync debug mode) with
     terminal states bit-equal to engine.build replays of their tables,
     one candidate's launches counted, the walls. (c) the cached search
     at cache_block 14: at most two captures, the tuned plan and a forced
     shallow plan bit-equal to cached engine.build replays,
     evals_per_latent. (d) `sample(plan=)` on (b)'s plan from its JSON:
     launches counted, bit-equal to the engine replay of its table.
 10. training at full width — dit-i256 (28 blocks, bf16 activations over
     fp32 params, batch 8) through `repro_torch.launch.train`: (a) each
     backward kernel (adaln_modulate_bwd, gate_residual_bwd,
     flash_attention_bwd) against its plain version at the path's shapes
     and strided operands and at edge shapes (fp32 1e-5 relative L-inf,
     bf16 1e-2 relative L2), the attention forward with its log-sum-exp
     bit-equal to the forward without it, each timed as in phase 3 beside
     its bound, its plain version and a library yardstick; (b) `train`
     for 20 steps: every loss finite, launches exactly 57 / 56 / 28
     forward and backward a step, step walls, tokens/s, peak memory, one
     step under torch.profiler and the forward / backward / optimizer
     split by CUDA events; (c) one step's loss and every gradient leaf,
     kernels against plain-pinned on the same perturbed params and draws
     (bf16 full width <= 2e-2 relative L2, fp32 at 4 blocks <= 1e-4);
     (d) the full step twice, bit-equal; (e) the trained params through
     a checkpoint, bit-equal, then `launch.sample --ckpt`: bit-equal to
     sampling the in-memory params, 24 / 684 / 672 / 336 launches (a
     warm-up row and the replay) and a replay alone 22 / 627 / 616 / 308,
     no backward launch; (f) `launch.tune.tune` as in phase 9 (b) with
     train_steps=100 (the reference's default): finite losses, tuned <=
     baseline, printed beside phase 9 (b)'s random-weight search.
 11. the decoder-only token family at full width: (a) flash_attention at
     the token paths' shapes (qwen2-0.5b's prefill (8, 14, 512, 64) causal
     GQA 14/2 and diffusion LM (8, 14, 64, 64), granite's (4, 24, 256, 64)
     causal 24/8, olmo's (8, 16, 512, 128) causal, a window of 64 at S 300
     with GQA 7), bf16 <= 1e-2 and fp32 <= 1e-5 against the plain version,
     labelled with the body, the bf16 case timed in a CUDA graph beside its
     bound and SDPA with enable_gqa; unipc_update's row ops at the (8, 64,
     64) state, bit-equal at fp32. (b) qwen2-0.5b (24 layers, d_model 896,
     14/2 heads of 64, vocab 151936, bf16 over fp32 params, the weights
     kept once) through `repro_torch.launch.serve.serve`: batch 8, prompt
     512, 64 greedy tokens, exactly 24 flash_attention launches (the
     prefill) and none in a decode step; the decode loop again on the
     captured graph under set_sync_debug_mode("error"), bit-equal; the
     eager step's tokens bit-equal to the graph's; prefill ms, decode ms a
     token (replay and eager), tokens/s, peak memory beside their bounds,
     torch.profiler's split of the prefill and of a decode replay;
     prefill's last logits and the run's tokens teacher-forced through
     decode steps, bf16 kernels and bf16 plain-pinned each against the
     fp32 plain-pinned run (the kernels within 1e-2 of the plain run's own
     distance, the kernel-vs-plain distance printed), fp32 kernels against
     fp32 plain-pinned at full depth (<= 1e-4); at fp32 over 4 layers,
     prefill + decode against the forward (<= 1e-4). (c) its diffusion LM
     (out_proj perturbed) through `launch.sample.sample`, UniPC-3, NFE 10,
     batch 8, unguided: a replay counted (264 flash_attention, 22 row
     ops), bit-equal to the eager loop, no host sync, within 1e-2 of the
     plain-pinned run, replay and eager walls (medians of 5). (d)
     granite-moe-3b-a800m (32 layers, 40 experts top-8) served at batch
     4, prompt 256, 16 tokens: prefill ms and decode ms a token, a decode
     replay's profile, prefill held as in (b), fp32 decode vs forward over
     4 layers with no token dropped (<= 1e-4).
 12. training the token family at full width: (a) flash_attention_bwd at
     the token training shapes (qwen2-0.5b's AR step (8, 14, 512, 64)
     causal GQA 14/2 and its diffusion LM's bidirectional step at S 512
     and 128, granite's (4, 24, 256, 64) causal 24/8, a window of 64 at S
     300 with GQA 7) and the DiT's (8, 16, 256, 72), fp32 (<= 1e-5
     relative L-inf) and bf16 (<= 1e-2 relative L2) against the plain
     version, each twice bit-equal, labelled with its plan, the DiT case's
     output bit-equal to its pinned sha256 (fp32: the unmasked kernel's
     before masks and groups; bf16: re-pinned when the bf16 backward came
     to split P and dS and to read Delta from the fp32 output); the bf16
     cases timed
     in a CUDA graph beside the bound, the plain version and SDPA forward
     + backward with enable_gqa. (b) qwen2-0.5b (bf16 over fp32 params)
     through `launch.train.train` for 20 steps at batch 8 x 512, AR then
     diffusion: every loss finite, exactly 24 flash_attention and 24
     flash_attention_bwd launches a step, step walls, tokens/s, peak
     memory, the forward / backward / optimizer split and one step under
     torch.profiler. (c) one AR step's loss and every gradient leaf on
     perturbed params, bf16 kernels and bf16 plain-pinned each against the
     fp32 plain-pinned step (kernels within the plain run's own distance +
     1e-2); fp32 kernels vs plain-pinned over 4 layers for both objectives
     (<= 1e-4); the full step twice, bit-equal. (d)
     granite-moe-3b-a800m at full width and 8 of its 32 layers, batch 4 x
     256, 10 AR steps, counted and timed; the reduced dit-cifar (4 q / 2
     kv heads) trained on the card for 5 steps. (e) (b)'s trained
     diffusion LM through a checkpoint and `launch.sample --ckpt`
     (UniPC-3, NFE 10, batch 8): bit-equal to sampling the in-memory
     params, no backward launch.
 13. the SSM and hybrid token families at full width: (a) flash_attention
     at zamba2's head dim 112 (the ND 16 body), (8, 32, 512, 112) causal MHA
     (its prefill) and (8, 32, 64, 112) (its diffusion LM), and
     flash_attention_bwd at (8, 32, 512, 112) causal (its training step),
     held, timed and labelled as in 11 (a) / 12 (a), each twice bit-equal.
     (b) mamba2-780m (48 Mamba2 layers, d_model 1536, 48 SSD heads of 64,
     state 128) and (c) zamba2-7b (81 layers, d_model 3584, 112 SSD heads of
     64, state 64, one shared attention block of 32 heads of 112 after
     every 6 layers) served through `launch.serve.serve` at batch 8, prompt
     512, 64 greedy tokens as in 11 (b): no flash_attention launch for
     mamba2, exactly 13 a zamba2 prefill and none in a decode step; the
     decode loop again on the graph from a fresh prefill's state under
     set_sync_debug_mode("error"), bit-equal to eager; prefill, decode
     (replay and eager) and tokens/s beside their bounds; the bf16 parity
     as 11 (b), zamba2's step by step at 13 layers (BF16_STEP_LAYERS:
     every teacher-forced step within plain + 1e-2 of the fp32 run, the
     latents within 1e-2 of plain-pinned) and, beside that, at all 81
     layers and two param seeds (0, and SECOND_SEED with its latents) as a
     run (DEEP_BF16: prefill and latents within plain + 1e-2 of the fp32
     run, the teacher-forced steps' worst and mean), the rounded-P plain
     run's readings printed beside the plain run's; the fp32 kernels vs plain-pinned at every layer; fp32 prefill + decode vs
     the forward over 4 layers (mamba2) and two groups of two and a tail
     (zamba2). (d) both diffusion LMs through `launch.sample.sample` as
     11 (c): a replay counted (22 row ops; 143 flash_attention for
     zamba2, none for mamba2), bit-equal to the eager loop, no host sync,
     the latents as (b)'s gates hold them. (e)
     `launch.train.train`, AR then diffusion, 10 steps at batch 8 x 512:
     mamba2-780m at full depth, zamba2-7b at 13 of its 81 layers (two groups
     of six and a tail: all 81 with AdamW's moments need about 106 GB),
     launches exact (2 + 2 a zamba2 step, none for mamba2), walls,
     tokens/s, peak memory, the split and one profiled step; one zamba2 AR
     step's gradients as 12 (c) (fp32 over two groups of two and a tail),
     each arch's step twice bit-equal. (f) mamba2's trained diffusion LM
     through a checkpoint and `sample --ckpt`: bit-equal, no backward.
 14. the vlm and audio token families at full width: (a) flash_attention
     and flash_attention_bwd at whisper's encoder (8, 12, 1500, 64)
     non-causal (a ragged last tile) and its cross-attention 384 over 1500
     frames, llama-3.2-vision's causal GQA 64/8 (8, 64, 512, 128) and its
     cross-attention 512 over 1600 image tokens, and both diffusion LMs'
     64 queries over the frames / the image, held, timed and labelled as
     11 (a) / 12 (a), each twice bit-equal, with the bf16 outputs' share
     bit-equal to plain's. (b) whisper-small (12 + 12 layers, d_model 768,
     12 heads of 64, vocab 51865, 1500 stub frames) and (c)
     llama-3.2-vision-90b at 10 of its 100 layers (d_model 8192, 64/8 heads
     of 128, d_ff 28672, vocab 128256, 1600 stub image tokens, its
     cross-attention gates drawn from U(0.3, 0.9)) served through
     `launch.serve.serve` at batch 8 (prompts 384 / 512, 64 greedy tokens)
     as 11 (b): exactly 36 / 10 flash_attention launches a prefill and
     none in a decode step, the graph's decode loop under the sync check,
     eager tokens bit-equal, the walls beside their bounds, the bf16
     gates step by step at full depth, fp32 kernels vs plain-pinned, fp32
     prefill + decode vs the forward over a depth cut. (d) both diffusion
     LMs through engine.build with the stub embeddings in the eps-net's
     batch (launch.sample refuses these families, as the reference's
     fails there): a replay counted (22 row ops; 396 / 110
     flash_attention), bit-equal to eager, no host sync, the walls, the
     latents within 1e-2 of plain-pinned and held against the fp32 run.
     (e) whisper-small trained through `launch.train.train`, AR then
     diffusion, 10 steps at batch 8 x 384: 36 + 36 attention launches a
     step, walls, tokens/s, peak memory, the split, a profiled step; one
     step's gradients as 12 (c), the step twice bit-equal.
 15. the analysis layer (`analysis/roofline.py`, `analysis/opcount.py`,
     `launch/dryrun.py`): (a) one dit-i256 eval, one qwen2-0.5b prefill
     (8 x 512) and one dit-i256 training step at batch 8, each counted on
     the card (the count's kernels are those `LAUNCHES` shows launched)
     and on the meta device: FLOPs by dtype, compulsory bytes and kernel
     calls equal; (b) the main path's bound and share: phase 4's replay
     wall against the roofline of the same engine spec run once eagerly
     under the count, and its MFU (model FLOPs: evals x rows x 2 N_active
     x tokens with the adaLN projections once a row, over the replay wall
     at 989 TFLOP/s) beside the counted FLOPs' utilisation; (c) for the DiT
     sampling run and step, qwen2's prefill and step, whisper's prefill
     and step and llama-vision's prefill at 10 layers, the dry run's
     predicted peak beside `max_memory_allocated` over the same run (the
     ratio within [0.5, 2]), and the dry run's fits_80GB agreeing with the
     script's cuts (zamba2 trained at 13 of 81 layers, llama-vision not
     trained, deepseek-67b and mixtral-8x7b CPU-only).
Every bound the script prints comes from `analysis/roofline.py`: a kernel
case's from its op's `cost` (next to the wrapper), a path's from the
operation count of one eager call (`path_bound`).
The last three lines are the kernels JSON (each kernel's launches on the
main path, and since phase 8 its launches per serving tick and in the
serving run, since phase 9 in each of its four runs, since phase 10 in the
training run, since phase 11 in the token prefill, a decode step (0), a
diffusion-LM replay and granite's prefill, with the token attention cases'
and row ops' times, since phase 12 in the token training runs, with the
token backward cases' times, since phase 13 in the SSM and hybrid runs,
with the D 112 cases, since phase 14 in the vlm and audio runs, with the
cross-attention cases; the backward kernels' launches are phase 10's
training run's), the card's name and power limit as `nvidia-smi
--query-gpu=name,power.limit` prints them, and {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
MAIN_TOL = 1e-2     # bf16 eval bound (DESIGN.md §11.3)
# Two bf16 implementations differ by single-ulp roundings (2^-8 relative)
# of eps; guidance 2.0 takes 3 e_cond - 2 e_uncond (5x), and the latents'
# L-inf scale is |x_T| / alpha_T while eps enters as sigma / alpha_T times
# eps: the floor of the main path's kernel-vs-plain rel L-inf is about
# 5 * 2^-8 * max|eps| / max|x_T|. With out_proj at 0.02 N(0, 1) (eps std
# ~0.7) it measured 1.1e-2 with either attention body; at 0.01 the floor is
# about half the bound. A wrong kernel moves eps by O(1) of itself and the
# latents by far more than 1e-2; the fp32 checks hold the kernels at 1e-4.
OUT_PROJ_SCALE = 0.01
SERVE_TOL = 1e-4
SMALL_TOL = 1e-4


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def device_ms(fn, iters: int = 100, reps: int = 5) -> float:
    """Device ms per call: `iters` calls captured in one CUDA graph, the
    graph replayed `reps` times between CUDA events. No host cost is in the
    measurement (the Python/ctypes wrapper runs once, at capture). The
    working sets fit the 50 MB L2, as on the main path where each op reads
    what the previous one just wrote."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


def rotated_ms(fns, iters: int = 100, reps: int = 5) -> float:
    """device_ms of calls that take `fns` in turn: each works on its own
    buffers, and their working sets together exceed the 50 MB L2, so every
    call reads from HBM what the call before it did not touch, as on the
    main path, where an op reads what was written several kernels earlier
    (or, for a weight, a matrix no other call of the eval reads)."""
    turn = [0]

    def fn():
        fns[turn[0] % len(fns)]()
        turn[0] += 1
    return device_ms(fn, iters, reps)


def host_call_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean ms per call over `iters` eager back-to-back calls between CUDA
    events: for a kernel shorter than its wrapper's host cost this is the
    rate the host can launch at, not the kernel's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_device_ms(fn, iters: int = 20) -> float:
    """Median device ms of one `fn()` between CUDA events, each call queued
    behind a spin kernel so the events time the card's work and not the
    host's launches."""
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(cost) -> tuple:
    """(ms, "bytes" or "operations") of a kernel call's `cost` (the op's
    `cost*` next to its wrapper) on this card's roofline."""
    from repro_torch.analysis.roofline import kernel_bound

    return kernel_bound(cost)


def path_bound(fn, *args) -> dict:
    """The least time of one eager call `fn(*args)` on this card: the H100
    roofline of its operation count (`analysis/opcount.py`: the matmul
    operations by dtype, the compulsory bytes; each kernel by its op's
    cost), with what set it. The call runs once more for the count."""
    from repro_torch.analysis.opcount import analyze
    from repro_torch.analysis.roofline import Roofline

    acct = analyze(fn, *args)
    roof = Roofline(acct["flops_by_dtype"], acct["min_bytes"])
    return dict(bound_ms=roof.step_time_s * 1e3,
                bound_by="bytes" if roof.bottleneck == "memory"
                else "operations",
                flops=acct["flops"], flops_by_dtype=acct["flops_by_dtype"],
                min_bytes=acct["min_bytes"], kernels=acct["kernels"])


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def kernel_phase(dev) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.adaln_modulate import ops as adaln_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.unipc_update import ops as uni_ops

    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    out = {}

    def record(name, cases, timed):
        """cases: [(label, kernel_out, plain_out, dtype)]; timed: (kernel
        fn, plain fn, library fn or None, the op's cost of the call)."""
        errs = []
        for label, k_out, p_out, dt in cases:
            torch.cuda.synchronize()
            if not torch.isfinite(k_out.float()).all():
                fail(f"{name} [{label}]: non-finite kernel output")
            err = rel_err(k_out, p_out)
            abs_err = float((k_out.double() - p_out.double()).abs().max())
            print(f"  {name} [{label}] rel L-inf {err:.3e} (tol {TOL[dt]:g}) "
                  f"abs {abs_err:.3e}")
            if not err <= TOL[dt]:
                fail(f"{name} [{label}] disagrees with its plain version: "
                     f"rel {err:.3e} > {TOL[dt]:g}")
            errs.append((label, err, abs_err))
        k_fn, p_fn, lib_fn, cost = timed
        bms, by = bound(cost)
        out[name] = dict(
            max_abs_err=max(a for _, _, a in errs),
            max_rel_err=max(e for _, e, _ in errs),
            cases={label: e for label, e, _ in errs},
            ms=device_ms(k_fn), host_call_ms=host_call_ms(k_fn),
            plain_ms=device_ms(p_fn),
            library_ms=device_ms(lib_fn) if lib_fn is not None else None,
            bound_ms=bms, bound_by=by)

    # B1 unipc_update at the main path's state (8 requests, 256 x 32 fp32):
    # the predictor's 4 terms with (K,) weights, the corrector's 5 with
    # per-slot (K, B) weights, and a ragged bf16 case.
    t4 = randn(4, 8, 256, 32)
    w4 = randn(4)
    t5 = randn(5, 8, 256, 32)
    w5b = randn(5, 8)
    tr = randn(6, 3, 1000, dtype=torch.bfloat16)
    wr = randn(6, 3)
    cases = [
        ("main (K,) K=4 fp32", uni_ops.weighted_combine(t4, w4),
         uni_ops.weighted_combine(t4, w4, backend="plain"), torch.float32),
        ("per-slot (K,B) K=5 fp32", uni_ops.weighted_combine(t5, w5b),
         uni_ops.weighted_combine(t5, w5b, backend="plain"), torch.float32),
        ("ragged N=1000 bf16", uni_ops.weighted_combine(tr, wr),
         uni_ops.weighted_combine(tr, wr, backend="plain"), torch.bfloat16),
    ]
    record("unipc_update", cases, (
        lambda: uni_ops.weighted_combine(t4, w4),
        lambda: uni_ops.weighted_combine(t4, w4, backend="plain"),
        lambda: torch.einsum("k,kbtl->btl", w4, t4),
        uni_ops.cost_combine(t4, w4)))
    out["unipc_update"] = unipc_row_cases(dev, randn, out["unipc_update"])

    # B2/B3 at the dit-i256 block shape: net batch 16 (8 requests x CFG),
    # T = 256, D = 1152, bf16, conditioning read in place from the (B, 6D)
    # modulation vector as the DiT does. modulate's cases then cover each
    # body its plan() picks (printed beside the label): the fp32 width of
    # phase 5, dit-cifar, the reduced config, D = 72, rows of 1004 (no
    # 16-byte multiple), MAX_D, the final layer's (B, 2D) conditioning and
    # conditioning rows 2 bytes off alignment.
    from repro_torch.kernels.adaln_modulate import kernel as adaln_kernel

    B, T, D = 16, 256, 1152
    x = randn(B, T, D, dtype=torch.bfloat16)
    y = randn(B, T, D, dtype=torch.bfloat16)
    mod = randn(B, 6 * D, dtype=torch.bfloat16)
    sh, sc, gt = mod[:, :D], mod[:, D:2 * D], mod[:, 2 * D:3 * D]
    xr = randn(2, 37, 72)
    modr = randn(2, 2 * 72)

    def mod_body(x_, sh_, sc_, out_):
        p = adaln_kernel.plan(x_, sh_, sc_, out_)
        shape = (f"{p['chunks']} chunks a lane" if p["chunks"]
                 else "chunks looped")
        return (f"{p['body']}, {p['access_bytes']}-byte, {p['lanes']} "
                f"lanes a row, {shape}, {p['blocks']} blocks")

    def mod_case(label, b_, t_, d_, dtype, layout="dit"):
        """(label [body], kernel, plain, dtype) of modulate on a fresh x
        and conditioning laid out as `layout` (dit: (B, 6D); head: (B,
        2D); unaligned: [:, 1:D+1] and [:, D+1:2D+1] of (B, 2D+1))."""
        width, off = {"dit": (6 * d_, 0), "head": (2 * d_, 0),
                      "unaligned": (2 * d_ + 1, 1)}[layout]
        x_ = randn(b_, t_, d_, dtype=dtype)
        m_ = randn(b_, width, dtype=dtype)
        sh_, sc_ = m_[:, off:off + d_], m_[:, off + d_:off + 2 * d_]
        got = adaln_ops.modulate(x_, sh_, sc_)
        want = adaln_ops.modulate(x_, sh_, sc_, backend="plain")
        return f"{label} [{mod_body(x_, sh_, sc_, got)}]", got, want, dtype

    bf, f32 = torch.bfloat16, torch.float32
    main_got = adaln_ops.modulate(x, sh, sc)
    cases = [
        (f"main bf16 (16, 256, 1152) [{mod_body(x, sh, sc, main_got)}]",
         main_got, adaln_ops.modulate(x, sh, sc, backend="plain"), bf),
        mod_case("fp32 (16, 256, 1152)", 16, 256, 1152, f32),
        mod_case("dit-cifar bf16 (16, 64, 384)", 16, 64, 384, bf),
        mod_case("reduced fp32 (2, 37, 128)", 2, 37, 128, f32),
        mod_case("bf16 (2, 37, 72)", 2, 37, 72, bf),
        mod_case("fp32 (2, 37, 72)", 2, 37, 72, f32),
        mod_case("bf16 (4, 64, 1004)", 4, 64, 1004, bf),
        mod_case("bf16 (4, 64, 8192) MAX_D", 4, 64, 8192, bf),
        mod_case("head (B, 2D) bf16 (16, 256, 1152)", 16, 256, 1152, bf,
                 "head"),
        mod_case("unaligned mod[:, 1:D+1] bf16 (16, 256, 1152)", 16, 256,
                 1152, bf, "unaligned"),
    ]
    record("adaln_modulate", cases, (
        lambda: adaln_ops.modulate(x, sh, sc),
        lambda: adaln_ops.modulate(x, sh, sc, backend="plain"),
        None, adaln_ops.cost_modulate(x, sh, sc)))
    ln_ms = device_ms(lambda: F.layer_norm(x, (D,)))
    st = out["adaln_modulate"]
    st["body"] = mod_body(x, sh, sc, main_got)
    st["layer_norm_subset_ms"] = ln_ms
    print(f"  adaln_modulate main bf16 (16, 256, 1152) [{st['body']}]: "
          f"{st['ms']:.6f} ms (bound {st['bound_ms']:.6f} by "
          f"{st['bound_by']}; plain {st['plain_ms']:.6f}; host "
          f"{st['host_call_ms']:.4f})")
    # the same call on six sets of x, out and modulation (119 MB): no call
    # finds its operands in L2, as on the main path (in the graph above the
    # 9.4 MB operands stay in the 50 MB L2, and the time beats the bound)
    msets = [(randn(B, T, D, dtype=bf), randn(B, 6 * D, dtype=bf),
              torch.empty_like(x)) for _ in range(6)]
    mplan = adaln_kernel.plan(msets[0][0], msets[0][1][:, :D],
                              msets[0][1][:, D:2 * D], msets[0][2])
    st["rotated_ms"] = rotated_ms([
        (lambda a=a: adaln_kernel._launch_modulate(
            a[0], a[1][:, :D], a[1][:, D:2 * D], a[2], 1e-5, mplan))
        for a in msets])
    del msets
    print(f"  adaln_modulate main bf16 (16, 256, 1152), rotated over 119 MB: "
          f"{st['rotated_ms']:.6f} ms (bound {st['bound_ms']:.6f}; in the "
          f"graph {st['ms']:.6f})")
    x32 = x.float()      # phase 5's fp32 width, the same conditioning rows
    sh32, sc32 = mod.float()[:, :D], mod.float()[:, D:2 * D]
    st["fp32_ms"] = device_ms(lambda: adaln_ops.modulate(x32, sh32, sc32))
    st["fp32_bound_ms"] = bound(adaln_ops.cost_modulate(x32, sh32, sc32))[0]
    print(f"  adaln_modulate fp32 (16, 256, 1152) "
          f"[{mod_body(x32, sh32, sc32, x32)}]: {st['fp32_ms']:.6f} ms "
          f"(bound {st['fp32_bound_ms']:.6f})")
    print(f"  F.layer_norm(x, (1152,)) at the main shape: {ln_ms:.6f} ms -- "
          f"a subset of modulate's work (no scale/shift) moving the same "
          f"bytes, not its library_ms (null: no single call does it all)")
    # gate_residual at the main shape, the gate read in place from the
    # modulation; then each body plan_gate() picks, as modulate's cases
    def gate_body(r_, g_, y_, out_):
        p = adaln_kernel.plan_gate(r_, g_, y_, out_)
        shape = (f"{p['chunks']} chunks a lane" if p["chunks"]
                 else "chunks looped")
        return (f"{p['body']}, {p['access_bytes']}-byte, {p['lanes']} "
                f"lanes a row, {shape}, {p['blocks']} blocks")

    def gate_case(label, b_, t_, d_, dtype, layout="dit"):
        """(label [body], kernel, plain, dtype) of gate_residual on fresh
        operands: "dit" the gate as mod[:, 2D:3D] of a (B, 6D) tensor,
        "unaligned" as mod[:, 1:D+1] of (B, D+1), "rows" resid and y
        starting one element past an aligned address."""
        off = 1 if layout == "rows" else 0
        r_, y_ = (randn(b_ * t_ * d_ + off, dtype=dtype)[off:].view(
            b_, t_, d_) for _ in range(2))
        width, col = (d_ + 1, 1) if layout == "unaligned" else (6 * d_, 2 * d_)
        g_ = randn(b_, width, dtype=dtype)[:, col:col + d_]
        got = adaln_ops.gate_residual(r_, g_, y_)
        want = adaln_ops.gate_residual(r_, g_, y_, backend="plain")
        return f"{label} [{gate_body(r_, g_, y_, got)}]", got, want, dtype

    gate_got = adaln_ops.gate_residual(x, gt, y)
    cases = [
        (f"main bf16 (16, 256, 1152) [{gate_body(x, gt, y, gate_got)}]",
         gate_got, adaln_ops.gate_residual(x, gt, y, backend="plain"), bf),
        ("ragged T=37 D=72 fp32",
         adaln_ops.gate_residual(xr, modr[:, :72], xr * 0.5),
         adaln_ops.gate_residual(xr, modr[:, :72], xr * 0.5, backend="plain"),
         torch.float32),
        gate_case("fp32 (16, 256, 1152)", 16, 256, 1152, f32),
        gate_case("dit-cifar bf16 (16, 64, 384)", 16, 64, 384, bf),
        gate_case("reduced fp32 (2, 37, 128)", 2, 37, 128, f32),
        gate_case("bf16 (2, 37, 72)", 2, 37, 72, bf),
        gate_case("bf16 (4, 64, 1004)", 4, 64, 1004, bf),
        gate_case("bf16 (4, 64, 8192) MAX_D", 4, 64, 8192, bf),
        gate_case("unaligned gate mod[:, 1:D+1] bf16 (16, 256, 1152)", 16,
                  256, 1152, bf, "unaligned"),
        gate_case("rows 2 bytes off bf16 (16, 256, 1152)", 16, 256, 1152, bf,
                  "rows"),
        gate_case("rows 4 bytes off fp32 (4, 37, 1003)", 4, 37, 1003, f32,
                  "rows"),
    ]
    record("gate_residual", cases, (
        lambda: adaln_ops.gate_residual(x, gt, y),
        lambda: adaln_ops.gate_residual(x, gt, y, backend="plain"),
        lambda: torch.addcmul(x, gt[:, None], y),
        adaln_ops.cost_gate(x, gt, y)))
    st = out["gate_residual"]
    st["body"] = gate_body(x, gt, y, gate_got)
    # the same call on six sets of resid, y, out and modulation (170 MB):
    # no call finds its operands in L2, as on the main path
    sets = [(randn(B, T, D, dtype=bf), randn(B, 6 * D, dtype=bf)[:, 2 * D:3 * D],
             randn(B, T, D, dtype=bf), torch.empty_like(x)) for _ in range(6)]
    gplan = adaln_kernel.plan_gate(*sets[0])
    st["rotated_ms"] = rotated_ms([
        (lambda a=a: adaln_kernel._launch_gate(*a, gplan)) for a in sets])
    st["rotated_library_ms"] = rotated_ms([
        (lambda a=a: torch.addcmul(a[0], a[1][:, None], a[2], out=a[3]))
        for a in sets])
    del sets
    print(f"  gate_residual main bf16 (16, 256, 1152) [{st['body']}]: "
          f"graph {st['ms']:.6f} ms, rotated over 170 MB "
          f"{st['rotated_ms']:.6f} ms (bound {st['bound_ms']:.6f} by "
          f"{st['bound_by']}; addcmul graph {st['library_ms']:.6f}, rotated "
          f"{st['rotated_library_ms']:.6f}; plain {st['plain_ms']:.6f}; "
          f"host {st['host_call_ms']:.4f})")

    # B4 flash_attention at the dit-i256 shape: net batch 16, 16 heads,
    # S = 256, head dim 72, bf16, non-causal; q/k/v are head-major views of
    # (B, S, H, D) projections as in the model, and the same values
    # contiguous. Then ragged lengths, the masks and GQA at D = 64 and 72,
    # keys past a tile edge, the reduced config's fp32 GQA (D = 32), and
    # D = 36 (no multiple of 8: the bf16 body's 2-byte loads). Each label
    # names the body that served it (kernel.plan).
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    H, S, Dh = 16, 256, 72
    q, k, v = (randn(B, S, H, Dh, dtype=torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    bf = torch.bfloat16

    def fa_case(label, q_, k_, v_, causal, window=None):
        got = fa_ops.attention(q_, k_, v_, causal=causal, window=window)
        want = fa_ops.attention(q_, k_, v_, causal=causal, window=window,
                                backend="plain")
        p = fa_kernel.plan(q_, k_, v_, got)
        loads = "16-byte" if p["vec_in"] else "2-byte"
        body = (f"{p['body']}, D in {8 * p['chunks']}, {loads} loads"
                if p["body"] == "mma" else p["body"])
        return f"{label} [{body}]", got, want, q_.dtype

    cases = [
        fa_case("main bf16 D=72 strided views", q, k, v, False),
        fa_case("main bf16 D=72 contiguous", q.contiguous(), k.contiguous(),
                v.contiguous(), False),
    ]
    for s_len in (200, 257):
        cases.append(fa_case(f"bf16 D=72 S={s_len}",
                             *(randn(2, 4, s_len, 72, dtype=bf)
                               for _ in range(3)), False))
    for d in (64, 72):
        qd = randn(2, 4, 300, d, dtype=bf)
        kd, vd = (randn(2, 2, 300, d, dtype=bf) for _ in range(2))
        cases += [fa_case(f"bf16 D={d} GQA 4/2 S=300 causal", qd, kd, vd, True),
                  fa_case(f"bf16 D={d} GQA 4/2 S=300 window 40", qd, kd, vd,
                          False, 40),
                  fa_case(f"bf16 D={d} GQA 4/2 S=300 causal window 40", qd, kd,
                          vd, True, 40)]
    cases.append(fa_case("bf16 D=72 Sq=100 Skv=150 (off the key tile)",
                         randn(2, 4, 100, 72, dtype=bf),
                         randn(2, 4, 150, 72, dtype=bf),
                         randn(2, 4, 150, 72, dtype=bf), False))
    qg = randn(2, 4, 100, 32)
    kg, vg = randn(2, 2, 100, 32), randn(2, 2, 100, 32)
    cases += [fa_case("GQA 4/2 D=32 S=100 fp32", qg, kg, vg, False),
              fa_case("GQA causal window=40 fp32", qg, kg, vg, True, 40),
              fa_case("GQA causal D=36 S=100 bf16",
                      randn(2, 4, 100, 36, dtype=bf),
                      randn(2, 2, 100, 36, dtype=bf),
                      randn(2, 2, 100, 36, dtype=bf), True)]
    record("flash_attention", cases, (
        lambda: fa_ops.attention(q, k, v, causal=False),
        lambda: fa_ops.attention(q, k, v, causal=False, backend="plain"),
        lambda: F.scaled_dot_product_attention(q, k, v),
        fa_ops.cost(q, k, v, causal=False, window=None)))
    out["flash_attention"]["body"] = fa_kernel.plan(q, k, v, q)["body"]
    out["quant_matmul"] = quant_kernel_cases(dev, randn)
    return out


def composed_step(model_fn, tab: dict, *, sign: float):
    """The sampler row as the port composed it before its row ops: the row
    index copied from the host (a blocking copy), a gather per table
    column, torch ops for the weight columns, the differences, two terms
    copies, the blend and the ring rotation around two weighted_combine
    launches. Kept only as the yardstick of the row ops' launches and host
    time (phase 3); no path of the port runs it."""
    from repro_torch.kernels.unipc_update import ops as uni_ops

    col_keys = sorted(k for k in tab if k.startswith("mc_"))
    n_rows = tab["t"].shape[0]

    def step(carry, idx, model_kwargs=None):
        x, E = carry
        idx = torch.as_tensor(idx, device=x.device).long().clamp(0, n_rows - 1)
        per_slot = idx.ndim == 1
        row = {k: v[idx] for k, v in tab.items()}

        def wstack(base_x, base_m0, w_prev, w_new=None):
            scale = row["out_scale"][..., None] if per_slot else row["out_scale"]
            parts = [base_x[None], base_m0[None],
                     torch.movedim(sign * scale * w_prev, -1, 0)]
            if w_new is not None:
                parts.append((sign * row["out_scale"] * w_new)[None])
            return torch.cat(parts, dim=0)

        m0 = E[0]
        diffs = E[1:] - m0[None]
        extras = {k[3:]: row[k] for k in col_keys}
        terms = torch.cat([x[None], m0[None], diffs], dim=0)
        x_pred = uni_ops.weighted_combine(terms, wstack(
            row["base_x"], row["base_m0"], row["w_pred"]))
        e_new = model_fn(x_pred, row["t"], **extras).to(E.dtype)
        d_new = e_new - m0
        terms_c = torch.cat([terms, d_new[None]], dim=0)
        x_corr = uni_ops.weighted_combine(terms_c, wstack(
            row["base_x_c"], row["base_m0_c"], row["w_corr_prev"],
            row["w_corr_new"]))
        use_c = (row["use_c"].reshape((-1,) + (1,) * (x.ndim - 1))
                 if per_slot else row["use_c"])
        x_next = x_pred + use_c * (x_corr - x_pred)
        return x_next, torch.cat([e_new[None], E[:-1]], dim=0)

    return step


def row_profile(step, carry, index, n_rows: int, rows: int = 33) -> dict:
    """Launches, device ms and host syncs per row of `rows` eager rows of
    `step` (row j's index is index(j % n_rows)), from torch.profiler; and
    host ms per row, the same rows timed unprofiled on the host clock to a
    sync."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def loop():
        c = carry
        for j in range(rows):
            c = step(c, index(j % n_rows))
        return c

    loop()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / rows
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    syncs = [e for e in prof.events() if e.device_type == DeviceType.CPU
             and "StreamSynchronize" in e.name]
    return dict(launches_per_row=len(dev) / rows,
                copies_to_device_per_row=sum("HtoD" in e.name
                                             for e in dev) / rows,
                device_ms_per_row=sum(e.time_range.elapsed_us()
                                      for e in dev) / 1e3 / rows,
                stream_syncs_per_row=len(syncs) / rows,
                host_ms_per_row=host_ms,
                kinds=sorted({e.name[:60] for e in dev}))


def unipc_row_cases(dev, randn, combine: dict) -> dict:
    """The sampler-row ops (unipc_row_predict / unipc_row_correct) at the
    main path's state: dit-i256's 8 requests of 256 x 32 fp32 latents and
    the eval ring of the nfe 10, order 3, cfg 2.0 table (K + 1 = 3 slots),
    against their plain versions (fp32 bit-equal, bf16 <= 1e-2), timed in a
    CUDA graph beside their bounds; then one row with a stub eps-net in
    three forms (row_profile). `combine` is weighted_combine's record; the
    returned entry keeps it under "combine" and reports the row ops, which
    are what the main path launches, at its top level."""
    from repro_torch.core.coeffs import augment_step_rows
    from repro_torch.core.unipc import rows_on, step_fn_over_rows
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec, SamplerEngine
    from repro_torch.kernels.unipc_update import kernel as uni_kernel
    from repro_torch.kernels.unipc_update import ops as uni_ops

    tab = SamplerEngine(VPLinear(), eps=None, device=dev).compile(
        EngineSpec(nfe=10, order=3, cfg_scale=2.0))
    dtab = rows_on(augment_step_rows(tab), dev)
    rows = uni_ops.pack_weight_rows(dtab)
    sign, K, n_rows = tab.sign, tab.w_pred.shape[1], rows.shape[0]
    B, shape = 8, (8, 256, 32)
    x, e_new, x_pred = (randn(*shape) for _ in range(3))
    E = randn(K + 1, *shape)
    uniform = torch.tensor(5, device=dev)                  # a body row
    # idle on the init row, warm-up, body, last, past the table
    slots = torch.tensor([0, 1, 2, 3, 5, 8, 10, 40], device=dev)

    def plan_of(x_, E_, idx):
        args, bits = uni_kernel._row_args(x_, E_, rows, idx, sign,
                                          torch.empty_like(x_))
        p = uni_kernel._plan(bits, x_.element_size(), B, args.N, x_)
        return (f"{p['access_bytes']}-byte, {p['blocks_per_row']} x {B} "
                f"blocks of {p['threads']}")

    def unaligned(t):
        return randn(t.numel() + 1)[1:].view(t.shape)

    cases, errs = {}, []

    def check(label, got, want, bit_equal):
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            if not torch.isfinite(g_.float()).all():
                fail(f"unipc_update [{label}]: non-finite kernel output")
            err = rel_err(g_, w_)
            abs_err = float((g_.double() - w_.double()).abs().max())
            if bit_equal and not torch.equal(g_, w_):
                fail(f"unipc_update [{label}] is not bit-equal to its plain "
                     f"version at fp32: rel {err:.3e}")
            if not err <= TOL[torch.bfloat16]:
                fail(f"unipc_update [{label}] disagrees with its plain "
                     f"version: rel {err:.3e}")
            errs.append(abs_err)
            cases[label] = max(cases.get(label, 0.0), err)
        print(f"  unipc_update [{label}] "
              f"{'bit-equal' if bit_equal else f'rel L-inf {cases[label]:.3e} (tol 0.01)'}")

    operands = {"fp32": (x, E, e_new, x_pred),
                "bf16": tuple(t.bfloat16() for t in (x, E, e_new, x_pred)),
                "fp32 unaligned views": tuple(unaligned(t) for t in (
                    x, E, e_new, x_pred))}
    for name, (x_, E_, e_, xp_) in operands.items():
        for kind, idx in (("uniform row 5", uniform), ("per-slot", slots)):
            label = f"{{}} {name} {kind} (8, 256, 32) [{plan_of(x_, E_, idx)}]"
            check(label.format("predict"),
                  [uni_ops.unipc_row_predict(x_, E_, rows, idx, sign)],
                  [uni_ops.unipc_row_predict(x_, E_, rows, idx, sign,
                                             backend="plain")],
                  name != "bf16")
            check(label.format("correct"),
                  uni_ops.unipc_row_correct(x_, E_, e_, xp_, rows, idx, sign),
                  uni_ops.unipc_row_correct(x_, E_, e_, xp_, rows, idx, sign,
                                            backend="plain"),
                  name != "bf16")

    timed = {}
    for kind, idx in (("uniform", uniform), ("per-slot", slots)):
        for op, fn, cost in (
                ("predict", lambda b=None, i=idx: uni_ops.unipc_row_predict(
                    x, E, rows, i, sign, backend=b),
                 uni_ops.cost_predict(x, E, rows, idx)),
                ("correct", lambda b=None, i=idx: uni_ops.unipc_row_correct(
                    x, E, e_new, x_pred, rows, i, sign, backend=b),
                 uni_ops.cost_correct(x, E, e_new, x_pred, rows, idx))):
            bms, by = bound(cost)
            st = timed[f"{op} {kind}"] = dict(
                ms=device_ms(fn), plain_ms=device_ms(lambda f=fn: f("plain")),
                host_call_ms=host_call_ms(fn), bound_ms=bms, bound_by=by,
                plan=plan_of(x, E, idx))
            print(f"  unipc_update {op} {kind} fp32 (8, 256, 32), K = {K} "
                  f"[{st['plan']}]: {st['ms']:.6f} ms in the graph (bound "
                  f"{bms:.6f} by {by}, {bms / st['ms']:.0%}; plain "
                  f"{st['plain_ms']:.6f}; host {st['host_call_ms']:.4f})")

    # one row with a stub eps-net, three forms
    def stub(x_, t, **kw):
        return x_ * 0.5
    row_ids = torch.arange(n_rows, device=dev)
    forms = {
        "row ops (kernel, device index)": (
            step_fn_over_rows(stub, dtab, sign=sign), lambda j: row_ids[j]),
        "composed row (torch ops + 2 combine launches, host index)": (
            composed_step(stub, dtab, sign=sign), lambda j: j),
        "plain-pinned row (device index)": (
            step_fn_over_rows(stub, dtab, sign=sign, fused_update=False),
            lambda j: row_ids[j]),
    }
    row_forms = {}
    for label, (step, index) in forms.items():
        st = row_forms[label] = row_profile(step, (x, E), index, n_rows)
        if "host index" not in label:
            st["graph_ms_per_row"] = device_ms(lambda s_=step: s_((x, E),
                                                                  row_ids[5]))
        graph = (f"; {st['graph_ms_per_row']:.6f} ms in a CUDA graph"
                 if "graph_ms_per_row" in st else "; not capturable")
        print(f"  row with a stub eps-net, {label}: "
              f"{st['launches_per_row']:.2f} device activities "
              f"({st['copies_to_device_per_row']:.2f} host-to-device copies), "
              f"{st['stream_syncs_per_row']:.2f} cudaStreamSynchronize, "
              f"{st['device_ms_per_row']:.6f} device ms and "
              f"{st['host_ms_per_row']:.4f} host ms a row{graph}")
        print(f"    device activity: {', '.join(st['kinds'])}")

    pair = [timed["predict uniform"], timed["correct uniform"]]
    return dict(
        max_abs_err=max(errs + [combine["max_abs_err"]]),
        max_rel_err=max(list(cases.values()) + [combine["max_rel_err"]]),
        cases={**combine["cases"], **cases},
        body="one body, three operand modes: combine (weighted_combine), "
             "predict, correct",
        ms=sum(t["ms"] for t in pair) / 2,
        host_call_ms=sum(t["host_call_ms"] for t in pair) / 2,
        plain_ms=sum(t["plain_ms"] for t in pair) / 2,
        bound_ms=sum(t["bound_ms"] for t in pair) / 2, bound_by="bytes",
        library_ms=None,
        per_call_over="the main path's two launches a row (predict and "
                      "correct, uniform row, fp32 (8, 256, 32), K = 2); no "
                      "single PyTorch call forms a UniPC row",
        row_ops=timed, row_forms=row_forms,
        combine={k: combine[k] for k in ("ms", "host_call_ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by")})


# the quantized dense sites of one dit-i256 eval at the main path's net
# batch 16 x 256 tokens (d_model 1152, d_ff 4608): (site, M, K, N, calls
# per eval); 28 x (4 + 1 + 1 + 1) + 1 = 197
QUANT_SITES = [("wq/wk/wv/wo", 4096, 1152, 1152, 112),
               ("w1", 4096, 1152, 4608, 28), ("w2", 4096, 4608, 1152, 28),
               ("ada", 16, 1152, 6912, 28), ("final_ada", 16, 1152, 2304, 1)]
# M of the skinny body's edge cases: around its 8-, 16-, 32- and 64-row
# x tiles
SKINNY_MS = (1, 2, 15, 16, 17, 33, 64)


def quant_kernel_cases(dev, randn) -> dict:
    """B5 quant_matmul against its plain version: w8a16 (bf16 x, int8
    weights) at the five site shapes, each operand combination at the
    attention site and at ragged shapes, all through the op a model calls.
    Times (device ms) are of the kernel's own work on the operands the op
    hands it (for w8a8: activations already quantized, sa folded into the
    scale). Returns the kernel line's entry: per-call numbers averaged over
    one eval's 197 calls, and every site and case apart."""
    from repro_torch.kernels.quant_matmul import kernel as qmm_kernel
    from repro_torch.kernels.quant_matmul import ops as qmm_ops
    from repro_torch.kernels.quant_matmul import ref as qmm_ref
    from repro_torch.models.quant import quant_spec

    def operands(M, K, N, mode, x_dtype):
        spec = quant_spec(mode)
        x = randn(M, K, dtype=x_dtype)
        qw, ws = qmm_ref.quantize(randn(K, N), bits=spec.bits,
                                  granularity=spec.granularity, fmt=spec.fmt)
        sa = x.float().abs().amax() / 127.0 if spec.act_bits == 8 else None
        return x, qw, ws, sa

    def body_of(x, qw, ws, sa):
        p = qmm_kernel.plan(qmm_ref.fold_act(x, ws, sa)[0], qw)
        if p["body"] != "skinny":
            return p["body"]
        return (f"skinny, {p['m_tiles']} x-row tiles, split {p['split']}, "
                f"{p['grid']} blocks, {p['access_x']}/{p['access_w']}-byte "
                f"x/qw copies")

    token_sites = [(site, M, K, N) for site, M, K, N, _ in QUANT_SITES
                   if M > qmm_kernel.SKINNY_MAX_M]
    cases, errs = {}, []
    for label, M, K, N, mode, x_dtype in (
            [(f"{site} w8a16 bf16", M, K, N, "w8a16", torch.bfloat16)
             for site, M, K, N, _ in QUANT_SITES]
            + [(f"{site} {mode} bf16", M, K, N, mode, torch.bfloat16)
               for mode in ("w8a8", "fp8a16", "w4a16")
               for site, M, K, N in token_sites[1:]]
            # ragged M, N, K off every wgmma tile edge (128 x 144 x 64); then
            # qw rows of 1160 bytes, no multiple of 16: TMA cannot take them
            + [(f"ragged {mode} bf16 ({M},{K},{N})", M, K, N, mode,
                torch.bfloat16)
               for mode in ("w8a16", "w8a8")
               for M, K, N in ((4100, 1168, 1168), (4100, 1160, 1160))]
            + [(f"{mode} {'bf16' if dt == torch.bfloat16 else 'fp32'} "
                f"({M},{K},{N})", M, K, N, mode, dt)
               for mode, dt in (("w8a8", torch.bfloat16),
                                ("fp8a16", torch.bfloat16),
                                ("w4a16", torch.bfloat16),
                                ("w8a16", torch.float32),
                                ("w8a8", torch.float32),
                                ("fp8a16", torch.float32))
               for M, K, N in ((4096, 1152, 1152), (37, 130, 200),
                               (5, 130, 200), (100, 64, 48))]
            # the skinny body at M around its x-row tiles, N and K off its
            # 64-column strips and 32-row ring tiles, every tier
            + [(f"skinny M={M} {mode} bf16 ({M},1000,2000)", M, 1000, 2000,
                mode, torch.bfloat16)
               for M in SKINNY_MS
               for mode in ("w8a16", "w8a8", "fp8a16", "w4a16")]):
        x, qw, ws, sa = operands(M, K, N, mode, x_dtype)
        label = f"{label} [{body_of(x, qw, ws, sa)}]"
        k_out = qmm_ops.quant_matmul(x, qw, ws, sa=sa)
        p_out = qmm_ops.quant_matmul(x, qw, ws, sa=sa, backend="plain")
        torch.cuda.synchronize()
        if k_out.dtype != x_dtype or not torch.isfinite(k_out.float()).all():
            fail(f"quant_matmul [{label}]: dtype {k_out.dtype} / non-finite")
        err = rel_err(k_out, p_out)
        abs_err = float((k_out.double() - p_out.double()).abs().max())
        tol = TOL[x_dtype]
        print(f"  quant_matmul [{label}] rel L-inf {err:.3e} (tol {tol:g}) "
              f"abs {abs_err:.3e}")
        if not err <= tol:
            fail(f"quant_matmul [{label}] disagrees with its plain version: "
                 f"rel {err:.3e} > {tol:g}")
        cases[label] = err
        errs.append(abs_err)
    # byte copies: x rows 2 bytes off 16-byte alignment, qw rows of 1001
    # bytes, at the adaLN sites' M
    x_wide = randn(16, 1153, dtype=torch.bfloat16)
    qw_b, ws_b = qmm_ref.quantize(randn(1130, 1001))
    x_b = x_wide[:, 1:1131]
    label = (f"skinny byte copies w8a16 bf16 (16,1130,1001) "
             f"[{body_of(x_b, qw_b, ws_b, None)}]")
    k_out = qmm_ops.quant_matmul(x_b, qw_b, ws_b)
    p_out = qmm_ops.quant_matmul(x_b, qw_b, ws_b, backend="plain")
    torch.cuda.synchronize()
    err = rel_err(k_out, p_out)
    print(f"  quant_matmul [{label}] rel L-inf {err:.3e} (tol 0.01)")
    if not (err <= 1e-2 and torch.isfinite(k_out.float()).all()):
        fail(f"quant_matmul [{label}] disagrees with its plain version: "
             f"rel {err:.3e}")
    cases[label] = err
    errs.append(float((k_out.double() - p_out.double()).abs().max()))

    def timed(M, K, N, mode, x_dtype):
        """Device, host, plain and library ms and the bound of one call."""
        x, qw, ws, sa = operands(M, K, N, mode, x_dtype)
        x, scale = qmm_ref.fold_act(x, ws, sa)   # what the op hands the kernel
        out_dtype = x_dtype
        k_fn = lambda: qmm_kernel.quant_matmul(x, qw, scale,
                                               out_dtype=out_dtype)
        p_fn = lambda: qmm_ref.matmul(x, qw, scale).to(out_dtype)
        if x.dtype == torch.int8 and hasattr(torch, "_int_mm"):
            lib, lib_fn = "torch._int_mm", lambda: torch._int_mm(x, qw)
        else:
            w_wide = qw.to(torch.bfloat16 if x.dtype != torch.float32
                           else torch.float32)
            x_lib = x.to(w_wide.dtype)
            lib, lib_fn = "torch.matmul", lambda: torch.matmul(x_lib, w_wide)
        bms, by = bound(qmm_ops.cost(x, qw, scale, out_dtype))
        plan = qmm_kernel.plan(x, qw)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        res = dict(body=plan["body"], tile=plan["tile"],
                   tiles=plan["blocks"],
                   waves=plan.get("grid", plan["blocks"]) / sms,
                   ms=device_ms(k_fn), host_call_ms=host_call_ms(k_fn),
                   plain_ms=device_ms(p_fn), library_ms=device_ms(lib_fn),
                   library=f"{lib} on a weight widened beforehand; omits "
                           f"the widening and the scale",
                   bound_ms=bms, bound_by=by)
        if plan["body"] == "skinny" and x.dtype == torch.bfloat16:
            res.update(split=plan["split"], m_tiles=plan["m_tiles"],
                       grid=plan["grid"])
            # in the path every adaLN site reads a weight no other call of
            # the eval reads: time the call on weights rotated over 100 MB
            n_sets = -(-100_000_000 // nbytes(qw)) + 1
            sets = [qmm_ref.quantize(randn(K, N))[0] for _ in range(n_sets)]
            res["rotated_ms"] = rotated_ms([
                (lambda w=w: qmm_kernel.quant_matmul(
                    x, w, scale, out_dtype=out_dtype)) for w in sets])
            wides = [w.to(torch.bfloat16) for w in sets]
            res["rotated_library_ms"] = rotated_ms([
                (lambda w=w: torch.matmul(x_lib, w)) for w in wides])
            del sets, wides
        return res

    sites = {}
    for site, M, K, N, per_eval in QUANT_SITES:
        sites[site] = dict(M=M, K=K, N=N, calls_per_eval=per_eval,
                           **timed(M, K, N, "w8a16", torch.bfloat16))
        st = sites[site]
        skinny = (f", split {st['split']}, {st['grid']} blocks"
                  if "split" in st else "")
        print(f"  quant_matmul {site} ({M},{K},{N}) w8a16 [{st['body']}, tile "
              f"{st['tile'][0]}x{st['tile'][1]}, {st['tiles']} tiles{skinny} "
              f"= {st['waves']:.2f} waves]: {st['ms']:.5f} ms "
              f"(bound {st['bound_ms']:.5f} by {st['bound_by']}; plain "
              f"{st['plain_ms']:.5f}, {st['library']}: {st['library_ms']:.5f},"
              f" host {st['host_call_ms']:.4f})")
        if "rotated_ms" in st:
            print(f"  quant_matmul {site} on weights rotated over 100 MB: "
                  f"{st['rotated_ms']:.5f} ms (torch.matmul on widened "
                  f"weights rotated alike {st['rotated_library_ms']:.5f})")
    others = {}
    for mode, dt in (("w8a8", torch.bfloat16), ("fp8a16", torch.bfloat16),
                     ("w4a16", torch.bfloat16), ("w8a16", torch.float32)):
        key = f"{mode} {'bf16' if dt == torch.bfloat16 else 'fp32'} x"
        others[key] = timed(4096, 1152, 1152, mode, dt)
        print(f"  quant_matmul wq site {key}: {others[key]['ms']:.5f} ms "
              f"(bound {others[key]['bound_ms']:.5f}; plain "
              f"{others[key]['plain_ms']:.5f}; library "
              f"{others[key]['library_ms']:.5f})")
    calls = sum(st["calls_per_eval"] for st in sites.values())

    def per_call(key):
        return sum(st["calls_per_eval"] * st[key]
                   for st in sites.values()) / calls

    bodies = {}
    for site, st in sites.items():
        bodies.setdefault(st["body"], []).append(site)
    return dict(max_abs_err=max(errs), max_rel_err=max(cases.values()),
                body=", ".join(f"{b} ({' '.join(v)})" for b, v in bodies.items()),
                cases=cases, ms=per_call("ms"),
                host_call_ms=per_call("host_call_ms"),
                plain_ms=per_call("plain_ms"),
                library_ms=per_call("library_ms"),
                bound_ms=per_call("bound_ms"),
                bound_by=max(("bytes", "operations"), key=lambda b: sum(
                    st["calls_per_eval"] * st["bound_ms"]
                    for st in sites.values() if st["bound_by"] == b)),
                per_call_over="one dit-i256 eval's 197 calls at the main "
                              "path's site shapes (w8a16, bf16)",
                sites=sites, other_operands_at_wq_site=others)


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------


def perturbed_params(cfg, dev, seed=0):
    """init_params with the zero-initialised adaLN and output weights
    perturbed: under adaLN-zero the untrained DiT's output is otherwise
    exactly zero and every comparison vacuous. The adaLN weights get
    0.02 N(0, 1); out_proj gets OUT_PROJ_SCALE N(0, 1), which sets the eps
    scale (std ~ 34 x scale at d_model 1152)."""
    from repro_torch.models import api

    params = api.init_params(cfg, seed, dev)
    bb = params["backbone"]
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    for tree, key, scale in (
            (bb["blocks"], "ada", 0.02), (bb["blocks"], "ada_b", 0.02),
            (bb, "final_ada", 0.02), (bb, "final_ada_b", 0.02),
            (bb, "out_proj", OUT_PROJ_SCALE)):
        tree[key] = tree[key] + scale * torch.randn(
            tree[key].shape, generator=g, device=dev, dtype=tree[key].dtype)
    return params


def plain_pinned(cfg):
    """`cfg` with every kernel op pinned to its plain version."""
    return dataclasses.replace(cfg, attention_backend="plain",
                               adaln_backend="plain", quant_backend="plain")


def expected_launches(cfg, rows: int, quantized: bool = False) -> dict:
    """Kernel launches of `rows` guided rows of the DiT sampler: 2 combines
    per row; per eval 2L + 1 modulations, 2L gated residuals, L attentions
    and, quantized, 7L + 1 dense sites (wq, wk, wv, wo, w1, w2, ada per
    block, and final_ada)."""
    L = cfg.num_layers
    out = {"unipc_update": 2 * rows, "adaln_modulate": (2 * L + 1) * rows,
           "gate_residual": 2 * L * rows, "flash_attention": L * rows}
    if quantized:
        out["quant_matmul"] = (7 * L + 1) * rows
    return out


# substrings of device kernel names, by what runs them on the main path
KERNEL_KINDS = (
    ("port kernels", ("modulate_kernel", "gate_kernel", "attn_", "qmm_",
                      "unipc_row_kernel")),
    ("matmul (torch.matmul / cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet",
                                        "sm90_")),
    ("copies and casts (fp32 -> bf16 weights, .to, cat)",
     ("copy", "memcpy", "catarray")),
)


def kernel_kind(name: str, kinds=KERNEL_KINDS) -> str:
    for kind, keys in kinds:
        if any(k in name.lower() for k in keys):
            return kind
    return "other (elementwise, reductions, memset)"


# a training step's kernels: the backward kernels first ("attn_" would
# take attention's)
TRAIN_KINDS = (
    ("backward kernels (port)", ("modulate_bwd_kernel", "gate_bwd_kernel",
                                 "column_sum_kernel", "attn_bwd_")),
    ("forward kernels (port)", ("modulate_kernel", "gate_kernel", "attn_")),
) + KERNEL_KINDS[1:]


def train_kind(name: str) -> str:
    return kernel_kind(name, TRAIN_KINDS)


def profile_split(fn, top: int = 12, kind=kernel_kind) -> dict:
    """Run `fn` once under torch.profiler with CUDA activity and split the
    device time: the top kernels by summed time with their counts, the sum
    by `kind` (a kernel name -> its kind), the `bfloat16_copy` casts, the sum of all device activity, the
    wall (host clock to a sync, with the profiler's own cost inside) and the
    share of the wall with no device activity (the union of kernel
    intervals against the wall). Returns {} if the profiler recorded no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        print("  profiler: no device activity recorded (split not measured)")
        return {}
    by_name: dict = {}
    for name, start, end in spans:
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + end - start)
    total_ms = sum(us for _, us in by_name.values()) / 1e3
    busy_us, reach = 0.0, float("-inf")   # union of the intervals
    for _, start, end in sorted(spans, key=lambda sp: sp[1]):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    kinds: dict = {}
    for name, (n, us) in by_name.items():
        k = kinds.setdefault(kind(name), [0, 0.0])
        k[0] += n
        k[1] += us / 1e3
    casts = [(n, us) for name, (n, us) in by_name.items()
             if "bfloat16_copy" in name]
    bf16_copies = sum(n for n, _ in casts)
    bf16_copy_ms = sum(us for _, us in casts) / 1e3
    idle = 1.0 - busy_us / 1e3 / (wall * 1e3)
    print(f"  profiled run: wall {wall:.4f} s (profiler on), device "
          f"activity {total_ms:.3f} ms summed, {busy_us / 1e3:.3f} ms as a "
          f"union; no kernel running for {idle:.1%} of the wall; "
          f"bfloat16_copy {bf16_copies} launches, {bf16_copy_ms:.3f} ms")
    for kind, (n, ms) in sorted(kinds.items(), key=lambda kv: -kv[1][1]):
        print(f"    {kind}: {ms:.3f} ms in {n} launches "
              f"({ms / total_ms:.1%} of device time)")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    for name, (n, us) in ranked:
        print(f"    {us / 1e3:9.3f} ms {n:6d}x  {name[:100]}")
    port = sorted(((name, n, us) for name, (n, us) in by_name.items()
                   if kernel_kind(name) == "port kernels"
                   or train_kind(name).startswith("backward")),
                  key=lambda k: -k[2])
    for name, n, us in port:
        print(f"    port kernel in the path: {us / 1e3:.3f} ms in {n} = "
              f"{us / 1e3 / n:.5f} ms a call  {name[:80]}")
    return dict(wall_s=wall, device_ms_sum=total_ms,
                device_busy_ms=busy_us / 1e3, idle_share_of_wall=idle,
                bfloat16_copy_launches=bf16_copies,
                bfloat16_copy_ms=bf16_copy_ms,
                by_kind={k: dict(launches=n, ms=ms)
                         for k, (n, ms) in kinds.items()},
                top=[dict(name=name[:200], launches=n, ms=us / 1e3)
                     for name, (n, us) in ranked],
                port_kernels=[dict(name=name[:200], launches=n, ms=us / 1e3,
                                   ms_per_call=us / 1e3 / n)
                              for name, n, us in port])


def median_walls(fns: dict, reps: int = 5) -> dict:
    """Each of `fns` (name -> callable) `reps` times, in turns (a, b, c,
    a, b, c, ...), each timed on the host clock to a sync; the median and
    every repetition, in seconds."""
    walls = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    return {name: dict(median_s=float(np.median(w)), reps_s=w)
            for name, w in walls.items()}


@contextlib.contextmanager
def per_use_casts():
    """`build_engine` without the weights kept once: every fp32 weight is
    cast to the activation dtype at each use, as before they were kept."""
    from repro_torch.models import api

    kept = api.cast_weights_once
    api.cast_weights_once = lambda cfg, params: params
    try:
        yield
    finally:
        api.cast_weights_once = kept


def free_graphs():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def graph_checks(label: str, engine, spec, x_T, expected: dict,
                 counts_out: dict) -> dict:
    """The CUDA graph of one engine's sampling run against its eager loop:
    the first call (one eager warm-up row, the capture, a replay) and then a
    replay alone, counted (the replay's counts go to `counts_out` and must
    be `expected` exactly); the replay's latents bit-equal to the eager
    run's, and a second replay on other inputs leaves the first result
    alone. Returns the run functions and the results."""
    from repro_torch.kernels.dispatch import LAUNCHES

    run, eager = engine.build(spec), engine.build(spec, jit=False)
    LAUNCHES.clear()
    x_first = run(x_T)
    torch.cuda.synchronize()
    first_counts = dict(LAUNCHES)
    LAUNCHES.clear()
    x_graph = run(x_T)
    torch.cuda.synchronize()
    counts_out.update(LAUNCHES)
    print(f"  {label}: launches of one replay {dict(sorted(counts_out.items()))}"
          f" expected {expected}; the first call (a warm-up row, the "
          f"capture, a replay) {dict(sorted(first_counts.items()))}")
    if dict(counts_out) != expected:
        fail(f"{label}: replay launch counts {dict(counts_out)} != "
             f"{expected}")
    LAUNCHES.clear()
    x_eager = eager(x_T)
    torch.cuda.synchronize()
    if dict(LAUNCHES) != expected:
        fail(f"{label}: eager launch counts {dict(LAUNCHES)} != {expected}")
    kept = x_graph.clone()
    other = run(torch.flip(x_T, dims=(0,)))
    torch.cuda.synchronize()
    same = (torch.equal(x_graph, x_eager) and torch.equal(x_first, x_eager)
            and torch.equal(x_graph, kept)
            and not torch.equal(other, x_graph))
    print(f"  {label}: replay vs eager latents bit-equal: {same}; max abs "
          f"{float((x_graph - x_eager).abs().max()):.3e}")
    if not same:
        fail(f"{label}: the CUDA graph replay differs from the eager run")
    return dict(run=run, eager=eager, x_graph=x_graph, x_eager=x_eager,
                first_call_counts=first_counts)


def main_path_phase(dev, counts_out: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.sample import build_engine, latent_shape, sample

    batch, nfe, order, g_scale = 8, 10, 3, 2.0
    rows = nfe + 1
    cfg = get_config("dit-i256")
    assert cfg.dtype == "bfloat16" and cfg.head_dim == 72
    params = perturbed_params(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    x_T = torch.randn(latent_shape(cfg, batch), generator=gen, device=dev)
    spec = EngineSpec(nfe=nfe, order=order, cfg_scale=g_scale)
    expected = expected_launches(cfg, rows)
    warm = expected_launches(cfg, 1)

    # every op pinned to its plain version, same params and x_T, eager
    engine = build_engine(plain_pinned(cfg), params, VPLinear(), batch,
                          seed=0, device=dev)
    LAUNCHES.clear()
    x_plain = engine.build(dataclasses.replace(spec, fused_update=False),
                           jit=False)(x_T)
    torch.cuda.synchronize()
    if sum(LAUNCHES.values()):
        fail(f"the plain-pinned run launched kernels: {dict(LAUNCHES)}")
    del engine

    # the main path, through the user's entry point: its engine captures
    # the run (after one eager warm-up row) and replays it once
    free_graphs()
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x0 = sample("dit-i256", reduced=False, nfe=nfe, order=order,
                cfg_scale=g_scale, batch=batch, params=params, x_T=x_T,
                device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sample_counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    want = {k: expected[k] + warm[k] for k in expected}
    print(f"  sample(): launches {dict(sorted(sample_counts.items()))} = one "
          f"eager warm-up row {warm} + one replay {expected}")
    if sample_counts != want:
        fail(f"sample() launch counts {sample_counts} != {want}")
    if x0.shape != tuple(x_T.shape) or not np.isfinite(x0).all():
        fail(f"main path output shape {x0.shape} / finite "
             f"{np.isfinite(x0).all()}")
    err = rel_err(torch.as_tensor(x0), x_plain.cpu())
    print(f"  kernel vs plain latents: rel L-inf {err:.3e} (tol {MAIN_TOL:g})")
    if not err <= MAIN_TOL:
        fail(f"main path latents disagree with the plain path: {err:.3e}")
    print(f"  sample() wall {wall:.3f} s for {batch} requests (first call: "
          f"capture included); peak memory {peak / 2**30:.2f} GiB")

    # one engine's graph: the replay alone, counted, against its eager loop
    free_graphs()
    engine = build_engine(cfg, params, VPLinear(), batch, seed=0, device=dev)
    g = graph_checks("main path", engine, spec, x_T, expected, counts_out)
    run, eager = g["run"], g["eager"]
    if not torch.equal(g["x_graph"].cpu(), torch.as_tensor(x0)):
        fail("sample()'s latents differ from the same engine's replay")

    # any host sync is an error: the eager row loop, then one replay
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x_nosync = eager(x_T)
        x_nosync_graph = run(x_T)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not (torch.equal(x_nosync, g["x_eager"])
            and torch.equal(x_nosync_graph, g["x_graph"])):
        fail("the sync-checked runs differ from the counted ones")
    print(f"  eager row loop and one replay under "
          f"set_sync_debug_mode('error'): {rows} rows, no host sync, latents "
          f"bit-equal to the counted runs")

    # walls: the first call (a new engine: weights kept once, table, warm-up
    # row, capture, replay), the steady replay and the eager loop, in turns
    def first_call():
        e = build_engine(cfg, params, VPLinear(), batch, seed=0, device=dev)
        e.build(spec)(x_T)

    walls = median_walls({"first_call": first_call,
                          "replay": lambda: run(x_T),
                          "eager": lambda: eager(x_T)})
    free_graphs()
    for name, w in walls.items():
        print(f"  wall {name}: median {w['median_s']:.4f} s of "
              f"{[round(v, 4) for v in w['reps_s']]} ({batch} requests)")

    # where the time goes: the eager loop and the replay under the profiler
    # (outside the timed walls)
    print("  profile of the eager loop:")
    split_eager = profile_split(lambda: eager(x_T))
    print("  profile of the replay:")
    split_graph = profile_split(lambda: run(x_T))
    del run, eager, g, engine

    # the weights kept once against the per-use casts: bit-equal latents,
    # the casts' launches and the peak memory of an eager run of each
    kept = {}
    for form in ("per_use", "kept_once"):
        free_graphs()
        torch.cuda.reset_peak_memory_stats(dev)
        with (per_use_casts() if form == "per_use"
              else contextlib.nullcontext()):
            e = build_engine(cfg, params, VPLinear(), batch, seed=0,
                             device=dev)
        eager_f = e.build(spec, jit=False)
        x_f = eager_f(x_T)
        torch.cuda.synchronize()
        kept[form] = dict(peak_bytes=torch.cuda.max_memory_allocated(dev),
                          latents=x_f)
        print(f"  weights {form}:")
        kept[form]["profile"] = profile_split(lambda: eager_f(x_T))
        del e, eager_f
    if not torch.equal(kept["per_use"]["latents"], kept["kept_once"]["latents"]):
        fail("the weights kept once change the latents")
    for form in kept:
        kept[form].pop("latents")
        prof = kept[form]["profile"]
        print(f"  weights {form}: bfloat16_copy "
              f"{prof.get('bfloat16_copy_launches', 'not measured')} "
              f"launches, peak memory "
              f"{kept[form]['peak_bytes'] / 2**30:.2f} GiB")
    print("  weights kept once vs cast at use: latents bit-equal")

    # the fast serving eval: every weight and activation in bf16
    free_graphs()
    x_bf16 = sample("dit-i256", reduced=False, nfe=nfe, order=order,
                    cfg_scale=g_scale, batch=batch, params=params, x_T=x_T,
                    eval_dtype="bfloat16", device=dev)
    bf16_err = rel_err(torch.as_tensor(x_bf16), torch.as_tensor(x0))
    print(f"  eval_dtype='bfloat16' vs the default path: rel L-inf "
          f"{bf16_err:.3e} (tol {MAIN_TOL:g})")
    if not (np.isfinite(x_bf16).all() and bf16_err <= MAIN_TOL):
        fail(f"the bf16-eval run disagrees with the default path: "
             f"{bf16_err:.3e}")

    # a small input through the kernels on the card and the plain path on
    # the CPU: the reduced config (fp32, GQA 4/2, head dim 32)
    free_graphs()
    small = get_config("dit-i256").reduced()
    sp = perturbed_params(small, "cpu", seed=3)
    xs = torch.randn(latent_shape(small, 2), generator=torch.Generator(
        device="cpu").manual_seed(5))
    on_card = sample("dit-i256", reduced=True, nfe=5, order=3, cfg_scale=2.0,
                     batch=2, params=sp, x_T=xs, device=dev)
    on_cpu = sample("dit-i256", reduced=True, nfe=5, order=3, cfg_scale=2.0,
                    batch=2, params=sp, x_T=xs, device="cpu")
    small_err = rel_err(torch.as_tensor(on_card), torch.as_tensor(on_cpu))
    print(f"  reduced dit-i256, card kernels vs CPU plain: rel L-inf "
          f"{small_err:.3e} (tol {SMALL_TOL:g})")
    if not small_err <= SMALL_TOL:
        fail(f"reduced-size card vs CPU disagree: {small_err:.3e}")
    # and one token config: the reduced qwen2-0.5b's diffusion LM (fp32,
    # GQA 4/2, rope), out_proj perturbed
    from repro_torch.models import api

    tsmall = get_config(TOKEN_ARCH).reduced()
    tp = api.init_params(tsmall, 3, "cpu")
    tp["diffusion_head"]["out_proj"] = 0.05 * torch.randn(
        tp["diffusion_head"]["out_proj"].shape,
        generator=torch.Generator().manual_seed(4))
    xt = torch.randn(latent_shape(tsmall, 2),
                     generator=torch.Generator().manual_seed(5))
    tok_card, tok_cpu = (sample(TOKEN_ARCH, reduced=True, nfe=5, order=3,
                                batch=2, params=tp, x_T=xt, device=d)
                         for d in (dev, "cpu"))
    tok_err = rel_err(torch.as_tensor(tok_card), torch.as_tensor(tok_cpu))
    print(f"  reduced {TOKEN_ARCH} diffusion LM, card kernels vs CPU plain: "
          f"rel L-inf {tok_err:.3e} (tol {SMALL_TOL:g})")
    if not tok_err <= SMALL_TOL:
        fail(f"reduced-size token card vs CPU disagree: {tok_err:.3e}")
    return dict(sample_wall_s=wall, sample_launches=sample_counts,
                sample_peak_bytes=peak, rel_err_vs_plain=err, rows=rows,
                walls=walls, profile_eager=split_eager,
                profile_replay=split_graph, weights=kept, bf16_eval_rel_err=bf16_err,
                small_rel_err=small_err, small_token_rel_err=tok_err,
                latents=x0)


# --------------------------------------------------------------------------
# phase 5: the serving step
# --------------------------------------------------------------------------


def run_slots(program, reqs, slots: int, dev):
    """Drive a per-slot StepProgram's `step` with a host index: each request
    of `reqs` (dicts with rid, arrival, g, x_T, cls) is admitted at its
    arrival tick into the first free slot, and every slot steps by its own
    row (idle slots park on row 0) until all have finished. Sets r["slot"]
    and r["reused"]; returns ({rid: latent}, ticks)."""
    state = program.init_state(slots, tuple(reqs[0]["x_T"].shape))
    g_slot = program.init_g(slots)
    cls_slot = torch.zeros(slots, dtype=torch.long, device=dev)
    row = np.zeros(slots, np.int64)
    owner = [None] * slots
    freed = set()                      # slots a finished request has left
    done, tick = {}, 0
    while len(done) < len(reqs):
        for r in reqs:
            if r["arrival"] == tick:
                s = owner.index(None)
                r["slot"], r["reused"] = s, s in freed
                # admission writes the slot in place: its latent, a zeroed
                # eval ring, its guidance scale and class
                x, E = state
                x[s] = r["x_T"]
                E[:, s] = 0
                g_slot[s] = r["g"]
                cls_slot[s] = r["cls"]
                row[s] = 0
                owner[s] = r["rid"]
        busy = np.array([o is not None for o in owner])
        idx = torch.as_tensor(np.where(busy, row, 0), device=dev)
        state = program.step(state, idx, g_slot, {"class_ids": cls_slot})
        row[busy] += 1
        for s in range(slots):
            if owner[s] is not None and row[s] == program.n_rows:
                done[owner[s]] = state[0][s].clone()
                owner[s] = None
                freed.add(s)
        tick += 1
    return done, tick


def run_flight(program, reqs, slots: int, dev):
    """Drive a StepProgram's `step_flight`: requests wait in arrival order
    for a free slot; admission writes the slot's latent, a zeroed ring, its
    guidance scale, class and [row 0, the tier's offset and budget, busy]
    into the buffers the program handed out; the only read back a tick is
    the (B,) done mask. Returns ({rid: latent}, {rid: done code}, ticks)."""
    state = program.init_state(slots, tuple(reqs[0]["x_T"].shape))
    meta = program.init_meta(slots)
    g_slot = program.init_g(slots)
    cls_slot = torch.zeros(slots, dtype=torch.long, device=dev)
    queue = sorted(reqs, key=lambda r: r["arrival"])
    owner = [None] * slots
    out, codes, tick = {}, {}, 0
    while len(out) < len(reqs):
        while queue and queue[0]["arrival"] <= tick and None in owner:
            r = queue.pop(0)
            s = owner.index(None)
            off, budget = program.resolve_tier(r.get("tier"))
            state[0][s] = r["x_T"]
            state[1][:, s] = 0
            g_slot[s] = r["g"]
            cls_slot[s] = r["cls"]
            meta[:, s] = torch.tensor([0, off, budget, 1], dtype=torch.int32)
            owner[s] = r["rid"]
        state, meta, done = program.step_flight(state, meta, g_slot,
                                                {"class_ids": cls_slot})
        done = done.cpu().numpy()
        for s in np.flatnonzero(done):
            out[owner[s]] = state[0][s].clone()
            codes[owner[s]] = int(done[s])
            owner[s] = None
        tick += 1
    return out, codes, tick


def serving_requests(dev, sample_shape, cases, seed0=100):
    """Requests of the serving checks: (arrival, g[, tier]) each, with a
    seeded latent and class."""
    reqs = []
    for rid, case in enumerate(cases):
        seed = seed0 + rid
        x_T = torch.randn(sample_shape, generator=torch.Generator(
            device=dev).manual_seed(seed), device=dev)
        cls = int(np.random.default_rng(seed).integers(0, 1000))
        reqs.append(dict(rid=rid, arrival=case[0], g=case[1], x_T=x_T,
                         cls=cls, tier=case[2] if len(case) > 2 else None))
    return reqs


def uniform_run(engine, spec, r, dev):
    return engine.build(dataclasses.replace(spec, cfg_scale=r["g"]))(
        r["x_T"][None], class_ids=torch.tensor([r["cls"]], device=dev))[0]


def serving_phase(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec
    from repro_torch.engine.compiler import DONE_NONFINITE, DONE_OK
    from repro_torch.engine.specs import default_tier_specs
    from repro_torch.launch.sample import build_engine, latent_shape

    cfg = dataclasses.replace(get_config("dit-i256"), dtype="float32")
    params = perturbed_params(cfg, dev)
    engine = build_engine(cfg, params, VPLinear(), 4, per_request_cond=True,
                          device=dev)
    spec = EngineSpec(nfe=10, order=3, cfg_scale=2.0)
    program = engine.build_step(spec)
    sample_shape = latent_shape(cfg, 1)[1:]
    # the fifth request arrives a tick after the first one finishes (it
    # holds rows 0..n_rows-1 from tick 0), so its freed slot first parks
    # idle on row 0 and is then re-admitted over a stale ring and class
    reuse_tick = program.n_rows + 1
    reqs = serving_requests(dev, sample_shape, list(zip(
        (0, 1, 2, 3, reuse_tick), (1.0, 2.0, 3.5, 1.5, 2.5))))

    # `step` with a host index, replayed from its graph
    done, tick = run_slots(program, reqs, 4, dev)
    worst = 0.0
    uniform = {}
    for r in reqs:
        ref = uniform[r["rid"]] = uniform_run(engine, spec, r, dev)
        err = rel_err(done[r["rid"]], ref)
        print(f"  step: request {r['rid']} (arrival {r['arrival']}, slot "
              f"{r['slot']}{' reused' if r['reused'] else ''}, g {r['g']}, "
              f"class {r['cls']}): staggered vs uniform rel L-inf {err:.3e}")
        if not torch.isfinite(done[r["rid"]]).all() or not err <= SERVE_TOL:
            fail(f"request {r['rid']}: staggered step disagrees with its "
                 f"uniform run ({err:.3e} > {SERVE_TOL:g})")
        worst = max(worst, err)
    print(f"  step: {len(reqs)} requests over {tick} ticks, worst "
          f"{worst:.3e} (tol {SERVE_TOL:g})")
    if not reqs[-1]["reused"]:
        fail("the last request did not land in a slot a finished request "
             "had freed: re-admission went untested")

    # `step_flight` from its graph, the meta on the card, only the done
    # mask read back; one more request with a NaN in its x_T
    bad = serving_requests(dev, sample_shape, [(4, 2.0)], seed0=150)[0]
    bad["rid"] = len(reqs)
    bad["x_T"][0, 0] = float("nan")
    flight_reqs = reqs + [bad]
    t0 = time.perf_counter()
    got, codes, flight_ticks = run_flight(program, flight_reqs, 4, dev)
    flight_wall = time.perf_counter() - t0
    eager_got, eager_codes, _ = run_flight(
        engine.build_step(spec, jit=False), flight_reqs, 4, dev)
    worst_flight = 0.0
    for r in reqs:
        err = rel_err(got[r["rid"]], uniform[r["rid"]])
        same = torch.equal(got[r["rid"]], eager_got[r["rid"]])
        print(f"  step_flight: request {r['rid']}: done code "
              f"{codes[r['rid']]}, vs uniform rel L-inf {err:.3e}, replay "
              f"vs eager step_flight bit-equal: {same}")
        if codes[r["rid"]] != DONE_OK or not err <= SERVE_TOL or not same:
            fail(f"step_flight request {r['rid']}: code {codes[r['rid']]}, "
                 f"{err:.3e} vs uniform, bit-equal to eager {same}")
        worst_flight = max(worst_flight, err)
    print(f"  step_flight: the NaN request's done code {codes[bad['rid']]} "
          f"(eager {eager_codes[bad['rid']]}); {len(flight_reqs)} requests "
          f"over {flight_ticks} ticks in {flight_wall:.3f} s (captures "
          f"included)")
    if codes[bad["rid"]] != DONE_NONFINITE or eager_codes != codes:
        fail(f"the non-finite request came back {codes[bad['rid']]}, not "
             f"DONE_NONFINITE ({DONE_NONFINITE})")

    # a plan bank of the default tiers serving tagged requests
    specs = default_tier_specs(cfg_scale=2.0)
    bank = engine.build_bank(specs)
    bank_reqs = serving_requests(dev, sample_shape, [
        (0, 1.0, "fast"), (0, 2.0, "quality"), (1, 3.0, "balanced"),
        (2, 1.5, "fast"), (6, 2.5, "balanced")], seed0=170)
    got, codes, bank_ticks = run_flight(bank, bank_reqs, 4, dev)
    worst_bank = 0.0
    for r in bank_reqs:
        ref = uniform_run(engine, specs[r["tier"]], r, dev)
        err = rel_err(got[r["rid"]], ref)
        print(f"  bank: request {r['rid']} tier {r['tier']} g {r['g']}: "
              f"done code {codes[r['rid']]}, vs its tier's uniform run rel "
              f"L-inf {err:.3e}")
        if codes[r["rid"]] != DONE_OK or not err <= SERVE_TOL:
            fail(f"bank request {r['rid']} ({r['tier']}): {err:.3e}")
        worst_bank = max(worst_bank, err)
    print(f"  bank {sorted(bank.tiers.items())}: {len(bank_reqs)} requests "
          f"over {bank_ticks} ticks, worst {worst_bank:.3e} (tol "
          f"{SERVE_TOL:g})")

    # the same fp32 full-width uniform run with every op pinned to its
    # plain version: the kernels at full width, at fp32 precision
    plain = build_engine(plain_pinned(cfg), params, VPLinear(), 4,
                         per_request_cond=True, device=dev)
    r = reqs[0]
    x_plain = plain.build(dataclasses.replace(
        spec, cfg_scale=r["g"], fused_update=False), jit=False)(
            r["x_T"][None], class_ids=torch.tensor([r["cls"]], device=dev))[0]
    fp32_err = rel_err(uniform[r["rid"]], x_plain)
    print(f"  fp32 full width, kernels vs plain (request 0): rel L-inf "
          f"{fp32_err:.3e} (tol {SERVE_TOL:g})")
    if not fp32_err <= SERVE_TOL:
        fail(f"fp32 full-width kernels disagree with the plain path: "
             f"{fp32_err:.3e}")
    return dict(step_worst_rel_err=worst, flight_worst_rel_err=worst_flight,
                bank_worst_rel_err=worst_bank, flight_ticks=flight_ticks,
                bank_ticks=bank_ticks,
                fp32_full_width_kernel_vs_plain=fp32_err)


# --------------------------------------------------------------------------
# phase 6: the quantized main path
# --------------------------------------------------------------------------


def quant_path_phase(dev, counts_out: dict, x_unquantized) -> dict:
    """Guided sampling of full-width dit-i256 with the w8a16 tier through
    `sample(quant=...)` (its graph), held against its plain-pinned run; one
    engine's replay counted and held bit-equal to its eager loop; then
    w8a8 (calibrated on the card), fp8a16 and w4a16 at depth 4, each
    against its plain-pinned run over the same quantized tree."""
    from repro_torch.configs import get_config
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.sample import build_engine, latent_shape, sample
    from repro_torch.models import api
    from repro_torch.models.quant import quant_param_bytes

    batch, nfe, order, g_scale = 8, 10, 3, 2.0
    rows = nfe + 1
    cfg = get_config("dit-i256")
    params = perturbed_params(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(7)   # phase 4's x_T
    x_T = torch.randn(latent_shape(cfg, batch), generator=gen, device=dev)
    spec = EngineSpec(nfe=nfe, order=order, cfg_scale=g_scale, quant="w8a16")
    expected = expected_launches(cfg, rows, quantized=True)
    warm = expected_launches(cfg, 1, quantized=True)

    def plain_run(cfg_q, params_q, tier, x):
        """The plain-pinned uniform run of a tier; `cfg_q` may carry the
        spec of an already quantized `params_q`."""
        engine = build_engine(plain_pinned(cfg_q), params_q, VPLinear(),
                              batch, seed=0, quant=tier, device=dev)
        spec = EngineSpec(nfe=nfe, order=order, cfg_scale=g_scale,
                          fused_update=False, quant=tier)
        LAUNCHES.clear()
        out = engine.build(spec, jit=False)(x)
        torch.cuda.synchronize()
        if sum(LAUNCHES.values()):
            fail(f"the plain-pinned {tier} run launched kernels: "
                 f"{dict(LAUNCHES)}")
        return out

    x_plain = plain_run(cfg, params, "w8a16", x_T)

    # the quantized main path, through the user's entry point
    free_graphs()
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x0 = sample("dit-i256", reduced=False, nfe=nfe, order=order,
                cfg_scale=g_scale, batch=batch, params=params, x_T=x_T,
                quant="w8a16", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sample_counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    want = {k: expected[k] + warm[k] for k in expected}
    print(f"  sample(quant='w8a16'): launches "
          f"{dict(sorted(sample_counts.items()))} = one eager warm-up row "
          f"{warm} + one replay {expected}")
    if sample_counts != want:
        fail(f"quantized sample() launch counts {sample_counts} != {want}")
    if x0.shape != tuple(x_T.shape) or not np.isfinite(x0).all():
        fail(f"quantized main path output shape {x0.shape} / finite "
             f"{np.isfinite(x0).all()}")
    x0 = torch.as_tensor(x0)
    err = rel_err(x0, x_plain.cpu())
    print(f"  w8a16 kernel vs plain latents: rel L-inf {err:.3e} "
          f"(tol {MAIN_TOL:g})")
    if not err <= MAIN_TOL:
        fail(f"quantized main path latents disagree with the plain path: "
             f"{err:.3e}")
    ref = torch.as_tensor(x_unquantized).double()
    drift = float(torch.linalg.norm(x0.double() - ref) / torch.linalg.norm(ref))
    qbytes = quant_param_bytes(api.calibrate_and_quantize(
        cfg, params, "w8a16")[1])
    print(f"  w8a16 vs unquantized latents (phase 4): rel L2 {drift:.3e}; "
          f"quantized weights {qbytes['quant']} B vs {qbytes['fp32']} B fp32 "
          f"({qbytes['quant'] / qbytes['fp32']:.3f}x)")
    print(f"  sample() wall {wall:.3f} s for {batch} requests (quantization "
          f"and capture included); peak memory {peak / 2**30:.2f} GiB")

    # one engine's graph: the replay alone, counted, against its eager loop
    free_graphs()
    engine = build_engine(cfg, params, VPLinear(), batch, seed=0,
                          quant="w8a16", device=dev)
    g = graph_checks("w8a16", engine, spec, x_T, expected, counts_out)
    run, eager = g["run"], g["eager"]
    if not torch.equal(g["x_graph"].cpu(), x0):
        fail("sample(quant='w8a16')'s latents differ from the same "
             "engine's replay")
    walls = median_walls({"replay": lambda: run(x_T),
                          "eager": lambda: eager(x_T)})
    for name, w in walls.items():
        print(f"  wall {name}: median {w['median_s']:.4f} s of "
              f"{[round(v, 4) for v in w['reps_s']]} ({batch} requests)")
    print("  profile of the eager loop:")
    split_eager = profile_split(lambda: eager(x_T))
    print("  profile of the replay:")
    split_graph = profile_split(lambda: run(x_T))
    del run, eager, g, engine
    free_graphs()

    # the other tiers at depth 4, full widths; the plain-pinned run uses
    # the tree `sample` builds (w8a8 calibrated through the kernels on the
    # card), so the comparison isolates the sampling run's kernels
    depth = 4
    cfg4 = dataclasses.replace(cfg, num_layers=depth)
    params4 = perturbed_params(cfg4, dev, seed=2)
    tiers = {}
    for tier in ("w8a8", "fp8a16", "w4a16"):
        LAUNCHES.clear()
        xk = sample("dit-i256", reduced=False, nfe=nfe, order=order,
                    cfg_scale=g_scale, batch=batch, params=params4, x_T=x_T,
                    quant=tier, num_layers=depth, device=dev)
        torch.cuda.synchronize()
        n_qmm = LAUNCHES["quant_matmul"]
        # one eager warm-up row before the capture, then the replay
        want = expected_launches(cfg4, rows + 1, quantized=True)[
            "quant_matmul"]
        qcfg, qparams, _ = api.calibrate_and_quantize(cfg4, params4, tier,
                                                      schedule=VPLinear())
        xp = plain_run(qcfg, qparams, tier, x_T)
        t_err = rel_err(torch.as_tensor(xk), xp.cpu())
        print(f"  {tier} depth {depth}: {n_qmm} quant_matmul launches "
              f"(a warm-up row and a replay: {want}); kernel vs plain rel "
              f"L-inf {t_err:.3e} (tol {MAIN_TOL:g})")
        if n_qmm != want or not np.isfinite(xk).all():
            fail(f"{tier}: {n_qmm} quant_matmul launches (expected {want}) "
                 f"/ finite {np.isfinite(xk).all()}")
        if not t_err <= MAIN_TOL:
            fail(f"{tier} latents disagree with the plain path: {t_err:.3e}")
        tiers[tier] = t_err
        free_graphs()
    return dict(sample_wall_s=wall, sample_launches=sample_counts,
                sample_peak_bytes=peak, rel_err_vs_plain=err,
                rel_l2_vs_unquantized=drift, quant_param_bytes=qbytes,
                walls=walls, profile_eager=split_eager,
                profile_replay=split_graph,
                tiers_depth4_rel_err_vs_plain=tiers)


def quant_serving_phase(dev) -> dict:
    """A w8a16 per-slot StepProgram at fp32 (full widths, depth 4), from
    its graph: two requests admitted at staggered ticks, each against its
    batch-1 uniform quantized run, and one uniform run against the
    plain-pinned path."""
    from repro_torch.configs import get_config
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.sample import build_engine, latent_shape

    cfg = dataclasses.replace(get_config("dit-i256"), dtype="float32",
                              num_layers=4)
    params = perturbed_params(cfg, dev, seed=3)
    engine = build_engine(cfg, params, VPLinear(), 2, per_request_cond=True,
                          quant="w8a16", device=dev)
    spec = EngineSpec(nfe=10, order=3, cfg_scale=2.0, quant="w8a16")
    program = engine.build_step(spec)
    sample_shape = latent_shape(cfg, 1)[1:]
    reqs = serving_requests(dev, sample_shape, [(0, 2.0), (3, 3.0)],
                            seed0=200)
    LAUNCHES.clear()
    done, ticks = run_slots(program, reqs, 2, dev)
    torch.cuda.synchronize()
    # the first tick also runs once eagerly, before its capture
    expected = expected_launches(cfg, ticks + 1,
                                 quantized=True)["quant_matmul"]
    if LAUNCHES["quant_matmul"] != expected:
        fail(f"quantized step: {LAUNCHES['quant_matmul']} quant_matmul "
             f"launches over {ticks} ticks and a warm-up tick, expected "
             f"{expected}")
    worst, uniform = 0.0, {}
    for r in reqs:
        uniform[r["rid"]] = uniform_run(engine, spec, r, dev)
        err = rel_err(done[r["rid"]], uniform[r["rid"]])
        print(f"  quantized request {r['rid']} (arrival {r['arrival']}, slot "
              f"{r['slot']}, g {r['g']}): staggered vs uniform rel L-inf "
              f"{err:.3e} (tol {SERVE_TOL:g})")
        if not torch.isfinite(done[r["rid"]]).all() or not err <= SERVE_TOL:
            fail(f"quantized request {r['rid']}: staggered step disagrees "
                 f"with its uniform run ({err:.3e})")
        worst = max(worst, err)
    plain = build_engine(plain_pinned(cfg), params, VPLinear(), 2,
                         per_request_cond=True, quant="w8a16", device=dev)
    r = reqs[0]
    x_plain = plain.build(dataclasses.replace(
        spec, cfg_scale=r["g"], fused_update=False), jit=False)(
            r["x_T"][None], class_ids=torch.tensor([r["cls"]], device=dev))[0]
    fp32_err = rel_err(uniform[r["rid"]], x_plain)
    print(f"  w8a16 fp32, kernels vs plain (request 0): rel L-inf "
          f"{fp32_err:.3e} (tol {SERVE_TOL:g})")
    if not fp32_err <= SERVE_TOL:
        fail(f"quantized fp32 kernels disagree with the plain path: "
             f"{fp32_err:.3e}")
    return dict(worst_rel_err=worst, fp32_kernel_vs_plain=fp32_err)


# --------------------------------------------------------------------------
# phase 7: the solver zoo
# --------------------------------------------------------------------------

# each run's label and EngineSpec keywords: the widest table (PNDM with
# UniC-4, K = 3), a corrector base that is not the predictor's (DEIS),
# noise-prediction tables (sign -1, out_scale sigma), the expanded grid of
# DPM-Solver 3S (per-row out_scale, use_c 0, G * order rows)
ZOO = (
    ("ddim + UniC-1", dict(solver="ddim", use_corrector=True)),
    ("dpmpp-3 + UniC-3", dict(solver="dpmpp", order=3, use_corrector=True)),
    ("pndm + UniC-4", dict(solver="pndm", use_corrector=True)),
    ("deis-3 + UniC-3", dict(solver="deis", order=3, use_corrector=True)),
    ("dpm-3S", dict(solver="dpm", order=3)),
)
LOOP_TOL = 1e-4     # fp32 loop against the engine, relative L-inf


def zoo_row_cases(dev, tab, label: str) -> dict:
    """The row ops on one zoo table at the main path's state (8 requests
    of 256 x 32 fp32 latents, the table's ring): every row as a uniform
    index and one per-slot index over the table, predict and correct, each
    bit-equal to its plain version; then each op at a body row timed in a
    CUDA graph beside its bound."""
    from repro_torch.core.coeffs import augment_step_rows
    from repro_torch.core.unipc import rows_on
    from repro_torch.kernels.unipc_update import ops as uni_ops

    rows = uni_ops.pack_weight_rows(rows_on(augment_step_rows(tab), dev))
    K, n_rows, sign = tab.w_pred.shape[1], rows.shape[0], tab.sign
    g = torch.Generator(device=dev).manual_seed(100 + K)
    x, e_new, x_pred = (torch.randn(8, 256, 32, generator=g, device=dev)
                        for _ in range(3))
    E = torch.randn(K + 1, 8, 256, 32, generator=g, device=dev)
    idxs = [torch.tensor(i, device=dev) for i in range(n_rows)]
    idxs.append(torch.arange(8, device=dev) * max(1, n_rows // 7))
    worst = 0.0
    for idx in idxs:
        got = [uni_ops.unipc_row_predict(x, E, rows, idx, sign)]
        got += uni_ops.unipc_row_correct(x, E, e_new, x_pred, rows, idx, sign)
        want = [uni_ops.unipc_row_predict(x, E, rows, idx, sign,
                                          backend="plain")]
        want += uni_ops.unipc_row_correct(x, E, e_new, x_pred, rows, idx,
                                          sign, backend="plain")
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            worst = max(worst, float((a - b).abs().max()))
            if not torch.equal(a, b):
                fail(f"unipc_update on the {label} table, row {idx.tolist()}"
                     f": not bit-equal to its plain version at fp32")
    body = torch.tensor(n_rows // 2, device=dev)
    timed = {}
    for op, fn, cost in (
            ("predict", lambda: uni_ops.unipc_row_predict(
                x, E, rows, body, sign), uni_ops.cost_predict(x, E, rows,
                                                              body)),
            ("correct", lambda: uni_ops.unipc_row_correct(
                x, E, e_new, x_pred, rows, body, sign),
             uni_ops.cost_correct(x, E, e_new, x_pred, rows, body))):
        bms, by = bound(cost)
        timed[op] = dict(ms=device_ms(fn), bound_ms=bms, bound_by=by)
    print(f"  unipc_update on the {label} table (K = {K}, {n_rows} rows, "
          f"sign {sign:+g}): predict and correct at every row and per slot, "
          f"bit-equal to the plain version at fp32; at row {int(body)} "
          f"predict {timed['predict']['ms']:.6f} ms (bound "
          f"{timed['predict']['bound_ms']:.6f}), correct "
          f"{timed['correct']['ms']:.6f} ms (bound "
          f"{timed['correct']['bound_ms']:.6f}) in a CUDA graph")
    return dict(solver=label, K=K, rows=n_rows, sign=sign,
                max_abs_err=worst, row_ops=timed)


def zoo_phase(dev) -> dict:
    """Guided sampling of full-width dit-i256 (bf16 activations, the bf16
    weights kept once) with each solver of ZOO at NFE 10: the row ops held
    on each table; one engine's replay counted and bit-equal to its eager
    loop (graph_checks); the eager loop and a replay under
    set_sync_debug_mode("error"); the kernel run against the plain-pinned
    run within MAIN_TOL; the replay wall, a median of 5. Then the fp32
    loop references (sequential CFG) of dpmpp-3 + UniC and dpm-3S at NFE
    12 against the engine, and `sample(solver="dpmpp", order=3)`."""
    from repro_torch.configs import get_config
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.sample import build_engine, latent_shape, sample

    batch, nfe, g_scale = 8, 10, 2.0
    cfg = get_config("dit-i256")
    params = perturbed_params(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(7)   # phase 4's x_T
    x_T = torch.randn(latent_shape(cfg, batch), generator=gen, device=dev)
    engine = build_engine(cfg, params, VPLinear(), batch, seed=0, device=dev)
    plain = build_engine(plain_pinned(cfg), params, VPLinear(), batch, seed=0,
                         device=dev)
    runs, tables = {}, []
    for label, kw in ZOO:
        spec = EngineSpec(nfe=nfe, cfg_scale=g_scale, **kw)
        tab = engine.compile(spec)
        rows = len(tab.timesteps)
        tables.append(zoo_row_cases(dev, tab, label))
        expected = expected_launches(cfg, rows)
        counts: dict = {}
        free_graphs()
        g = graph_checks(label, engine, spec, x_T, expected, counts)
        run, eager = g["run"], g["eager"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            x_nosync, x_nosync_graph = eager(x_T), run(x_T)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if not (torch.equal(x_nosync, g["x_eager"])
                and torch.equal(x_nosync_graph, g["x_graph"])):
            fail(f"{label}: the sync-checked runs differ from the counted "
                 f"ones")
        LAUNCHES.clear()
        x_plain = plain.build(dataclasses.replace(spec, fused_update=False),
                              jit=False)(x_T)
        torch.cuda.synchronize()
        if sum(LAUNCHES.values()):
            fail(f"{label}: the plain-pinned run launched kernels: "
                 f"{dict(LAUNCHES)}")
        x_graph = g["x_graph"]
        err = rel_err(x_graph, x_plain)
        finite = bool(torch.isfinite(x_graph).all())
        walls = median_walls({"replay": lambda: run(x_T)})
        print(f"  {label}: {rows} rows (K = {tab.w_pred.shape[1]}, "
              f"{tab.prediction} prediction); no host sync in the eager loop "
              f"or a replay; kernel vs plain latents rel L-inf {err:.3e} (tol "
              f"{MAIN_TOL:g}); replay wall median "
              f"{walls['replay']['median_s']:.4f} s of "
              f"{[round(v, 4) for v in walls['replay']['reps_s']]}")
        if not (finite and err <= MAIN_TOL):
            fail(f"{label}: kernel vs plain latents {err:.3e}, finite "
                 f"{finite}")
        tables[-1]["launches"] = dict(counts)
        runs[label] = dict(rows=rows, K=tab.w_pred.shape[1],
                           prediction=tab.prediction, launches=dict(counts),
                           rel_err_vs_plain=err, replay_wall=walls["replay"],
                           first_call_counts=g["first_call_counts"])
        del g, run, eager, x_plain
    del plain
    free_graphs()

    # the loop references against the engine, fp32 activations (TF32 off)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    engine32 = build_engine(cfg32, params, VPLinear(), batch, seed=0,
                            device=dev)
    loops = {}
    for label, kw in (("dpmpp-3 + UniC-3", ZOO[1][1]), ("dpm-3S", ZOO[4][1])):
        spec = EngineSpec(nfe=12, cfg_scale=g_scale, **kw)
        loop = engine32.build_loop(spec)
        x_loop = loop(x_T)
        x_eng = engine32.build(spec)(x_T)
        torch.cuda.synchronize()
        err = rel_err(x_loop, x_eng)
        loops[label] = dict(rel_err=err, loop_nfe=loop.solver.model.nfe,
                            engine_rows=len(engine32.compile(spec).timesteps))
        print(f"  {label}, nfe 12, fp32 activations: build_loop (sequential "
              f"CFG, {loop.solver.model.nfe} guided evals) vs build (fused "
              f"CFG) rel L-inf {err:.3e} (tol {LOOP_TOL:g})")
        if not (bool(torch.isfinite(x_loop).all()) and err <= LOOP_TOL):
            fail(f"{label}: the loop reference and the engine disagree: "
                 f"{err:.3e}")
    del engine32
    free_graphs()

    # the entry point with a zoo solver: its graph's first call, counted
    spec = EngineSpec(solver="dpmpp", order=3, nfe=nfe, cfg_scale=g_scale)
    rows = len(engine.compile(spec).timesteps)
    want = {k: a + b for (k, a), b in zip(
        expected_launches(cfg, rows).items(),
        expected_launches(cfg, 1).values())}
    LAUNCHES.clear()
    x0 = sample("dit-i256", reduced=False, solver="dpmpp", order=3, nfe=nfe,
                cfg_scale=g_scale, batch=batch, params=params, x_T=x_T,
                device=dev)
    torch.cuda.synchronize()
    sample_counts = dict(LAUNCHES)
    same = torch.equal(torch.as_tensor(x0), engine.build(spec)(x_T).cpu())
    print(f"  sample(solver='dpmpp', order=3): launches "
          f"{dict(sorted(sample_counts.items()))} (a warm-up row + one "
          f"replay: {want}); latents bit-equal to the engine's replay: {same}")
    if sample_counts != want or not same or not np.isfinite(x0).all():
        fail(f"sample(solver='dpmpp'): launches {sample_counts}, bit-equal "
             f"{same}")
    del engine
    free_graphs()
    return dict(runs=runs, tables=tables, loop_vs_engine=loops,
                sample_dpmpp_launches=sample_counts)


# --------------------------------------------------------------------------
# phase 8: serving at full width
# --------------------------------------------------------------------------

SERVE_TRACE = dict(arrival_rate=0.5, requests=24, cfg_scale=2.0)
CACHE_BLOCK = 14
# the shallow plan: NFE 10, every other body step from the 2nd to the 8th
# reuses the deep features (4 of 11 evals at 14 of 28 blocks)
SHALLOW_DEPTH = [0, CACHE_BLOCK, 0, CACHE_BLOCK, 0, CACHE_BLOCK, 0,
                 CACHE_BLOCK, 0, 0]


def completion_rows(sched) -> list:
    """Each completion's bookkeeping, in completion order."""
    return [(c.rid, c.arrival, c.admit_tick, c.finish_tick, c.finish_clock,
             c.evals, c.tier, c.eval_cost, c.ok, c.retries, c.requeues)
            for c in sched.completions]


def tick_metrics(m) -> tuple:
    """The tick-denominated ServeMetrics fields (depth aside)."""
    return (m.requests, m.completed, m.ticks, m.evals, m.makespan_ticks,
            m.throughput_per_tick, m.latency_ticks_p50, m.latency_ticks_p95,
            m.occupancy, m.evals_per_latent, m.per_tier, m.rejected,
            m.retries, m.failed, m.recoveries, m.faults_injected)


def serve_summary(label: str, run, wall: float) -> dict:
    """One serving run's numbers. `readback` is booked only on the flights
    that carry completions (the host waits on no other), so it is also
    given per completing tick."""
    m = run.metrics
    completing = len({c.finish_tick for c in run.sched.completions})
    readback_us = run.sched.phase_ns["readback"] / 1e3 / max(completing, 1)
    row = dict(capture_s=run.capture_s, wall_s=wall, serve_wall_s=m.wall_s,
               ticks=m.ticks, tick_ms=m.tick_s * 1e3,
               throughput_rps=m.throughput_rps,
               latency_ms_p50=m.latency_s_p50 * 1e3,
               latency_ms_p95=m.latency_s_p95 * 1e3,
               latency_ticks_p50=m.latency_ticks_p50,
               latency_ticks_p95=m.latency_ticks_p95,
               occupancy=m.occupancy, completed=m.completed,
               host_phase_us_per_tick=m.host_phase_us_per_tick,
               completing_ticks=completing,
               readback_us_per_completing_tick=readback_us)
    print(f"  {label}: capture {run.capture_s:.3f} s; {m.completed}/"
          f"{m.requests} requests in {m.ticks} ticks, trace wall "
          f"{m.wall_s:.4f} s, tick {m.tick_s * 1e3:.3f} ms, throughput "
          f"{m.throughput_rps:.2f} req/s, latency p50/p95 "
          f"{m.latency_s_p50 * 1e3:.1f}/{m.latency_s_p95 * 1e3:.1f} ms "
          f"({m.latency_ticks_p50:.1f}/{m.latency_ticks_p95:.1f} ticks), "
          f"occupancy {m.occupancy:.3f}; host us/tick "
          f"{ {k: round(v, 1) for k, v in m.host_phase_us_per_tick.items()} }"
          f"; readback {readback_us:.1f} us on each of {completing} "
          f"completing ticks")
    return row


def with_classes(reqs):
    """Each request's class id drawn from its seed, as launch.serve does."""
    from repro_torch.launch.sample import class_ids

    for r in reqs:
        r.extras = {"class_ids": int(class_ids(1, seed=r.seed)[0])}
    return reqs


def one_tick_launches(sched, reqs) -> dict:
    """Submit `reqs` to a drained scheduler and count the launches of its
    next tick (one replay of the flight graph), then drain it."""
    from repro_torch.kernels.dispatch import LAUNCHES

    for r in reqs:
        sched.submit(r)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    sched.tick()
    counts = dict(LAUNCHES)
    sched.drain()
    return counts


def graph_replay_ms(graph, iters: int = 20) -> float:
    """Device ms per replay of a captured step graph, between CUDA events
    (the replays advance the state they run on; the work does not depend on
    its values)."""
    graph.graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def serving_at_width_phase(dev, counts_out: dict, qcounts_out: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.sample import NULL_CLASS_ID, build_engine
    from repro_torch.launch.serve import serve_diffusion
    from repro_torch.serving import (FaultPlan, MetaFault, NanFault, Request,
                                     ResilienceConfig, SlotScheduler,
                                     poisson_requests, run_trace)
    from repro_torch.serving.scheduler import _apply_admission, _gather_rows
    from repro_torch.tuning import SolverPlan, save_bank

    cfg = get_config("dit-i256")
    L = cfg.num_layers
    params = perturbed_params(cfg, dev)
    sample_shape = (cfg.patch_tokens, cfg.latent_dim)
    kw = dict(reduced=False, batch=8, nfe=10, order=3, params=params,
              device=dev, return_run=True)
    one_eval = {"unipc_update": 2, "adaln_modulate": 2 * L + 1,
                "gate_residual": 2 * L, "flash_attention": L}
    out: dict = {}

    # (a) a Poisson trace at depths 1, 2 and 3; the depth-2 run is the
    # serving main path, counted
    runs, rows = {}, {}
    for depth in (1, 2, 3):
        free_graphs()
        torch.cuda.synchronize()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        runs[depth] = serve_diffusion("dit-i256", pipeline_depth=depth,
                                      **kw, **SERVE_TRACE)
        wall = time.perf_counter() - t0
        if depth == 2:
            counts_out.update(LAUNCHES)
        rows[depth] = serve_summary(f"depth {depth}", runs[depth], wall)
    base = runs[1]
    # phase 9 serves the same trace traced and probed and holds it to this
    out["_clean"] = dict(latents=runs[2].latents,
                         rows=completion_rows(runs[2].sched),
                         metrics=tick_metrics(runs[2].metrics))
    for depth in (2, 3):
        r = runs[depth]
        same = (np.array_equal(r.latents, base.latents)
                and completion_rows(r.sched) == completion_rows(base.sched)
                and tick_metrics(r.metrics) == tick_metrics(base.metrics))
        print(f"  depth {depth} vs depth 1: latents, completion order, "
              f"admit/finish ticks and tick metrics bit-identical: {same}")
        if not same:
            fail(f"serving at depth {depth} differs from depth 1")
    if base.metrics.completed != SERVE_TRACE["requests"] or not np.isfinite(
            base.latents).all():
        fail(f"{base.metrics.completed} of {SERVE_TRACE['requests']} "
             f"requests completed, finite {np.isfinite(base.latents).all()}")
    print(f"  launches of the depth-2 serve_diffusion call (capture warm-up "
          f"included): {dict(sorted(counts_out.items()))}")
    if set(counts_out) != set(one_eval) or min(counts_out.values()) == 0:
        fail(f"the serving run did not launch every kernel: {counts_out}")

    # four completions against their own uniform runs (batch 1, the
    # request's drawn x_T, class and the nominal scale), bit for bit: every
    # op computes a row alike whatever the batch around it
    free_graphs()
    engine = build_engine(cfg, params, VPLinear(), 1, per_request_cond=True,
                          device=dev)
    uniform = engine.build(EngineSpec(nfe=10, order=3, cfg_scale=2.0))
    sched2 = runs[2].sched
    worst = 0.0
    picks = [sched2.completions[i] for i in (0, 7, 15, 23)]
    for c in picks:
        req = with_classes([Request(rid=c.rid, seed=c.rid)])[0]
        x = torch.as_tensor(sched2._draw(req), device=dev)[None]
        ref = uniform(x, class_ids=torch.tensor(
            [req.extras["class_ids"]], device=dev))[0].cpu().numpy()
        err = rel_err(torch.as_tensor(c.latent), torch.as_tensor(ref))
        worst = max(worst, err)
        same = np.array_equal(c.latent, ref)
        print(f"  request {c.rid} (admitted tick {c.admit_tick}, class "
              f"{req.extras['class_ids']}): served vs its uniform run rel "
              f"L-inf {err:.3e}, bit-equal {same}")
        if not same:
            fail(f"served request {c.rid} is not bit-equal to its uniform "
                 f"run: rel L-inf {err:.3e}")
    del engine, uniform
    out["uniform_worst_rel_err"] = worst

    # one tick of a replay: one eval's kernels and the two row ops
    tick = one_tick_launches(sched2, with_classes(
        [Request(rid=1000, seed=1000)]))
    print(f"  one tick (a replay): launches {dict(sorted(tick.items()))}, "
          f"expected {one_eval}")
    if tick != one_eval:
        fail(f"one serving tick launched {tick}, not {one_eval}")
    out["launches_per_tick"] = tick

    # the same depth-2 trace under sync debug mode: the only syncs are the
    # flight-event waits of _consume, which turn the mode off by design
    prog = runs[2].program
    sched = SlotScheduler(prog, 8, sample_shape, pipeline_depth=2,
                          extras_init={"class_ids": NULL_CLASS_ID})
    sched.aot_compile()
    reqs = with_classes(poisson_requests(SERVE_TRACE["requests"],
                                         SERVE_TRACE["arrival_rate"]))
    torch.cuda.set_sync_debug_mode("error")
    try:
        run_trace(sched, reqs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = {c.rid: c.latent for c in sched.completions}
    want = {c.rid: c.latent for c in sched2.completions}
    same = all(np.array_equal(got[r], want[r]) for r in range(24))
    print(f"  depth-2 trace under set_sync_debug_mode('error'): no host sync "
          f"outside the readback event waits; latents bit-equal: {same}")
    if not same or len(got) != 24:
        fail("the sync-checked trace differs from the depth-2 run")
    out["depths"] = rows

    # where a serving trace's time goes: the same trace under the profiler
    print("  profile of the depth-2 trace:")
    sched = SlotScheduler(prog, 8, sample_shape, pipeline_depth=2,
                          extras_init={"class_ids": NULL_CLASS_ID})
    out["profile_depth2"] = profile_split(lambda: run_trace(
        sched, with_classes(poisson_requests(SERVE_TRACE["requests"],
                                             SERVE_TRACE["arrival_rate"]))))
    # the per-tick ops around the replay, eager between CUDA events: the
    # admission (one staging copy and the masked selects, here of an empty
    # mask) and the readback of a completing tick (the padded gather and
    # the two copies to pinned memory); then the two copies alone on the
    # card, queued behind a spin so the host's launches do not count
    stage = torch.zeros(sched._layout.nbytes, dtype=torch.uint8,
                        pin_memory=dev.type == "cuda")
    buf = sched._free[0]
    done0 = torch.zeros(8, dtype=torch.int32, device=dev)
    gathered = _gather_rows(sched.state[0], done0)

    def admission():
        sched._stage_dev.copy_(stage, non_blocking=True)
        _apply_admission(sched.state, sched.meta, sched.g, sched.extras,
                         sched._stage_views)

    def readback():
        buf.mask.copy_(done0, non_blocking=True)
        buf.lat.copy_(_gather_rows(sched.state[0], done0), non_blocking=True)

    def copies():
        buf.mask.copy_(done0, non_blocking=True)
        buf.lat.copy_(gathered, non_blocking=True)

    out["admission_ms"] = host_call_ms(admission)
    out["readback_ms"] = host_call_ms(readback)
    out["readback_copy_ms"] = queued_device_ms(copies)
    out["readback_bytes"] = nbytes(done0, gathered)
    print(f"  a tick's admission {out['admission_ms']:.4f} ms and a "
          f"completing tick's readback {out['readback_ms']:.4f} ms (eager "
          f"calls between CUDA events); the readback's two copies alone "
          f"{out['readback_copy_ms']:.4f} ms on the card "
          f"({out['readback_bytes']} bytes to pinned memory)")
    clean = base.latents
    del runs, base, sched, sched2, prog

    # (b) feature reuse at cache_block 14, unguided: 8 requests at tick 0
    bank_dir = ROOT / "build" / "serving"
    bank_dir.mkdir(parents=True, exist_ok=True)
    plan = SolverPlan.default(10, order=3)
    shallow_plan = dataclasses.replace(plan, cache_depth=SHALLOW_DEPTH)
    cached = {}
    for name, p in (("uncached", plan), ("shallow", shallow_plan)):
        path = str(bank_dir / f"{name}.json")
        save_bank(path, {"default": p})
        free_graphs()
        t0 = time.perf_counter()
        cached[name] = serve_diffusion("dit-i256", plan_bank=path,
                                       pipeline_depth=2, **kw)
        serve_summary(f"bank {name}", cached[name], time.perf_counter() - t0)
    # a plan with every step full is not a cached bank to launch.serve (its
    # cache_block is 0), so its program is wired here as serve_diffusion
    # wires a cached one: the engine at block 14, the bank, the scheduler
    free_graphs()
    engine = build_engine(cfg, params, VPLinear(), 8, per_request_cond=True,
                          cache_block=CACHE_BLOCK, device=dev)
    zero = dataclasses.replace(plan, cache_depth=[0] * 10)
    program = engine.build_bank(
        {"default": EngineSpec(nfe=10, order=3, cache_block=CACHE_BLOCK)},
        {"default": zero.compile(engine.schedule)})
    sched = SlotScheduler(program, 8, sample_shape, pipeline_depth=2,
                          extras_init={"class_ids": NULL_CLASS_ID})
    sched.aot_compile()
    run_trace(sched, with_classes([Request(rid=i, seed=i, tier="default")
                                   for i in range(8)]))
    all_full = np.stack([c.latent for c in sorted(sched.completions,
                                                  key=lambda c: c.rid)])
    same = (np.array_equal(all_full, cached["uncached"].latents)
            and sched.shallow_ticks == 0)
    print(f"  cache_block {CACHE_BLOCK}, cache_depth all 0 vs the uncached "
          f"program: latents bit-equal: {same}")
    if not same:
        fail("a cached program with every step full differs from the "
             "uncached one")
    del engine, program, sched
    sh = cached["shallow"]
    drift = rel_err(torch.as_tensor(sh.latents),
                    torch.as_tensor(cached["uncached"].latents))
    costs = sorted({c.eval_cost for c in sh.sched.completions})
    want_cost = shallow_plan.eval_cost(L)
    print(f"  shallow plan {SHALLOW_DEPTH}: finite "
          f"{np.isfinite(sh.latents).all()}, rel L-inf from the uncached "
          f"run {drift:.3e}, {sh.sched.shallow_ticks} shallow ticks of "
          f"{sh.metrics.ticks}, eval_cost per request {costs} (plan: "
          f"{want_cost})")
    if (not np.isfinite(sh.latents).all() or drift == 0.0
            or sh.sched.shallow_ticks == 0 or costs != [want_cost]):
        fail("the shallow plan did not serve as planned")
    shallow_ticks = sh.sched.shallow_ticks
    # a tick of each graph, counted, on a new lockstep batch
    s = sh.sched
    for i in range(8):
        s.submit(Request(rid=2000 + i, seed=2000 + i, tier="default",
                         extras={"class_ids": NULL_CLASS_ID}))
    per_kind = {}
    while s.queue or s.active:
        n0 = s.shallow_ticks
        torch.cuda.synchronize()
        LAUNCHES.clear()
        s.tick()
        per_kind.setdefault("shallow" if s.shallow_ticks > n0 else "full",
                            dict(LAUNCHES))
    s.flush()
    k = CACHE_BLOCK
    want_shallow = {"unipc_update": 2, "adaln_modulate": 2 * k + 1,
                    "gate_residual": 2 * k, "flash_attention": k}
    print(f"  a full tick launches {per_kind.get('full')}, a shallow tick "
          f"{per_kind.get('shallow')} (expected {want_shallow})")
    if (per_kind.get("full") != one_eval
            or per_kind.get("shallow") != want_shallow):
        fail(f"cached tick launches {per_kind}")
    graphs = sh.program.step_graphs.graphs
    walls = {kind: graph_replay_ms(g) for (kind, *_), g in graphs.items()}
    print(f"  replay of one tick (device ms, 20 replays): "
          f"{ {k: round(v, 4) for k, v in walls.items()} }")
    out["cache"] = dict(block=k, shallow_depth=SHALLOW_DEPTH,
                        shallow_ticks=shallow_ticks,
                        ticks=sh.metrics.ticks, eval_cost=want_cost,
                        rel_err_vs_uncached=drift, launches=per_kind,
                        replay_ms=walls)
    del cached, sh, s, graphs

    # (c) resilience: a NaN and a desync on the depth-2 trace; the retry
    # and the requeued requests keep their x_T, so every latent is the
    # clean run's
    free_graphs()
    plan_faults = FaultPlan(nans=(NanFault(rid=2, step=1),),
                            metas=(MetaFault(tick=40),))
    res = serve_diffusion("dit-i256", pipeline_depth=2,
                          resilience=ResilienceConfig(max_retries=2),
                          faults=plan_faults, **kw, **SERVE_TRACE)
    m = res.metrics
    kinds = [ev[0] for ev in res.sched.events]
    same = np.array_equal(res.latents, clean)
    print(f"  faults {plan_faults.describe()}: {m.completed}/{m.requests} "
          f"completed, {m.retries} retries, {m.recoveries} recoveries, "
          f"latents bit-equal to the clean run (a): {same}")
    for ev in res.sched.events:
        print(f"    event {ev}")
    if (m.completed != SERVE_TRACE["requests"] or "retry" not in kinds
            or "desync" not in kinds or not same
            or not all(c.ok for c in res.sched.completions)):
        fail("the faulted trace did not recover to the clean latents")
    out["resilience"] = dict(events=[list(map(str, ev))
                                     for ev in res.sched.events],
                             retries=m.retries, recoveries=m.recoveries)
    del res

    # (d) the quantized path: a short w8a16 trace
    free_graphs()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    q = serve_diffusion("dit-i256", quant="w8a16", pipeline_depth=2,
                        arrival_rate=0.5, requests=8, cfg_scale=2.0, **kw)
    q_wall = time.perf_counter() - t0
    qcounts_out.update(LAUNCHES)
    q_tick = one_tick_launches(q.sched, with_classes(
        [Request(rid=3000, seed=3000)]))
    want_q = {**one_eval, "quant_matmul": 7 * L + 1}
    print(f"  w8a16: {q.metrics.completed}/8 completed, finite "
          f"{np.isfinite(q.latents).all()}; one tick launches "
          f"{dict(sorted(q_tick.items()))} (expected {want_q})")
    if (q_tick != want_q or q.metrics.completed != 8
            or not np.isfinite(q.latents).all()):
        fail(f"the w8a16 serving tick launched {q_tick}")
    out["quant"] = dict(launches_per_tick=q_tick,
                        run=serve_summary("w8a16", q, q_wall))
    del q
    free_graphs()
    return out



# --------------------------------------------------------------------------
# phase 9: observability and the tuner
# --------------------------------------------------------------------------

PROBE = dict(probe_fraction=0.25, probe_ref_nfe=64)
PROBE_CAP = 4                 # QualityProbe(max_probes=) for phase 9 (a)
OBS_OVERHEAD_LIMIT = 0.05     # DESIGN.md §15.5: tracer host cost / tick wall
TUNE = dict(nfe=8, ref_nfe=48, batch=4, budget=24, rounds=1)
CACHED_BUDGET = 8
# a cached plan at NFE 8 whose even body steps from the 2nd reuse the deep
# features, so the cached runner replays both of its row graphs
TUNE_SHALLOW = [0, CACHE_BLOCK, 0, CACHE_BLOCK, 0, CACHE_BLOCK, 0, 0]


def row_launches(L: int, rows: int) -> dict:
    """Launches of `rows` rows of the sampler over a DiT of L blocks (the
    two row ops and one eval's kernels a row)."""
    return {"unipc_update": 2 * rows, "adaln_modulate": (2 * L + 1) * rows,
            "gate_residual": 2 * L * rows, "flash_attention": L * rows}


def need_every_kernel(label: str, counts: dict) -> None:
    missing = [k for k in ("unipc_update", "adaln_modulate", "gate_residual",
                           "flash_attention") if not counts.get(k)]
    if missing:
        fail(f"{label} launched no {missing}: {counts}")


@contextlib.contextmanager
def probe_capped(max_probes: int):
    """serve_diffusion builds its QualityProbe uncapped, as the reference
    does; within this block it builds it with `max_probes`."""
    import repro_torch.obs as obs

    orig = obs.QualityProbe
    obs.QualityProbe = functools.partial(orig, max_probes=max_probes)
    try:
        yield
    finally:
        obs.QualityProbe = orig


@contextlib.contextmanager
def objectives_made(tune_mod):
    """Yields the list of the PlanObjectives that launch.tune's `tune` makes
    within this block (its report is plain data, as in the reference)."""
    made, orig = [], tune_mod.make_objective

    def spy(*args, **kwargs):
        made.append(orig(*args, **kwargs))
        return made[-1]

    tune_mod.make_objective = spy
    try:
        yield made
    finally:
        tune_mod.make_objective = orig


def sync_checked(fn):
    """Run `fn` under torch.cuda.set_sync_debug_mode("error"): any host
    sync outside the designed readback waits (graphs.readback_sync) raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def obs_overhead(program, sample_shape, reps: int = 5) -> dict:
    """The tracer's cost on the scheduler's own host counters (the
    reference's methodology, DESIGN.md §15.5): the phase 8 trace served
    untraced and traced in turns, `reps` times each, on one program; the
    median host us a tick of each, their difference over the untraced
    tick wall. The trace walls are given beside."""
    from repro_torch.launch.sample import NULL_CLASS_ID
    from repro_torch.obs import Tracer
    from repro_torch.serving import SlotScheduler, poisson_requests, run_trace

    rows = {False: [], True: []}
    for _ in range(reps):
        for traced in (False, True):
            sched = SlotScheduler(program, 8, sample_shape, pipeline_depth=2,
                                  extras_init={"class_ids": NULL_CLASS_ID},
                                  tracer=Tracer() if traced else None)
            m = run_trace(sched, with_classes(poisson_requests(
                SERVE_TRACE["requests"], SERVE_TRACE["arrival_rate"])))
            rows[traced].append((m.host_us_per_tick, m.tick_s, m.wall_s))

    def median(rs):
        return sorted(rs)[len(rs) // 2]

    base, traced = median(rows[False]), median(rows[True])
    frac = (traced[0] - base[0]) / (base[1] * 1e6)
    return dict(untraced_host_us_per_tick=base[0],
                traced_host_us_per_tick=traced[0],
                untraced_tick_ms=base[1] * 1e3, traced_tick_ms=traced[1] * 1e3,
                untraced_wall_s=[r[2] for r in rows[False]],
                traced_wall_s=[r[2] for r in rows[True]],
                overhead_frac=frac, limit=OBS_OVERHEAD_LIMIT)


def traced_serving_part(dev, cfg, params, clean: dict,
                        counts_out: dict) -> dict:
    """(a) phase 8 (a)'s depth-2 trace through serve_diffusion, traced, with
    the metrics artifact and the probe; then its checks (see main)."""
    import io

    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch import obsreport
    from repro_torch.launch.sample import NULL_CLASS_ID
    from repro_torch.launch.serve import serve_diffusion
    from repro_torch.obs import Tracer, validate_metrics, validate_trace
    from repro_torch.serving import (Request, SlotScheduler, poisson_requests,
                                     run_trace)

    art = ROOT / "build" / "obs"
    art.mkdir(parents=True, exist_ok=True)
    trace_path, metrics_path = str(art / "trace.json"), str(art / "metrics.json")
    sample_shape = (cfg.patch_tokens, cfg.latent_dim)
    free_graphs()
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    with probe_capped(PROBE_CAP):
        run = serve_diffusion("dit-i256", reduced=False, batch=8, nfe=10,
                              order=3, params=params, device=dev,
                              return_run=True, pipeline_depth=2,
                              trace_out=trace_path, metrics_out=metrics_path,
                              metrics_every=8, **PROBE, **SERVE_TRACE)
    wall = time.perf_counter() - t0
    counts_out.update(LAUNCHES)
    print(f"  launches of the traced, probed serve_diffusion call (capture "
          f"warm-ups and the probe's replays included): "
          f"{dict(sorted(counts_out.items()))}")
    need_every_kernel("the traced serving run", counts_out)
    row = serve_summary("traced depth 2", run, wall)
    same = {"latents": np.array_equal(run.latents, clean["latents"]),
            "completions": completion_rows(run.sched) == clean["rows"],
            "tick metrics": tick_metrics(run.metrics) == clean["metrics"]}
    print(f"  traced + probed vs phase 8 (a)'s untraced depth-2 run, "
          f"bit-identical: {same}")
    if not all(same.values()):
        fail("tracing or probing changed what serving computed")
    with open(trace_path) as f:
        trace = json.load(f)
    with open(metrics_path) as f:
        metrics = json.load(f)
    t_errs, m_errs = validate_trace(trace), validate_metrics(metrics)
    print(f"  trace: {len(trace['traceEvents'])} events, "
          f"{trace['otherData']['dropped_events']} dropped, violations "
          f"{t_errs}; metrics artifact: {len(metrics['rows'])} periodic rows, "
          f"violations {m_errs}")
    if t_errs or m_errs:
        fail(f"invalid artifacts: trace {t_errs}, metrics {m_errs}")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        obsreport.main(["--trace", trace_path, "--metrics", metrics_path,
                        "--check"])
    lines = text.getvalue().splitlines()
    print(f"  obsreport --check: {lines[0]}")
    for line in lines[lines.index("where a tick goes (measured, per "
                                  "executed tick):"):][:9]:
        print(f"    {line}")
    if lines[0] != ("check ok: embedded ServeMetrics == re-derivation from "
                    "the raw snapshot"):
        fail("obsreport --check failed on the artifact")

    # the probe: its replays, their walls, kept out of the tick phases
    probe, sched = run.probe, run.sched
    ref = probe.reference_fn
    res = probe.results
    captures = ref.captures()
    probe_s = sched._probe_ns / 1e9
    phase_s = sum(sched.phase_ns.values()) / 1e9
    print(f"  probe: {len(res)} replays (cap {PROBE_CAP}) of "
          f"fraction {PROBE['probe_fraction']} against UniPC-3 at NFE "
          f"{PROBE['probe_ref_nfe']} (guided fp32 eval boundary, batch 1), "
          f"{captures} capture(s); {probe_s:.4f} s of probe replays, kept out "
          f"of the tick phases ({phase_s:.4f} s booked there)")
    for r in res:
        print(f"    rid {r['rid']} tier {r['tier']}: discrepancy "
              f"{r['discrepancy']:.6e}")
    ds = [r["discrepancy"] for r in res]
    if (len(res) != PROBE_CAP or captures > 1
            or not all(np.isfinite(d) and d > 0 for d in ds)
            or sched._probe_ns <= 0):
        fail(f"the probe did not run as asked: {len(res)} replays, "
             f"{captures} captures, discrepancies {ds}")
    # one probed request again, alone, and under sync debug mode: the
    # replays make no host sync but the readback of x_ref
    c = next(c for c in sched.completions if c.rid == res[0]["rid"])
    req = with_classes([Request(rid=c.rid, seed=c.rid)])[0]
    x = sched._draw(req)[None]
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        x_ref = sync_checked(lambda: ref(x, g=SERVE_TRACE["cfg_scale"],
                                         extras=req.extras))
        walls.append(time.perf_counter() - t0)
    d = float(np.linalg.norm(np.asarray(c.latent, np.float32) - x_ref[0])
              / max(float(np.linalg.norm(x_ref[0])), 1e-12))   # as observe
    print(f"  a probe replay alone ({PROBE['probe_ref_nfe'] + 1} rows, "
          f"under set_sync_debug_mode('error')): walls "
          f"{[round(w, 4) for w in walls]} s, discrepancy {d:.6e} "
          f"(in the run {res[0]['discrepancy']:.6e}), captures "
          f"{ref.captures()}")
    if d != res[0]["discrepancy"] or ref.captures() != captures:
        fail("the probe's replay alone differs from the one in the run")
    sg = ref.program.step_graphs
    probe_row_ms = (graph_replay_ms(next(iter(sg.graphs.values())))
                    if sg is not None else None)
    print(f"  a probe row's replay on the card: {probe_row_ms} ms (20 "
          f"replays between CUDA events), {ref.program.n_rows} rows a probe")

    # the tracer's host cost, and the traced run under sync debug mode
    overhead = obs_overhead(run.program, sample_shape)
    print(f"  tracer host cost: {overhead['traced_host_us_per_tick']:.1f} "
          f"vs {overhead['untraced_host_us_per_tick']:.1f} us a tick "
          f"(medians of 5), {overhead['overhead_frac'] * 100:.3f}% of the "
          f"{overhead['untraced_tick_ms']:.3f} ms tick (limit "
          f"{OBS_OVERHEAD_LIMIT:.0%}); trace walls untraced "
          f"{overhead['untraced_wall_s']} traced {overhead['traced_wall_s']}")
    if overhead["overhead_frac"] > OBS_OVERHEAD_LIMIT:
        fail(f"the tracer costs {overhead['overhead_frac']:.2%} of a tick")
    tr = Tracer()
    sched = SlotScheduler(run.program, 8, sample_shape, pipeline_depth=2,
                          extras_init={"class_ids": NULL_CLASS_ID}, tracer=tr)
    sched.aot_compile()
    sync_checked(lambda: run_trace(sched, with_classes(poisson_requests(
        SERVE_TRACE["requests"], SERVE_TRACE["arrival_rate"]))))
    got = np.stack([c.latent for c in sorted(sched.completions,
                                             key=lambda c: c.rid)])
    same = np.array_equal(got, clean["latents"])
    print(f"  traced depth-2 trace (probe off) under set_sync_debug_mode("
          f"'error'): no host sync outside the readback event waits, "
          f"{len(tr.events())} events, latents bit-equal: {same}")
    if not same or validate_trace(tr.to_json()):
        fail("the sync-checked traced run differs from phase 8 (a)")
    return dict(run=row, trace_events=len(trace["traceEvents"]),
                metrics_rows=len(metrics["rows"]),
                probe=dict(discrepancy=ds, rids=[r["rid"] for r in res],
                           captures=captures, probe_s=probe_s,
                           replay_alone_s=walls, row_device_ms=probe_row_ms,
                           summary=probe.summary()),
                overhead=overhead)


def tuner_part(dev, cfg, params, counts_out: dict) -> dict:
    """(b) the objective and the search, unguided, through launch.tune's
    `tune`; (c) the cached search at CACHE_BLOCK; (d) sample(plan=) on
    (b)'s plan. Checks in main's docstring."""
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch import tune as tune_mod
    from repro_torch.launch.sample import build_engine, latent_shape, sample
    from repro_torch.tuning import SolverPlan

    L = cfg.num_layers
    nfe, batch = TUNE["nfe"], TUNE["batch"]
    rows = nfe + 1
    out: dict = {}
    free_graphs()
    engine = build_engine(cfg, params, VPLinear(), batch, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    x_T = torch.randn(latent_shape(cfg, batch), generator=gen, device=dev)
    spec = EngineSpec(solver="unipc", nfe=nfe, order=2)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    with objectives_made(tune_mod) as made:
        plan, rep = tune_mod.tune("dit-i256", nfe=nfe,
                                  budget=TUNE["budget"],
                                  rounds=TUNE["rounds"],
                                  ref_nfe=TUNE["ref_nfe"], batch=batch,
                                  train_steps=0, engine=engine, x_T=x_T)
    wall = time.perf_counter() - t0
    counts_out["tune"] = dict(LAUNCHES)
    need_every_kernel("the search", counts_out["tune"])
    obj, = made
    runner = obj._runner
    print(f"  tune (b): NFE {nfe}, reference NFE {TUNE['ref_nfe']}, batch "
          f"{batch}, budget {TUNE['budget']}, {TUNE['rounds']} round: "
          f"baseline {rep['baseline']:.6f} -> tuned {rep['tuned']:.6f} in "
          f"{rep['evals']} evals; search wall {rep['search_wall_s']:.4f} s "
          f"({rep['search_wall_s'] / rep['evals'] * 1e3:.3f} ms a "
          f"candidate), the call {wall:.4f} s with the reference and its "
          f"capture; runner captures {runner.captures} for "
          f"{runner.builds} table shape(s); launches "
          f"{dict(sorted(counts_out['tune'].items()))}")
    if runner.captures > runner.builds or runner.builds != 1:
        fail(f"the search captured {runner.captures} graphs for "
             f"{runner.builds} NFE")
    if not rep["tuned"] <= rep["baseline"]:
        fail(f"tuned {rep['tuned']} > baseline {rep['baseline']}")
    # three plans in a row through the one capture, each against its own
    # engine.build replay; the second's table differs from the first's
    sched = engine.schedule
    picks = {"baseline": SolverPlan.from_spec(spec), "tuned": plan,
             "unipc-3": SolverPlan.default(nfe, order=3)}
    states, walls = {}, {}
    for name, p in picks.items():
        t0 = time.perf_counter()
        sync_checked(lambda p=p: obj(p, sched))
        walls[name] = time.perf_counter() - t0
        states[name] = runner.last
    LAUNCHES.clear()
    obj(plan, sched)
    one = dict(LAUNCHES)
    want_one = row_launches(L, rows)
    print(f"  one candidate's replay launches {dict(sorted(one.items()))} "
          f"(expected {want_one}); score walls (under sync debug mode) "
          f"{ {k: round(v, 5) for k, v in walls.items()} } s; captures "
          f"{runner.captures}")
    if one != want_one or runner.captures != (dev.type == "cuda"):
        fail(f"a candidate launched {one} with {runner.captures} captures")
    # where a candidate's wall goes: the graph's replay on the card, and
    # the host's lowering and packing of the plan's table
    from repro_torch.core.coeffs import augment_step_rows
    from repro_torch.core.unipc import pack_step_rows, rows_on

    run_graph = next(iter(runner.entries.values()))["graphs"].get("run")
    cand_dev_ms = graph_replay_ms(run_graph) if run_graph else None
    t0 = time.perf_counter()
    for _ in range(20):
        pack_step_rows(rows_on(augment_step_rows(plan.compile(sched)),
                               "cpu"))
    pack_ms = (time.perf_counter() - t0) / 20 * 1e3
    print(f"  a candidate: replay {cand_dev_ms} ms on the card (20 replays "
          f"between CUDA events), the plan's lowering and packing "
          f"{pack_ms:.3f} ms on the host")
    for name, p in picks.items():
        want = engine.build(spec, table=engine.compile(
            spec, table=p.compile(sched)))(x_T).cpu().numpy()
        same = np.array_equal(states[name], want)
        print(f"    {name}: terminal states bit-equal to engine.build's "
              f"replay of its table: {same}")
        if not same:
            fail(f"the runner's {name} plan differs from engine.build's")
    out["search"] = dict(baseline=rep["baseline"], tuned=rep["tuned"],
                         evals=rep["evals"],
                         search_wall_s=rep["search_wall_s"],
                         ms_per_candidate=rep["search_wall_s"]
                         / rep["evals"] * 1e3, call_wall_s=wall,
                         captures=runner.captures, score_walls_s=walls,
                         launches_per_candidate=one,
                         candidate_replay_ms=cand_dev_ms,
                         host_pack_ms=pack_ms)
    del obj, runner, rep, made

    # (c) the cached search: at most two captures (the row graphs with and
    # without the deep blocks), scores against cached engine.build replays
    free_graphs()
    cengine = build_engine(cfg, params, VPLinear(), batch,
                           cache_block=CACHE_BLOCK, device=dev)
    cspec = EngineSpec(solver="unipc", nfe=nfe, order=2,
                       cache_block=CACHE_BLOCK)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    with objectives_made(tune_mod) as made:
        cplan, crep = tune_mod.tune("dit-i256", nfe=nfe,
                                    budget=CACHED_BUDGET, rounds=1,
                                    ref_nfe=TUNE["ref_nfe"], batch=batch,
                                    train_steps=0, engine=cengine, x_T=x_T,
                                    cache_block=CACHE_BLOCK)
    counts_out["tune_cached"] = dict(LAUNCHES)
    need_every_kernel("the cached search", counts_out["tune_cached"])
    cobj, = made
    crun = cobj._runner
    forced = dataclasses.replace(SolverPlan.from_spec(spec),
                                 cache_depth=TUNE_SHALLOW)
    cpicks = {"cached tuned": cplan, "forced shallow": forced}
    cstates = {}
    for name, p in cpicks.items():
        sync_checked(lambda p=p: cobj(p, sched))
        cstates[name] = crun.last
    print(f"  tune (c), cache_block {CACHE_BLOCK}: baseline "
          f"{crep['baseline']:.6f} -> tuned {crep['tuned']:.6f} (no-cache "
          f"anchor {crep['uncached_tuned']:.6f}, ratio "
          f"{crep['cached_ratio']:.4f}) in {crep['evals']} evals, "
          f"{crep['search_wall_s']:.4f} s; evals_per_latent "
          f"{crep['evals_per_latent']:.4f} of {crep['nfe_evals']}; plan "
          f"cache_depth {cplan.cache_depth}; runner captures "
          f"{crun.captures}")
    if crun.captures > 2 or crun.builds != 1:
        fail(f"the cached search captured {crun.captures} graphs")
    for name, p in cpicks.items():
        want = cengine.build(cspec, table=cengine.compile(
            cspec, table=p.compile(sched)))(x_T).cpu().numpy()
        same = np.array_equal(cstates[name], want)
        print(f"    {name} {p.cache_depth}: terminal states bit-equal to "
              f"the cached engine.build replay: {same}")
        if not same:
            fail(f"the cached runner's {name} plan differs from "
                 f"engine.build's")
    out["cached_search"] = dict(
        baseline=crep["baseline"], tuned=crep["tuned"],
        uncached_tuned=crep["uncached_tuned"], evals=crep["evals"],
        search_wall_s=crep["search_wall_s"],
        evals_per_latent=crep["evals_per_latent"],
        cache_depth=cplan.cache_depth, captures=crun.captures)
    del cobj, crun, crep, cengine, made

    # (d) sample(plan=) on (b)'s plan from its JSON, against the replay of
    # the same table on (b)'s engine (the same class ids, from seed 0)
    path = ROOT / "build" / "obs" / "plan.json"
    plan.save(str(path))
    free_graphs()
    torch.cuda.synchronize()
    LAUNCHES.clear()
    got = sample("dit-i256", reduced=False, batch=batch, plan=str(path),
                 params=params, x_T=x_T, device=dev)
    counts_out["sample_plan"] = dict(LAUNCHES)
    want = engine.build(spec, table=engine.compile(
        spec, table=SolverPlan.load(str(path)).compile(sched)))(
            x_T).cpu().numpy()
    same = np.array_equal(got, want)
    # on the card the first call runs one eager warm-up row, then the
    # capture's replay of every row
    want_counts = row_launches(L, rows + (dev.type == "cuda"))
    print(f"  sample(plan=) (d): launches "
          f"{dict(sorted(counts_out['sample_plan'].items()))} (expected "
          f"{want_counts}: a warm-up row and the replay), latents bit-equal "
          f"to the engine replay of the plan's table: {same}")
    if not same or counts_out["sample_plan"] != want_counts:
        fail("sample(plan=) differs from the engine replay of its table")
    out["sample_plan"] = dict(launches=counts_out["sample_plan"],
                              bit_equal=same)
    del engine
    free_graphs()
    return out


def obs_and_tuner_phase(dev, clean: dict, counts_out: dict) -> dict:
    from repro_torch.configs import get_config

    cfg = get_config("dit-i256")
    params = perturbed_params(cfg, dev)
    counts_out["serve"] = {}
    out = {"traced": traced_serving_part(dev, cfg, params, clean,
                                         counts_out["serve"])}
    out.update(tuner_part(dev, cfg, params, counts_out))
    return out

# --------------------------------------------------------------------------
# phase 10: training at full width
# --------------------------------------------------------------------------
# phase 11: the decoder-only token family
# --------------------------------------------------------------------------

TOKEN_ARCH = "qwen2-0.5b"
TOKEN_SERVE = dict(batch=8, prompt_len=512, gen=64)
TOKEN_SAMPLE = dict(batch=8, nfe=10, order=3)
MOE_ARCH = "granite-moe-3b-a800m"
MOE_SERVE = dict(batch=4, prompt_len=256, gen=16)
# bf16 logits of a random-weight LM sit 1.2e-2 (qwen2-0.5b at one layer)
# to 6e-2 (granite, routing near-ties) from their fp32 values whichever
# implementation computes them (PERF.md §6): the plain-pinned bf16 run
# is as far from the fp32 run as the kernel run. So the bf16 gate holds the
# kernel run's distance from the fp32 run (plain-pinned) to the plain bf16
# run's own plus TOKEN_TOL, prints the kernel-vs-plain distance beside it,
# and the fp32 runs (kernels against plain-pinned, every layer) to
# DECODE_TOL.
TOKEN_TOL = 1e-2
DECODE_TOL = 1e-4         # fp32 prefill + decode against the forward
DECODE_DEPTH = 4          # layers of the fp32 decode-vs-forward check
MOE_CAPACITY = 8.0        # no token drops (the reference's test_models.py)
TOKEN_ATTENTION = [  # label, B, Hq, Hkv, S, D, causal, window
    ("qwen2-0.5b prefill, causal GQA 14/2", 8, 14, 2, 512, 64, True, None),
    ("qwen2-0.5b diffusion LM, GQA 14/2", 8, 14, 2, 64, 64, False, None),
    ("granite prefill, causal GQA 24/8", 4, 24, 8, 256, 64, True, None),
    ("olmo-1b prefill, causal MHA D=128", 8, 16, 16, 512, 128, True, None),
    ("window 64, GQA 14/2, S=300", 8, 14, 2, 300, 64, True, 64),
]


def token_kernel_cases(dev, cases=TOKEN_ATTENTION,
                       row_ops: bool = True) -> dict:
    """(a) flash_attention at the token paths' shapes (`cases`): q/k/v as
    the models hand them over (head-major views of (B, S, H, D)
    projections), bf16 against the plain version (<= 1e-2) and the same
    shapes at fp32 (<= 1e-5), each twice (bit-equal) and labelled with the
    body plan() chose; the bf16 case timed as phase 3 times (100 calls in a
    CUDA graph) beside its bound, its plain version and SDPA with
    enable_gqa (a yardstick only). A case with a ninth entry Skv is
    cross-attention: Sq = S queries over Skv keys, non-causal. With
    `row_ops`, unipc_update's row ops at the diffusion LM's (8, 64, 64)
    state, bit-equal at fp32."""
    from repro_torch.core.coeffs import augment_step_rows
    from repro_torch.core.unipc import rows_on
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec, SamplerEngine
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.unipc_update import ops as uni_ops

    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for label, B, Hq, Hkv, S, D, causal, window, *cross in cases:
        Skv = cross[0] if cross else S
        row = {}
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, S, Hq, D, generator=g, device=dev).to(dt)
            k, v = (torch.randn(B, Skv, Hkv, D, generator=g,
                                device=dev).to(dt) for _ in range(2))
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            got = fa_ops.attention(q, k, v, causal=causal, window=window)
            again = fa_ops.attention(q, k, v, causal=causal, window=window)
            want = fa_ops.attention(q, k, v, causal=causal, window=window,
                                    backend="plain")
            torch.cuda.synchronize()
            p = fa_kernel.plan(q, k, v, got)
            body = (f"{p['body']}, D in {8 * p['chunks']}, "
                    f"{'16' if p['vec_in'] else '2'}-byte loads"
                    if p["body"] == "mma" else p["body"])
            err = rel_err(got, want)
            name = "bf16" if dt == torch.bfloat16 else "fp32"
            same = torch.equal(got, again)
            print(f"  flash_attention [{label} ({B}, {Hq}/{Hkv}, {S}"
                  f"{'' if Skv == S else f' over {Skv}'}, {D}) {name}] "
                  f"[{body}] rel L-inf {err:.3e} (tol {TOL[dt]:g}); twice "
                  f"bit-equal {same}")
            if not (torch.isfinite(got.float()).all() and err <= TOL[dt]
                    and same):
                fail(f"flash_attention [{label} {name}] disagrees with its "
                     f"plain version (rel {err:.3e}) or with itself "
                     f"({same})")
            row[f"rel_err_{name}"] = err
            row[f"abs_err_{name}"] = float(
                (got.double() - want.double()).abs().max())
            row[f"body_{name}"] = body
        # the bf16 outputs' share bit-equal to plain's (fp32 P) and to the
        # rounded-P variant's (one bf16 P, as the kernel's P V takes it)
        with plain_rounding_p():
            rounded = fa_ops.attention(q, k, v, causal=causal, window=window,
                                       backend="plain")
        row.update(bit_equal_share_plain=float((got == want).float().mean()),
                   bit_equal_share_rounded_p=float(
                       (got == rounded).float().mean()))
        print(f"  flash_attention [{label}] bf16: "
              f"{row['bit_equal_share_plain']:.2%} of the outputs bit-equal "
              f"to plain's, {row['bit_equal_share_rounded_p']:.2%} to the "
              f"rounded-P variant's")
        del rounded
        # q, k, v are the bf16 ones now: time the path's dtype
        if window:
            qi = torch.arange(S, device=dev)[:, None]
            ki = torch.arange(S, device=dev)[None, :]
            mask = (ki <= qi) & (ki > qi - window)
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                q, k, v, is_causal=causal, enable_gqa=True)
        pairs = fa_ops.attention_pairs(S, Skv, causal, window)
        bms, by = bound(fa_ops.cost(q, k, v, causal=causal, window=window))
        row.update(
            shape=[B, Hq, Hkv, S, D], skv=Skv, causal=causal, window=window,
            ms=device_ms(lambda: fa_ops.attention(q, k, v, causal=causal,
                                                  window=window)),
            plain_ms=device_ms(lambda: fa_ops.attention(
                q, k, v, causal=causal, window=window, backend="plain"),
                iters=20),
            library_ms=device_ms(lib), bound_ms=bms, bound_by=by,
            pairs=pairs)
        print(f"  flash_attention [{label}] bf16: {row['ms']:.6f} ms in the "
              f"graph (bound {bms:.6f} by {by}, {bms / row['ms']:.0%}; SDPA "
              f"enable_gqa {row['library_ms']:.6f}; plain "
              f"{row['plain_ms']:.6f})")
        out[label] = row
    if not row_ops:
        return out

    # the diffusion LM's sampler rows: unguided NFE 10, order 3 table
    tab = SamplerEngine(VPLinear(), eps=None, device=dev).compile(
        EngineSpec(nfe=TOKEN_SAMPLE["nfe"], order=TOKEN_SAMPLE["order"]))
    rows = uni_ops.pack_weight_rows(rows_on(augment_step_rows(tab), dev))
    K, sign = tab.w_pred.shape[1], tab.sign
    shape = (TOKEN_SAMPLE["batch"], 64, 64)
    x, e_new, x_pred = (torch.randn(shape, generator=g, device=dev)
                        for _ in range(3))
    E = torch.randn((K + 1,) + shape, generator=g, device=dev)
    row_ops = {}
    for kind, idx in (("uniform row 5", torch.tensor(5, device=dev)),
                      ("per-slot", torch.tensor([0, 1, 2, 3, 5, 8, 10, 11],
                                                device=dev))):
        for op, fn, cost in (
                ("predict", lambda b=None, i=idx: uni_ops.unipc_row_predict(
                    x, E, rows, i, sign, backend=b),
                 uni_ops.cost_predict(x, E, rows, idx)),
                ("correct", lambda b=None, i=idx: uni_ops.unipc_row_correct(
                    x, E, e_new, x_pred, rows, i, sign, backend=b),
                 uni_ops.cost_correct(x, E, e_new, x_pred, rows, idx))):
            got, want = fn(), fn("plain")
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"unipc_update {op} [{kind} (8, 64, 64) fp32] is not "
                     f"bit-equal to its plain version")
            bms, by = bound(cost)
            st = row_ops[f"{op} {kind}"] = dict(
                ms=device_ms(fn), plain_ms=device_ms(lambda f=fn: f("plain")),
                bound_ms=bms, bound_by=by)
            print(f"  unipc_update {op} [{kind} (8, 64, 64) fp32, K = {K}] "
                  f"bit-equal; {st['ms']:.6f} ms in the graph (bound "
                  f"{bms:.6f} by {by}; plain {st['plain_ms']:.6f})")
    out["unipc_row_ops"] = row_ops
    return out


def token_inputs(cfg, batch: int, length: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, length)).astype(np.int32)


@contextlib.contextmanager
def plain_rounding_p():
    """Inside the block, the plain attention (what `backend="plain"` runs)
    is its round_p=True variant: P rounded to bf16 before P.V, the row sum
    from the fp32 P, as the bf16 kernel's `mma` body does it (the port's
    plain version and the reference's Pallas kernel keep P in fp32). A
    yardstick for the kernel runs only; no path of the port reaches it."""
    from repro_torch.kernels.flash_attention import ref as fa_ref

    plain = fa_ref.attention
    fa_ref.attention = functools.partial(plain, round_p=True)
    try:
        yield
    finally:
        fa_ref.attention = plain


def serving_bounds(cfg, kept, inputs, max_len: int, decoder) -> dict:
    """The prefill's and a decode step's bounds on this card, each from the
    operation count of one eager call (`path_bound`): the prefill of
    `inputs` over the kept weights, and one step of `decoder`'s decode
    function on a copy of its cache (the step writes the cache in place)."""
    from repro_torch.models import api

    with torch.no_grad():
        pre = path_bound(api.prefill_fn(cfg), kept, inputs, max_len)
        cache = clone_tree(decoder.cache)
        dec = path_bound(api.decode_fn(cfg), kept, cache, decoder.token,
                         decoder.pos)
    del cache
    return dict(prefill_bound_ms=pre["bound_ms"], decode_bound_ms=dec[
        "bound_ms"], prefill=pre, decode=dec)


def bf16_parity(label: str, k, p, t, r=None) -> dict:
    """Kernel (k) and plain-pinned (p) bf16 results against the fp32
    plain-pinned one (t), relative L-inf; fails unless the kernel run is
    within TOKEN_TOL of the plain run's own distance from t. With `r`, the
    bf16 run pinned to plain_rounding_p's variant (a second correct plain
    run, one rounding apart, as DEEP_BF16 carries it), its distances are
    printed beside them."""
    errs = dict(kernel_vs_plain=rel_err(k, p), kernel_vs_fp32=rel_err(k, t),
                plain_vs_fp32=rel_err(p, t))
    null = ""
    if r is not None:
        errs.update(rounded_vs_fp32=rel_err(r, t),
                    rounded_vs_plain=rel_err(r, p))
        null = (f"; the rounded-P plain run: {errs['rounded_vs_fp32']:.3e} "
                f"from the fp32 run, {errs['rounded_vs_plain']:.3e} from "
                f"plain-pinned")
    print(f"  {label}: bf16 kernels vs plain-pinned "
          f"{errs['kernel_vs_plain']:.3e}; vs the fp32 run: kernels "
          f"{errs['kernel_vs_fp32']:.3e}, plain-pinned "
          f"{errs['plain_vs_fp32']:.3e}{null} (gate: kernels <= plain + "
          f"{TOKEN_TOL:g})")
    if not errs["kernel_vs_fp32"] <= errs["plain_vs_fp32"] + TOKEN_TOL:
        fail(f"{label}: the kernel run is {errs['kernel_vs_fp32']:.3e} from "
             f"the fp32 run, the plain-pinned bf16 run "
             f"{errs['plain_vs_fp32']:.3e}")
    return errs


def prefill_parity(cfg, params, kept, batch: dict, max_len: int,
                   rounded: bool = False) -> tuple:
    """Prefill's last-position logits four ways at full depth: bf16 with the
    kernels and plain-pinned (over the weights kept once), fp32
    plain-pinned (the truth) and fp32 with the kernels (<= DECODE_TOL of
    it); with `rounded` a fifth, bf16 pinned to plain_rounding_p's
    variant (DEEP_BF16's second plain run). `batch` holds the prompts (and a vlm's or
    an audio model's embeddings). Returns the errors and the caches in
    that order (None for the fifth unless `rounded`)."""
    from repro_torch.models import api

    c32 = dataclasses.replace(cfg, dtype="float32")
    lk, kc = api.prefill_fn(cfg)(kept, batch, max_len)
    lp, pc = api.prefill_fn(plain_pinned(cfg))(kept, batch, max_len)
    lt, tc = api.prefill_fn(plain_pinned(c32))(params, batch, max_len)
    lk32, kc32 = api.prefill_fn(c32)(params, batch, max_len)
    lr, rc = None, None
    if rounded:
        with plain_rounding_p():
            lr, rc = api.prefill_fn(plain_pinned(cfg))(kept, batch, max_len)
    errs = bf16_parity(f"{cfg.arch_id} prefill's last logits", lk, lp, lt,
                       lr)
    errs["fp32_kernel_vs_plain"] = rel_err(lk32, lt)
    print(f"  {cfg.arch_id} prefill at fp32, all {cfg.num_layers} layers: "
          f"kernels vs plain-pinned {errs['fp32_kernel_vs_plain']:.3e} (tol "
          f"{DECODE_TOL:g})")
    if not errs["fp32_kernel_vs_plain"] <= DECODE_TOL:
        fail(f"{cfg.arch_id} fp32 prefill: kernels vs plain-pinned "
             f"{errs['fp32_kernel_vs_plain']:.3e}")
    return errs, (kc, pc, tc, kc32, rc)


def teacher_forced_parity(cfg, params, kept, caches, tokens, start: int):
    """The kernel run's tokens fed through eager decode steps (which launch
    no port kernel) over prefill_parity's caches, each step's logits held
    as bf16_parity holds prefill's: within TOKEN_TOL of the plain run's
    distance from the fp32 run at every step; where prefill_parity made
    the rounded-P cache (an arch in DEEP_BF16), over the run instead: the
    worst step and the mean over the steps each within TOKEN_TOL of the
    plain run's, with the steps past plain + TOKEN_TOL counted for the
    kernel run and for the rounded-P run. The fp32 kernel cache's logits
    are held to the fp32 plain-pinned cache's within DECODE_TOL at each
    step. Returns the worst step's errors, the means and the counts."""
    from repro_torch.models import api

    c32 = dataclasses.replace(cfg, dtype="float32")
    kc, pc, tc, kc32, rc = caches
    deep = rc is not None
    steps = []
    for i in range(tokens.shape[1]):
        tok, pos = tokens[:, i:i + 1], start + i
        lk, _ = api.decode_fn(cfg)(kept, kc, tok, pos)
        lp, _ = api.decode_fn(cfg)(kept, pc, tok, pos)
        lt, _ = api.decode_fn(c32)(params, tc, tok, pos)
        step = dict(kernel_vs_plain=rel_err(lk, lp),
                    kernel_vs_fp32=rel_err(lk, lt),
                    plain_vs_fp32=rel_err(lp, lt))
        if deep:
            lr, _ = api.decode_fn(cfg)(kept, rc, tok, pos)
            step.update(rounded_vs_plain=rel_err(lr, lp),
                        rounded_vs_fp32=rel_err(lr, lt))
        l32, _ = api.decode_fn(c32)(params, kc32, tok, pos)
        step["fp32_kernel_vs_plain"] = rel_err(l32, lt)
        if step["fp32_kernel_vs_plain"] > DECODE_TOL:
            fail(f"teacher-forced decode step {i} at fp32: the kernel "
                 f"cache's logits are {step['fp32_kernel_vs_plain']:.3e} "
                 f"from the plain-pinned cache's")
        if not deep and step["kernel_vs_fp32"] > (step["plain_vs_fp32"]
                                                  + TOKEN_TOL):
            fail(f"teacher-forced decode step {i}: the kernel cache's logits "
                 f"are {step['kernel_vs_fp32']:.3e} from the fp32 run's, the "
                 f"plain-pinned cache's {step['plain_vs_fp32']:.3e}")
        steps.append(step)
    worst = {k: max(st[k] for st in steps) for k in steps[0]}
    mean = {k: float(np.mean([st[k] for st in steps])) for k in steps[0]}
    over = sum(st["kernel_vs_fp32"] > st["plain_vs_fp32"] + TOKEN_TOL
               for st in steps)
    over_rounded = over_farther = None
    if deep:
        over_rounded = sum(st["rounded_vs_fp32"] > st["plain_vs_fp32"]
                           + TOKEN_TOL for st in steps)
        over_farther = sum(st["kernel_vs_fp32"] > max(
            st["plain_vs_fp32"], st["rounded_vs_fp32"]) + TOKEN_TOL
            for st in steps)
    rounded = ("" if not deep else
               f"; the rounded-P plain cache: vs plain-pinned at most "
               f"{worst['rounded_vs_plain']:.3e}, vs fp32 worst "
               f"{worst['rounded_vs_fp32']:.3e} mean "
               f"{mean['rounded_vs_fp32']:.3e}, {over_rounded} step(s) past "
               f"plain + {TOKEN_TOL:g}; {over_farther} step(s) with kernels > "
               f"the farther of the two + {TOKEN_TOL:g}")
    print(f"  the run's {tokens.shape[1]} tokens teacher-forced through "
          f"decode steps, worst step: kernel cache vs plain-pinned cache "
          f"{worst['kernel_vs_plain']:.3e}; vs the fp32 cache: kernels "
          f"{worst['kernel_vs_fp32']:.3e}, plain-pinned "
          f"{worst['plain_vs_fp32']:.3e}; mean over the steps: kernels "
          f"{mean['kernel_vs_fp32']:.3e}, plain-pinned "
          f"{mean['plain_vs_fp32']:.3e}; {over} step(s) with kernels > plain "
          f"+ {TOKEN_TOL:g}{rounded}; fp32 kernel cache vs plain-pinned at most "
          f"{worst['fp32_kernel_vs_plain']:.3e} (tol {DECODE_TOL:g} a step) "
          f"(bf16 gate: kernels <= plain + {TOKEN_TOL:g} "
          f"{'on the worst step and the mean' if deep else 'a step'})")
    if deep:
        for name, got, yard in (
                ("worst step", worst["kernel_vs_fp32"],
                 worst["plain_vs_fp32"]),
                ("mean", mean["kernel_vs_fp32"], mean["plain_vs_fp32"])):
            if not got <= yard + TOKEN_TOL:
                fail(f"teacher-forced decode, {name}: the kernel cache's "
                     f"logits are {got:.3e} from the fp32 run's, the "
                     f"plain-pinned cache's {yard:.3e}")
    return dict(worst, mean=mean, steps_over=over,
                rounded_steps_over=over_rounded,
                steps_over_farther=over_farther)


def depth_cut(cfg, **over):
    """The fp32 checks' config at full width: DECODE_DEPTH layers; for the
    hybrid two groups of two and a one-layer tail; for the vlm two groups
    of a self-attention and a cross-attention layer; for the audio model
    DECODE_DEPTH encoder and decoder layers."""
    if cfg.family == "hybrid":
        over = dict(attn_every=2, **over)
    if cfg.family == "vlm":
        over = dict(cross_attn_every=2, **over)
    if cfg.family == "audio":
        over = dict(encoder_layers=DECODE_DEPTH, **over)
    return dataclasses.replace(
        cfg, num_layers=5 if cfg.family == "hybrid" else DECODE_DEPTH,
        dtype="float32", **over)


def fp32_decode_vs_forward(cfg, params, dev, S: int = 256) -> float:
    """The reference's test_decode_matches_forward at full width over a
    depth cut (`cfg` from depth_cut, `params` initialised at it): prefill
    of t[:S] then decode of t[S] against the full forward's logits at S
    (kernels on both sides)."""
    from repro_torch.data.synthetic import frontend_embeds
    from repro_torch.models import api, encdec, hybrid, transformer, vlm

    forward = {"ssm": hybrid.mamba_forward, "hybrid": hybrid.zamba_forward,
               "vlm": vlm.vlm_forward,
               "audio": encdec.encdec_forward}.get(cfg.family,
                                                   transformer.forward)
    t = torch.as_tensor(token_inputs(cfg, 2, S + 1, seed=5)).long().to(dev)
    cond = {k: torch.from_numpy(v).to(dev)
            for k, v in frontend_embeds(cfg, 2, 5).items()}
    hidden, _ = forward(params["backbone"], cfg, t, *cond.values())
    want = transformer.logits_from_hidden(params["backbone"], cfg,
                                          hidden)[:, S]
    _, cache = api.prefill_fn(cfg)(params, dict(tokens=t[:, :S], **cond),
                                   S + 4)
    got, _ = api.decode_fn(cfg)(params, cache, t[:, S:S + 1], S)
    return rel_err(got[:, 0], want)


def diffusion_lm_inputs(cfg, params, batch: int, dev) -> torch.Tensor:
    """Perturbs the diffusion head's out_proj in place (zero-init: eps = 0
    and every parity vacuous otherwise) and draws x_T."""
    from repro_torch.launch.sample import latent_shape

    head = params["diffusion_head"]
    head["out_proj"] = OUT_PROJ_SCALE * torch.randn(
        head["out_proj"].shape, generator=torch.Generator(
            device=dev).manual_seed(2), device=dev)
    return torch.randn(latent_shape(cfg, batch), generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)


def lm_engine(cfg, params, batch: int, dev, cond=None):
    """The diffusion LM's engine: launch.sample.build_engine's, or with
    `cond` (a vlm's or an audio model's frontend embeddings, which
    launch.sample does not feed, as the reference's does not) the same
    wiring with `cond` as the eps-net's batch (the reference's api takes
    them so, `src/repro/models/api.py:46-63`)."""
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import SamplerEngine
    from repro_torch.launch.sample import build_engine
    from repro_torch.models import api

    if not cond:
        return build_engine(cfg, params, VPLinear(), batch, device=dev)
    kept = api.cast_weights_once(cfg, params)
    net = api.eps_network(cfg)
    return SamplerEngine(VPLinear(), eps=lambda x, t: net(kept, x, t, cond),
                         device=dev)


def eager_latents(cfg, params, x_T, dev, rounded: bool = False, cond=None):
    """The diffusion LM's latents from one eager UniPC run (build, jit off)
    of `cfg`'s eps-net over `params` (and `cond`, as lm_engine takes it):
    kernels and the row-op kernel, or for a plain-pinned `cfg` the plain
    row ops too, with `rounded` inside plain_rounding_p."""
    from repro_torch.engine import EngineSpec

    spec = EngineSpec(nfe=TOKEN_SAMPLE["nfe"], order=TOKEN_SAMPLE["order"],
                      fused_update=cfg.attention_backend != "plain")
    with plain_rounding_p() if rounded else contextlib.nullcontext():
        return lm_engine(cfg, params, x_T.shape[0], dev, cond).build(
            spec, jit=False)(x_T)


def bf16_second_seed(arch, dev, batch: dict, tokens, max_len: int,
                     seed: int) -> dict:
    """An arch in DEEP_BF16 again at full depth on params from another
    seed (the served model is seed 0, the sampled one seed 1):
    prefill_parity and the teacher-forced run (the served run's tokens)
    with the rounded-P plain run, and the diffusion LM's latents (eager UniPC)
    as latents_parity holds them."""
    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = get_config(arch)
    print(f"  bf16 gates again at all {cfg.num_layers} layers, params of "
          f"seed {seed}:")
    params = api.init_params(cfg, seed, dev)
    kept = api.cast_weights_once(cfg, params)
    pre, caches = prefill_parity(cfg, params, kept, batch, max_len,
                                 rounded=True)
    tf = teacher_forced_parity(cfg, params, kept, caches, tokens,
                               batch["tokens"].shape[1])
    del caches, kept
    free_graphs()
    x_T = diffusion_lm_inputs(cfg, params, TOKEN_SAMPLE["batch"], dev)
    x_k = eager_latents(cfg, params, x_T, dev)
    x_p = eager_latents(plain_pinned(cfg), params, x_T, dev)
    lat = latents_parity(cfg, params, x_T, x_k, x_p, dev)
    return dict(seed=seed, prefill_parity=pre, teacher_forced_parity=tf,
                latents=lat)


def bf16_step_parity(arch, dev, batch: dict, tokens, max_len: int) -> dict:
    """Phase 11's bf16 gates for an arch in DEEP_BF16 at BF16_STEP_LAYERS,
    beside its full-depth ones: fresh params, prefill_parity, every
    teacher-forced step (the served run's tokens) within the plain run's
    distance from the fp32 run + TOKEN_TOL, and the diffusion LM's latents
    (eager UniPC) within MAIN_TOL of plain-pinned."""
    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = dataclasses.replace(get_config(arch),
                              num_layers=BF16_STEP_LAYERS[arch])
    print(f"  bf16 gates step by step at {cut_depth_note(cfg)}:")
    params = init_model(cfg, 0, dev)
    kept = api.cast_weights_once(cfg, params)
    pre, caches = prefill_parity(cfg, params, kept, batch, max_len)
    tf = teacher_forced_parity(cfg, params, kept, caches, tokens,
                               batch["tokens"].shape[1])
    del caches, kept
    free_graphs()
    x_T = diffusion_lm_inputs(cfg, params, TOKEN_SAMPLE["batch"], dev)
    err = rel_err(eager_latents(cfg, params, x_T, dev),
                  eager_latents(plain_pinned(cfg), params, x_T, dev))
    print(f"  diffusion-LM latents, eager: kernels vs plain-pinned rel L-inf "
          f"{err:.3e} (tol {MAIN_TOL:g})")
    if not err <= MAIN_TOL:
        fail(f"{arch} at {cfg.num_layers} layers: diffusion-LM latents "
             f"disagree with plain-pinned: {err:.3e}")
    return dict(layers=cfg.num_layers, prefill_parity=pre,
                teacher_forced_parity=tf, latents_vs_plain=err)


def cut_depth_note(cfg) -> str:
    if cfg.family == "hybrid":
        return f"{cfg.num_layers} layers (groups of {cfg.attn_every} and a tail)"
    if cfg.family == "vlm":
        return (f"{cfg.num_layers} layers (groups of {cfg.cross_attn_every}: "
                f"self-attention layers and a cross-attention layer)")
    if cfg.family == "audio":
        return f"{cfg.encoder_layers} + {cfg.num_layers} layers"
    return f"{cfg.num_layers} layers"


def attention_launches(cfg) -> int:
    """flash_attention launches of one forward (a prefill, an eval, a
    training step's forward): one a layer for the transformers and the vlm
    (its self- and cross-attention layers alike), one an invocation of
    zamba2's shared block, none for the Mamba2 stack, and for the audio
    model one an encoder layer and two a decoder layer (self- and
    cross-attention)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def describe(cfg) -> str:
    if cfg.family in ("ssm", "hybrid"):
        shared = (f"; one shared attention block every {cfg.attn_every} "
                  f"layers ({cfg.num_heads}/{cfg.num_kv_heads} heads of "
                  f"{cfg.head_dim})" if cfg.family == "hybrid" else "")
        return (f"{cfg.num_layers} Mamba2 layers, d_model {cfg.d_model}, "
                f"{cfg.ssm_heads} SSD heads of {cfg.ssm_head_dim}, state "
                f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}{shared}, vocab "
                f"{cfg.vocab_size}, {cfg.dtype} over {cfg.param_dtype} params")
    if cfg.family in ("vlm", "audio"):
        over = (f"{cfg.image_tokens} image tokens" if cfg.family == "vlm"
                else f"{cfg.audio_frames} frames")
        return (f"{cut_depth_note(cfg)} over {over}, d_model {cfg.d_model}, "
                f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim},"
                f" d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype} over "
                f"{cfg.param_dtype} params")
    return (f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
            f"vocab {cfg.vocab_size}, {cfg.dtype} over {cfg.param_dtype} "
            f"params")


def copy_tree(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            copy_tree(dst[k], src[k])
    else:
        dst.copy_(src)


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def init_model(cfg, seed: int, dev) -> dict:
    """api.init_params, with a vlm's zero-init cross-attention gates drawn
    from U(0.3, 0.9) (a fresh vlm's cross-attention adds exactly nothing,
    and every image-path parity would be vacuous)."""
    from repro_torch.models import api

    params = api.init_params(cfg, seed, dev)
    if cfg.family == "vlm":
        g = torch.Generator(device=dev).manual_seed(seed + 100)
        xl = params["backbone"]["xattn_layers"]
        for gate in ("gate_attn", "gate_mlp"):
            xl[gate] = 0.3 + 0.6 * torch.rand(
                xl[gate].shape, generator=g, device=dev, dtype=xl[gate].dtype)
    return params


@contextlib.contextmanager
def depth_of(module, layers):
    """`module.get_config` returning the arch's config cut to `layers`
    layers at full width (unchanged with None): how a depth cut reaches an
    entry point that looks the arch up itself."""
    get_config = module.get_config
    if layers:
        module.get_config = lambda a: dataclasses.replace(
            get_config(a), num_layers=layers)
    try:
        yield
    finally:
        module.get_config = get_config


def token_serving_part(dev, counts_out: dict, arch: str = TOKEN_ARCH,
                       shape: dict = TOKEN_SERVE, layers=None) -> dict:
    """(b) a token arch (qwen2-0.5b in phase 11; mamba2-780m and zamba2-7b
    in phase 13; whisper-small and llama-3.2-vision-90b at `layers` in
    phase 14) at full width through launch.serve.serve."""
    from repro_torch.launch import serve as serve_mod

    with depth_of(serve_mod, layers):
        return _token_serving_part(dev, counts_out, arch, shape,
                                   serve_mod.get_config(arch))


def _token_serving_part(dev, counts_out: dict, arch: str, shape: dict,
                        cfg) -> dict:
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.serve import decode_tokens, serve
    from repro_torch.models import api

    print(f"  {arch}: {describe(cfg)}")
    B, S, G = (shape[k] for k in ("batch", "prompt_len", "gen"))
    params = init_model(cfg, 0, dev)
    n_params = sum(t.numel() for t in tensor_leaves(params["backbone"]))
    prompts = token_inputs(cfg, B, S, seed=3)
    # the weights kept once, as serve() keeps them: made here, so both
    # serve() calls below share one bf16 copy (llama-vision's 10 layers
    # hold 43 GB of fp32 params and 21 GB of bf16 weights)
    kw = dict(reduced=False, batch=B, prompt_len=S, gen=G, device=dev,
              params=api.cast_weights_once(cfg, params), prompts=prompts)
    free_graphs()
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES.clear()
    run = serve(arch, return_run=True, **kw)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    counts_out.update(counts)
    peak = torch.cuda.max_memory_allocated(dev)
    want = nonzero({"flash_attention": attention_launches(cfg)})
    print(f"  serve(): launches {counts} (prefill {want}, decode 0 a step); "
          f"prefill {run.prefill_s * 1e3:.3f} ms, decode {G} steps "
          f"{run.decode_s * 1e3:.3f} ms (the capture inside); peak memory "
          f"{peak / 2**30:.2f} GiB")
    if counts != want:
        fail(f"token serve launch counts {counts} != {want}")
    dec = run.decoder
    if dec.graph is None:
        fail("the decode step was not captured as a CUDA graph")
    LAUNCHES.clear()
    dec.graph.replay()
    torch.cuda.synchronize()
    if sum(LAUNCHES.values()):
        fail(f"a decode step launched port kernels: {dict(LAUNCHES)}")

    # the steady decode loop again on the captured graph, from prefill's
    # logits and its cache (prefill again, bit-equal, copied into the
    # graph's: an SSM state has moved on with every step): bit-equal
    # tokens, no host sync, its wall
    _, fresh = api.prefill_fn(cfg)(dec.params, run.inputs,
                                   S + G)
    copy_tree(dec.cache, fresh)
    del fresh
    first = torch.argmax(run.prefill_logits[:, -1], dim=-1)
    gen_rng = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        again = decode_tokens(dec, first, S, G, 0.0, gen_rng)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    if not np.array_equal(again.cpu().numpy(), run.tokens):
        fail("the graph's decode loop run again differs from serve()'s")
    print(f"  the decode loop again on the graph under "
          f"set_sync_debug_mode('error'): {G} steps, no host sync, tokens "
          f"bit-equal; {loop_s * 1e3:.3f} ms, "
          f"{B * G / loop_s:.1f} tokens/s")

    # the eager step: the same tokens bit for bit
    free_graphs()
    eager = serve(arch, jit=False, return_run=True, **kw)
    if not np.array_equal(eager.tokens, run.tokens):
        fail("graph decode tokens differ from the eager decode's")
    print(f"  eager decode (jit=False): tokens bit-equal to the graph's; "
          f"{eager.decode_s * 1e3:.3f} ms for {G} steps, "
          f"{B * G / eager.decode_s:.1f} tokens/s")
    replay_ms = host_call_ms(dec.graph.replay, iters=20, warmup=2)
    eager_ms = host_call_ms(eager.decoder.step, iters=20, warmup=2)
    kept = dec.params
    prefill_walls = median_walls({"prefill": lambda: api.prefill_fn(cfg)(
        kept, run.inputs, S + G)}, reps=3)["prefill"]
    bounds = serving_bounds(cfg, kept, run.inputs, S + G, eager.decoder)
    print(f"  decode step: graph replay {replay_ms:.4f} ms, eager step "
          f"{eager_ms:.4f} ms (CUDA events, back to back; bound "
          f"{bounds['decode_bound_ms']:.4f} ms by "
          f"{bounds['decode']['bound_by']}: "
          f"{bounds['decode']['min_bytes'] / 1e9:.3f} GB); prefill median "
          f"{prefill_walls['median_s'] * 1e3:.3f} ms of "
          f"{[round(w * 1e3, 3) for w in prefill_walls['reps_s']]} (bound "
          f"{bounds['prefill_bound_ms']:.4f} ms by "
          f"{bounds['prefill']['bound_by']}: "
          f"{bounds['prefill']['flops'] / 1e12:.3f} TFLOP, "
          f"{bounds['prefill']['min_bytes'] / 1e9:.3f} GB)")
    del eager

    # kernels against plain-pinned and fp32: prefill's last logits, then
    # the kernel run's tokens teacher-forced through decode steps
    tokens = torch.as_tensor(run.tokens).long().to(dev)
    rounded = arch in DEEP_BF16
    pre, caches = prefill_parity(cfg, params, kept, run.inputs, S + G,
                                 rounded=rounded)
    tf = teacher_forced_parity(cfg, params, kept, caches, tokens, S)
    del caches
    print("  profile of the prefill:")
    prof_prefill = profile_split(lambda: api.prefill_fn(cfg)(
        kept, run.inputs, S + G))
    print("  profile of a decode step's replay:")
    prof_decode = profile_split(dec.graph.replay)
    run_prefill_ms = run.prefill_s * 1e3
    inputs = run.inputs
    del dec, run, kept, params, kw
    free_graphs()
    second = stepwise = {}
    if rounded:
        second = bf16_second_seed(arch, dev, inputs, tokens, S + G,
                                  SECOND_SEED)
        free_graphs()
        stepwise = bf16_step_parity(arch, dev, inputs, tokens, S + G)
        free_graphs()
    c4 = depth_cut(cfg)
    dec_err = fp32_decode_vs_forward(c4, init_model(c4, 5, dev), dev)
    print(f"  fp32, {cut_depth_note(c4)} at full width: prefill t[:256] + "
          f"decode t[256] "
          f"vs the forward's logits at 256: rel L-inf {dec_err:.3e} (tol "
          f"{DECODE_TOL:g})")
    if not dec_err <= DECODE_TOL:
        fail(f"decode disagrees with the forward: {dec_err:.3e}")
    return dict(launches=counts, params_b=n_params / 1e9,
                peak_memory_gib=peak / 2**30,
                prefill_first_ms=run_prefill_ms,
                prefill_ms=prefill_walls["median_s"] * 1e3,
                prefill_reps_ms=[w * 1e3 for w in prefill_walls["reps_s"]],
                decode_replay_ms=replay_ms, decode_eager_ms=eager_ms,
                decode_loop_ms_per_token=loop_s / G * 1e3,
                tokens_per_s=B * G / loop_s, **bounds,
                prefill_parity=pre, teacher_forced_parity=tf,
                second_seed_parity=second, step_parity=stepwise,
                fp32_decode_rel_err=dec_err,
                profile_prefill=prof_prefill,
                profile_decode_replay=prof_decode)


def token_sample_part(dev, counts_out: dict, arch: str = TOKEN_ARCH) -> dict:
    """(c) UniPC sampling of a token arch's diffusion LM (qwen2-0.5b in
    phase 11; mamba2-780m and zamba2-7b in phase 13) at full width through
    launch.sample.sample and one engine's graph."""
    from repro_torch.configs import get_config
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.sample import build_engine, sample
    from repro_torch.models import api

    B, nfe, order = (TOKEN_SAMPLE[k] for k in ("batch", "nfe", "order"))
    rows = nfe + 1
    cfg = get_config(arch)
    params = api.init_params(cfg, 1, dev)
    x_T = diffusion_lm_inputs(cfg, params, B, dev)
    spec = EngineSpec(nfe=nfe, order=order)
    L = attention_launches(cfg)
    expected = nonzero({"flash_attention": L * rows, "unipc_update": 2 * rows})
    warm = nonzero({"flash_attention": L, "unipc_update": 2})
    free_graphs()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    x0 = sample(arch, reduced=False, nfe=nfe, order=order, batch=B,
                params=params, x_T=x_T, device=dev)
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    want = {k: expected[k] + warm[k] for k in expected}
    print(f"  sample(): launches {dict(sorted(counts.items()))} = one eager "
          f"warm-up row {warm} + one replay {expected}; {wall:.3f} s "
          f"(first call: capture included)")
    if counts != want:
        fail(f"diffusion-LM sample() launch counts {counts} != {want}")
    if x0.shape != (B, 64, cfg.latent_dim) or not np.isfinite(x0).all():
        fail(f"diffusion-LM output shape {x0.shape} / finite "
             f"{np.isfinite(x0).all()}")
    engine = build_engine(cfg, params, VPLinear(), B, device=dev)
    g = graph_checks("diffusion LM", engine, spec, x_T, expected, counts_out)
    if not torch.equal(g["x_graph"].cpu(), torch.as_tensor(x0)):
        fail("diffusion-LM sample()'s latents differ from the engine replay")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x_eager = g["eager"](x_T)
        x_replay = g["run"](x_T)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not (torch.equal(x_eager, g["x_eager"])
            and torch.equal(x_replay, g["x_graph"])):
        fail("the sync-checked diffusion-LM runs differ from the counted ones")
    print(f"  eager row loop and one replay under set_sync_debug_mode"
          f"('error'): {rows} rows, no host sync, bit-equal")
    walls = median_walls({"replay": lambda: g["run"](x_T),
                          "eager": lambda: g["eager"](x_T)})
    for name, w in walls.items():
        print(f"  wall {name}: median {w['median_s']:.4f} s of "
              f"{[round(v, 4) for v in w['reps_s']]} ({B} sequences of 64)")
    del g, engine
    free_graphs()
    plain = build_engine(plain_pinned(cfg), params, VPLinear(), B, device=dev)
    LAUNCHES.clear()
    x_plain = plain.build(dataclasses.replace(spec, fused_update=False),
                          jit=False)(x_T)
    torch.cuda.synchronize()
    if sum(LAUNCHES.values()):
        fail(f"the plain-pinned diffusion-LM run launched kernels: "
             f"{dict(LAUNCHES)}")
    del plain
    x0 = torch.as_tensor(x0).to(dev)
    out = dict(sample_wall_s=wall, sample_launches=counts,
               replay_launches=dict(counts_out), walls=walls)
    return dict(out, **latents_parity(cfg, params, x_T, x0, x_plain, dev))


def latents_parity(cfg, params, x_T, x0, x_plain, dev, cond=None) -> dict:
    """The sampled latents `x0` (kernels) within MAIN_TOL of the eager
    plain-pinned run `x_plain`; for an arch in DEEP_BF16 that gate holds at
    BF16_STEP_LAYERS (bf16_step_parity), and here the eager rounded-P
    plain-pinned run's distance from `x_plain` is printed beside the
    kernels' and the fp32-anchored gate below holds. Beyond the decoder-only family (phases 13, 14), both bf16
    runs against the fp32 run as bf16_parity holds logits, and the
    kernels at fp32 to DECODE_TOL, all layers."""
    arch = cfg.arch_id
    err = rel_err(x0, x_plain)
    out = dict(rel_err_vs_plain=err)
    x_round = None
    if arch in DEEP_BF16:
        x_round = eager_latents(plain_pinned(cfg), params, x_T, dev,
                                rounded=True, cond=cond)
        out["rounded_rel_err_vs_plain"] = rel_err(x_round, x_plain)
        print(f"  kernel vs plain-pinned latents: rel L-inf {err:.3e}; the "
              f"rounded-P plain run vs plain-pinned "
              f"{out['rounded_rel_err_vs_plain']:.3e} (tol {MAIN_TOL:g} held at "
              f"{BF16_STEP_LAYERS[arch]} layers; at this depth against the "
              f"fp32 run below)")
    else:
        print(f"  kernel vs plain-pinned latents: rel L-inf {err:.3e} (tol "
              f"{MAIN_TOL:g})")
        if not err <= MAIN_TOL:
            fail(f"{arch}: diffusion-LM latents disagree with plain-pinned: "
                 f"{err:.3e}")
    if cfg.family in ("dense", "moe"):
        return out
    c32 = dataclasses.replace(cfg, dtype="float32")
    truth = eager_latents(plain_pinned(c32), params, x_T, dev, cond=cond)
    x32 = eager_latents(c32, params, x_T, dev, cond=cond)
    errs = bf16_parity(f"{arch}'s diffusion-LM latents", x0, x_plain, truth,
                       x_round)
    errs["fp32_kernel_vs_plain"] = rel_err(x32, truth)
    print(f"  at fp32, all {cfg.num_layers} layers: kernel vs plain-pinned "
          f"latents {errs['fp32_kernel_vs_plain']:.3e} (tol {DECODE_TOL:g})")
    if not errs["fp32_kernel_vs_plain"] <= DECODE_TOL:
        fail(f"{arch}'s fp32 diffusion-LM latents: kernels vs plain-pinned "
             f"{errs['fp32_kernel_vs_plain']:.3e}")
    return dict(out, parity=errs)


def moe_serving_part(dev, counts_out: dict) -> dict:
    """(d) granite-moe-3b-a800m at full width through launch.serve.serve."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.serve import serve
    from repro_torch.models import api

    cfg = get_config(MOE_ARCH)
    B, S, G = (MOE_SERVE[k] for k in ("batch", "prompt_len", "gen"))
    params = api.init_params(cfg, 2, dev)
    n_params = sum(t.numel() for t in tensor_leaves(params["backbone"]))
    prompts = token_inputs(cfg, B, S, seed=4)
    free_graphs()
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES.clear()
    run = serve(MOE_ARCH, reduced=False, batch=B, prompt_len=S, gen=G,
                device=dev, params=params, prompts=prompts, return_run=True)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    counts_out.update(counts)
    peak = torch.cuda.max_memory_allocated(dev)
    if counts != {"flash_attention": cfg.num_layers}:
        fail(f"granite serve launch counts {counts}")
    dec = run.decoder
    replay_ms = host_call_ms(dec.graph.replay, iters=10, warmup=2)
    kept = dec.params
    prefill_walls = median_walls({"prefill": lambda: api.prefill_fn(cfg)(
        kept, run.inputs, S + G)}, reps=3)["prefill"]
    bounds = serving_bounds(cfg, kept, run.inputs, S + G, dec)
    print(f"  {n_params / 1e9:.3f}B backbone params; serve(): launches "
          f"{counts}; prefill median {prefill_walls['median_s'] * 1e3:.3f} ms "
          f"(bound {bounds['prefill_bound_ms']:.4f}), decode replay "
          f"{replay_ms:.4f} ms a token (bound "
          f"{bounds['decode_bound_ms']:.4f}: "
          f"{bounds['decode']['min_bytes'] / 1e9:.3f} GB); peak "
          f"memory {peak / 2**30:.2f} GiB")
    print("  profile of a decode step's replay:")
    prof_decode = profile_split(dec.graph.replay)
    pre, caches = prefill_parity(cfg, params, kept, run.inputs, S + G)
    del dec, run, kept, caches, params
    free_graphs()
    c4 = depth_cut(cfg, capacity_factor=MOE_CAPACITY)
    dec_err = fp32_decode_vs_forward(c4, api.init_params(c4, 5, dev), dev)
    print(f"  fp32, {DECODE_DEPTH} layers at full width, capacity "
          f"{MOE_CAPACITY:g} (no drops): decode vs forward rel L-inf "
          f"{dec_err:.3e} (tol {DECODE_TOL:g})")
    if not dec_err <= DECODE_TOL:
        fail(f"granite decode disagrees with the forward: {dec_err:.3e}")
    return dict(launches=counts, params_b=n_params / 1e9,
                peak_memory_gib=peak / 2**30,
                prefill_ms=prefill_walls["median_s"] * 1e3,
                decode_replay_ms=replay_ms, **bounds,
                prefill_parity=pre, fp32_decode_rel_err=dec_err,
                profile_decode_replay=prof_decode)


def tensor_leaves(tree) -> list:
    """The tensors of a nested dict."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    return [tree]


def token_phase(dev, counts_out: dict) -> dict:
    out = {"kernels": token_kernel_cases(dev)}
    free_graphs()
    counts_out["serve"], counts_out["sample"], counts_out["moe"] = {}, {}, {}
    out["serve"] = token_serving_part(dev, counts_out["serve"])
    free_graphs()
    out["sample"] = token_sample_part(dev, counts_out["sample"])
    free_graphs()
    out["moe"] = moe_serving_part(dev, counts_out["moe"])
    free_graphs()
    return out


# --------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH = 20, 8
TRAIN_PROFILE_STEP = 10       # the step run under torch.profiler
TUNE_TRAIN_STEPS = 100        # launch.tune's default, the reference's
# one bf16 training step, kernels against plain-pinned: each gradient leaf
# within this relative L2 (the ceiling; PERF.md states the measured value);
# the same step at fp32 over STEP_FP32_DEPTH blocks within STEP_FP32_TOL
STEP_TOL = 2e-2
STEP_FP32_DEPTH = 4
STEP_FP32_TOL = 1e-4
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}   # per backward case
BWD_KERNELS = [  # name, source, replaces (the TPU kernel differentiated)
    ("adaln_modulate_bwd", "src/repro_torch/kernels/csrc/adaln_modulate.cu",
     "src/repro/kernels/adaln_modulate/kernel.py:61"),
    ("gate_residual_bwd", "src/repro_torch/kernels/csrc/adaln_modulate.cu",
     "src/repro/kernels/adaln_modulate/kernel.py:90"),
    ("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention/kernel.py:84"),
]


def train_launches(cfg, steps: int) -> dict:
    """Kernel launches of `steps` training steps of the DiT: per step the
    eval's 2L + 1 modulations, 2L gated residuals and L attentions, and
    one backward launch of each."""
    L = cfg.num_layers
    per = {"adaln_modulate": 2 * L + 1, "gate_residual": 2 * L,
           "flash_attention": L}
    return {k + s: n * steps for k, n in per.items() for s in ("", "_bwd")}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def backward_kernel_cases(dev) -> dict:
    """(a) each backward kernel against its plain version (`ref.py`'s
    formula) at the training path's shapes and operand layouts and at edge
    shapes, each labelled with its plan; timed as phase 3 times (100 calls
    in a CUDA graph) beside its bound, its plain version and one library
    call (timed queued behind a spin kernel, as it runs through autograd or
    has no graph-safe form)."""
    import torch.nn.functional as F

    from repro_torch.kernels.adaln_modulate import kernel as ak
    from repro_torch.kernels.adaln_modulate import ops as adaln_ops
    from repro_torch.kernels.adaln_modulate import ref as ar
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fr

    g = torch.Generator(device=dev).manual_seed(4321)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    out = {}

    def check(name, label, got, want, dt):
        torch.cuda.synchronize()
        linf = max(rel_err(a, b) for a, b in zip(got, want))
        l2 = max(rel_l2(a, b) for a, b in zip(got, want))
        abs_err = max(float((a.double() - b.double()).abs().max())
                      for a, b in zip(got, want))
        if not all(torch.isfinite(a.float()).all() for a in got):
            fail(f"{name} [{label}]: non-finite kernel output")
        # fp32: relative L-inf; bf16 (P and dS rounded for the tensor
        # cores, each output rounded once): relative L2
        err = linf if dt == torch.float32 else l2
        print(f"  {name} [{label}] rel L-inf {linf:.3e} rel L2 {l2:.3e} "
              f"(tol {BWD_TOL[dt]:g} {'L-inf' if dt == torch.float32 else 'L2'})"
              f" abs {abs_err:.3e}")
        if not err <= BWD_TOL[dt]:
            fail(f"{name} [{label}] disagrees with its plain version: "
                 f"{err:.3e} > {BWD_TOL[dt]:g}")
        st = out.setdefault(name, dict(cases={}, max_abs_err=0.0,
                                       max_rel_err=0.0))
        st["cases"][label] = dict(rel_linf=linf, rel_l2=l2)
        st["max_abs_err"] = max(st["max_abs_err"], abs_err)
        st["max_rel_err"] = max(st["max_rel_err"], err)

    def timed(name, k_fn, p_fn, lib, cost, **extra):
        bms, by = bound(cost)
        lib_ms = queued_device_ms(lib) if lib is not None else None
        out[name].update(ms=device_ms(k_fn), host_call_ms=host_call_ms(k_fn),
                         plain_ms=device_ms(p_fn), library_ms=lib_ms,
                         bound_ms=bms, bound_by=by, **extra)
        st = out[name]
        print(f"  {name}: {st['ms']:.6f} ms a call on the card (bound "
              f"{bms:.6f} by {by}), plain {st['plain_ms']:.6f}, library "
              f"{lib_ms if lib_ms is None else round(lib_ms, 6)}, host "
              f"{st['host_call_ms']:.6f} ms a call eager; "
              f"{ {k: v for k, v in extra.items()} }")

    # adaLN modulate and gate_residual: (B, T, D, dtype, conditioning
    # width): the path's block and head rows at batch 8, the fp32 run's,
    # ragged D and T, dit-cifar, MAX_D
    B, T, D = TRAIN_BATCH, 256, 1152
    row_cases = [(B, T, D, torch.bfloat16, 6, "path block (B, 6D) rows"),
                 (B, T, D, torch.bfloat16, 2, "path head (B, 2D) rows"),
                 (B, T, D, torch.float32, 6, "fp32 run"),
                 (3, 37, 100, torch.float32, 6, "fp32 ragged D 100, T 37"),
                 (2, 5, 72, torch.float32, 6, "fp32 D 72"),
                 (B, 64, 384, torch.bfloat16, 6, "dit-cifar"),
                 (2, 33, 100, torch.bfloat16, 6, "bf16 ragged D 100"),
                 (2, 5, 8192, torch.bfloat16, 6, "MAX_D")]
    path = {}
    for b_, t_, d_, dt, width, label in row_cases:
        x, y, gr = (randn(b_, t_, d_, dtype=dt) for _ in range(3))
        mod = randn(b_, width * d_, dtype=dt)
        scale, gate = mod[:, d_:2 * d_], mod[:, (width - 1) * d_:width * d_]
        tag = f"{label} ({b_}, {t_}, {d_}) {str(dt)[6:]}, rows {ak.bwd_rows(x)}"
        check("adaln_modulate_bwd", tag, ak.modulate_bwd(gr, x, scale),
              ar.modulate_bwd(gr, x, scale), dt)
        check("gate_residual_bwd", tag, ak.gate_residual_bwd(gr, gate, y),
              ar.gate_residual_bwd(gr, gate, y), dt)
        if not path:
            path = dict(x=x, y=y, g=gr, scale=scale, gate=gate)
    x, y, gr, scale, gate = (path[k] for k in ("x", "y", "g", "scale",
                                               "gate"))
    ones = torch.ones(D, device=dev, dtype=x.dtype)
    zeros = torch.zeros(D, device=dev, dtype=x.dtype)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [D], ones, zeros,
                                                     1e-5)
    timed("adaln_modulate_bwd", lambda: ak.modulate_bwd(gr, x, scale),
          lambda: ar.modulate_bwd(gr, x, scale),
          lambda: torch.ops.aten.native_layer_norm_backward(
              gr, x, [D], mean, rstd, ones, zeros, [True, True, True]),
          adaln_ops.cost_modulate_bwd(gr, x, scale),
          library="aten.native_layer_norm_backward (dx, and the column "
                  "sums over all B*T rows)")
    timed("gate_residual_bwd", lambda: ak.gate_residual_bwd(gr, gate, y),
          lambda: ar.gate_residual_bwd(gr, gate, y), None,
          adaln_ops.cost_gate_bwd(gr, gate, y),
          library="none: no one PyTorch call computes dy and the per-b "
                  "sums")

    # attention: (B, H, Sq, Skv, D, dtype, label); q, k, v, do as the
    # head-major views of (B, S, H, D) projections the DiT passes
    att_cases = [(B, 16, 256, 256, 72, torch.bfloat16, "path"),
                 (B, 16, 256, 256, 72, torch.float32, "fp32 run"),
                 (2, 3, 67, 67, 72, torch.float32, "fp32 ragged S 67"),
                 (2, 2, 33, 50, 100, torch.float32, "fp32 D 100, Sq != Skv"),
                 (2, 2, 33, 50, 100, torch.bfloat16, "bf16 D 100, Sq != Skv"),
                 (B, 6, 64, 64, 64, torch.bfloat16, "dit-cifar D 64"),
                 (B, 6, 64, 64, 64, torch.float32, "dit-cifar D 64 fp32"),
                 (1, 2, 130, 70, 128, torch.bfloat16, "D 128")]
    apath = {}
    lse_same = True
    for b_, h_, sq, skv, d_, dt, label in att_cases:
        q = randn(b_, sq, h_, d_, dtype=dt).transpose(1, 2)
        k, v = (randn(b_, skv, h_, d_, dtype=dt).transpose(1, 2)
                for _ in range(2))
        do = randn(b_, sq, h_, d_, dtype=dt).transpose(1, 2)
        o_plain = fk.flash_attention(q, k, v, causal=False)
        o, lse, o32 = fk.flash_attention(q, k, v, causal=False, lse=True)
        torch.cuda.synchronize()
        # the output with lse and o32 is the output without them, and o32
        # rounds to it bit for bit
        same = torch.equal(o, o_plain) and torch.equal(o32.to(dt), o)
        lse_err = rel_err(lse, fr.attention_lse(q, k, causal=False))
        lse_same = lse_same and same
        p = fk.plan_bwd(q, k, v, do)
        tag = (f"{label} ({b_}, {h_}, {sq}, {skv}, {d_}) {str(dt)[6:]}, "
               f"{p['body']} chunks {p['chunks']} vec_in {p['vec_in']}")
        print(f"  flash_attention with lse and o32 [{label}]: output "
              f"bit-equal to the forward without them, o32 rounding to it: "
              f"{same}; lse rel L-inf {lse_err:.3e}")
        if not same or not lse_err <= 1e-5:
            fail(f"flash_attention with lse [{label}]: output equal {same}, "
                 f"lse {lse_err:.3e}")
        got = fk.flash_attention_bwd(q, k, v, o32, lse, do)
        want = fr.attention_bwd(q, k, v, o32, lse, do)
        for a, src in zip(got, (q, k, v)):
            if a.stride() != src.stride():
                fail(f"flash_attention_bwd [{label}]: gradient strides "
                     f"{a.stride()} != the input's {src.stride()}")
        check("flash_attention_bwd", tag, got, want, dt)
        if not apath:
            apath = dict(q=q, k=k, v=v, do=do, o=o32, lse=lse)
    q, k, v, do, o, lse = (apath[n] for n in ("q", "k", "v", "do", "o",
                                              "lse"))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd_bwd():
        out_ = F.scaled_dot_product_attention(*leaves)
        return torch.autograd.grad(out_, leaves, do)

    def ours_fwd_bwd():
        _, l_, o_ = fk.flash_attention(q, k, v, causal=False, lse=True)
        return fk.flash_attention_bwd(q, k, v, o_, l_, do)

    timed("flash_attention_bwd",
          lambda: fk.flash_attention_bwd(q, k, v, o, lse, do),
          lambda: fr.attention_bwd(q, k, v, o, lse, do), sdpa_fwd_bwd,
          fa_ops.cost_bwd(q, k, v, o, lse, do, causal=False, window=None),
          library="SDPA forward + backward through autograd",
          fwd_bwd_queued_ms=queued_device_ms(ours_fwd_bwd),
          lse_output_bit_equal=lse_same)
    return out


@contextlib.contextmanager
def step_recorder(train_mod, profile_at=None):
    """launch.train's steps within the block, instrumented: each step's
    wall (host clock between syncs), its loss tensor, and CUDA event times
    of the loss's forward, the backward and the optimizer's update; step
    `profile_at` runs under torch.profiler instead (its wall kept out)."""
    from repro_torch.models import api

    rec = dict(n=0, walls=[], losses=[], phases=[], profile=None)
    marks: dict = {}
    orig_make, orig_loss = train_mod.make_train_step, api.train_loss

    def mark(name):
        marks[name] = torch.cuda.Event(enable_timing=True)
        marks[name].record()

    def loss_fn(cfg, objective):
        fn = orig_loss(cfg, objective)

        def timed(*args):
            mark("fwd0")
            loss = fn(*args)
            mark("fwd1")
            return loss
        return timed

    class _Opt:
        def __init__(self, opt):
            self.opt = opt

        def init(self, params):
            return self.opt.init(params)

        def update(self, *args):
            mark("opt0")
            res = self.opt.update(*args)
            mark("opt1")
            return res

    def make(cfg, objective, opt):
        step = orig_make(cfg, objective, _Opt(opt))

        def run(*args):
            idx = rec["n"]
            rec["n"] += 1
            torch.cuda.synchronize()
            if idx == profile_at:
                box = {}
                rec["profile"] = profile_split(
                    lambda: box.setdefault("r", step(*args)), kind=train_kind)
                res = box["r"]
            else:
                t0 = time.perf_counter()
                mark("step0")
                res = step(*args)
                mark("step1")
                torch.cuda.synchronize()
                rec["walls"].append(time.perf_counter() - t0)
                rec["phases"].append({
                    "forward": marks["fwd0"].elapsed_time(marks["fwd1"]),
                    "backward": marks["fwd1"].elapsed_time(marks["opt0"]),
                    "optimizer": marks["opt0"].elapsed_time(marks["opt1"]),
                    "step": marks["step0"].elapsed_time(marks["step1"])})
            rec["losses"].append(res[2])
            return res
        return run

    train_mod.make_train_step, api.train_loss = make, loss_fn
    try:
        yield rec
    finally:
        train_mod.make_train_step, api.train_loss = orig_make, orig_loss


def check_losses(label: str, rec: dict, steps: int) -> list:
    losses = torch.stack(rec["losses"]).float().cpu()
    if len(losses) != steps or not torch.isfinite(losses).all():
        fail(f"{label}: {len(losses)} losses of {steps}, finite "
             f"{torch.isfinite(losses).tolist()}")
    return losses.tolist()


def training_part(dev, counts_out: dict) -> dict:
    """(b) launch.train.train at full width: every loss finite, launches a
    step exact, step walls, tokens/s, peak memory, one step's profile."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import tree_leaves

    cfg = get_config("dit-i256")
    free_graphs()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with step_recorder(train_mod, profile_at=TRAIN_PROFILE_STEP) as rec:
        LAUNCHES.clear()
        t0 = time.perf_counter()
        params, hist = train_mod.train(
            "dit-i256", reduced=False, objective="diffusion",
            steps=TRAIN_STEPS, batch=TRAIN_BATCH, log_every=TRAIN_STEPS,
            device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts_out.update(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = check_losses("train()", rec, TRAIN_STEPS)
    want = train_launches(cfg, TRAIN_STEPS)
    print(f"  train(): {TRAIN_STEPS} steps at batch {TRAIN_BATCH} in "
          f"{wall:.3f} s; launches {dict(sorted(counts_out.items()))} "
          f"(expected {want}); losses {[round(x, 4) for x in losses]}")
    if dict(counts_out) != want:
        fail(f"train() launched {dict(counts_out)} != {want}")
    walls = rec["walls"][1:]           # after the first
    med = float(np.median(walls))
    phases = {k: float(np.median([p[k] for p in rec["phases"][1:]]))
              for k in rec["phases"][0]}
    tokens = TRAIN_BATCH * cfg.patch_tokens
    print(f"  step wall: first {rec['walls'][0]:.4f} s, median after it "
          f"{med:.4f} s ({min(walls):.4f}-{max(walls):.4f}); "
          f"{tokens / med:.1f} tokens/s ({TRAIN_BATCH / med:.2f} images/s); "
          f"peak memory {peak / 2**30:.2f} GiB; device-timeline medians "
          f"(CUDA events) forward {phases['forward']:.3f} ms, backward "
          f"{phases['backward']:.3f} ms, optimizer {phases['optimizer']:.3f}"
          f" ms, step {phases['step']:.3f} ms")
    if any(p.requires_grad for p in tree_leaves(params)):
        fail("train() returned params that require grad")
    return dict(params=params, out=dict(
        steps=TRAIN_STEPS, batch=TRAIN_BATCH, wall_s=wall, losses=losses,
        first_step_s=rec["walls"][0], median_step_s=med,
        step_walls_s=rec["walls"], tokens_per_s=tokens / med,
        peak_memory_gib=peak / 2**30, phase_ms=phases,
        launches=dict(counts_out), profile=rec["profile"],
        history=hist))


def loss_and_grads(cfg, params, batch, draws):
    """The diffusion loss and its gradient leaves (sorted key order) at
    `params`, with explicit draws."""
    from repro_torch.models import api
    from repro_torch.optim import tree_leaves, tree_map

    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = api.diffusion_loss_fn(cfg)(leaves, batch, draws)
    flat = tree_leaves(leaves)
    return loss.detach(), torch.autograd.grad(loss, flat)


def step_parity_part(dev) -> dict:
    """(c) one step's loss and every gradient leaf, kernels against
    plain-pinned, from the same perturbed params and draws: bf16 at full
    width (<= STEP_TOL) and fp32 over STEP_FP32_DEPTH blocks
    (<= STEP_FP32_TOL); (d) the full step (loss, gradients, AdamW) twice
    from the same inputs, bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.diffusion import VPLinear
    from repro_torch.diffusion.process import draw_t_noise
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.train import build_batch_fn, make_train_step
    from repro_torch.optim import AdamW, tree_leaves, warmup_cosine

    full = get_config("dit-i256")
    out = {}
    names = None
    for label, cfg, tol in (
            ("bf16, full width", full, STEP_TOL),
            (f"fp32, {STEP_FP32_DEPTH} blocks", dataclasses.replace(
                full, num_layers=STEP_FP32_DEPTH, dtype="float32"),
             STEP_FP32_TOL)):
        free_graphs()
        params = perturbed_params(cfg, dev)
        batch = build_batch_fn(cfg, TRAIN_BATCH, 32, seed=0, device=dev)(0)
        draws = draw_t_noise(VPLinear(), batch["latents"],
                             torch.Generator(device=dev).manual_seed(11))
        LAUNCHES.clear()
        loss_k, grads_k = loss_and_grads(cfg, params, batch, draws)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        if counts != train_launches(cfg, 1):
            fail(f"step ({label}) launched {counts}")
        loss_p, grads_p = loss_and_grads(plain_pinned(cfg), params, batch,
                                         draws)
        if names is None:
            names = [k for k in _leaf_names(params)]
        errs = {n: rel_l2(a, b) for n, a, b in zip(names, grads_k, grads_p)}
        loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        worst = max(errs, key=errs.get)
        print(f"  one step ({label}), kernels vs plain-pinned: loss "
              f"{float(loss_k):.6f} vs {float(loss_p):.6f} (rel "
              f"{loss_err:.3e}); gradient leaves rel L2 max {errs[worst]:.3e}"
              f" ({worst}), each "
              f"{ {n: float(f'{e:.3e}') for n, e in errs.items()} } "
              f"(tol {tol:g})")
        if not (loss_err <= tol and max(errs.values()) <= tol):
            fail(f"one step ({label}): kernels vs plain {loss_err:.3e} / "
                 f"{errs[worst]:.3e} > {tol:g}")
        out[label] = dict(loss=float(loss_k), loss_plain=float(loss_p),
                          loss_rel=loss_err, grad_rel_l2=errs,
                          max_grad_rel_l2=errs[worst])
        del grads_k, grads_p
        if cfg is full:
            # (d) the whole step twice from the same inputs
            opt = AdamW(lr=warmup_cosine(1e-3, 3, 20))
            step = make_train_step(cfg, "diffusion", opt)
            state = opt.init(params)
            runs = [step(params, state, batch, draws) for _ in range(2)]
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(
                [runs[0][2], *tree_leaves(runs[0][0]),
                 *tree_leaves(runs[0][1].m), *tree_leaves(runs[0][1].v)],
                [runs[1][2], *tree_leaves(runs[1][0]),
                 *tree_leaves(runs[1][1].m), *tree_leaves(runs[1][1].v)]))
            print(f"  the full-width step (loss, gradients, AdamW) twice "
                  f"from the same inputs: loss, params and moments "
                  f"bit-equal: {same}")
            if not same:
                fail("two runs of the same training step differ")
            out["repeat_bit_equal"] = same
            del runs, state
        del params
    return out


def _leaf_names(tree, prefix="") -> list:
    """Leaf paths in sorted key order (optim.tree_leaves's order)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}" if prefix
                                     else k)]
    return [prefix]


def checkpoint_part(dev, params) -> dict:
    """(e) the trained params through ckpt.save / restore at full width,
    bit-equal; sampled through launch.sample's --ckpt path, bit-equal to
    sampling the in-memory params, with sampling's launch counts and no
    backward launch."""
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch import sample as sample_mod
    from repro_torch.models import api
    from repro_torch.optim import tree_leaves

    cfg = get_config("dit-i256")
    nfe, order, g_scale, batch = 10, 3, 2.0, 8
    rows = nfe + 1
    expected = expected_launches(cfg, rows)
    # on the card sample()'s first call runs one eager warm-up row more
    warm = expected_launches(cfg, int(dev.type == "cuda"))
    free_graphs()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ckpt.save(d, {"params": params}, step=TRAIN_STEPS)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree, step = ckpt.restore(d)
        restore_s = time.perf_counter() - t0
        flat = tree_leaves(tree["params"])
        same = step == TRAIN_STEPS and all(
            np.array_equal(a, b.cpu().numpy())
            for a, b in zip(flat, tree_leaves(params)))
        nbytes_ = sum(a.nbytes for a in flat)
        print(f"  checkpoint: {nbytes_ / 2**30:.2f} GiB saved in "
              f"{save_s:.2f} s, restored in {restore_s:.2f} s, bit-equal "
              f"to the trained params: {same}")
        if not same:
            fail("the restored checkpoint differs from the trained params")
        free_graphs()
        LAUNCHES.clear()
        x_ckpt = sample_mod.main([
            "--arch", "dit-i256", "--full", "--ckpt", d, "--nfe", str(nfe),
            "--order", str(order), "--cfg-scale", str(g_scale), "--batch",
            str(batch)])
        torch.cuda.synchronize()
        ckpt_counts = dict(LAUNCHES)
    restored = api.params_from_numpy(tree["params"], cfg, dev)
    del tree, flat
    x_mem = sample_mod.sample("dit-i256", reduced=False, params=params,
                              nfe=nfe, order=order, cfg_scale=g_scale,
                              batch=batch, device=dev)
    same = np.array_equal(x_ckpt, x_mem)
    want = {k: expected[k] + warm[k] for k in expected}
    print(f"  sample --ckpt: launches {dict(sorted(ckpt_counts.items()))} "
          f"(expected a warm-up row and the replay {want}); latents "
          f"bit-equal to sample(params=) on the in-memory params: {same}; "
          f"finite {np.isfinite(x_ckpt).all()}, std {x_ckpt.std():.4f}")
    if not same or ckpt_counts != want or not np.isfinite(x_ckpt).all():
        fail("sampling the checkpoint differs from the in-memory params")
    free_graphs()
    engine = sample_mod.build_engine(cfg, restored, VPLinear(), batch,
                                     device=dev)
    spec = EngineSpec(nfe=nfe, order=order, cfg_scale=g_scale)
    run = engine.build(spec)
    x_T = torch.randn(sample_mod.latent_shape(cfg, batch),
                      generator=torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    run(x_T)
    LAUNCHES.clear()
    x_rep = run(x_T)
    torch.cuda.synchronize()
    replay = dict(LAUNCHES)
    print(f"  a replay alone of the restored params' engine: launches "
          f"{dict(sorted(replay.items()))} (phase 4's {expected}); bit-equal "
          f"to sample --ckpt: {np.array_equal(x_rep.cpu().numpy(), x_ckpt)}")
    if replay != expected or not np.array_equal(x_rep.cpu().numpy(),
                                                x_ckpt):
        fail(f"the restored engine's replay launched {replay}")
    del engine, run, restored
    free_graphs()
    return dict(checkpoint_gib=nbytes_ / 2**30, save_s=save_s,
                restore_s=restore_s, restore_bit_equal=True,
                sample_launches=ckpt_counts, replay_launches=replay,
                sample_bit_equal=True)


def tune_trained_part(dev, random_search: dict) -> dict:
    """(f) launch.tune.tune as phase 9 (b), the eps-net trained first for
    the reference's default TUNE_TRAIN_STEPS steps at full width."""
    from repro_torch.launch import train as train_mod
    from repro_torch.launch import tune as tune_mod

    free_graphs()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with step_recorder(train_mod) as rec:
        plan, rep = tune_mod.tune(
            "dit-i256", reduced=False, nfe=TUNE["nfe"],
            budget=TUNE["budget"], rounds=TUNE["rounds"],
            ref_nfe=TUNE["ref_nfe"], batch=TUNE["batch"],
            train_steps=TUNE_TRAIN_STEPS, device=dev)
    wall = time.perf_counter() - t0
    losses = check_losses("tune's training", rec, TUNE_TRAIN_STEPS)
    med = float(np.median(rec["walls"][1:]))
    print(f"  tune (f), trained {TUNE_TRAIN_STEPS} steps first (lr 1e-3, "
          f"batch 8): loss {losses[0]:.4f} -> {losses[-1]:.4f} (min "
          f"{min(losses):.4f}), median step {med:.4f} s; baseline "
          f"{rep['baseline']:.6f} -> tuned {rep['tuned']:.6f} in "
          f"{rep['evals']} evals; phase 9 (b) on random weights "
          f"{random_search['baseline']:.6f} -> {random_search['tuned']:.6f};"
          f" the call {wall:.2f} s; plan orders {plan.orders}")
    if not rep["tuned"] <= rep["baseline"]:
        fail(f"tuned {rep['tuned']} > baseline {rep['baseline']}")
    return dict(train_steps=TUNE_TRAIN_STEPS, losses=losses,
                median_step_s=med, baseline=rep["baseline"],
                tuned=rep["tuned"], evals=rep["evals"],
                random_weights=dict(baseline=random_search["baseline"],
                                    tuned=random_search["tuned"]),
                call_wall_s=wall, plan_orders=list(plan.orders))


def training_phase(dev, counts_out: dict, random_search: dict) -> dict:
    out = {"backward_kernels": backward_kernel_cases(dev)}
    free_graphs()
    trained = training_part(dev, counts_out)
    out["train"] = trained["out"]
    out["step_parity"] = step_parity_part(dev)
    out["checkpoint"] = checkpoint_part(dev, trained.pop("params"))
    out["tune_trained"] = tune_trained_part(dev, random_search)
    return out

# --------------------------------------------------------------------------
# phase 12: training the decoder-only token family
# --------------------------------------------------------------------------

TOKEN_TRAIN = dict(steps=20, batch=8, seq=512)
TRAIN_PARTS = ("ar", "diffusion", "moe", "dit_cifar")   # phase 12's runs
MOE_TRAIN = dict(steps=10, batch=4, seq=256, layers=8)
CIFAR_TRAIN = dict(steps=5, batch=8)
TOKEN_CKPT_SAMPLE = dict(nfe=10, order=3, batch=8)
# label, B, Hq, Hkv, S, D, causal, window: the token training paths'
# attention (qwen2's AR step, its diffusion LM's bidirectional step at the
# training length and at 128, granite's AR step), a window with a group of
# 7, and the DiT's training shape, whose output is pinned bit for bit
# (DIT_BWD_SHA256)
TOKEN_BWD = [
    ("qwen2-0.5b AR, causal GQA 14/2", 8, 14, 2, 512, 64, True, None),
    ("qwen2-0.5b diffusion LM, GQA 14/2", 8, 14, 2, 512, 64, False, None),
    ("diffusion LM at S 128, GQA 14/2", 8, 14, 2, 128, 64, False, None),
    ("granite AR, causal GQA 24/8", 4, 24, 8, 256, 64, True, None),
    ("window 64, GQA 14/2, S=300", 8, 14, 2, 300, 64, True, 64),
    ("dit-i256 training, MHA", 8, 16, 16, 256, 72, False, None),
]
# sha256 of (o, lse, dq, dk, dv) at the DiT's training shape from
# `dit_bwd_inputs`, measured on an H100 80GB HBM3 (torch 2.11.0+cu128): fp32
# with the non-causal, Hq == Hkv backward that preceded masks and groups,
# which the extended backward reproduces; bf16 re-measured when the bf16
# backward came to split P and dS into hi and lo halves and to read Delta
# from the forward's fp32 output, which change those bits on purpose.
# The kernels must reproduce them bit for bit.
DIT_BWD_SHA256 = {
    torch.bfloat16:
        "9e264de9b06524e3667099e3050134a91f09a22b90a0eef572f9f62ea0c58a82",
    torch.float32:
        "2397ded79cc686b1c47ccd5ee05add098b7111767a1bc6a6b1701eeb3fd2d05b"}
PARAM_PERTURB = 0.02      # added to the constant-initialised leaves in (c)


def dit_bwd_inputs(dev, dtype):
    """The DiT case's q, k, v, do: head-major views of (8, 256, 16, 72)
    projections from a CPU generator (the same on every card), the first
    four draws at bf16, the next four at fp32."""
    g = torch.Generator().manual_seed(2024)
    draws = [torch.randn(8, 256, 16, 72, generator=g) for _ in range(8)]
    first = 0 if dtype == torch.bfloat16 else 4
    return [t.to(dtype).to(dev).transpose(1, 2)
            for t in draws[first:first + 4]]


def tensors_sha256(ts) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def token_backward_cases(dev, cases=TOKEN_BWD) -> dict:
    """(a) flash_attention_bwd at the token training shapes, each mask and
    group size, fp32 (<= 1e-5 relative L-inf) and bf16 (<= 1e-2 relative
    L2) against the plain version, each twice (bit-equal) and labelled with
    its plan; the bf16 cases timed as phase 3 times (100 calls in a CUDA
    graph) beside the bound, the plain version and SDPA forward + backward
    with enable_gqa (queued behind a spin kernel, as it runs through
    autograd); the DiT case bit-equal to its pinned output
    (DIT_BWD_SHA256). The backward reads Delta from the forward's fp32
    output (o32), as the autograd Function runs it."""
    F = torch.nn.functional
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fr

    g = torch.Generator(device=dev).manual_seed(12)
    out = {}
    for label, B, Hq, Hkv, S, D, causal, window, *cross in cases:
        Skv = cross[0] if cross else S
        row = dict(shape=[B, Hq, Hkv, S, D], skv=Skv, causal=causal,
                   window=window)
        kw = dict(causal=causal, window=window)
        dit = label.startswith("dit")
        for dt in (torch.float32, torch.bfloat16):
            name = "bf16" if dt == torch.bfloat16 else "fp32"
            if dit:
                q, k, v, do = dit_bwd_inputs(dev, dt)
            else:
                q, do = (torch.randn(B, S, Hq, D, generator=g, device=dev)
                         .to(dt).transpose(1, 2) for _ in range(2))
                k, v = (torch.randn(B, Skv, Hkv, D, generator=g, device=dev)
                        .to(dt).transpose(1, 2) for _ in range(2))
            o, lse, o32 = fk.flash_attention(q, k, v, lse=True, **kw)
            got = fk.flash_attention_bwd(q, k, v, o32, lse, do, **kw)
            again = fk.flash_attention_bwd(q, k, v, o32, lse, do, **kw)
            want = fr.attention_bwd(q, k, v, o32, lse, do, **kw)
            torch.cuda.synchronize()
            p = fk.plan_bwd(q, k, v, do)
            body = (f"{p['body']}, D in {8 * p['chunks']}, "
                    f"{'16' if p['vec_in'] else '2'}-byte loads, grids "
                    f"{p['blocks']}" if p["body"] == "mma"
                    else f"{p['body']}, grids {p['blocks']}")
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            linf = max(rel_err(a, b) for a, b in zip(got, want))
            l2 = max(rel_l2(a, b) for a, b in zip(got, want))
            err = linf if dt == torch.float32 else l2
            finite = all(torch.isfinite(a.float()).all() for a in got)
            strides = all(a.stride() == t.stride()
                          for a, t in zip(got, (q, k, v)))
            print(f"  flash_attention_bwd [{label} ({B}, {Hq}/{Hkv}, {S}"
                  f"{'' if Skv == S else f' over {Skv}'}, {D}) {name}] "
                  f"[{body}] rel L-inf {linf:.3e} rel L2 "
                  f"{l2:.3e} (tol {BWD_TOL[dt]:g} "
                  f"{'L-inf' if dt == torch.float32 else 'L2'}); twice "
                  f"bit-equal {same}")
            if not (finite and strides and same and err <= BWD_TOL[dt]):
                fail(f"flash_attention_bwd [{label} {name}]: finite {finite}"
                     f", strides {strides}, repeat {same}, err {err:.3e}")
            row[f"rel_err_{name}"] = err
            row[f"abs_err_{name}"] = max(
                float((a.double() - b.double()).abs().max())
                for a, b in zip(got, want))
            row[f"body_{name}"] = body
            if dit:
                sha = tensors_sha256((o, lse) + tuple(got))
                ok = sha == DIT_BWD_SHA256[dt]
                print(f"  the DiT case {name}: output sha256 {sha[:16]}...; "
                      f"bit-equal to the pinned kernel output: {ok}")
                if not ok:
                    fail(f"flash_attention_bwd at the DiT's shape ({name}) "
                         f"differs from the pinned kernel output: {sha}")
                row[f"pinned_bits_equal_{name}"] = ok
        # q, k, v, do, o32, lse are the bf16 ones now: time the path's dtype
        pairs = fa_ops.attention_pairs(S, Skv, causal, window)
        bms, by = bound(fa_ops.cost_bwd(q, k, v, o32, lse, do, causal=causal,
                                        window=window))
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        if window:
            qi = torch.arange(S, device=dev)[:, None]
            ki = torch.arange(S, device=dev)[None, :]
            mask = (ki <= qi) & (ki > qi - window)
            sdpa = dict(attn_mask=mask)
        else:
            sdpa = dict(is_causal=causal)

        def lib(leaves=leaves, sdpa=sdpa, do=do):
            out_ = F.scaled_dot_product_attention(*leaves, enable_gqa=True,
                                                  **sdpa)
            return torch.autograd.grad(out_, leaves, do)

        def ours(q=q, k=k, v=v, do=do, kw=kw):
            _, l_, o_ = fk.flash_attention(q, k, v, lse=True, **kw)
            return fk.flash_attention_bwd(q, k, v, o_, l_, do, **kw)

        row.update(
            ms=device_ms(lambda: fk.flash_attention_bwd(q, k, v, o32, lse, do,
                                                        **kw)),
            plain_ms=device_ms(lambda: fr.attention_bwd(q, k, v, o32, lse,
                                                        do, **kw), iters=20),
            library_ms=queued_device_ms(lib),
            fwd_bwd_queued_ms=queued_device_ms(ours), bound_ms=bms,
            bound_by=by, pairs=pairs)
        print(f"  flash_attention_bwd [{label}] bf16: {row['ms']:.6f} ms in "
              f"the graph (bound {bms:.6f} by {by}, {bms / row['ms']:.0%}); "
              f"plain {row['plain_ms']:.6f}; forward + backward queued "
              f"{row['fwd_bwd_queued_ms']:.6f} against SDPA's "
              f"{row['library_ms']:.6f} (enable_gqa)")
        out[label] = row
    return out


def perturbed_token_params(cfg, dev, seed=0):
    """init_params with PARAM_PERTURB N(0, 1) added to each leaf that
    starts constant (the qkv biases, the norms, the diffusion head's
    zero out_proj): their gradients would otherwise be those of a
    special point, and out_proj's zero makes the diffusion loss's
    backbone gradients exactly zero."""
    from repro_torch.models import api

    params = api.init_params(cfg, seed, dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)

    def walk(tree):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf)
            elif leaf.numel() > 1 and bool((leaf == leaf.flatten()[0]).all()):
                tree[key] = leaf + PARAM_PERTURB * torch.randn(
                    leaf.shape, generator=g, device=dev, dtype=leaf.dtype)
    walk(params)
    return params


def token_loss_and_grads(cfg, objective, params, batch, rng) -> tuple:
    """The loss and every gradient leaf (sorted key order; zeros where the
    loss reads no leaf, as make_train_step gives them)."""
    from repro_torch.models import api
    from repro_torch.optim import tree_leaves, tree_map

    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = api.train_loss(cfg, objective)(leaves, batch, rng)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if gr is None else gr
                           for p, gr in zip(flat, grads)]


def token_train_run(dev, arch, objective, counts_out, *, steps, batch, seq,
                    reduced=False, profile_at=None, layers=None) -> dict:
    """launch.train.train: every loss finite, launches counted, step walls,
    tokens/s, peak memory, the forward / backward / optimizer split (CUDA
    events) and one step's profile. `layers` cuts the config's depth."""
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch import train as train_mod

    free_graphs()
    torch.cuda.reset_peak_memory_stats(dev)
    with depth_of(train_mod, layers), \
            step_recorder(train_mod, profile_at=profile_at) as rec:
        LAUNCHES.clear()
        t0 = time.perf_counter()
        params, hist = train_mod.train(
            arch, reduced=reduced, objective=objective, steps=steps,
            batch=batch, seq=seq, log_every=steps, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts_out.update(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = check_losses(f"train({arch}, {objective})", rec, steps)
    walls = rec["walls"][1:]
    med = float(np.median(walls))
    phases = {k: float(np.median([p[k] for p in rec["phases"][1:]]))
              for k in rec["phases"][0]}
    tokens = batch * seq
    print(f"  train({arch}, {objective}): {steps} steps at batch {batch} x "
          f"{seq} in {wall:.3f} s; launches {dict(sorted(counts_out.items()))}"
          f"; losses {[round(x, 4) for x in losses]}; step wall: first "
          f"{rec['walls'][0]:.4f} s, median after it {med:.4f} s "
          f"({min(walls):.4f}-{max(walls):.4f}); {tokens / med:.1f} tokens/s; "
          f"peak memory {peak / 2**30:.2f} GiB; device-timeline medians "
          f"(CUDA events) forward {phases['forward']:.3f} ms, backward "
          f"{phases['backward']:.3f} ms, optimizer {phases['optimizer']:.3f}"
          f" ms, step {phases['step']:.3f} ms")
    return dict(params=params, out=dict(
        arch=arch, objective=objective, steps=steps, batch=batch, seq=seq,
        wall_s=wall, losses=losses, first_step_s=rec["walls"][0],
        median_step_s=med, step_walls_s=rec["walls"],
        tokens_per_s=tokens / med, peak_memory_gib=peak / 2**30,
        phase_ms=phases, launches=dict(counts_out), profile=rec["profile"]))


def token_training_part(dev, counts_out: dict) -> dict:
    """(b) qwen2-0.5b at full width through launch.train, AR then
    diffusion: exactly one flash_attention and one flash_attention_bwd a
    layer a step."""
    from repro_torch.configs import get_config

    cfg = get_config(TOKEN_ARCH)
    L, steps = cfg.num_layers, TOKEN_TRAIN["steps"]
    want = {"flash_attention": L * steps, "flash_attention_bwd": L * steps}
    out = {}
    for objective in ("ar", "diffusion"):
        counts = counts_out.setdefault(objective, {})
        run = token_train_run(dev, TOKEN_ARCH, objective, counts,
                              profile_at=TRAIN_PROFILE_STEP, **TOKEN_TRAIN)
        if counts != want:
            fail(f"train({TOKEN_ARCH}, {objective}) launched {counts} != "
                 f"{want}")
        out[objective] = run["out"]
        if objective == "diffusion":
            out["_params"] = run["params"]
        del run
    return out


def token_step_parity_part(dev, arch: str = TOKEN_ARCH, layers=None,
                           shape: dict = TOKEN_TRAIN) -> dict:
    """(c) one step's loss and every gradient leaf on perturbed params: a
    token arch (qwen2-0.5b in phase 12, zamba2-7b at `layers` in phase 13)
    at full width, AR, bf16 kernels and bf16 plain-pinned each against the
    fp32 plain-pinned run (the kernels within the plain run's own distance
    + TOKEN_TOL, loss and each leaf, relative L2); fp32 kernels against
    fp32 plain-pinned over depth_cut, both objectives (<= STEP_FP32_TOL);
    the full bf16 step twice, bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.diffusion import VPLinear
    from repro_torch.diffusion.process import draw_t_noise
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.train import build_batch_fn

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    c32 = dataclasses.replace(cfg, dtype="float32")
    params = perturbed_token_params(cfg, dev)
    names = _leaf_names(params)
    batch = build_batch_fn(cfg, shape["batch"], shape["seq"], seed=0,
                           device=dev)(0)
    out = {}
    free_graphs()
    LAUNCHES.clear()
    loss_k, grads_k = token_loss_and_grads(cfg, "ar", params, batch, None)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    L = attention_launches(cfg)
    if counts != nonzero({"flash_attention": L, "flash_attention_bwd": L}):
        fail(f"one AR step launched {counts}")
    loss_p, grads_p = token_loss_and_grads(plain_pinned(cfg), "ar", params,
                                           batch, None)
    loss_t, grads_t = token_loss_and_grads(plain_pinned(c32), "ar", params,
                                           batch, None)
    rows = {}
    for n, k, p, t in zip(["loss"] + names, [loss_k] + list(grads_k),
                          [loss_p] + list(grads_p), [loss_t] + list(grads_t)):
        if not t.abs().max() > 0:
            continue                     # a leaf the AR loss does not read
        rows[n] = dict(kernel_vs_plain=rel_l2(k, p), kernel_vs_fp32=rel_l2(
            k, t), plain_vs_fp32=rel_l2(p, t))
    bad = [n for n, r in rows.items()
           if not r["kernel_vs_fp32"] <= r["plain_vs_fp32"] + TOKEN_TOL]
    worst = max(rows, key=lambda n: rows[n]["kernel_vs_fp32"])
    worst_kp = max(rows, key=lambda n: rows[n]["kernel_vs_plain"])
    print(f"  one AR step (bf16, full width), loss and {len(rows) - 1} "
          f"gradient leaves against the fp32 plain-pinned step (rel L2): "
          f"farthest {worst}: kernels {rows[worst]['kernel_vs_fp32']:.3e}, "
          f"plain-pinned {rows[worst]['plain_vs_fp32']:.3e}; loss: kernels "
          f"{rows['loss']['kernel_vs_fp32']:.3e}, plain "
          f"{rows['loss']['plain_vs_fp32']:.3e}; kernels vs plain-pinned at "
          f"most {rows[worst_kp]['kernel_vs_plain']:.3e} ({worst_kp}) (gate: "
          f"kernels <= plain + {TOKEN_TOL:g})")
    if bad:
        fail(f"one AR step: kernels farther from fp32 than plain + "
             f"{TOKEN_TOL:g} at {bad}")
    out["bf16_full_width"] = dict(leaves=rows, worst=worst)
    del grads_k, grads_p, grads_t
    free_graphs()
    out["repeat_bit_equal"] = step_twice(cfg, params, batch)
    del params
    free_graphs()

    c4 = depth_cut(cfg)
    p4 = perturbed_token_params(c4, dev, seed=3)
    fp32 = {}
    for objective in ("ar", "diffusion"):
        rng = (draw_t_noise(VPLinear(), p4["token_latents"][batch["tokens"]],
                            torch.Generator(device=dev).manual_seed(5))
               if objective == "diffusion" else None)
        lk, gk = token_loss_and_grads(c4, objective, p4, batch, rng)
        lp, gp = token_loss_and_grads(plain_pinned(c4), objective, p4, batch,
                                      rng)
        errs = {n: rel_l2(a, b) for n, a, b in zip(names, gk, gp)
                if b.abs().max() > 0}
        errs["loss"] = rel_l2(lk, lp)
        w = max(errs, key=errs.get)
        print(f"  one {objective} step at fp32, {c4.num_layers} layers: "
              f"kernels vs plain-pinned, loss {errs['loss']:.3e}, gradient "
              f"leaves at most {errs[w]:.3e} ({w}) (tol {STEP_FP32_TOL:g})")
        if not errs[w] <= STEP_FP32_TOL:
            fail(f"fp32 {objective} step: kernels vs plain {errs[w]:.3e}")
        fp32[objective] = dict(loss=float(lk), max_rel_l2=errs[w], worst=w)
    out["fp32_depth_cut"] = fp32
    del p4
    return out


def step_twice(cfg, params, batch) -> bool:
    """The whole bf16 AR step (loss, gradients, AdamW) twice from the same
    inputs, as phase 10 (d) runs the DiT's: fails unless the loss, params
    and moments are bit-equal."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import AdamW, tree_leaves, warmup_cosine

    opt = AdamW(lr=warmup_cosine(1e-3, 3, 20))
    step = make_train_step(cfg, "ar", opt)
    state = opt.init(params)
    runs = [step(params, state, batch, None) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(
        [runs[0][2], *tree_leaves(runs[0][0]), *tree_leaves(runs[0][1].m),
         *tree_leaves(runs[0][1].v)],
        [runs[1][2], *tree_leaves(runs[1][0]), *tree_leaves(runs[1][1].m),
         *tree_leaves(runs[1][1].v)]))
    print(f"  {cfg.arch_id} at {cfg.num_layers} layers: the full-width AR "
          f"step (loss, gradients, AdamW) twice from the same inputs: loss, "
          f"params and moments bit-equal: {same}")
    if not same:
        fail(f"two runs of the same {cfg.arch_id} training step differ")
    return same


def token_more_training_part(dev, counts_out: dict) -> dict:
    """(d) granite-moe-3b-a800m at full width and MOE_TRAIN["layers"] of
    its layers, AR; the reduced dit-cifar (4 q / 2 kv heads) on the card."""
    from repro_torch.configs import get_config

    out = {}
    counts = counts_out.setdefault("moe", {})
    n, L = MOE_TRAIN["steps"], MOE_TRAIN["layers"]
    run = token_train_run(dev, MOE_ARCH, "ar", counts, steps=n,
                          batch=MOE_TRAIN["batch"], seq=MOE_TRAIN["seq"],
                          layers=L)
    if counts != {"flash_attention": L * n, "flash_attention_bwd": L * n}:
        fail(f"granite training launched {counts}")
    out["moe"] = run["out"]
    del run
    cifar = get_config("dit-cifar").reduced()
    counts = counts_out.setdefault("dit_cifar", {})
    run = token_train_run(dev, "dit-cifar", "diffusion", counts,
                          steps=CIFAR_TRAIN["steps"],
                          batch=CIFAR_TRAIN["batch"], seq=32, reduced=True)
    want = train_launches(cifar, CIFAR_TRAIN["steps"])
    print(f"  dit-cifar (reduced, {cifar.num_heads} q / {cifar.num_kv_heads} "
          f"kv heads) trained on the card: launches {counts} (expected "
          f"{want})")
    if counts != want:
        fail(f"dit-cifar training launched {counts} != {want}")
    out["dit_cifar"] = run["out"]
    return out


def token_checkpoint_part(dev, params, arch: str = TOKEN_ARCH,
                          steps: int = TOKEN_TRAIN["steps"]) -> dict:
    """(e) the diffusion LM trained in (b) (phase 13: mamba2-780m's) through
    its checkpoint and `launch.sample --ckpt`: bit-equal to sampling the
    in-memory params, sampling's launches (a warm-up row and a replay), no
    backward."""
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch import sample as sample_mod
    from repro_torch.optim import tree_leaves

    cfg = get_config(arch)
    nfe, order, batch = (TOKEN_CKPT_SAMPLE[k] for k in ("nfe", "order",
                                                        "batch"))
    rows, L = nfe + 1, attention_launches(cfg)
    want = nonzero({"flash_attention": L * (rows + 1),
                    "unipc_update": 2 * (rows + 1)})
    free_graphs()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ckpt.save(d, {"params": params}, step=steps)
        save_s = time.perf_counter() - t0
        tree, step = ckpt.restore(d)
        nbytes_ = sum(a.nbytes for a in tree_leaves(tree["params"]))
        same = step == steps and all(
            np.array_equal(a, b.cpu().numpy()) for a, b in zip(
                tree_leaves(tree["params"]), tree_leaves(params)))
        del tree
        free_graphs()
        LAUNCHES.clear()
        x_ckpt = sample_mod.main([
            "--arch", arch, "--full", "--ckpt", d, "--nfe", str(nfe),
            "--order", str(order), "--batch", str(batch)])
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
    free_graphs()
    x_mem = sample_mod.sample(arch, reduced=False, params=params,
                              nfe=nfe, order=order, batch=batch, device=dev)
    bit = np.array_equal(x_ckpt, x_mem)
    print(f"  checkpoint of the trained diffusion LM: {nbytes_ / 2**30:.2f} "
          f"GiB saved in {save_s:.2f} s, restored bit-equal: {same}; sample "
          f"--ckpt (UniPC-{order}, NFE {nfe}, batch {batch}): launches "
          f"{counts} (expected a warm-up row and the replay {want}); "
          f"latents bit-equal to sample(params=): {bit}; finite "
          f"{np.isfinite(x_ckpt).all()}, shape {x_ckpt.shape}, std "
          f"{x_ckpt.std():.4f}")
    if not (same and bit and counts == want and np.isfinite(x_ckpt).all()):
        fail("the trained diffusion LM's checkpoint does not sample as its "
             "in-memory params")
    return dict(checkpoint_gib=nbytes_ / 2**30, save_s=save_s,
                sample_launches=counts, sample_bit_equal=bit,
                latents_std=float(x_ckpt.std()))


# --------------------------------------------------------------------------
# phase 13: the SSM and hybrid token families
# --------------------------------------------------------------------------

SSM_ARCH = "mamba2-780m"
HYBRID_ARCH = "zamba2-7b"
SSM_ARCHS = (SSM_ARCH, HYBRID_ARCH)
SSM_SERVE = dict(batch=8, prompt_len=512, gen=64)
SSM_TRAIN = dict(steps=10, batch=8, seq=512)
SSM_PROFILE_STEP = 5
# zamba2-7b trains at 13 of its 81 layers: two groups of six and a
# one-layer tail (about 1.35B params; all 81 with AdamW's fp32 moments
# would need about 106 GB); mamba2-780m at full depth
TRAIN_LAYERS = {SSM_ARCH: None, HYBRID_ARCH: 13}
# the archs whose bf16 gates are held step by step at BF16_STEP_LAYERS and,
# beside them, as a run at full depth. Over zamba2's 81 random-weight
# layers two bf16 runs that differ in one rounding anywhere part as far as
# either is from the fp32 run (PERF.md §6, ROADMAP C8): the plain run and
# the rounded-P plain run (plain_rounding_p) sit 4e-2 apart in the logits
# and 1.5e-2 in the latents, and 1-3 of 64 teacher-forced steps land past
# plain + TOKEN_TOL for the rounded-P run, 1-4 past the farther of the two
# for the kernel run, whatever P V's precision. So at BF16_STEP_LAYERS,
# where one rounding has not saturated, phase 11's gates hold: every step
# within the plain run's distance from fp32 + TOKEN_TOL, the latents within
# MAIN_TOL of plain-pinned; and at all layers and two param seeds, against
# the fp32 run: prefill and latents within the plain run's distance +
# TOKEN_TOL, the teacher-forced steps on their worst step and their mean,
# the rounded-P run's distances and excursions printed beside them
DEEP_BF16 = (HYBRID_ARCH,)
SECOND_SEED = 2
BF16_STEP_LAYERS = {HYBRID_ARCH: TRAIN_LAYERS[HYBRID_ARCH]}
# zamba2's shared block: 32 heads of 112 (3584 / 32), causal MHA, at its
# prefill and training length and at its diffusion LM's 64 tokens
SSM_ATTENTION = [
    ("zamba2-7b prefill, causal MHA D=112", 8, 32, 32, 512, 112, True,
     None),
    ("zamba2-7b diffusion LM, causal MHA D=112", 8, 32, 32, 64, 112, True,
     None),
]
SSM_BWD = [
    ("zamba2-7b training, causal MHA D=112", 8, 32, 32, 512, 112, True,
     None),
]


def ssm_training_part(dev, counts_out: dict) -> dict:
    """(e) mamba2-780m at full depth and zamba2-7b at TRAIN_LAYERS through
    launch.train, AR then diffusion: every loss finite, exactly one
    flash_attention and one flash_attention_bwd an invocation of the
    shared block a step (2 + 2 for zamba2 at 13 layers), none for
    mamba2."""
    from repro_torch.configs import get_config

    out = {}
    steps = SSM_TRAIN["steps"]
    for arch in SSM_ARCHS:
        layers = TRAIN_LAYERS[arch]
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        n = attention_launches(cfg) * steps
        want = nonzero({"flash_attention": n, "flash_attention_bwd": n})
        for objective in ("ar", "diffusion"):
            counts = counts_out.setdefault(f"{arch} {objective}", {})
            run = token_train_run(dev, arch, objective, counts,
                                  profile_at=SSM_PROFILE_STEP, layers=layers,
                                  **SSM_TRAIN)
            if counts != want:
                fail(f"train({arch}, {objective}) launched {counts} != "
                     f"{want}")
            out[f"{arch} {objective}"] = dict(run["out"], layers=cfg.num_layers)
            if arch == SSM_ARCH and objective == "diffusion":
                out["_params"] = run["params"]
            del run
            free_graphs()
    return out


def ssm_phase(dev, counts_out: dict) -> dict:
    """Phase 13: (a) the attention kernels at zamba2's head dim; (b), (c)
    both archs served; (d) both diffusion LMs sampled; (e) trained; (f)
    mamba2's trained diffusion LM through a checkpoint and sample
    --ckpt."""
    out = {"kernels": token_kernel_cases(dev, SSM_ATTENTION, row_ops=False),
           "backward": token_backward_cases(dev, SSM_BWD)}
    free_graphs()
    for arch in SSM_ARCHS:
        print(f"  -- {arch} served")
        counts = counts_out.setdefault(f"{arch} serve", {})
        out[f"{arch} serve"] = token_serving_part(dev, counts, arch,
                                                  SSM_SERVE)
        free_graphs()
        print(f"  -- {arch}'s diffusion LM sampled")
        counts = counts_out.setdefault(f"{arch} sample", {})
        out[f"{arch} sample"] = token_sample_part(dev, counts, arch)
        free_graphs()
    out.update(ssm_training_phase(dev, counts_out))
    return out


def ssm_training_phase(dev, counts_out: dict) -> dict:
    """Phase 13 (e) and (f)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_batch_fn

    print("  -- training")
    trained = ssm_training_part(dev, counts_out)
    params = trained.pop("_params")
    out = {"train": trained}
    out[f"{HYBRID_ARCH} step"] = token_step_parity_part(
        dev, HYBRID_ARCH, TRAIN_LAYERS[HYBRID_ARCH], SSM_TRAIN)
    free_graphs()
    # mamba2's step launches no port kernel: held twice, bit-equal
    cfg = get_config(SSM_ARCH)
    batch = build_batch_fn(cfg, SSM_TRAIN["batch"], SSM_TRAIN["seq"], seed=0,
                           device=dev)(0)
    out[f"{SSM_ARCH} step"] = dict(repeat_bit_equal=step_twice(
        cfg, perturbed_token_params(cfg, dev), batch))
    free_graphs()
    out["checkpoint"] = token_checkpoint_part(dev, params, SSM_ARCH,
                                              SSM_TRAIN["steps"])
    del params
    free_graphs()
    return out


def token_training_phase(dev, counts_out: dict) -> dict:
    out = {"backward": token_backward_cases(dev)}
    free_graphs()
    trained = token_training_part(dev, counts_out)
    params = trained.pop("_params")
    out["train"] = trained
    out["step_parity"] = token_step_parity_part(dev)
    free_graphs()
    out["more"] = token_more_training_part(dev, counts_out)
    free_graphs()
    out["checkpoint"] = token_checkpoint_part(dev, params)
    del params
    free_graphs()
    return out


# --------------------------------------------------------------------------
# phase 14: the vlm and audio token families
# --------------------------------------------------------------------------

AUDIO_ARCH = "whisper-small"
VLM_ARCH = "llama-3.2-vision-90b"
COND_ARCHS = (AUDIO_ARCH, VLM_ARCH)
# whisper: a prompt of 384 and 64 new tokens fill the 448 decoder positions
# of the whisper paper's models; llama-vision as the token paths run
COND_SERVE = {AUDIO_ARCH: dict(batch=8, prompt_len=384, gen=64),
              VLM_ARCH: dict(batch=8, prompt_len=512, gen=64)}
# llama-vision at 10 of its 100 layers, full width: two groups of four
# self-attention layers and a cross-attention layer (about 9.7B params:
# 38.7 GB in fp32 and 19.4 GB of bf16 weights kept once; all 100 layers are
# about 173 GB in bf16). whisper-small at full depth.
COND_LAYERS = {AUDIO_ARCH: None, VLM_ARCH: 10}
AUDIO_TRAIN = dict(steps=10, batch=8, seq=384)
# label, B, Hq, Hkv, S, D, causal, window[, Skv]: whisper's encoder (S
# 1500: 23 tiles of 64 and a ragged 28) and its decoder's cross-attention
# over the frames, llama-vision's causal GQA 64/8 self-attention at D 128
# and its cross-attention over 1600 image tokens, and both diffusion LMs'
# 64 queries over the frames / the image; forward and backward alike
COND_ATTENTION = [
    ("whisper encoder, non-causal MHA D=64", 8, 12, 12, 1500, 64, False,
     None),
    ("whisper cross-attention, 384 over 1500 frames", 8, 12, 12, 384, 64,
     False, None, 1500),
    ("llama-vision prefill, causal GQA 64/8 D=128", 8, 64, 8, 512, 128,
     True, None),
    ("llama-vision cross-attention, 512 over 1600, GQA 64/8", 8, 64, 8, 512,
     128, False, None, 1600),
    ("whisper diffusion LM cross-attention, 64 over 1500", 8, 12, 12, 64, 64,
     False, None, 1500),
    ("llama-vision diffusion LM cross-attention, 64 over 1600", 8, 64, 8, 64,
     128, False, None, 1600),
]


def cond_sample_part(dev, counts_out: dict, arch: str, layers=None) -> dict:
    """(d) UniPC sampling of a vlm's or an audio model's diffusion LM at
    full width through engine.build, the stub frontend's embeddings in the
    eps-net's batch (launch.sample feeds none and refuses these families,
    as the reference's fails there): a replay counted, bit-equal to the
    eager loop, no host sync, the replay and eager walls; the latents as
    latents_parity holds them. The audio model encodes its frames again at
    every eval, as the reference's does."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import frontend_embeds
    from repro_torch.engine import EngineSpec
    from repro_torch.kernels.dispatch import LAUNCHES

    B, nfe, order = (TOKEN_SAMPLE[k] for k in ("batch", "nfe", "order"))
    rows = nfe + 1
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = init_model(cfg, 1, dev)
    x_T = diffusion_lm_inputs(cfg, params, B, dev)
    cond = {k: torch.from_numpy(v).to(dev)
            for k, v in frontend_embeds(cfg, B, 1).items()}
    spec = EngineSpec(nfe=nfe, order=order)
    expected = {"flash_attention": attention_launches(cfg) * rows,
                "unipc_update": 2 * rows}
    free_graphs()
    engine = lm_engine(cfg, params, B, dev, cond)
    g = graph_checks(f"{arch} diffusion LM", engine, spec, x_T, expected,
                     counts_out)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x_eager = g["eager"](x_T)
        x_replay = g["run"](x_T)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not (torch.equal(x_eager, g["x_eager"])
            and torch.equal(x_replay, g["x_graph"])):
        fail("the sync-checked diffusion-LM runs differ from the counted ones")
    print(f"  eager row loop and one replay under set_sync_debug_mode"
          f"('error'): {rows} rows, no host sync, bit-equal")
    walls = median_walls({"replay": lambda: g["run"](x_T),
                          "eager": lambda: g["eager"](x_T)})
    for name, w in walls.items():
        print(f"  wall {name}: median {w['median_s']:.4f} s of "
              f"{[round(v, 4) for v in w['reps_s']]} ({B} sequences of 64)")
    x0 = g["x_graph"].clone()
    if x0.shape != (B, 64, cfg.latent_dim) or not torch.isfinite(x0).all():
        fail(f"diffusion-LM output shape {tuple(x0.shape)} / finite "
             f"{bool(torch.isfinite(x0).all())}")
    del g, engine
    free_graphs()
    LAUNCHES.clear()
    x_plain = eager_latents(plain_pinned(cfg), params, x_T, dev, cond=cond)
    torch.cuda.synchronize()
    if sum(LAUNCHES.values()):
        fail(f"the plain-pinned diffusion-LM run launched kernels: "
             f"{dict(LAUNCHES)}")
    out = dict(layers=cfg.num_layers, replay_launches=dict(counts_out),
               walls=walls)
    out.update(latents_parity(cfg, params, x_T, x0, x_plain, dev, cond))
    del params
    return out


def cond_training_part(dev, counts_out: dict) -> dict:
    """(e) whisper-small at full width and depth through launch.train, AR
    then diffusion: every loss finite, exactly one flash_attention and one
    flash_attention_bwd an encoder layer and two a decoder layer a step;
    one step's gradients as 12 (c), the step twice bit-equal. (llama-vision
    is not trained on the card: one group of 5 layers at 16 bytes a param,
    fp32 params, gradients and AdamW's two moments, is about 86 GB; the CPU
    tests train it at the reduced config.)"""
    from repro_torch.configs import get_config

    cfg = get_config(AUDIO_ARCH)
    n = attention_launches(cfg) * AUDIO_TRAIN["steps"]
    want = {"flash_attention": n, "flash_attention_bwd": n}
    out = {}
    for objective in ("ar", "diffusion"):
        counts = counts_out.setdefault(f"{AUDIO_ARCH} {objective}", {})
        run = token_train_run(dev, AUDIO_ARCH, objective, counts,
                              profile_at=SSM_PROFILE_STEP, **AUDIO_TRAIN)
        if counts != want:
            fail(f"train({AUDIO_ARCH}, {objective}) launched {counts} != "
                 f"{want}")
        out[objective] = run["out"]
        del run
        free_graphs()
    out["step"] = token_step_parity_part(dev, AUDIO_ARCH, None, AUDIO_TRAIN)
    free_graphs()
    return out


def cond_phase(dev, counts_out: dict) -> dict:
    """Phase 14: (a) the attention kernels at the new shapes, forward and
    backward; (b), (c) both archs served; (d) both diffusion LMs sampled;
    (e) whisper trained; (f) the bf16 gates at full depth inside (b) and
    (d)."""
    out = {"kernels": token_kernel_cases(dev, COND_ATTENTION, row_ops=False),
           "backward": token_backward_cases(dev, COND_ATTENTION)}
    free_graphs()
    for arch in COND_ARCHS:
        print(f"  -- {arch} served")
        counts = counts_out.setdefault(f"{arch} serve", {})
        out[f"{arch} serve"] = token_serving_part(
            dev, counts, arch, COND_SERVE[arch], COND_LAYERS[arch])
        free_graphs()
        print(f"  -- {arch}'s diffusion LM sampled")
        counts = counts_out.setdefault(f"{arch} sample", {})
        out[f"{arch} sample"] = cond_sample_part(dev, counts, arch,
                                                 COND_LAYERS[arch])
        free_graphs()
    print("  -- training")
    out["train"] = cond_training_part(dev, counts_out)
    return out


# --------------------------------------------------------------------------
# phase 15: the analysis layer on the card
# --------------------------------------------------------------------------

ANALYSIS_BATCH = 8
MAIN_SPEC = dict(nfe=10, order=3, cfg_scale=2.0)     # phase 4's run
PEAK_RATIO = (0.5, 2.0)    # predicted / measured peak memory, inclusive


def analysis_workloads() -> dict:
    """{label: build(device) -> (fn, args)} of the runs phase 15 (a) counts
    on the card and on meta: one dit-i256 eval, one qwen2-0.5b prefill and
    one dit-i256 training step, at batch 8, each through the dry run's own
    builders."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import api

    B = ANALYSIS_BATCH
    dit, lm = get_config("dit-i256"), get_config(TOKEN_ARCH)

    def dit_eval(device):
        p = api.init_params(dit, 0, device)
        x = torch.zeros(B, dit.patch_tokens, dit.latent_dim, device=device)
        t = torch.full((B,), 0.5, device=device)
        ids = torch.zeros(B, dtype=torch.int64, device=device)
        return api.eps_network(dit), (p, x, t, {"class_ids": ids})

    def workload(cfg, shape, objective="ar"):
        def build(device):
            w = dryrun.build_workload(cfg, shape, objective, device)
            return w.fn, w.args
        return build

    return {
        "dit-i256 eval": dit_eval,
        f"{TOKEN_ARCH} prefill": workload(lm, InputShape(
            "prefill", TOKEN_SERVE["prompt_len"], B, "prefill")),
        "dit-i256 training step": workload(dit, InputShape(
            "train", dit.patch_tokens, B, "train"), "diffusion"),
    }


def count_parity_part(dev) -> dict:
    """(a) each run counted on the card, where its kernels launch
    (`LAUNCHES` shows them), and on meta: FLOPs by dtype, the compulsory
    bytes and the kernel calls equal exactly."""
    from repro_torch.analysis.opcount import analyze
    from repro_torch.kernels.dispatch import LAUNCHES

    out = {}
    for label, build in analysis_workloads().items():
        fn, args = build(dev)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        card = analyze(fn, *args)
        torch.cuda.synchronize()
        launched = dict(LAUNCHES)
        del fn, args
        free_graphs()
        fn, args = build("meta")
        meta = analyze(fn, *args)
        del fn, args
        same = {k: card[k] == meta[k] for k in card}
        print(f"  {label}: card {card['flops'] / 1e12:.4f} TFLOP "
              f"{ {k: v / 1e12 for k, v in card['flops_by_dtype'].items()} }, "
              f"{card['min_bytes'] / 1e9:.4f} GB compulsory, kernels "
              f"{card['kernels']} (launched {launched}); equal on meta: "
              f"{same}")
        if launched != card["kernels"]:
            fail(f"phase 15 (a) {label}: the count's kernels "
                 f"{card['kernels']} are not those launched {launched}")
        if not (same["flops_by_dtype"] and same["min_bytes"]
                and same["kernels"]):
            fail(f"phase 15 (a) {label}: the card's count differs from the "
                 f"meta count: {card} vs {meta}")
        out[label] = dict(card, launched=launched, equal_on_meta=same)
    return out


def main_path_share_part(dev, replay_s: float) -> dict:
    """(b) the main path's bound and share: phase 4's guided UniPC-3 replay
    of 8 requests against the roofline of the same engine spec run once
    eagerly under the count (a graph replay cannot be counted), and its
    MFU from the model FLOPs the dry run's sampling workload counts
    (`model_flops_sample`: evals x rows x 2 N_active x tokens, the adaLN
    projections once a row), with the utilisation of the FLOPs the run
    counts beside it."""
    from repro_torch.analysis.opcount import analyze
    from repro_torch.analysis.roofline import (MFU_PEAK, Roofline,
                                               model_flops_sample)
    from repro_torch.configs import get_config
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec
    from repro_torch.launch.sample import build_engine, latent_shape

    cfg, B = get_config("dit-i256"), ANALYSIS_BATCH
    engine = build_engine(cfg, perturbed_params(cfg, dev), VPLinear(), B,
                          seed=0, device=dev)
    eager = engine.build(EngineSpec(**MAIN_SPEC), jit=False)
    x_T = torch.randn(latent_shape(cfg, B), generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    acct = analyze(eager, x_T)
    evals = acct["kernels"]["flash_attention"] // cfg.num_layers
    rows = 2 * B if MAIN_SPEC["cfg_scale"] else B
    mf = model_flops_sample(cfg, evals, rows)
    roof = Roofline(acct["flops_by_dtype"], acct["min_bytes"], model_flops=mf)
    mfu = mf / (replay_s * MFU_PEAK)
    counted_util = acct["flops"] / (replay_s * MFU_PEAK)
    print(f"  main path MFU {mfu:.4f}: {mf / 1e12:.4f} TFLOP of model "
          f"operations ({evals} evals x {rows} rows, 2 N_active a token, "
          f"adaLN once a row) in phase 4's replay of {replay_s:.5f} s, "
          f"against {MFU_PEAK / 1e12:.0f} TFLOP/s; the counted "
          f"{acct['flops'] / 1e12:.4f} TFLOP at {counted_util:.4f}")
    print(f"  main path bound {roof.step_time_s * 1e3:.4f} ms by "
          f"{roof.bottleneck} ({acct['flops'] / 1e12:.4f} TFLOP counted "
          f"{ {k: v / 1e12 for k, v in acct['flops_by_dtype'].items()} }, "
          f"{acct['min_bytes'] / 1e9:.4f} GB compulsory; kernels "
          f"{acct['kernels']}); the replay at "
          f"{roof.step_time_s / replay_s:.1%} of it")
    del engine, eager
    free_graphs()
    return dict(replay_s=replay_s, bound_s=roof.step_time_s,
                share=roof.step_time_s / replay_s, mfu=mfu, model_flops=mf,
                counted_utilisation=counted_util,
                evals=evals, roofline=roof.row(), kernels=acct["kernels"],
                min_bytes=acct["min_bytes"])


def memory_workloads() -> dict:
    """{label: build(device) -> (fn, args, arguments)} of the paths the
    script runs whose peak phase 15 (c) predicts: the main path's eager
    engine run (its params, the weights kept once and x_T the arguments),
    and the dry run's workloads at the script's shapes (the DiT and
    qwen2-0.5b steps, the qwen2 and whisper prefills and whisper's step,
    llama-vision's prefill at 10 layers)."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.diffusion import VPLinear
    from repro_torch.engine import EngineSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.sample import build_engine, latent_shape
    from repro_torch.models import api

    B = ANALYSIS_BATCH
    dit = get_config("dit-i256")

    def replay(device):
        params = api.init_params(dit, 0, device)
        engine = build_engine(dit, params, VPLinear(), B, seed=0,
                              device=device)
        x_T = torch.zeros(latent_shape(dit, B), device=device)
        kept = api.cast_weights_once(dit, params) if torch.device(
            device).type == "meta" else None
        return engine.build(EngineSpec(**MAIN_SPEC), jit=False), (x_T,), (
            params, kept, x_T)

    def workload(arch, kind, seq, objective="ar", layers=None):
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)

        def build(device):
            w = dryrun.build_workload(cfg, InputShape(kind, seq, B, kind),
                                      objective, device)
            return w.fn, w.args, w.parts
        return build

    S, W = TOKEN_SERVE["prompt_len"], COND_SERVE[AUDIO_ARCH]["prompt_len"]
    return {
        "dit-i256 sampling (the replay's spec, eager)": replay,
        "dit-i256 training step": workload("dit-i256", "train",
                                           dit.patch_tokens, "diffusion"),
        f"{TOKEN_ARCH} prefill": workload(TOKEN_ARCH, "prefill", S),
        f"{TOKEN_ARCH} AR step": workload(TOKEN_ARCH, "train", S),
        f"{AUDIO_ARCH} prefill": workload(AUDIO_ARCH, "prefill", W),
        f"{AUDIO_ARCH} AR step": workload(AUDIO_ARCH, "train", W),
        f"{VLM_ARCH} prefill at {COND_LAYERS[VLM_ARCH]} layers": workload(
            VLM_ARCH, "prefill", COND_SERVE[VLM_ARCH]["prompt_len"],
            layers=COND_LAYERS[VLM_ARCH]),
    }


# what the script cuts, by the dry run's verdict on one card: (arch, kind,
# layers, fits_80GB) at batch 8 x 512
FIT_CUTS = [(HYBRID_ARCH, "train", None, False),
            (HYBRID_ARCH, "train", TRAIN_LAYERS[HYBRID_ARCH], True),
            (VLM_ARCH, "train", None, False),
            ("deepseek-67b", "prefill", None, False),
            ("mixtral-8x7b", "prefill", None, False)]


def memory_part(dev) -> dict:
    """(c) each path's peak predicted on meta as `dryrun.run_one` predicts
    it (the arguments' bytes plus the largest live set of what the run
    creates) beside `torch.cuda.max_memory_allocated` over the same run on
    the card (reset once its arguments are made: their init's temporaries
    are not the run's; less what was allocated before), with their ratio;
    then the dry run's `fits_80GB` against
    the cuts the script makes (FIT_CUTS)."""
    from repro_torch.analysis.opcount import analyze
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun

    out = {}
    for label, build in memory_workloads().items():
        fn, args, arguments = build("meta")
        acct = analyze(fn, *args)
        predicted = dryrun.tree_bytes(arguments) + acct["peak_live_bytes"]
        del fn, args, arguments
        free_graphs()
        base = torch.cuda.memory_allocated(dev)
        fn, args, arguments = build(dev)
        torch.cuda.synchronize()
        made = torch.cuda.memory_allocated(dev) - base
        torch.cuda.reset_peak_memory_stats(dev)   # past the params' init
        fn(*args)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated(dev) - base
        del fn, args, arguments
        free_graphs()
        ratio = predicted / measured
        temp = (acct["peak_live_bytes"], measured - made)
        print(f"  {label}: predicted peak {predicted / 1e9:.3f} GB, "
              f"measured {measured / 1e9:.3f} GB (ratio {ratio:.3f}); "
              f"beyond the arguments {temp[0] / 1e9:.3f} / "
              f"{temp[1] / 1e9:.3f} GB (ratio {temp[0] / max(temp[1], 1):.3f})")
        if not PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]:
            fail(f"phase 15 (c) {label}: predicted / measured peak "
                 f"{ratio:.3f} outside {PEAK_RATIO}")
        out[label] = dict(predicted_bytes=predicted, measured_bytes=measured,
                          ratio=ratio, predicted_temp_bytes=temp[0],
                          measured_temp_bytes=temp[1])
    fits = {}
    for arch, kind, layers, want in FIT_CUTS:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        _, mem, _ = dryrun.measure(cfg, InputShape(kind, 512, ANALYSIS_BATCH,
                                                   kind))
        tag = f"{arch} {kind}{f' at {layers} layers' if layers else ''}"
        print(f"  dry run, {tag} at batch {ANALYSIS_BATCH} x 512: peak "
              f"{mem['peak_bytes'] / 1e9:.1f} GB (params "
              f"{mem['params_bytes'] / 1e9:.1f}, AdamW "
              f"{mem.get('optimizer_bytes', 0) / 1e9:.1f}), fits_80GB "
              f"{mem['fits_80GB']} (the script's cut: {want})")
        if mem["fits_80GB"] != want:
            fail(f"phase 15 (c): the dry run says {tag} fits_80GB="
                 f"{mem['fits_80GB']}, the script's cut says {want}")
        fits[tag] = dict(peak_bytes=mem["peak_bytes"],
                         fits_80GB=mem["fits_80GB"])
    return dict(peaks=out, fits=fits)


def analysis_phase(dev, replay_s: float) -> dict:
    t0 = time.perf_counter()
    print("  (a) counts on the card against counts on meta:")
    counts = count_parity_part(dev)
    print("  (b) the main path's bound and MFU:")
    share = main_path_share_part(dev, replay_s)
    print("  (c) predicted against measured peak memory:")
    memory = memory_part(dev)
    print(f"  phase 15 took {time.perf_counter() - t0:.1f} s")
    return dict(counts=counts, main_path=share, memory=memory)


# --------------------------------------------------------------------------


KERNELS = [  # name, source, replaces (TPU kernel file:line), launches per eval
    ("unipc_update", "src/repro_torch/kernels/csrc/unipc_update.cu",
     "src/repro/kernels/unipc_update/kernel.py:48", None),
    ("adaln_modulate", "src/repro_torch/kernels/csrc/adaln_modulate.cu",
     "src/repro/kernels/adaln_modulate/kernel.py:61", 57),
    ("gate_residual", "src/repro_torch/kernels/csrc/adaln_modulate.cu",
     "src/repro/kernels/adaln_modulate/kernel.py:90", 56),
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention/kernel.py:84", 28),
    ("quant_matmul", "src/repro_torch/kernels/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul/kernel.py:57", 197),
]


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}; run "
             f"it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda:0")

    print("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    name = torch.cuda.get_device_name(0)
    print(f"  {name}; power limit {smi[0].split(',')[-1].strip()}; torch "
          f"{torch.__version__}; CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} card(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== phase 2: build")
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build()
    print(f"  built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s (parallel nvcc, sm_90a)")
    for kname, rep in sorted(reports.items()):
        entry, spills = "?", ""
        for line in rep.splitlines():   # one line per compiled kernel
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                print(f"  ptxas {kname} {entry[:60]}: {line.split(':', 1)[-1].strip()}"
                      f"; {spills}")

    print("== phase 3: kernels vs plain versions (main-path shapes)")
    kstats = kernel_phase(dev)

    print("== phase 4: main path (dit-i256 full width, nfe 10, order 3, "
          "cfg 2.0, batch 8)")
    counts: dict = {}
    main_stats = main_path_phase(dev, counts)

    print("== phase 5: serving step (4 slots, staggered, slot reuse, fp32 "
          "full width)")
    serve_stats = serving_phase(dev)

    print("== phase 6: quantized main path (w8a16, dit-i256 full width, "
          "nfe 10, order 3, cfg 2.0, batch 8; w8a8/fp8a16/w4a16 at depth 4; "
          "the w8a16 serving step at fp32)")
    qcounts: dict = {}
    quant_stats = quant_path_phase(dev, qcounts, main_stats.pop("latents"))
    quant_serve = quant_serving_phase(dev)

    print("== phase 7: the solver zoo (dit-i256 full width, nfe 10, cfg 2.0, "
          "batch 8: ddim, dpmpp-3, pndm and deis-3 with UniC, dpm-3S; the "
          "loop references at fp32)")
    zoo = zoo_phase(dev)

    print("== phase 8: serving at full width (dit-i256 through "
          "launch.serve: 8 slots, 24 Poisson requests at depths 1/2/3; "
          f"cache_block {CACHE_BLOCK}; NaN + desync faults; w8a16)")
    scounts: dict = {}
    sqcounts: dict = {}
    served = serving_at_width_phase(dev, scounts, sqcounts)

    print("== phase 9: observability and the tuner (dit-i256 full width: "
          "phase 8's trace traced, with the metrics artifact and the "
          "probe; tune at NFE 8, uncached and at cache_block "
          f"{CACHE_BLOCK}; sample(plan=))")
    ocounts: dict = {}
    obs = obs_and_tuner_phase(dev, served.pop("_clean"), ocounts)

    print(f"== phase 10: training at full width (dit-i256 through "
          f"launch.train: {TRAIN_STEPS} steps at batch {TRAIN_BATCH}; the "
          f"backward kernels; kernels vs plain-pinned step; checkpoint and "
          f"sample --ckpt; tune with {TUNE_TRAIN_STEPS} training steps) "
          f"on {smi[0]}")
    tcounts: dict = {}
    trained = training_phase(dev, tcounts, obs["search"])

    print(f"== phase 11: the token family at full width ({TOKEN_ARCH} served "
          f"through launch.serve: batch {TOKEN_SERVE['batch']}, prompt "
          f"{TOKEN_SERVE['prompt_len']}, {TOKEN_SERVE['gen']} greedy tokens; "
          f"its diffusion LM sampled through launch.sample: UniPC-"
          f"{TOKEN_SAMPLE['order']}, NFE {TOKEN_SAMPLE['nfe']}, batch "
          f"{TOKEN_SAMPLE['batch']}; {MOE_ARCH} served at batch "
          f"{MOE_SERVE['batch']}, prompt {MOE_SERVE['prompt_len']}, "
          f"{MOE_SERVE['gen']} tokens) on {smi[0]}")
    kcounts: dict = {}
    tokens = token_phase(dev, kcounts)

    print(f"== phase 12: training the token family at full width "
          f"({TOKEN_ARCH} through launch.train: {TOKEN_TRAIN['steps']} steps "
          f"at batch {TOKEN_TRAIN['batch']} x {TOKEN_TRAIN['seq']}, AR and "
          f"diffusion; the attention backward at every mask and group size; "
          f"kernels vs plain-pinned step; {MOE_ARCH} at "
          f"{MOE_TRAIN['layers']} layers; dit-cifar; sample --ckpt) on "
          f"{smi[0]}")
    gcounts: dict = {}
    token_trained = token_training_phase(dev, gcounts)

    print(f"== phase 13: the SSM and hybrid token families at full width "
          f"({SSM_ARCH} and {HYBRID_ARCH} served through launch.serve: batch "
          f"{SSM_SERVE['batch']}, prompt {SSM_SERVE['prompt_len']}, "
          f"{SSM_SERVE['gen']} greedy tokens; their diffusion LMs sampled; "
          f"trained through launch.train, {SSM_TRAIN['steps']} steps at "
          f"batch {SSM_TRAIN['batch']} x {SSM_TRAIN['seq']}, AR and "
          f"diffusion, {HYBRID_ARCH} at {TRAIN_LAYERS[HYBRID_ARCH]} of its "
          f"layers; sample --ckpt) on {smi[0]}")
    scounts13: dict = {}
    ssm = ssm_phase(dev, scounts13)

    print(f"== phase 14: the vlm and audio token families at full width "
          f"({AUDIO_ARCH} at all {12 + 12} layers and {VLM_ARCH} at "
          f"{COND_LAYERS[VLM_ARCH]} of its 100, served through launch.serve "
          f"at batch 8 over the stub frontend's embeddings: prompts "
          f"{COND_SERVE[AUDIO_ARCH]['prompt_len']} / "
          f"{COND_SERVE[VLM_ARCH]['prompt_len']}, 64 greedy tokens; their "
          f"diffusion LMs sampled through engine.build; {AUDIO_ARCH} trained "
          f"through launch.train, {AUDIO_TRAIN['steps']} steps at batch "
          f"{AUDIO_TRAIN['batch']} x {AUDIO_TRAIN['seq']}, AR and diffusion; "
          f"the attention kernels at the cross-attention shapes) on "
          f"{smi[0]}")
    ccounts14: dict = {}
    cond = cond_phase(dev, ccounts14)

    print(f"== phase 15: the analysis layer (counts on the card against "
          f"meta, the main path's bound and MFU, predicted against measured "
          f"peak memory, the dry run's fits_80GB against the script's cuts) "
          f"on {smi[0]}")
    analysis = analysis_phase(dev, main_stats["walls"]["replay"]["median_s"])

    entries = []
    for kname, src, replaces, per_eval in KERNELS:
        st = kstats[kname]
        # each kernel's launches are those of the main path that first
        # runs it: phase 4's, and phase 6's quantized path for quant_matmul
        path_counts = qcounts if kname == "quant_matmul" else counts
        entry = dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=path_counts.get(kname, 0),
            launches_per_eval=per_eval if per_eval else "2 per row",
            max_abs_err=st["max_abs_err"], max_rel_err=st["max_rel_err"],
            body=st.get("body", "cuda (one body)"),
            cases=st["cases"], ms=st["ms"], kernel_ms=st["ms"],
            host_call_ms=st["host_call_ms"], plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
            bound_by=st["bound_by"], library_ms=st["library_ms"])
        if "sites" in st:
            entry["sites"] = st["sites"]
        if kname == "unipc_update":
            entry["tables"] = zoo["tables"]
        # phase 8: one serving tick (a replay) and the whole depth-2 serve
        # run of phase 8 (a); (d)'s w8a16 run for quant_matmul
        serve_tick = (served["quant"]["launches_per_tick"]
                      if kname == "quant_matmul"
                      else served["launches_per_tick"])
        entry["serving_launches_per_tick"] = serve_tick.get(kname, 0)
        entry["serving_launches"] = (sqcounts if kname == "quant_matmul"
                                     else scounts).get(kname, 0)
        # phase 9: the traced and probed serving run, the search (the
        # reference trajectory with it), the cached search, sample(plan=)
        for part in ("serve", "tune", "tune_cached", "sample_plan"):
            entry[f"obs_tuner_launches_{part}"] = ocounts[part].get(kname, 0)
        # phase 10: the training run
        entry["training_launches"] = tcounts.get(kname, 0)
        # phase 11: qwen2-0.5b's serve() (its prefill; a decode step
        # launches no port kernel), one replay of its diffusion LM's
        # sampling run, granite's serve()
        entry["token_launches_prefill"] = kcounts["serve"].get(kname, 0)
        entry["token_launches_decode_step"] = 0
        entry["token_launches_sample_replay"] = kcounts["sample"].get(kname,
                                                                     0)
        entry["token_launches_moe_prefill"] = kcounts["moe"].get(kname, 0)
        # phase 12: the token family's training runs (qwen2-0.5b AR and
        # diffusion, granite), and the reduced dit-cifar's
        entry["token_training_launches"] = {
            part: gcounts[part].get(kname, 0) for part in TRAIN_PARTS}
        if kname == "flash_attention":
            entry["token_cases"] = {
                label: {k: v for k, v in row.items()
                        if k in ("shape", "ms", "plain_ms", "library_ms",
                                 "bound_ms", "bound_by", "rel_err_bf16",
                                 "rel_err_fp32", "body_bf16")}
                for label, row in tokens["kernels"].items()
                if label != "unipc_row_ops"}
        if kname == "unipc_update":
            entry["token_row_ops"] = tokens["kernels"]["unipc_row_ops"]
        # phase 13: the SSM and hybrid archs' prefills, sampling replays
        # and training runs (a decode step launches no port kernel)
        entry["ssm_launches"] = {part: c.get(kname, 0)
                                 for part, c in scounts13.items()}
        if kname == "flash_attention":
            entry["ssm_cases"] = {
                label: {k: v for k, v in row.items()
                        if k in ("shape", "ms", "plain_ms", "library_ms",
                                 "bound_ms", "bound_by", "rel_err_bf16",
                                 "rel_err_fp32", "body_bf16")}
                for label, row in ssm["kernels"].items()}
        # phase 14: the vlm and audio archs' prefills, sampling replays and
        # whisper's training runs (a decode step launches no port kernel)
        entry["cond_launches"] = {part: c.get(kname, 0)
                                  for part, c in ccounts14.items()}
        if kname == "flash_attention":
            entry["cond_cases"] = {
                label: {k: v for k, v in row.items()
                        if k in ("shape", "skv", "ms", "plain_ms",
                                 "library_ms", "bound_ms", "bound_by",
                                 "rel_err_bf16", "rel_err_fp32",
                                 "body_bf16", "bit_equal_share_plain",
                                 "bit_equal_share_rounded_p")}
                for label, row in cond["kernels"].items()}
            entry["max_abs_err"] = max([entry["max_abs_err"]] + [
                row[f"abs_err_{n}"] for row in cond["kernels"].values()
                for n in ("fp32", "bf16")])
        if kname in served["cache"]["launches"].get("shallow", {}):
            entry["serving_launches_per_shallow_tick"] = (
                served["cache"]["launches"]["shallow"][kname])
        for key in ("layer_norm_subset_ms", "fp32_ms", "fp32_bound_ms",
                    "rotated_ms", "rotated_library_ms", "per_call_over",
                    "row_ops", "row_forms", "combine"):
            if key in st:
                entry[key] = st[key]
        entries.append(entry)
    for kname, src, replaces in BWD_KERNELS:
        st = trained["backward_kernels"][kname]
        entry = dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=tcounts.get(kname, 0),
            launches_per_step=tcounts.get(kname, 0) // TRAIN_STEPS,
            max_abs_err=st["max_abs_err"], max_rel_err=st["max_rel_err"],
            cases=st["cases"], ms=st["ms"], kernel_ms=st["ms"],
            host_call_ms=st["host_call_ms"], plain_ms=st["plain_ms"],
            bound_ms=st["bound_ms"], bound_by=st["bound_by"],
            library_ms=st["library_ms"], library=st["library"],
            token_training_launches={part: gcounts[part].get(kname, 0)
                                     for part in TRAIN_PARTS},
            **{k: st[k] for k in ("fwd_bwd_queued_ms",
                                  "lse_output_bit_equal") if k in st})
        if kname == "flash_attention_bwd":
            rows = token_trained["backward"]
            entry["token_cases"] = rows
            entry["ssm_cases"] = ssm["backward"]
            entry["ssm_launches"] = {part: c.get(kname, 0)
                                     for part, c in scounts13.items()}
            entry["cond_cases"] = cond["backward"]
            entry["cond_launches"] = {part: c.get(kname, 0)
                                      for part, c in ccounts14.items()}
            entry["max_abs_err"] = max([entry["max_abs_err"]] + [
                row[f"abs_err_{n}"]
                for rows_ in (rows, ssm["backward"], cond["backward"])
                for row in rows_.values() for n in ("fp32", "bf16")])
        entries.append(entry)
    summary = dict(main_path=main_stats, serving=serve_stats,
                   quant_main_path=quant_stats, quant_serving=quant_serve,
                   serving_at_width=served, obs_and_tuner=obs,
                   training=trained, token_training=token_trained,
                   ssm_and_hybrid={k: v for k, v in ssm.items()
                                   if k not in ("kernels", "backward")},
                   vlm_and_audio={k: v for k, v in cond.items()
                                  if k not in ("kernels", "backward")},
                   tokens={k: v for k, v in tokens.items() if k != "kernels"},
                   analysis=analysis,
                   zoo={k: v for k, v in zoo.items() if k != "tables"},
                   quant_other_operands_at_wq_site=kstats["quant_matmul"][
                       "other_operands_at_wq_site"])
    print("summary " + json.dumps(summary))
    print(json.dumps({"kernels": entries}))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
