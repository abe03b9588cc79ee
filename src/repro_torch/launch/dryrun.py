"""One-card dry run on the meta device (the counterpart of
`repro/launch/dryrun.py`): every (architecture x input shape) built and run
once with shapes only, no allocation and no arithmetic; its operations and
bytes counted (`analysis/opcount.py`), its H100 roofline
(`analysis/roofline.py`), and its memory against the card's 80 GB.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --out results/dryrun_h100
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sample

This entry point never touches CUDA. The reference's dry run never runs on
a TPU either: it lowers on forced host CPU devices. Its one-card
counterpart builds on the meta device by design: a meta run counts the
same operations and bytes as an eager run on the card (the kernels report
their cost on every route), in seconds a cell on the CPU, with no card.

One card has no mesh: the sharding rules, `rules_for` and the stages of
the reference's `OPTIMIZATIONS` that set rules or `moe_shard_map` belong
to the mesh layer (ROADMAP 12e); `--opt` refuses them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import NamedTuple

import torch

from ..analysis.opcount import analyze
from ..analysis.roofline import (DEVICE_BYTES, Roofline, active_params,
                                 model_flops_decode, model_flops_sample,
                                 model_flops_train)
from ..configs.base import INPUT_SHAPES, InputShape, ModelConfig
from ..configs.registry import all_arch_ids, get_config
from ..models import api
from ..optim import AdamW
from .specs import abstract_cache, input_specs
from .train import make_train_step

MESH = "h100x1"

# (arch, shape) pairs that do not build, with the reason (DESIGN.md §7.2)
SKIPS = {
    ("whisper-small", "long_500k"):
        "enc-dec full cross-attention; no sub-quadratic decode variant",
}

# long-context overrides: dense/moe/vlm/hybrid archs get a sliding window so
# long_500k decode is sub-quadratic with an O(window) cache (DESIGN.md §7.2)
LONG_SWA_WINDOW = 8192


def adapt_config(cfg, shape_name):
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm",
                                                    "hybrid"):
        if not cfg.sliding_window:
            cfg = dataclasses.replace(cfg, sliding_window=LONG_SWA_WINDOW)
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat=True)
    return cfg


# the reference's optimization stages that change the config alone (the
# port honours them on one card): MoE dispatch locality, blockwise attention
OPTIMIZATIONS = {
    ("granite-moe-3b-a800m", "train_4k"): {
        "local_dispatch": dict(moe_dispatch_groups=32)},
    ("mixtral-8x7b", "train_4k"): {
        "local_dispatch": dict(moe_dispatch_groups=32)},
    ("deepseek-67b", "train_4k"): {"chunk": dict(attention_chunk=512)},
    ("qwen2-0.5b", "prefill_32k"): {
        "chunk": dict(attention_chunk=1024),
        "chunk512": dict(attention_chunk=512),
        "chunk2048": dict(attention_chunk=2048)},
}
# the reference's stages that set sharding rules or moe_shard_map
MESH_STAGES = ("shard_map", "shard_map_seqp", "seqp", "seqp_chunk", "kvseq",
               "kvseq_bf16")


def stage(arch: str, shape_name: str, opt: str) -> dict:
    """The config overrides of optimization stage `opt` for (arch, shape)."""
    if opt in MESH_STAGES:
        raise ValueError(f"--opt {opt} needs the mesh layer (ROADMAP 12e)")
    stages = OPTIMIZATIONS.get((arch, shape_name), {})
    if opt not in stages:
        raise KeyError(f"no stage {opt!r} for {arch} x {shape_name}; have "
                       f"{sorted(stages)}")
    return stages[opt]


class Workload(NamedTuple):
    fn: object
    args: tuple
    parts: dict      # params / optimizer / batch / cache -> their tensors


def _generator(device) -> torch.Generator:
    """A seeded generator for `device` (a CPU one for meta tensors)."""
    device = torch.device(device)
    return torch.Generator(device="cpu" if device.type == "meta"
                           else device).manual_seed(0)


def build_workload(cfg: ModelConfig, shape: InputShape, objective="ar",
                   device="meta") -> Workload:
    """The reference's three kinds, with no mesh: a train step (the loss,
    its gradient by autograd, the port's AdamW update), a prefill, and one
    decode step against a seq_len-deep cache."""
    params = api.init_params(cfg, device=device)
    batch = input_specs(cfg, shape, objective, device)
    if shape.kind == "train":
        opt = AdamW()
        opt_state = opt.init(params)
        return Workload(make_train_step(cfg, objective, opt),
                        (params, opt_state, batch, _generator(device)),
                        dict(params=params, optimizer=opt_state, batch=batch))
    if shape.kind == "prefill":
        pf = api.prefill_fn(cfg)

        @torch.no_grad()
        def prefill_step(params, batch):
            return pf(params, batch, shape.seq_len)

        return Workload(prefill_step, (params, batch),
                        dict(params=params, batch=batch))
    cache = abstract_cache(cfg, shape, device)
    dec = api.decode_fn(cfg)
    pos = torch.full((), shape.seq_len - 1, dtype=torch.int64, device=device)

    @torch.no_grad()
    def decode_step(params, cache, batch, pos):
        return dec(params, cache, batch["tokens"], pos)

    return Workload(decode_step, (params, cache, batch, pos),
                    dict(params=params, cache=cache, batch=batch))


def tree_bytes(tree) -> int:
    """The bytes of the distinct storages under a tree of tensors."""
    from torch.utils._pytree import tree_leaves

    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def memory_record(parts: dict, acct: dict, train: bool) -> dict:
    """The memory of one run, the counterpart of XLA's memory_analysis():
    the arguments' bytes (params, AdamW state, batch, cache: exact), the
    outputs' (exact), and an estimate of the peak: the arguments plus the
    largest live set of the storages the run created (`temp_bytes`: a train
    step's saved activations, its gradients and the update's new params
    and moments all pass through it). `activation_bytes` is what a train
    step saves for backward (each storage once), and otherwise what the run
    holds beyond its outputs at its peak."""
    sizes = {f"{k}_bytes": tree_bytes(v) for k, v in parts.items()}
    argument = sum(sizes.values())
    peak = argument + acct["peak_live_bytes"]
    activation = (acct["saved_bytes"] if train else
                  max(0, acct["peak_live_bytes"] - acct["output_bytes"]))
    return dict(argument_bytes=argument, output_bytes=acct["output_bytes"],
                temp_bytes=acct["peak_live_bytes"], peak_bytes=peak,
                activation_bytes=activation, fits_80GB=peak <= DEVICE_BYTES,
                **sizes)


def measure(cfg: ModelConfig, shape: InputShape, objective="ar") -> tuple:
    """(count, memory, model_flops) of one workload run once on meta."""
    w = build_workload(cfg, shape, objective)
    acct = analyze(w.fn, *w.args)
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        mf = model_flops_train(cfg, tokens)
    elif shape.kind == "prefill":
        mf = 2.0 * active_params(cfg) * tokens
    else:
        mf = model_flops_decode(cfg, shape.global_batch)
    return acct, memory_record(w.parts, acct, shape.kind == "train"), mf


def run_one(arch, shape, objective="ar", out_dir=None, opt=None) -> dict:
    """The dry-run record of one (arch, shape): `arch` an id or a config,
    `shape` a name of INPUT_SHAPES or an InputShape. The roofline's bytes
    are the run's compulsory traffic (`min_bytes`); the unfused traffic
    proxy is kept under `cost_unfused`."""
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_config(arch) if isinstance(arch, str) else arch
    cfg = adapt_config(cfg, shape)
    if opt:
        cfg = dataclasses.replace(cfg, **stage(cfg.arch_id, shape.name, opt))
    t0 = time.time()
    acct, mem, mf = measure(cfg, shape, objective)
    roof = Roofline(acct["flops_by_dtype"], acct["min_bytes"],
                    acct["collectives"]["_total"], chips=1, model_flops=mf)
    rec = {
        "arch": cfg.arch_id, "shape": shape.name, "mesh": MESH, "chips": 1,
        "opt": opt,
        "objective": objective if shape.kind == "train" else shape.kind,
        "compile_s": round(time.time() - t0, 2),
        "cost_unfused": {"flops": acct["flops"],
                         "hbm_bytes": acct["hbm_bytes"]},
        "min_bytes": acct["min_bytes"],
        "kernels": acct["kernels"],
        "memory": mem,
        "collectives": acct["collectives"],
        "roofline": roof.row(),
        "params_active": active_params(cfg),
    }
    if out_dir:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        suffix = f"__{opt}" if opt else ""
        (out_dir / f"{cfg.arch_id}__{shape.name}__{MESH}{suffix}.json"
         ).write_text(json.dumps(rec, indent=1))
    return rec


def sample_workload(cfg: ModelConfig, batch: int, nfe: int, order: int,
                    device="meta", fused_update=True) -> tuple:
    """(fn, args, evals) of the paper's production workload, unguided: a
    whole UniPC trajectory of the eps-net through the port's row loop
    (`core/unipc.unipc_sample_scan`), data prediction over VPLinear;
    `evals[0]` counts the eps-net evals a run makes."""
    from ..core import make_unipc_schedule, unipc_sample_scan
    from ..diffusion.schedules import VPLinear

    vp = VPLinear()
    sched = make_unipc_schedule(vp, nfe, order=order, prediction="data")
    net = api.eps_network(cfg)
    act = cfg.activation_dtype
    params = api.init_params(cfg, device=device)
    x_T = torch.zeros((batch, cfg.patch_tokens, cfg.latent_dim), dtype=act,
                      device=device)
    ids = torch.zeros((batch,), dtype=torch.int32, device=device)
    evals = [0]

    @torch.no_grad()
    def sample_step(params, x_T, class_ids):
        def data_model(x, t):
            evals[0] += 1
            a, sg = vp.alpha_sigma_torch(t.to(torch.float32))
            eps = net(params, x, t, {"class_ids": class_ids})
            return ((x.to(torch.float32) - sg * eps.to(torch.float32))
                    / a).to(x.dtype)

        return unipc_sample_scan(data_model, x_T, sched,
                                 fused_update=fused_update, dtype=act)

    return sample_step, (params, x_T, ids), evals


def run_sample_workload(arch="dit-i256", batch=256, nfe=10, order=3,
                        out_dir=None, fused_update=True) -> dict:
    """Beyond the assigned pairs: count the paper's production workload, a
    whole UniPC sampling trajectory (one eps-net eval a row), on the meta
    device. model_flops = `model_flops_sample` (2 N_active a token, the
    DiT's adaLN once a row)."""
    cfg = get_config(arch)
    t0 = time.time()
    fn, args, evals = sample_workload(cfg, batch, nfe, order,
                                      fused_update=fused_update)
    acct = analyze(fn, *args)
    mf = model_flops_sample(cfg, evals[0], batch)
    roof = Roofline(acct["flops_by_dtype"], acct["min_bytes"], chips=1,
                    model_flops=mf)
    rec = {"arch": arch, "shape": f"sample_nfe{nfe}", "mesh": MESH,
           "chips": 1, "opt": None, "compile_s": round(time.time() - t0, 2),
           "evals": evals[0], "collectives": acct["collectives"],
           "roofline": roof.row(), "kernels": acct["kernels"],
           "memory": memory_record(dict(params=args[0], batch=args[1:]),
                                   acct, train=False),
           "params_active": active_params(cfg)}
    r = rec["roofline"]
    print(f"[ok] {arch} x sample_nfe{nfe} x {MESH}: "
          f"bottleneck={r['bottleneck']} compute={r['compute_s']:.2e}s "
          f"mem={r['memory_s']:.2e}s coll={r['collective_s']:.2e}s "
          f"mfu={r['mfu']:.4f}")
    if out_dir:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}__sample_nfe{nfe}__{MESH}.json").write_text(
            json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=["all"])
    ap.add_argument("--objective", default="ar", choices=["ar", "diffusion"])
    ap.add_argument("--out", default="results/dryrun_h100")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--opt", default=None,
                    help="a config-only optimization stage of OPTIMIZATIONS")
    ap.add_argument("--sample", action="store_true",
                    help="count the UniPC sampling workload instead")
    args = ap.parse_args(argv)

    if args.sample:
        for arch in (args.arch if args.arch != ["all"] else ["dit-i256"]):
            run_sample_workload(arch, out_dir=args.out)
        return
    archs = all_arch_ids() if args.arch == ["all"] else args.arch
    shapes = list(INPUT_SHAPES) if args.shape == ["all"] else args.shape
    failures = []
    for arch in archs:
        for shape in shapes:
            tag = f"{arch} x {shape} x {MESH}"
            if (arch, shape) in SKIPS:
                print(f"[SKIP] {tag}: {SKIPS[(arch, shape)]}")
                continue
            suffix = f"__{args.opt}" if args.opt else ""
            out_file = Path(args.out) / f"{arch}__{shape}__{MESH}{suffix}.json"
            if args.resume and out_file.exists():
                print(f"[ok-cached] {tag}")
                continue
            try:
                rec = run_one(arch, shape, args.objective, args.out,
                              opt=args.opt)
                r, m = rec["roofline"], rec["memory"]
                gb = {k[:-6]: m.get(k, 0) / 1e9 for k in (
                    "params_bytes", "optimizer_bytes", "cache_bytes",
                    "activation_bytes", "peak_bytes")}
                print(f"[ok] {tag}: count={rec['compile_s']}s "
                      f"bottleneck={r['bottleneck']} "
                      f"compute={r['compute_s']:.2e}s "
                      f"mem={r['memory_s']:.2e}s "
                      f"coll={r['collective_s']:.2e}s "
                      + " ".join(f"{k}={v:.1f}GB" for k, v in gb.items())
                      + f" fits_80GB={m['fits_80GB']}")
            except Exception as e:  # noqa: BLE001 — report every cell
                failures.append((tag, str(e)))
                print(f"[FAIL] {tag}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        raise SystemExit(1)
    print("\nall dry-runs counted")


if __name__ == "__main__":
    main()
