"""One-card dry run on the meta device (the counterpart of
`repro/launch/dryrun.py`): every (architecture x input shape) built and run
once with shapes only, no allocation and no arithmetic; its operations and
bytes counted (`analysis/opcount.py`), its H100 roofline
(`analysis/roofline.py`), and its memory against the card's 80 GB.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --out results/dryrun_h100
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sample
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-67b \\
        --shape decode_32k --mesh single multi --opt kvseq

This entry point never touches CUDA. The reference's dry run never runs on
a TPU either: it lowers on forced host CPU devices. Its one-card
counterpart builds on the meta device by design: a meta run counts the
same operations and bytes as an eager run on the card (the kernels report
their cost on every route), in seconds a cell on the CPU, with no card.

`--mesh` picks where the run is placed: `h100x1` (the default) is one card
and no sharding context; `host` the 1x1 mesh (`launch.mesh.make_host_mesh`
on meta); `single` and `multi` the abstract production meshes (16 x 16
and 2 x 16 x 16 chips). Under a mesh the run happens inside
`sharding_rules(mesh, rules)`, the rules being `rules_for(shape)` or the
`--opt` stage's, and its record differs from one card's in these keys:
`chips` is the mesh's; `memory.argument_bytes` is what one chip holds of
the params, the AdamW state, the batch and the cache, summed from the
spec tables' `shard_shape`s (and so are the `*_bytes` parts); the
reference reads `temp_bytes`, `peak_bytes`, `output_bytes` and
`collectives` from XLA's SPMD partitioner, which one card has not, so they
are null; the operation count and the roofline stay the whole program's
on one card (`count_scope` says so). An `--opt` stage's config applies on
every mesh; its rules only under a mesh (one card places nothing).
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
from ..parallel.sharding import (KV_SEQ_SERVE_RULES, LONG_SERVE_RULES,
                                 SEQ_PARALLEL_TRAIN_RULES, SERVE_RULES,
                                 TRAIN_RULES, NamedSharding, P,
                                 normalize_axes, sharding_rules)
from .mesh import make_host_mesh, make_production_mesh
from .specs import (abstract_cache, batch_shardings, cache_shardings,
                    input_specs, param_shardings, shard_bytes)
from .train import make_train_step

MESH = "h100x1"
MESHES = (MESH, "host", "single", "multi")
COUNT_SCOPE = ("whole program on one card: per-chip operations, temp and "
               "peak memory and collectives need an SPMD partitioner")

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


# the reference's per-(arch, shape) optimization stages, --opt <stage>:
# cfg = dataclasses.replace overrides; rules = an alternative rule set
OPTIMIZATIONS = {
    # MoE dispatch locality
    ("granite-moe-3b-a800m", "train_4k"): {
        "local_dispatch": dict(cfg=dict(moe_dispatch_groups=32)),
        "shard_map": dict(cfg=dict(moe_shard_map=True)),
        "shard_map_seqp": dict(cfg=dict(moe_shard_map=True),
                               rules=SEQ_PARALLEL_TRAIN_RULES),
    },
    ("mixtral-8x7b", "train_4k"): {
        "local_dispatch": dict(cfg=dict(moe_dispatch_groups=32)),
        "shard_map": dict(cfg=dict(moe_shard_map=True)),
    },
    # sequence parallelism for the biggest dense train
    ("deepseek-67b", "train_4k"): {
        "seqp": dict(rules=SEQ_PARALLEL_TRAIN_RULES),
        "seqp_chunk": dict(cfg=dict(attention_chunk=512),
                           rules=SEQ_PARALLEL_TRAIN_RULES),
        "chunk": dict(cfg=dict(attention_chunk=512)),
    },
    # KV-seq model sharding when kv-heads don't divide the axis
    ("deepseek-67b", "decode_32k"): {
        "kvseq": dict(rules=KV_SEQ_SERVE_RULES),
        "kvseq_bf16": dict(cfg=dict(param_dtype="bfloat16"),
                           rules=KV_SEQ_SERVE_RULES),
    },
    ("qwen2-0.5b", "decode_32k"): {
        "kvseq": dict(rules=KV_SEQ_SERVE_RULES),
    },
    # blockwise attention for the memory-bound long prefill
    ("qwen2-0.5b", "prefill_32k"): {
        "chunk": dict(cfg=dict(attention_chunk=1024)),
        "chunk512": dict(cfg=dict(attention_chunk=512)),
        "chunk2048": dict(cfg=dict(attention_chunk=2048)),
    },
}


def stage(arch: str, shape_name: str, opt: str) -> dict:
    """Optimization stage `opt` of (arch, shape): `cfg` overrides and/or
    `rules`."""
    stages = OPTIMIZATIONS.get((arch, shape_name), {})
    if opt not in stages:
        raise KeyError(f"no stage {opt!r} for {arch} x {shape_name}; have "
                       f"{sorted(stages)}")
    return stages[opt]


def rules_for(shape: InputShape) -> dict:
    if shape.kind == "train":
        return TRAIN_RULES
    if shape.name == "long_500k":
        return LONG_SERVE_RULES
    return SERVE_RULES


def make_mesh(kind: str):
    """The mesh of `--mesh kind`; None for one card."""
    if kind not in MESHES:
        raise ValueError(f"--mesh {kind!r}: one of {MESHES}")
    if kind == MESH:
        return None
    if kind == "host":
        return make_host_mesh("meta")
    return make_production_mesh(multi_pod=kind == "multi")


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


def mesh_memory_record(parts: dict, mesh, rules: dict) -> dict:
    """What one chip of `mesh` holds of a workload's arguments under
    `rules`: each part's bytes from the spec tables' `shard_shape`s (the
    AdamW moments mirror the params' shardings, its step is replicated,
    as in the reference), summed into `argument_bytes`. What XLA's SPMD
    partitioner would add (outputs, temporaries, the peak) is null."""
    sh = {"params": param_shardings(parts["params"], mesh, rules)}
    if "optimizer" in parts:
        opt = parts["optimizer"]
        sh["optimizer"] = type(opt)(NamedSharding(mesh, P()), sh["params"],
                                    sh["params"])
    if "batch" in parts:
        sh["batch"] = batch_shardings(parts["batch"], mesh, rules)
    if "cache" in parts:
        sh["cache"] = cache_shardings(parts["cache"], mesh, rules)
    sizes = {f"{k}_bytes": shard_bytes(parts[k], s) for k, s in sh.items()}
    return dict(argument_bytes=sum(sizes.values()), output_bytes=None,
                temp_bytes=None, peak_bytes=None, **sizes)


def measure(cfg: ModelConfig, shape: InputShape, objective="ar", mesh=None,
            rules=None) -> tuple:
    """(count, memory, model_flops) of one workload run once on meta; with
    a `mesh`, inside `sharding_rules(mesh, rules)` and with one chip's
    argument bytes (`mesh_memory_record`)."""
    w = build_workload(cfg, shape, objective)
    if mesh is None:
        acct = analyze(w.fn, *w.args)
        memory = memory_record(w.parts, acct, shape.kind == "train")
    else:
        with sharding_rules(mesh, rules):
            acct = analyze(w.fn, *w.args)
        memory = mesh_memory_record(w.parts, mesh, rules)
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        mf = model_flops_train(cfg, tokens)
    elif shape.kind == "prefill":
        mf = 2.0 * active_params(cfg) * tokens
    else:
        mf = model_flops_decode(cfg, shape.global_batch)
    return acct, memory, mf


def run_one(arch, shape, objective="ar", out_dir=None, opt=None,
            mesh_kind=MESH) -> dict:
    """The dry-run record of one (arch, shape): `arch` an id or a config,
    `shape` a name of INPUT_SHAPES or an InputShape, placed on `mesh_kind`
    (one of MESHES; see the module docstring). The roofline's bytes are
    the run's compulsory traffic (`min_bytes`); the unfused traffic proxy
    is kept under `cost_unfused`."""
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_config(arch) if isinstance(arch, str) else arch
    cfg = adapt_config(cfg, shape)
    mesh = make_mesh(mesh_kind)
    rules = rules_for(shape)
    if opt:
        st = stage(cfg.arch_id, shape.name, opt)
        if st.get("cfg"):
            cfg = dataclasses.replace(cfg, **st["cfg"])
        if st.get("rules") is not None:
            rules = st["rules"]
    t0 = time.time()
    acct, mem, mf = measure(cfg, shape, objective, mesh, rules)
    roof = Roofline(acct["flops_by_dtype"], acct["min_bytes"],
                    acct["collectives"]["_total"], chips=1, model_flops=mf)
    rec = {
        "arch": cfg.arch_id, "shape": shape.name, "mesh": mesh_kind,
        "chips": 1 if mesh is None else mesh.size,
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
    if mesh is not None:
        rec["collectives"] = None
        rec["count_scope"] = COUNT_SCOPE
    if out_dir:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        suffix = f"__{opt}" if opt else ""
        (out_dir / f"{cfg.arch_id}__{shape.name}__{mesh_kind}{suffix}.json"
         ).write_text(json.dumps(rec, indent=1))
    return rec


def sample_workload(cfg: ModelConfig, batch: int, nfe: int, order: int,
                    device="meta", fused_update=True) -> tuple:
    """(fn, args, evals) of the paper's production workload, unguided: a
    whole UniPC trajectory of the eps-net through the port's row loop
    (`core/unipc.unipc_sample_scan`), data prediction over VPLinear;
    `evals[0]` counts the eps-net evals a run makes."""
    from ..core import make_unipc_schedule
    from ..core.unipc import sample_step_fn
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
    trajectory = sample_step_fn(sched, fused_update=fused_update)

    @torch.no_grad()
    def sample_step(params, x_T, class_ids):
        def data_model(x, t):
            evals[0] += 1
            a, sg = vp.alpha_sigma_torch(t.to(torch.float32))
            eps = net(params, x, t, {"class_ids": class_ids})
            return ((x.to(torch.float32) - sg * eps.to(torch.float32))
                    / a).to(x.dtype)

        return trajectory(data_model, x_T, dtype=act)

    return sample_step, (params, x_T, ids), evals


def run_sample_workload(arch="dit-i256", batch=256, nfe=10, order=3,
                        out_dir=None, fused_update=True,
                        mesh_kind=MESH) -> dict:
    """Beyond the assigned pairs: count the paper's production workload, a
    whole UniPC sampling trajectory (one eps-net eval a row), on the meta
    device. model_flops = `model_flops_sample` (2 N_active a token, the
    DiT's adaLN once a row). Under a mesh, inside SERVE_RULES, the latents
    and class ids split over the batch axes as the reference places them,
    and one chip's argument bytes recorded."""
    cfg = get_config(arch)
    mesh = make_mesh(mesh_kind)
    t0 = time.time()
    fn, args, evals = sample_workload(cfg, batch, nfe, order,
                                      fused_update=fused_update)
    parts = dict(params=args[0], batch=args[1:])
    if mesh is None:
        acct = analyze(fn, *args)
        memory = memory_record(parts, acct, train=False)
    else:
        with sharding_rules(mesh, SERVE_RULES):
            acct = analyze(fn, *args)
        baxes = normalize_axes(mesh, ("pod", "data"))
        memory = mesh_memory_record(dict(params=args[0]), mesh, SERVE_RULES)
        memory["batch_bytes"] = shard_bytes(
            args[1:], (NamedSharding(mesh, P(baxes, None, None)),
                       NamedSharding(mesh, P(baxes))))
        memory["argument_bytes"] += memory["batch_bytes"]
    mf = model_flops_sample(cfg, evals[0], batch)
    roof = Roofline(acct["flops_by_dtype"], acct["min_bytes"], chips=1,
                    model_flops=mf)
    rec = {"arch": arch, "shape": f"sample_nfe{nfe}", "mesh": mesh_kind,
           "chips": 1 if mesh is None else mesh.size, "opt": None,
           "compile_s": round(time.time() - t0, 2),
           "evals": evals[0], "collectives": acct["collectives"],
           "roofline": roof.row(), "kernels": acct["kernels"],
           "memory": memory, "params_active": active_params(cfg)}
    if mesh is not None:
        rec["collectives"] = None
        rec["count_scope"] = COUNT_SCOPE
    r = rec["roofline"]
    print(f"[ok] {arch} x sample_nfe{nfe} x {mesh_kind}: "
          f"bottleneck={r['bottleneck']} compute={r['compute_s']:.2e}s "
          f"mem={r['memory_s']:.2e}s coll={r['collective_s']:.2e}s "
          f"mfu={r['mfu']:.4f} argument_bytes/chip="
          f"{memory['argument_bytes']}")
    if out_dir:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}__sample_nfe{nfe}__{mesh_kind}.json").write_text(
            json.dumps(rec, indent=1))
    return rec


def _summary(rec: dict) -> str:
    """The printed line of one record: its roofline, and its memory in GB
    (one card's parts and peak, or one chip's arguments on a mesh)."""
    r, m = rec["roofline"], rec["memory"]
    keys = (("params_bytes", "optimizer_bytes", "cache_bytes",
             "activation_bytes", "peak_bytes") if rec["mesh"] == MESH else
            ("params_bytes", "optimizer_bytes", "batch_bytes", "cache_bytes",
             "argument_bytes"))
    digits = 1 if rec["mesh"] == MESH else 3
    gb = " ".join(f"{k[:-6]}={m.get(k, 0) / 1e9:.{digits}f}GB" for k in keys)
    tail = (f" fits_80GB={m['fits_80GB']}" if rec["mesh"] == MESH else
            f" per chip of {rec['chips']}")
    return (f"count={rec['compile_s']}s bottleneck={r['bottleneck']} "
            f"compute={r['compute_s']:.2e}s mem={r['memory_s']:.2e}s "
            f"coll={r['collective_s']:.2e}s {gb}{tail}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=["all"])
    ap.add_argument("--objective", default="ar", choices=["ar", "diffusion"])
    ap.add_argument("--out", default="results/dryrun_h100")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", nargs="+", default=[MESH], choices=MESHES,
                    help="h100x1 = one card, host = 1x1, single = 256 "
                         "chips, multi = 512")
    ap.add_argument("--opt", default=None,
                    help="optimization stage name from OPTIMIZATIONS")
    ap.add_argument("--sample", action="store_true",
                    help="count the UniPC sampling workload instead")
    args = ap.parse_args(argv)

    if args.sample:
        for arch in (args.arch if args.arch != ["all"] else ["dit-i256"]):
            for mesh_kind in args.mesh:
                run_sample_workload(arch, out_dir=args.out,
                                    mesh_kind=mesh_kind)
        return
    archs = all_arch_ids() if args.arch == ["all"] else args.arch
    shapes = list(INPUT_SHAPES) if args.shape == ["all"] else args.shape
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in args.mesh:
                tag = f"{arch} x {shape} x {mesh_kind}"
                if (arch, shape) in SKIPS:
                    print(f"[SKIP] {tag}: {SKIPS[(arch, shape)]}")
                    continue
                suffix = f"__{args.opt}" if args.opt else ""
                out_file = (Path(args.out)
                            / f"{arch}__{shape}__{mesh_kind}{suffix}.json")
                if args.resume and out_file.exists():
                    print(f"[ok-cached] {tag}")
                    continue
                try:
                    rec = run_one(arch, shape, args.objective, args.out,
                                  opt=args.opt, mesh_kind=mesh_kind)
                    print(f"[ok] {tag}: " + _summary(rec))
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
