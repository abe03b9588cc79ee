"""Diffusion sampling launcher (the port of `repro.launch.sample`): build the
eps-network for --arch (the DiT, or for a token arch the diffusion-LM head
over its backbone, unguided, over a 64-token latent window),
then sample with any solver of the zoo through the engine, or with its
python-loop reference (`--loop`), or a tuned `SolverPlan` (`--plan`, from
`launch.tune`). Runs on the CUDA card unless `--device cpu` is given; there
the engine's run is one CUDA graph replay (`engine/graphs.py`).

    PYTHONPATH=src python -m repro_torch.launch.sample --arch dit-i256 \
        --full --solver dpmpp --nfe 10 --order 3 --cfg-scale 2.0 --batch 8 \
        [--loop] [--quant w8a16] [--eval-dtype bfloat16] [--plan plan.json]
        [--ckpt ckpt_dir]
    PYTHONPATH=src python -m repro_torch.launch.sample --arch qwen2-0.5b \
        --full --nfe 10 --batch 8        # or mamba2-780m, zamba2-7b

The vlm and audio families are refused: their eps-net needs the frontend
embeddings in its batch, which this entry point does not feed (the
reference's fails there too); `api.eps_network` samples them with the
embeddings in `batch`.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..checkpoint import ckpt
from ..configs.registry import get_config
from ..diffusion.schedules import VPLinear
from ..engine import SOLVERS, CacheSpec, EngineSpec, SamplerEngine
from ..engine.engine import resolve_device
from ..engine.specs import EVAL_DTYPES
from ..models import api
from ..models.dit import dit_cache_shape
from ..models.quant import quant_spec
from ..obs.counters import DeviceCounters

NULL_CLASS_ID = api.NUM_CLASSES


def refuse_frontend_families(cfg) -> None:
    """ValueError for a family whose eps-net reads frontend embeddings from
    its batch: this entry point feeds none, as the reference's (its
    `eps_with({})`, src/repro/launch/sample.py:129, fails with a KeyError
    there)."""
    key = api.frontend_key(cfg)
    if key is not None:
        raise ValueError(
            f"launch.sample feeds the diffusion LM no frontend embeddings, "
            f"and the {cfg.family!r} family's eps-net needs "
            f"batch[{key!r}] (arch {cfg.arch_id!r}); the reference's "
            f"launch.sample fails there too (KeyError: {key!r}). Sample it "
            f"through api.eps_network(cfg) with {key!r} in the batch")


def class_ids(batch: int, num_classes: int = 1000, seed: int = 0) -> np.ndarray:
    """The class ids `repro.data.synthetic.class_ids` draws for a seed."""
    return np.random.default_rng(seed).integers(
        0, num_classes, size=(batch,)).astype(np.int32)


def build_engine(cfg, params, schedule, batch: int, seed: int = 0,
                 per_request_cond: bool = False, quant: str = "none",
                 eval_dtype: str = "float32", cache_block: int = 0,
                 device="cuda") -> SamplerEngine:
    """Wire the arch's eps-network into a SamplerEngine on `device`. For the
    DiT: the cond branch, the stacked 2B cond+uncond branch guided sampling
    runs, and the uncond branch (null class ids) for the sequential loop
    reference. For a token arch: the unguided diffusion-LM eps-net only
    (the reference's, `launch/sample.py:125-130`); guidance, quantization
    and feature reuse need the dit family. A token arch's engine carries
    the eps-net's device counters (`obs.counters.DeviceCounters`: a
    dropless MoE's rows routed to each expert), which `build`'s runs
    hold as `counters`.

    per_request_cond: instead of baking per-row class ids drawn from `seed`,
    the eps branches take `class_ids` as a per-call (B,) keyword argument
    (the serving step scatters one per request into its slot).

    eval_dtype="bfloat16" is the fast serving eval (DESIGN.md §11): the
    config's activations and every float param leaf go to bf16
    (`api.cast_params_for_eval`, before any quantization, as in the
    reference); the engine side of the boundary stays fp32 through the
    matching `EngineSpec.eval_dtype`.

    The weights kept once: the leaves the DiT casts to its activation dtype
    at each use (bf16 activations over fp32 params, the full-size default)
    are installed as one cast copy each (`api.cast_weights_once`, after any
    quantization, so the quant records are those of the fp32 tree). The
    per-use casts then launch nothing, and the samples are bit-identical.

    quant != "none" (dit only) calibrates and installs the tier's quantized
    param tree (`api.calibrate_and_quantize`, deterministic given `seed`)
    once, after the params are on `device` (so a8 calibration runs there),
    and before wiring, so every eps branch routes its dense sites through
    the quant_matmul op. A `cfg` that already carries the tier's spec (the
    cfg' of `api.calibrate_and_quantize`) comes with a quantized tree, which
    is wired as it is. The engine records the tier; its `model_fn` rejects
    specs that disagree, and likewise for eval_dtype.

    cache_block > 0 also wires the feature-reuse eval (DESIGN.md §12): the
    engine gets `eps_cached`, the same network with a deep-feature cache
    split at block `cache_block`, and the matching `CacheSpec`; it then
    serves cached plans whose specs carry the same `cache_block`
    (unconditional only: `EngineSpec.resolve` refuses guidance)."""
    if eval_dtype not in EVAL_DTYPES:
        raise ValueError(f"eval_dtype must be 'float32' or 'bfloat16', "
                         f"got {eval_dtype!r}")
    refuse_frontend_families(cfg)
    if quant != "none" and cfg.family != "dit":
        raise ValueError(f"the quantized denoiser path needs the dit "
                         f"family; {cfg.arch_id!r} is family "
                         f"{cfg.family!r}")
    if cache_block and cfg.family != "dit":
        raise ValueError(f"cache_block needs the dit family; "
                         f"{cfg.arch_id!r} is family {cfg.family!r}")
    if cache_block and not 1 <= cache_block < cfg.num_layers:
        raise ValueError(f"cache_block must be in "
                         f"1..{cfg.num_layers - 1}, got {cache_block}")
    device = resolve_device(device)
    params = api.params_to(params, device)
    if eval_dtype != "float32":
        cfg = dataclasses.replace(cfg, dtype=eval_dtype)
        params = api.cast_params_for_eval(params, eval_dtype)
    if quant != "none":
        if cfg.quant is None:
            cfg, params, _ = api.calibrate_and_quantize(
                cfg, params, quant, schedule=schedule, seed=seed)
        elif cfg.quant != quant_spec(quant):
            raise ValueError(f"cfg.quant={cfg.quant} is not the {quant!r} "
                             f"tier's spec {quant_spec(quant)}")
    params = api.cast_weights_once(cfg, params)
    if cfg.family != "dit":
        counters = DeviceCounters()
        net = api.eps_network(cfg, counters)
        return SamplerEngine(schedule, eps=lambda x, t: net(params, x, t, {}),
                             device=device, quant=quant,
                             eval_dtype=eval_dtype, counters=counters)
    net = api.eps_network(cfg)

    def cache_kw(baked=None):
        """The cached eps-net and its CacheSpec ({} uncached). `baked` fixes
        the class ids at build time; otherwise they come per call."""
        if not cache_block:
            return {}
        cnet = api.eps_network_cached(cfg, cache_block)

        def eps_cached(x, t, cache, reuse, deep=True, class_ids=None):
            ids = (baked if baked is not None else
                   None if class_ids is None else class_ids.long())
            return cnet(params, x, t, {"class_ids": ids}, cache, reuse,
                        deep=deep)

        return {"eps_cached": eps_cached,
                "cache_spec": CacheSpec(shape=dit_cache_shape(cfg),
                                        block=cache_block,
                                        n_blocks=cfg.num_layers,
                                        dtype=cfg.dtype)}

    def null_like(ids):
        return torch.full_like(ids, NULL_CLASS_ID)

    null = torch.full((batch,), NULL_CLASS_ID, dtype=torch.long,
                      device=device)

    def eps_uncond(x, t):
        return net(params, x, t, {"class_ids": null})

    if per_request_cond:
        def eps_cond(x, t, class_ids):
            return net(params, x, t, {"class_ids": class_ids.long()})

        def eps_stacked(xx, t, class_ids):
            ids = class_ids.long()
            return net(params, xx, t,
                       {"class_ids": torch.cat([ids, null_like(ids)])})

        return SamplerEngine(schedule, eps=eps_cond, eps_stacked=eps_stacked,
                             eps_uncond=eps_uncond, device=device,
                             quant=quant, eval_dtype=eval_dtype,
                             **cache_kw())
    ids = torch.as_tensor(class_ids(batch, seed=seed)).long().to(device)
    ids2 = torch.cat([ids, null_like(ids)])
    return SamplerEngine(
        schedule,
        eps=lambda x, t: net(params, x, t, {"class_ids": ids}),
        eps_stacked=lambda xx, t: net(params, xx, t, {"class_ids": ids2}),
        eps_uncond=eps_uncond, device=device, quant=quant,
        eval_dtype=eval_dtype, **cache_kw(baked=ids))


def latent_shape(cfg, batch):
    if cfg.family == "dit":
        return (batch, cfg.patch_tokens, cfg.latent_dim)
    return (batch, 64, cfg.latent_dim)  # diffusion-LM over a 64-token window


def sample(arch: str, *, reduced=True, solver="unipc", order=3, nfe=10,
           variant="bh2", prediction=None, batch=4, seed=0, params=None,
           x_T=None, loop=False, fused_update=True, cfg_scale=0.0,
           cfg_schedule="constant", thresholding=False, plan=None,
           quant="none", eval_dtype="float32", num_layers=None,
           device="cuda"):
    """Sample `batch` latents with `solver` (any name in `SOLVERS`); returns
    them as a numpy array: (batch, patch_tokens, latent_dim) for the DiT,
    (batch, 64, latent_dim) for a token arch's diffusion LM (unguided).

    `params` default to `api.init_params(cfg, seed)`; `x_T` to a standard
    normal draw from a torch.Generator seeded with `seed`; class ids come
    from numpy's default_rng(seed), as in the reference. `loop=True` runs
    the python-loop reference (`SamplerEngine.build_loop`: sequential CFG,
    fp32 only) instead of the engine's row loop. `quant` picks a quantized
    tier (models/quant.py, dit only), `eval_dtype` the eps-net's precision;
    `num_layers` cuts the depth of the config and keeps its widths. On the
    card the engine's run is a CUDA graph replay.

    `plan` (a `tuning.SolverPlan` or the path of its JSON) replaces the
    registry table: solver, NFE and order come from the plan, its lowered
    table goes to `engine.build(spec, table=...)`, and a cached plan (one
    with shallow steps) wires the engine's feature reuse at the plan's
    `cache_block`. A plan has no python-loop reference."""
    plan_tab = None
    cache_block = 0
    schedule = VPLinear()
    if plan is not None:
        # a tuned SolverPlan (path or object) replaces the registry table:
        # the spec keeps only the conditioning/runtime knobs
        from ..tuning import SolverPlan

        if loop:
            raise ValueError("a tuned plan runs the engine's table; there "
                             "is no python-loop reference for searched "
                             "plans")
        if isinstance(plan, str):
            plan = SolverPlan.load(plan)
        solver, nfe, order = "unipc", plan.nfe, max(plan.orders)
        prediction = plan.prediction
        # a cached plan (nonzero cache_depth) needs the cache-wired engine
        # and a spec carrying the same static boundary
        cache_block = plan.cache_block
        plan_tab = plan.compile(schedule)
    if loop and eval_dtype != "float32":
        raise ValueError("the python-loop reference is fp32-only; "
                         "eval_dtype rides the engine paths")
    if loop and quant != "none":
        raise ValueError("the python-loop reference is fp32-only; "
                         "quantized tiers ride the engine paths")
    device = resolve_device(device)
    cfg = get_config(arch)
    refuse_frontend_families(cfg)
    if cfg_scale and cfg.family != "dit":
        raise ValueError("classifier-free guidance needs the dit family "
                         "(class-conditional eps-net)")
    if reduced:
        cfg = cfg.reduced()
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    if params is None:
        params = api.init_params(cfg, seed, device)
    engine = build_engine(cfg, params, schedule, batch, seed, quant=quant,
                          eval_dtype=eval_dtype, cache_block=cache_block,
                          device=device)
    spec = EngineSpec(solver=solver, nfe=nfe, order=order, variant=variant,
                      prediction=prediction, cfg_scale=cfg_scale,
                      cfg_schedule=cfg_schedule, thresholding=thresholding,
                      fused_update=fused_update, quant=quant,
                      eval_dtype=eval_dtype, cache_block=cache_block)
    if x_T is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        x_T = torch.randn(latent_shape(cfg, batch), generator=gen,
                          device=device, dtype=torch.float32)
    x_T = torch.as_tensor(x_T, dtype=torch.float32).to(device)

    t0 = time.perf_counter()
    if loop:
        run = engine.build_loop(spec)
        x0 = run(x_T)
        nfe_used = run.solver.model.nfe  # measured eval count
    else:
        tab = engine.compile(spec, table=plan_tab)
        x0 = engine.build(spec, table=tab)(x_T)
        # the row loop evaluates the last row too; fused CFG keeps one
        # (2B-batched) call a row
        nfe_used = len(tab.timesteps)
    x0 = x0.cpu().numpy()  # waits for the device
    dt = time.perf_counter() - t0
    tag = (f"{solver}-{order}" + (" [plan]" if plan_tab is not None else "")
           + (f" [{quant}]" if quant != "none" else "")
           + (f" [{eval_dtype}]" if eval_dtype != "float32" else ""))
    mode = (" loop" if loop else
            " graph" if device.type == "cuda" else "")
    cache_note = (f" evals/latent={plan.eval_cost(cfg.num_layers):.2f} "
                  f"(cache_block={cache_block})" if cache_block else "")
    print(f"{tag} [{device.type}{mode}] nfe={nfe_used}{cache_note} "
          f"cfg={cfg_scale} wall={dt:.2f}s out_shape={x0.shape} "
          f"mean={x0.mean():+.4f} std={x0.std():.4f} "
          f"finite={np.isfinite(x0).all()}")
    return x0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dit-cifar")
    ap.add_argument("--solver", default="unipc", choices=sorted(SOLVERS))
    ap.add_argument("--order", type=int, default=3)
    ap.add_argument("--nfe", type=int, default=10)
    ap.add_argument("--variant", default="bh2", choices=["bh1", "bh2", "vary"])
    ap.add_argument("--prediction", default=None, choices=["data", "noise"],
                    help="override the solver's native prediction type "
                         "(unipc/ddim/dpm support both)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loop", action="store_true",
                    help="python-loop GridSolver reference instead of the "
                         "engine's row loop")
    ap.add_argument("--no-fused-update", action="store_true",
                    help="pin the row ops' plain PyTorch version (default: "
                         "the unipc_update kernel on the card)")
    ap.add_argument("--cfg-scale", type=float, default=0.0,
                    help="classifier-free guidance scale (0 = off); one "
                         "batched cond+uncond eval per step")
    ap.add_argument("--cfg-schedule", default="constant",
                    choices=["constant", "linear", "cosine"])
    ap.add_argument("--thresholding", action="store_true",
                    help="Imagen-style dynamic thresholding of the x0 "
                         "prediction (data-prediction solvers)")
    ap.add_argument("--quant", default="none",
                    choices=["none", "w8a16", "w8a8", "fp8a16", "w4a16"],
                    help="quantized denoiser tier: int8/fp8 weight matmuls "
                         "through the quant_matmul kernel, calibrated "
                         "scales, fp32 accumulation; dit family only")
    ap.add_argument("--eval-dtype", default="float32", choices=EVAL_DTYPES,
                    help="the eps-net's eval precision; solver state stays "
                         "fp32 (bfloat16: the fast serving eval)")
    ap.add_argument("--plan", default=None,
                    help="path to a tuned SolverPlan JSON "
                         "(repro_torch.launch.tune); overrides --solver/"
                         "--order/--nfe with the plan's searched per-step "
                         "schedule")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain PyTorch path")
    scale = ap.add_mutually_exclusive_group()
    scale.add_argument("--reduced", action="store_true",
                       help="reduced CPU-scale config (the default)")
    scale.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="a checkpoint directory (launch/train.py "
                         "--ckpt-dir, of either package): sample its "
                         "params")
    args = ap.parse_args(argv)
    if args.plan and args.loop:
        ap.error("--plan runs the engine's table; --loop has no python-loop "
                 "reference for searched plans")
    if args.loop and args.eval_dtype != "float32":
        ap.error("--eval-dtype rides the engine paths; the python-loop "
                 "reference is fp32-only")
    if args.loop and args.quant != "none":
        ap.error("--quant rides the engine paths; the python-loop "
                 "reference is fp32-only")
    try:
        refuse_frontend_families(get_config(args.arch))
    except ValueError as err:
        ap.error(str(err))
    family = get_config(args.arch).family
    if args.cfg_scale and family != "dit":
        ap.error(f"--cfg-scale needs a class-conditional eps-net; --arch "
                 f"{args.arch} is family '{family}', not 'dit' (try "
                 f"dit-cifar or dit-i256)")
    if args.quant != "none" and family != "dit":
        ap.error(f"--quant needs the dit family; --arch {args.arch} is "
                 f"family {family!r}")
    params = None
    if args.ckpt:
        tree, _ = ckpt.restore(args.ckpt)
        cfg = get_config(args.arch)
        if not args.full:
            cfg = cfg.reduced()
        params = api.params_from_numpy(tree["params"], cfg,
                                       resolve_device(args.device))
    return sample(args.arch, reduced=not args.full, solver=args.solver,
                  order=args.order, nfe=args.nfe, variant=args.variant,
                  prediction=args.prediction, batch=args.batch, seed=args.seed,
                  params=params,
                  loop=args.loop, fused_update=not args.no_fused_update,
                  cfg_scale=args.cfg_scale, cfg_schedule=args.cfg_schedule,
                  thresholding=args.thresholding, plan=args.plan,
                  quant=args.quant, eval_dtype=args.eval_dtype,
                  device=args.device)


if __name__ == "__main__":
    main()
