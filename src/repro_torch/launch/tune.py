"""Solver-plan autotuning launcher (the port of `repro.launch.tune`,
DESIGN.md §10).

Searches the per-step decision space (timestep knots, UniP order, UniC
on/off, B(h) variant) for one NFE budget — or a whole tier bank — against a
high-NFE reference trajectory on the arch's eps-network, and saves the
winning plan(s) as JSON for `launch/sample.py --plan` and
`launch/serve.py --plan-bank`. Runs on the CUDA card unless `--device cpu`
is given; there every candidate of an NFE replays the same CUDA graphs.

    PYTHONPATH=src python -m repro_torch.launch.tune --arch dit-cifar \
        --nfe 8 --budget 80 --out plan8.json
    PYTHONPATH=src python -m repro_torch.launch.tune --arch dit-cifar \
        --bank fast=5,balanced=8,quality=16 --out bank.json
    PYTHONPATH=src python -m repro_torch.launch.tune --smoke --device cpu

The eps-net is trained `--train-steps` steps first (the reference's
default 100, `launch/train.py`); `--train-steps 0` tunes the random init.
The smoke runs a tiny search and exits nonzero unless the tuned plan's
discrepancy is no worse than the hand-set UniPC-2 baseline it starts from
(the search never regresses, so a failure means the tuner itself broke).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs.registry import get_config
from ..diffusion.schedules import VPLinear
from ..engine import EngineSpec
from ..engine.engine import resolve_device
from ..models import api
from ..tuning import (SearchConfig, SolverPlan, make_objective,
                      quant_parity_gate, reference_trajectory, save_bank,
                      tune_cached_plan, tune_plan)
from .sample import build_engine, latent_shape


def _setup(arch: str, reduced: bool, batch: int, seed: int,
           train_steps: int = 0, cache_block: int = 0, quant: str = "none",
           device="cuda"):
    """Engine + probe latents for the objective. `train_steps > 0` briefly
    trains the eps-net first (diffusion objective, `launch/train.py`, on
    `device`): at random init the reduced nets are nearly linear and every
    solver lands within fp32 noise of the reference, so plan rankings are
    meaningless; ~100 steps makes the trajectory curvature real.

    Returns (engine, x_T, fp32_engine). With `quant != "none"` the primary
    engine serves the quantized denoiser (DESIGN.md §14) and `fp32_engine`
    is a second engine over the SAME params at fp32 — the parity gate's
    reference and baseline anchor. Otherwise fp32_engine IS engine.
    Params are the trained ones, or `api.init_params(cfg, seed)`; x_T is a
    standard normal draw from a torch.Generator seeded with `seed` on
    `device`."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if train_steps > 0:
        from .train import train as _train

        params, _ = _train(arch, reduced=reduced, objective="diffusion",
                           steps=train_steps, batch=8, seq=32, lr=1e-3,
                           log_every=max(1, train_steps), seed=seed,
                           device=device)
    else:
        params = api.init_params(cfg, seed, device)
    engine = build_engine(cfg, params, VPLinear(), batch, seed,
                          cache_block=cache_block, quant=quant, device=device)
    fp32_engine = engine
    if quant != "none":
        fp32_engine = build_engine(cfg, params, VPLinear(), batch, seed,
                                   cache_block=cache_block, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x_T = torch.randn(latent_shape(cfg, batch), generator=gen, device=device,
                      dtype=torch.float32)
    return engine, x_T, fp32_engine


def tune(arch: str = "dit-cifar", *, nfe: int = 8, budget: int = 80,
         beam: int = 2, rounds: int = 3, baseline_order: int = 2,
         ref_nfe: int = 48, batch: int = 4, seed: int = 0,
         reduced: bool = True, train_steps: int = 100, engine=None,
         x_T=None, x_ref=None, cache_block: int = 0,
         cache_slack: float = 1.1, quant: str = "none",
         quant_slack: float = 1.5, fp32_engine=None, verbose: bool = False,
         device="cuda"):
    """Search one NFE budget; returns (plan, report). The search starts from
    the hand-set UniPC-`baseline_order` plan, so the reported baseline IS the
    paper's default table at this budget. Pass engine/x_T/x_ref (see
    `reference_trajectory`) to share setup across several budgets.

    cache_block > 0 runs the joint solver + cache-schedule search
    (`tune_cached_plan`, DESIGN.md §12): the engine must be cache-wired
    (pass cache_block to `_setup`, or an `engine` built with it), and the
    report gains the no-cache anchor, the discrepancy ratio against it
    (constrained <= `cache_slack`), and the plan's evals-per-latent.

    quant != "none" tunes against the quantized denoiser (DESIGN.md §14)
    but anchors everything to fp32: the reference trajectory AND the
    baseline anchor come from `fp32_engine` (same params, full precision),
    and the tuned plan is only emitted if its discrepancy stays within
    `quant_slack` x the fp32 baseline's — `quant_parity_gate` raises
    `QuantParityError` otherwise. The emitted plan's meta records the tier,
    so a serving bank pins it (`launch/serve.py --plan-bank`).

    Without a prebuilt engine, `_setup` builds one on `device`, training
    the eps-net `train_steps` steps first."""
    if engine is None:
        engine, x_T, fp32_engine = _setup(arch, reduced, batch, seed,
                                          train_steps,
                                          cache_block=cache_block,
                                          quant=quant, device=device)
    elif quant != "none" and fp32_engine is None:
        raise ValueError("tuning a quant tier with a prebuilt engine needs "
                         "the matching fp32_engine (same params) for the "
                         "parity gate's reference and baseline anchor")
    spec = EngineSpec(solver="unipc", nfe=nfe, order=baseline_order,
                      cache_block=cache_block, quant=quant)
    fp32_anchor = None
    if quant != "none":
        from dataclasses import replace as _replace

        fp32_spec = _replace(spec, quant="none")
        if x_ref is None:
            x_ref = reference_trajectory(fp32_engine, fp32_spec, x_T,
                                         ref_nfe=ref_nfe)
        anchor_obj = make_objective(fp32_engine, fp32_spec, x_T,
                                    ref_nfe=ref_nfe, x_ref=x_ref)
        fp32_anchor = anchor_obj(SolverPlan.from_spec(fp32_spec),
                                 fp32_engine.schedule)
    objective = make_objective(engine, spec, x_T, ref_nfe=ref_nfe,
                               x_ref=x_ref)
    init = SolverPlan.from_spec(spec)
    cfg_search = SearchConfig(budget=budget, beam=beam, rounds=rounds)
    t0 = time.perf_counter()
    if cache_block:
        cres = tune_cached_plan(objective, engine.schedule, init, cfg_search,
                                cache_block=cache_block, slack=cache_slack,
                                verbose=verbose)
        wall = time.perf_counter() - t0
        n_blocks = engine.cache_spec.n_blocks
        plan = cres.plan.with_meta(arch=arch, nfe=nfe, ref_nfe=ref_nfe,
                                   baseline_order=baseline_order, seed=seed,
                                   search_wall_s=round(wall, 3))
        report = {"arch": arch, "nfe": nfe,
                  "baseline": cres.history[0][0] if cres.history else None,
                  "tuned": cres.score, "evals": cres.evals,
                  "search_wall_s": wall, "cache_block": cache_block,
                  "uncached_tuned": cres.uncached_score,
                  "cached_ratio": cres.score / max(cres.uncached_score,
                                                   1e-12),
                  "nfe_evals": nfe + 1,
                  "evals_per_latent": plan.eval_cost(n_blocks)}
        tuned = cres.score
    else:
        res = tune_plan(objective, engine.schedule, init, cfg_search,
                        verbose=verbose)
        wall = time.perf_counter() - t0
        plan = res.plan.with_meta(arch=arch, nfe=nfe, ref_nfe=ref_nfe,
                                  baseline_order=baseline_order, seed=seed,
                                  search_wall_s=round(wall, 3))
        report = {"arch": arch, "nfe": nfe, "baseline": res.baseline,
                  "tuned": res.score,
                  "improvement": res.baseline - res.score,
                  "evals": res.evals, "search_wall_s": wall}
        tuned = res.score
    if quant != "none":
        # gate BEFORE emitting: raises QuantParityError on an over-quantized
        # tier, so no plan with an unmet parity budget ever reaches disk
        ratio = quant_parity_gate(tuned, fp32_anchor, slack=quant_slack,
                                  quant=quant, context=f"{arch} nfe={nfe}")
        plan = plan.with_meta(quant=quant, quant_slack=quant_slack,
                              quant_ratio=round(ratio, 4),
                              fp32_baseline=fp32_anchor)
        report.update(quant=quant, quant_slack=quant_slack,
                      quant_ratio=ratio, fp32_baseline=fp32_anchor)
    return plan, report


def tune_bank(arch: str, tiers: dict, *, budget: int = 80, beam: int = 2,
              rounds: int = 3, baseline_order: int = 2, seed: int = 0,
              ref_nfe: int = 48, batch: int = 4, reduced: bool = True,
              train_steps: int = 100, cache_block: int = 0,
              cache_slack: float = 1.1, quant: str = "none",
              quant_slack: float = 1.5, verbose: bool = False,
              device="cuda"):
    """Tune one plan per tier ({name: nfe}) over a shared engine, probe
    batch, and reference trajectory; returns ({name: plan}, [report]).
    `cache_block > 0` tunes every tier jointly with a cache schedule at that
    shared boundary (a bank serves through ONE step program). With
    `quant != "none"` the whole bank is tuned against one quantized param
    tree — the fp32 reference trajectory is shared, each tier runs its own
    parity gate, and every plan's meta records the tier so serving pins it."""
    engine, x_T, fp32_engine = _setup(arch, reduced, batch, seed, train_steps,
                                      cache_block=cache_block, quant=quant,
                                      device=device)
    x_ref = reference_trajectory(
        fp32_engine, EngineSpec(solver="unipc", nfe=ref_nfe,
                                cache_block=cache_block), x_T,
        ref_nfe=ref_nfe)
    plans, reports = {}, []
    for name, nfe in tiers.items():
        plan, rep = tune(arch, nfe=int(nfe), budget=budget, beam=beam,
                         rounds=rounds, baseline_order=baseline_order,
                         ref_nfe=ref_nfe, seed=seed,
                         engine=engine, x_T=x_T, x_ref=x_ref,
                         cache_block=cache_block, cache_slack=cache_slack,
                         quant=quant, quant_slack=quant_slack,
                         fp32_engine=fp32_engine, verbose=verbose)
        plans[name] = plan.with_meta(tier=name)
        rep["tier"] = name
        reports.append(rep)
    return plans, reports


def smoke(arch: str = "dit-cifar", nfe: int = 6, budget: int = 24,
          train_steps: int = 100, seed: int = 0, reduced: bool = True,
          device="cuda") -> dict:
    """The CI gate: tiny search budget, assert the tuned plan's discrepancy
    is <= the hand-set UniPC-2 baseline's. rounds=1 / ref_nfe=24 / batch=2
    are pinned — they define smoke scale."""
    plan, report = tune(arch, nfe=nfe, budget=budget, rounds=1,
                        ref_nfe=24, batch=2, seed=seed, reduced=reduced,
                        train_steps=train_steps, device=device)
    assert report["tuned"] <= report["baseline"], (
        f"tuned plan regressed the baseline: {report['tuned']:.6f} > "
        f"{report['baseline']:.6f}")
    assert plan.nfe == nfe
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="dit-cifar")
    ap.add_argument("--nfe", type=int, default=8)
    ap.add_argument("--budget", type=int, default=80,
                    help="max objective evaluations for the search")
    ap.add_argument("--beam", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--baseline-order", type=int, default=2,
                    help="order of the hand-set UniPC baseline the search "
                         "starts from (and is scored against)")
    ap.add_argument("--ref-nfe", type=int, default=48,
                    help="NFE of the reference trajectory the objective "
                         "measures discrepancy against")
    ap.add_argument("--batch", type=int, default=4,
                    help="probe latent batch size")
    ap.add_argument("--train-steps", type=int, default=100,
                    help="brief diffusion-objective training of the eps-net "
                         "before tuning (0 = tune the random init)")
    ap.add_argument("--cache-block", type=int, default=0,
                    help="jointly tune a DiT feature-reuse schedule at this "
                         "block boundary (0 = no caching); shallow steps "
                         "recompute only the first k blocks (DESIGN.md §12)")
    ap.add_argument("--cache-slack", type=float, default=1.1,
                    help="max tuned-discrepancy ratio vs the no-cache anchor "
                         "the cached search may spend on reuse steps")
    ap.add_argument("--quant", default="none",
                    choices=["none", "w8a16", "w8a8", "fp8a16", "w4a16"],
                    help="tune against the quantized denoiser tier "
                         "(DESIGN.md §14); the plan is only emitted if its "
                         "discrepancy vs the fp32 reference passes the "
                         "parity gate (exits nonzero otherwise)")
    ap.add_argument("--quant-slack", type=float, default=1.5,
                    help="parity budget: max tuned-discrepancy ratio vs the "
                         "fp32 baseline a quantized tier may cost")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the tuned plan (or bank) JSON here")
    ap.add_argument("--bank", default=None,
                    help="tune a tier bank instead: name=nfe pairs, e.g. "
                         "fast=5,balanced=8,quality=16")
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: tiny search on dit-cifar, exit nonzero "
                         "if the tuned plan is worse than the UniPC-2 "
                         "baseline")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain PyTorch path")
    scale = ap.add_mutually_exclusive_group()
    scale.add_argument("--reduced", action="store_true",
                       help="reduced CPU-scale config (the default)")
    scale.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    if args.smoke:
        report = smoke(args.arch, nfe=args.nfe, budget=args.budget,
                       train_steps=args.train_steps, seed=args.seed,
                       reduced=not args.full, device=args.device)
        print(json.dumps(report, indent=1))
        print(f"tuning smoke ok: baseline {report['baseline']:.5f} -> "
              f"tuned {report['tuned']:.5f} in {report['evals']} evals")
        return report
    if args.bank:
        tiers = dict(kv.split("=") for kv in args.bank.split(","))
        plans, reports = tune_bank(
            args.arch, tiers, budget=args.budget, beam=args.beam,
            rounds=args.rounds, baseline_order=args.baseline_order,
            seed=args.seed, ref_nfe=args.ref_nfe,
            batch=args.batch, reduced=not args.full,
            train_steps=args.train_steps, cache_block=args.cache_block,
            cache_slack=args.cache_slack, quant=args.quant,
            quant_slack=args.quant_slack, verbose=args.verbose,
            device=args.device)
        for rep in reports:
            print(f"tier {rep['tier']} (nfe={rep['nfe']}): baseline "
                  f"{rep['baseline']:.5f} -> tuned {rep['tuned']:.5f} "
                  f"({rep['evals']} evals, {rep['search_wall_s']:.1f}s)")
            if args.quant != "none":
                print(f"    quant {args.quant}: {rep['quant_ratio']:.3f}x "
                      f"the fp32 baseline {rep['fp32_baseline']:.5f} "
                      f"(budget {args.quant_slack}x) — parity gate passed")
        if args.out:
            save_bank(args.out, plans)
            print(f"wrote bank ({', '.join(plans)}) to {args.out}")
        return plans
    plan, report = tune(args.arch, nfe=args.nfe, budget=args.budget,
                        beam=args.beam, rounds=args.rounds,
                        baseline_order=args.baseline_order,
                        ref_nfe=args.ref_nfe, batch=args.batch,
                        seed=args.seed, reduced=not args.full,
                        train_steps=args.train_steps,
                        cache_block=args.cache_block,
                        cache_slack=args.cache_slack, quant=args.quant,
                        quant_slack=args.quant_slack, verbose=args.verbose,
                        device=args.device)
    print(f"{args.arch} nfe={args.nfe}: baseline {report['baseline']:.5f} "
          f"-> tuned {report['tuned']:.5f} ({report['evals']} evals, "
          f"{report['search_wall_s']:.1f}s)")
    if args.quant != "none":
        print(f"  quant {args.quant}: {report['quant_ratio']:.3f}x the fp32 "
              f"baseline {report['fp32_baseline']:.5f} "
              f"(budget {args.quant_slack}x) — parity gate passed")
    if args.cache_block:
        print(f"  cached @ block {args.cache_block}: "
              f"{report['evals_per_latent']:.2f} evals/latent vs "
              f"{report['nfe_evals']} uncached, ratio "
              f"{report['cached_ratio']:.3f} (slack {args.cache_slack})")
    if args.out:
        plan.save(args.out)
        print(f"wrote plan to {args.out}")
    return plan


if __name__ == "__main__":
    main()
