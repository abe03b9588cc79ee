"""Batched serving (the port of `repro.launch.serve`). Token models
(the decoder-only dense and MoE transformers, the Mamba2 SSM stack, the
zamba2 hybrid, the llama-vision vlm and the whisper encoder-decoder, whose
frontends are stubs fed `stub_embeds` as in the reference): prefill a
batch of prompts, then greedy or temperature decode with the stacked
cache (KV caches, SSM states, the fixed cross-attention K/V), each decode
step a CUDA graph replay on the card (`TokenDecoder`). Diffusion models (dit
family): continuous batching, one request = one latent to generate. A
request-level scheduler over `--batch` slots drives the engine's per-slot
step program, so requests admit the moment a slot frees, carry their own
seed, class and guidance scale, and emit without waiting for a batch to
drain. One batched (optionally 2B cond+uncond stacked) network eval per
tick, any registered solver, a plan bank of quality tiers, feature reuse
from a cached plan bank, the quantized and bf16 evals, resilience and fault
injection, and observability: a Chrome trace of tick spans and request
lifecycles (`--trace-out`), the metrics artifact (`--metrics-out`,
rendered and checked by `launch.obsreport`), and the quality probe
(`--probe-fraction`), which replays sampled completions against a
high-NFE fp32 reference. Runs on the CUDA card unless `--device cpu` is
given; there each tick is a CUDA graph replay and finished latents come
back as a pipelined trailing stream.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --full --batch 8 --prompt-len 512 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --batch 2 --prompt-len 12 --gen 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --full --batch 8 --prompt-len 512 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
        --full --batch 8 --prompt-len 384 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama-3.2-vision-90b --batch 2 --prompt-len 12 --gen 4 \
        --device cpu                     # --reduced, the default
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dit-i256 \
        --full --batch 8 --nfe 10 --cfg-scale 2.0 --arrival-rate 0.5 \
        --requests 24
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dit-cifar \
        --batch 4 --nfe 8 --arrival-rate 0.5 --requests 16 --device cpu \
        --trace-out trace.json --metrics-out metrics.json \
        --probe-fraction 0.25 --probe-ref-nfe 16

Under an active `sharding_rules(mesh, SERVE_RULES)` context (the caller's;
neither CLI has a mesh flag) the slot batch is annotated over the data axis,
as in the reference; on one card the annotation is the identity, so the
latents, the CUDA graphs and their launches are those of a run without it.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..configs.registry import get_config
from ..data.synthetic import TokenStream, frontend_embeds
from ..engine import graphs
from ..engine.engine import resolve_device
from ..engine.specs import EVAL_DTYPES
from ..models import api
from ..obs import metrics as obsm


class TokenDecoder:
    """The decode loop's step on static buffers: `token` (B, 1) int64 and
    `pos` a 0-d int64, both on the device, and the cache, which the step
    updates in place (KV slots at `pos % W`, SSM states) or reads as it is
    (the vlm's image K/V and the audio model's encoder K/V, fixed at
    prefill, so the graph captures them as part of the cache). `step()` runs one
    decode step on what they hold and returns the (B, 1, V) logits. With
    `jit` on the card the step is a CUDA graph (the reference's
    `jax.jit(decode)`), captured at the first `step()` after one eager
    step on a side stream over a copy of the cache (an SSM state advances
    at every step, so the warm-up must not touch the real one); the logits
    are the graph's static output, which the next step overwrites.
    Otherwise the step runs eagerly."""

    def __init__(self, params, cfg, cache: dict, batch: int, device,
                 jit: bool = True):
        self.params, self.cache = params, cache
        self.decode = api.decode_fn(cfg)
        self.token = torch.zeros((batch, 1), dtype=torch.int64, device=device)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.graphed = graphs.graphed(jit, device)
        self.graph = None

    def _step(self, token, pos):
        return self.decode(self.params, self.cache, token, pos)[0]

    def _warmup(self, token, pos):
        scratch = _clone_tree(self.cache)
        self.decode(self.params, scratch, token, pos)

    def step(self) -> torch.Tensor:
        if not self.graphed:
            return self._step(self.token, self.pos)
        if self.graph is None:
            self.graph = graphs.Graph(self._step, (self.token, self.pos),
                                      self._warmup)
        return self.graph.replay()


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def choose_token(logits: torch.Tensor, temperature: float,
                 generator: torch.Generator) -> torch.Tensor:
    """(B, S, V) logits -> (B,) int64 tokens from the last position: greedy
    `argmax` (the first maximum, as `jnp.argmax`), or with temperature > 0
    a categorical draw by the Gumbel-max trick (`jax.random.categorical`'s
    method) from `generator`, on the device and without a host sync."""
    last = logits[:, -1]
    if temperature <= 0:
        return torch.argmax(last, dim=-1)
    u = torch.rand(last.shape, generator=generator, device=last.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(last.to(torch.float32) / temperature
                        - torch.log(-torch.log(u)), dim=-1)


def decode_tokens(decoder: TokenDecoder, first: torch.Tensor, start: int,
                  gen: int, temperature: float,
                  generator: torch.Generator) -> torch.Tensor:
    """`gen` tokens (B, gen) on the device: `first`, then each step's choice
    fed back at positions start, start + 1, ... The tokens stay on the card
    (the reference reads each back); no step syncs with the host."""
    out = torch.empty((first.shape[0], gen), dtype=torch.int64,
                      device=first.device)
    tok = first
    for i in range(gen):
        out[:, i] = tok
        decoder.token.copy_(tok[:, None])
        decoder.pos.fill_(start + i)
        tok = choose_token(decoder.step(), temperature, generator)
    return out


@dataclass
class TokenRun:
    """What one `serve(..., return_run=True)` call served: the (batch, gen)
    tokens, the prefill and decode walls (host clock to a sync), the
    prompts, prefill's inputs (the prompts as "tokens" and any frontend
    embeddings, on the device), the last-position prefill logits and the
    decoder (its params, cache and graph)."""

    tokens: np.ndarray
    prefill_s: float
    decode_s: float
    prompts: torch.Tensor
    inputs: dict
    prefill_logits: torch.Tensor
    decoder: TokenDecoder


def serve(arch: str, *, reduced=True, batch=4, prompt_len=32, gen=32,
          temperature=0.0, seed=0, device="cuda", params=None, prompts=None,
          jit=True, return_run=False):
    """Token serving: prefill a batch of prompts, then decode `gen` tokens
    greedily (`temperature` 0) or by temperature sampling from a
    torch.Generator seeded with `seed`. Returns the (batch, gen) int32
    tokens (a `TokenRun` with `return_run=True`).

    `params` default to `api.init_params(cfg, seed)` on `device`; the
    weights the model casts at each use are kept once in the activation
    dtype (`api.cast_weights_once`). `prompts` (batch, prompt_len) default
    to block 0 of a `TokenStream` seeded with `seed` (its block seed comes
    from Python's string hash, so pass prompts to compare processes). A
    vlm's image embeddings and an audio model's frames are the stub
    frontend's, `stub_embeds(batch, ..., seed)`, as the reference feeds
    them. Prefill runs eagerly (the attention kernel: causal GQA, and the
    encoder's and the cross-attention's non-causal calls); each decode step
    is a CUDA graph replay on the card with `jit` (the eager step
    without)."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if cfg.family not in api.TOKEN_FAMILIES:
        raise ValueError(f"serve() decodes the token families "
                         f"{api.TOKEN_FAMILIES}; arch {arch!r} is family "
                         f"{cfg.family!r} (serve_diffusion serves dit)")
    if reduced:
        cfg = cfg.reduced()
    if params is None:
        params = api.init_params(cfg, seed, device)
    params = api.cast_weights_once(cfg, api.params_to(params, device))
    max_len = prompt_len + gen
    if prompts is None:
        prompts = TokenStream(cfg.vocab_size, prompt_len, batch,
                              seed).block(0)["tokens"]
    prompts = torch.as_tensor(np.asarray(prompts)).long().to(device)
    if prompts.shape != (batch, prompt_len):
        raise ValueError(f"prompts must be ({batch}, {prompt_len}), got "
                         f"{tuple(prompts.shape)}")
    generator = torch.Generator(device=device).manual_seed(seed)
    inputs = {"tokens": prompts}
    inputs.update({k: torch.from_numpy(v).to(device) for k, v in
                   frontend_embeds(cfg, batch, seed).items()})

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    logits, cache = api.prefill_fn(cfg)(params, inputs, max_len)
    sync()
    prefill_s = time.perf_counter() - t0
    decoder = TokenDecoder(params, cfg, cache, batch, device, jit=jit)
    t0 = time.perf_counter()
    out = decode_tokens(decoder, choose_token(logits, temperature, generator),
                        prompt_len, gen, temperature, generator)
    tokens = out.cpu().numpy().astype(np.int32)    # the one readback
    decode_s = time.perf_counter() - t0
    mode = " graph" if decoder.graphed else ""
    print(f"token [{device.type}{mode}] {arch}: prefill {prefill_s*1e3:.1f} "
          f"ms; decode {gen} steps {decode_s*1e3:.1f} ms "
          f"({decode_s/gen*1e3:.2f} ms/tok, batch={batch})")
    if return_run:
        return TokenRun(tokens=tokens, prefill_s=prefill_s,
                        decode_s=decode_s, prompts=prompts, inputs=inputs,
                        prefill_logits=logits, decoder=decoder)
    return tokens


@dataclass
class ServeRun:
    """What one `serve_diffusion(..., return_run=True)` call served: the
    finished latents ordered by rid, the scheduler (completions, events,
    registry), the run's metrics, the capture seconds, the program, and the
    tracer and quality probe when they were asked for."""

    latents: np.ndarray
    sched: object
    metrics: object
    capture_s: float
    program: object
    tracer: object = None
    probe: object = None


def serve_diffusion(arch: str, *, reduced=True, batch=4, nfe=10, order=3,
                    solver="unipc", fused_update=True, cfg_scale=0.0,
                    cfg_schedule="constant", thresholding=False, seed=0,
                    arrival_rate=None, trace=None, requests=None,
                    plan_bank=None, tiers=None, eval_dtype="float32",
                    quant="none", pipeline_depth=2, trace_out=None,
                    metrics_out=None, metrics_every=None,
                    probe_fraction=0.0, probe_ref_nfe=64, resilience=None,
                    faults=None, device="cuda", params=None,
                    return_run=False):
    """Continuous-batching diffusion serving through the engine's per-slot
    step program (`SamplerEngine.build_step` + `serving.SlotScheduler`):
    `batch` slots, requests admitted the tick a slot frees, per-request
    seed/class/cfg-scale, one batched eps-net eval per tick. `cfg_scale`
    turns on fused classifier-free guidance — ONE 2B-batched cond+uncond
    network call per tick, the per-slot guidance scale riding the step
    state; `thresholding` adds dynamic thresholding of the x0 prediction.

    Traffic: `trace` (a JSON arrival trace) or `arrival_rate` (Poisson,
    requests per tick) serve asynchronous traffic; with neither, `batch`
    requests all arrive at tick 0. The flight step is captured ahead of
    time (`SlotScheduler.aot_compile`), so capture and steady-state serving
    are reported apart. Returns the finished latents ordered by rid (a
    `ServeRun` with `return_run=True`).

    `pipeline_depth` (DESIGN.md §13) is how many ticks the scheduler keeps
    in flight: the default 2 overlaps host bookkeeping and admission with
    the card's work; 1 is the synchronous loop. Finished latents and
    tick-denominated metrics are bit-identical across depths.

    Quality tiers (DESIGN.md §10): `plan_bank` (a JSON bank of
    `SolverPlan`s) or `tiers` (hand-set tier names of
    `engine.default_tier_specs`) builds ONE `StepProgram` serving every
    tier. A plan bank whose plans carry `cache_depth` wires feature reuse
    (DESIGN.md §12) at their one `cache_block`; cached programs serve
    unconditional sampling only.

    Resilience (DESIGN.md §16): `resilience` (a `serving.ResilienceConfig`)
    and `faults` (a `serving.FaultPlan`, CLI `--inject-faults`).

    Observability (DESIGN.md §15): `trace_out` writes the Chrome trace of
    the run; `metrics_out` the metrics artifact (the registry's snapshot
    delta, the derived ServeMetrics, a periodic row every `metrics_every`
    executed ticks — 8 by default — and the Prometheus exposition);
    `probe_fraction` > 0 replays that fraction of the completions against
    a UniPC-3 reference at `probe_ref_nfe` on a second engine over the same
    params (fp32, unquantized, uncached).

    `params` (a DiT param tree) default to `api.init_params(cfg, seed)`.
    Latents are drawn from a CPU torch.Generator seeded with each request's
    seed, and each request's class id from numpy's default_rng(seed), as in
    the reference.
    """
    from ..diffusion import VPLinear
    from ..engine import EngineSpec, default_tier_specs
    from ..obs import (QualityProbe, Tracer, build_reference_fn,
                       write_metrics_artifact)
    from ..serving import (Request, SlotScheduler, load_trace,
                           poisson_requests, run_trace)
    from .sample import NULL_CLASS_ID, build_engine, class_ids

    if not 0.0 <= probe_fraction <= 1.0:
        raise ValueError(f"probe_fraction must be in [0, 1], "
                         f"got {probe_fraction}")
    device = resolve_device(device)
    cfg = get_config(arch)
    if cfg.family != "dit":
        raise ValueError(f"serve_diffusion serves the dit family; arch "
                         f"{arch!r} is family {cfg.family!r} (serve() "
                         f"decodes the token families)")
    if reduced:
        cfg = cfg.reduced()
    if params is None:
        params = api.init_params(cfg, seed, device)
    # a cached plan bank (DESIGN.md §12) decides the engine's cache wiring,
    # so load it before build_engine; every cached tier must agree on the one
    # static block boundary the program bakes in
    plans = None
    cache_block = 0
    if plan_bank is not None:
        from ..tuning import load_bank

        plans = load_bank(plan_bank)
        blocks = sorted({p.cache_block for p in plans.values()
                         if p.cache_block})
        if len(blocks) > 1:
            raise ValueError(
                f"plan bank {plan_bank} mixes cache boundaries {blocks}; one "
                f"program serves one static cache_block — retune the bank "
                f"with a single --cache-block")
        cache_block = blocks[0] if blocks else 0
        if cache_block and cfg_scale != 0.0:
            raise ValueError(
                f"plan bank {plan_bank} schedules feature reuse "
                f"(cache_block={cache_block}) but --cfg-scale={cfg_scale}; "
                f"cached programs serve unconditional sampling only")
        # a quant-tuned bank records its tier in plan meta; one quantized
        # param tree serves the whole program, so the bank must be uniform
        # and must agree with an explicit --quant
        bank_quants = sorted({p.meta.get("quant", "none")
                              for p in plans.values()})
        if len(bank_quants) > 1:
            raise ValueError(
                f"plan bank {plan_bank} mixes quant tiers {bank_quants}; "
                f"one quantized param tree serves one program — retune the "
                f"bank with a single --quant")
        if bank_quants[0] != "none":
            if quant not in ("none", bank_quants[0]):
                raise ValueError(
                    f"plan bank {plan_bank} was tuned for "
                    f"quant={bank_quants[0]!r} but --quant={quant!r}; a "
                    f"plan's parity gate only holds for the tier it was "
                    f"scored against")
            quant = bank_quants[0]
    engine = build_engine(cfg, params, VPLinear(), batch, seed,
                          per_request_cond=True, eval_dtype=eval_dtype,
                          cache_block=cache_block, quant=quant,
                          device=device)
    spec = EngineSpec(solver=solver, nfe=nfe, order=order,
                      cfg_scale=cfg_scale, cfg_schedule=cfg_schedule,
                      thresholding=thresholding, fused_update=fused_update,
                      eval_dtype=eval_dtype, quant=quant)
    common = dict(cfg_scale=cfg_scale, cfg_schedule=cfg_schedule,
                  thresholding=thresholding, fused_update=fused_update,
                  eval_dtype=eval_dtype, cache_block=cache_block,
                  quant=quant)
    tier_names = None
    if plans is not None:
        tier_specs = {
            name: EngineSpec(solver="unipc", nfe=p.nfe,
                             order=max(p.orders), prediction=p.prediction,
                             **common)
            for name, p in plans.items()}
        tables = {name: p.compile(engine.schedule)
                  for name, p in plans.items()}
        program = engine.build_bank(tier_specs, tables)
        tier_names = list(plans)
    elif tiers:
        all_specs = default_tier_specs(**common)
        unknown = [t for t in tiers if t not in all_specs]
        if unknown:
            raise ValueError(f"unknown tiers {unknown}; hand-set tiers are "
                             f"{sorted(all_specs)}")
        program = engine.build_bank({t: all_specs[t] for t in tiers})
        tier_names = list(tiers)
    else:
        program = engine.build_step(spec)
    tracer = None
    if trace_out is not None:
        tracer = Tracer(meta={"arch": arch, "slots": batch,
                              "pipeline_depth": pipeline_depth,
                              "eval_dtype": eval_dtype, "quant": quant,
                              "cache_block": cache_block,
                              "cfg_scale": cfg_scale,
                              "tiers": tier_names})
    probe = None
    if probe_fraction > 0.0:
        # the reference engine is deliberately plain — fp32, unquantized,
        # uncached — over the same param tensors, so the probe measures
        # what the SERVING tier's precision tricks cost, against the
        # converged solver trajectory
        ref_engine = build_engine(cfg, params, VPLinear(), batch, seed,
                                  per_request_cond=True, device=device)
        probe = QualityProbe(
            build_reference_fn(ref_engine, spec, ref_nfe=probe_ref_nfe),
            probe_fraction)
    # idle slots are conditioned on the null class; every request carries its
    # own class id (drawn from its seed), so conditioning is reproducible
    # whichever slot the scheduler admits it into
    sched = SlotScheduler(program, batch,
                          (cfg.patch_tokens, cfg.latent_dim),
                          extras_init={"class_ids": NULL_CLASS_ID},
                          pipeline_depth=pipeline_depth,
                          tracer=tracer, probe=probe,
                          resilience=resilience, faults=faults)
    capture_s = sched.aot_compile()
    if trace is not None:
        reqs = load_trace(trace)
    elif arrival_rate is not None:
        n_req = requests if requests is not None else 4 * batch
        reqs = poisson_requests(n_req, arrival_rate, seed=seed,
                                base_seed=seed, tiers=tier_names)
    else:
        reqs = [Request(rid=i, seed=seed + i) for i in range(batch)]
    for r in reqs:
        # single assignment point for untagged requests on a tiered program
        # (trace requests may carry their own tags)
        if tier_names is not None and r.tier is None:
            r.tier = tier_names[r.rid % len(tier_names)]
        if r.extras is None or "class_ids" not in r.extras:
            r.extras = {**(r.extras or {}),
                        "class_ids": int(class_ids(1, seed=r.seed)[0])}
    snap0 = sched.registry.snapshot()
    snapshot_log = [] if metrics_out is not None else None
    if metrics_out is not None and not metrics_every:
        metrics_every = 8
    m = run_trace(sched, reqs, snapshot_every=metrics_every,
                  snapshot_log=snapshot_log)
    if trace_out is not None:
        exported = tracer.export(trace_out)
        print(f"trace: {len(exported['traceEvents'])} events "
              f"({tracer.dropped} dropped) -> {trace_out}")
    if metrics_out is not None:
        write_metrics_artifact(
            metrics_out,
            metrics=obsm.delta(snap0, sched.registry.snapshot()),
            serve_metrics=m.row(),
            static={"mode": m.mode, "slots": m.slots, "n_rows": m.n_rows,
                    "pipeline_depth": m.pipeline_depth},
            exposition=sched.registry.exposition(),
            rows=snapshot_log,
            probe=probe.summary() if probe is not None else None)
        print(f"metrics: {len(snapshot_log)} periodic rows -> {metrics_out}")
    if probe is not None:
        for t, row in sorted(probe.summary().items()):
            print(f"  probe tier {t}: {row['count']} replayed, "
                  f"discrepancy mean {row['mean']:.3e} max {row['max']:.3e} "
                  f"(vs fp32 unipc-3 nfe={probe_ref_nfe})")
    mode = (f"bank[{','.join(tier_names)}]" if tier_names
            else f"{solver} nfe={nfe} order={order}")
    print(f"diffusion [{device.type}] slots={batch} {mode} "
          f"depth={m.pipeline_depth} cfg={cfg_scale} "
          f"fused_update={fused_update} eval={eval_dtype} quant={quant}"
          + (f" cache_block={cache_block}" if cache_block else "")
          + f": capture {capture_s:.2f}s, tick {m.tick_s * 1e3:.1f} ms, "
          f"{m.completed}/{m.requests} requests, "
          f"throughput {m.throughput_rps:.2f} req/s, "
          f"latency p50/p95 {m.latency_s_p50 * 1e3:.0f}/"
          f"{m.latency_s_p95 * 1e3:.0f} ms, occupancy {m.occupancy:.2f}, "
          f"evals/latent {m.evals_per_latent:.1f}")
    if (m.rejected or m.retries or m.failed or m.recoveries
            or m.faults_injected):
        print(f"  resilience: {m.rejected} rejected "
              f"({m.expired} expired), {m.degraded} shed-degraded, "
              f"{m.retries} retries, {m.failed} failed, "
              f"{m.recoveries} desync recoveries, "
              f"{m.faults_injected} faults injected")
        for ev in sched.events:
            print(f"    event {ev}")
    if m.per_tier:
        for t, row in m.per_tier.items():
            cost = (f" ({row['eval_cost']:.2f} full-eval units)"
                    if row["eval_cost"] and row["eval_cost"] != row["evals"]
                    else "")
            print(f"  tier {t}: {row['completed']} done, "
                  f"{row['evals']} evals/request{cost}, "
                  f"p50 latency {row['latency_ticks_p50']:.0f} ticks")
    # failed completions (retry budget exhausted on a non-finite latent)
    # carry poisoned arrays; never ship those
    order_by_rid = sorted((c for c in sched.completions if c.ok),
                          key=lambda c: c.rid)
    latents = (np.stack([c.latent for c in order_by_rid], axis=0)
               if order_by_rid else  # e.g. an empty trace
               np.zeros((0, cfg.patch_tokens, cfg.latent_dim), np.float32))
    if return_run:
        return ServeRun(latents=latents, sched=sched, metrics=m,
                        capture_s=capture_s, program=program, tracer=tracer,
                        probe=probe)
    return latents


def main(argv=None):
    from ..engine import SOLVERS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nfe", type=int, default=None,
                    help="sampler steps (default 10; incompatible with "
                         "--plan-bank/--tiers, which carry per-tier "
                         "schedules)")
    ap.add_argument("--order", type=int, default=None,
                    help="solver order (default 3; incompatible with "
                         "--plan-bank/--tiers)")
    ap.add_argument("--solver", default=None, choices=sorted(SOLVERS),
                    help="any registered solver (default unipc; "
                         "incompatible with --plan-bank/--tiers)")
    ap.add_argument("--no-fused-update", action="store_true",
                    help="pin the row ops' plain PyTorch version")
    ap.add_argument("--cfg-scale", type=float, default=0.0,
                    help="fused classifier-free guidance scale (0 = off; "
                         "one batched eval per step)")
    ap.add_argument("--cfg-schedule", default="constant",
                    choices=["constant", "linear", "cosine"])
    ap.add_argument("--thresholding", action="store_true",
                    help="dynamic thresholding (off by default)")
    ap.add_argument("--eval-dtype", default="float32", choices=EVAL_DTYPES,
                    help="the eps-net's eval precision; solver state and "
                         "combine weights stay fp32 (DESIGN.md §11)")
    ap.add_argument("--quant", default="none",
                    choices=["none", "w8a16", "w8a8", "fp8a16", "w4a16"],
                    help="quantized denoiser tier (DESIGN.md §14); a "
                         "quant-tuned plan bank pins its own tier")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="Poisson request arrivals, in requests per tick "
                         "(one tick = one batched eval); omit for all "
                         "requests at tick 0")
    ap.add_argument("--trace", default=None,
                    help="JSON arrival trace (list of {rid, seed, arrival, "
                         "cfg_scale, extras, tier, ttl})")
    ap.add_argument("--requests", type=int, default=None,
                    help="request count for --arrival-rate traffic "
                         "(default 4x batch)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="ticks kept in flight (DESIGN.md §13); 1 = "
                         "synchronous loop; finished latents are "
                         "bit-identical at any depth")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace_event JSON of per-tick and "
                         "per-request spans (open in chrome://tracing; "
                         "DESIGN.md §15)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics artifact (registry snapshot + "
                         "derived ServeMetrics + Prometheus exposition); "
                         "render with python -m repro_torch.launch.obsreport")
    ap.add_argument("--metrics-every", type=int, default=None,
                    help="periodic snapshot row cadence in executed ticks "
                         "for --metrics-out (default 8)")
    ap.add_argument("--probe-fraction", type=float, default=0.0,
                    help="replay this fraction of completed requests "
                         "against a high-NFE fp32 reference and record "
                         "per-tier trajectory-discrepancy gauges (0 = off)")
    ap.add_argument("--probe-ref-nfe", type=int, default=64,
                    help="NFE of the probe's UniPC-3 reference run")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="resilience (DESIGN.md §16): bound on queued "
                         "requests; past it new submissions are shed per "
                         "--shed-policy (default unbounded)")
    ap.add_argument("--shed-policy", default="reject",
                    choices=["reject", "degrade"])
    ap.add_argument("--degrade-tier", default=None,
                    help="tier shed requests are remapped to under "
                         "--shed-policy degrade (needs --plan-bank/--tiers)")
    ap.add_argument("--ttl", type=float, default=None,
                    help="admission deadline in tick-clock units past "
                         "arrival")
    ap.add_argument("--max-retries", type=int, default=0,
                    help="re-admissions after a non-finite latent (same "
                         "seed) before emitting a failed completion")
    ap.add_argument("--retry-fallback", default=None,
                    help="comma-separated safer-tier chain walked on retry")
    ap.add_argument("--recovery", default="recover",
                    choices=["recover", "raise"],
                    help="host/device desync handling")
    ap.add_argument("--inject-faults", default=None,
                    help="fault clauses, e.g. "
                         "'nan:rid=2,step=1;meta:tick=6;skew:tick=3,delta=9' "
                         "or 'seed:7,requests=8,nfe=4' for a seeded plan")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="token serving: prompt length")
    ap.add_argument("--gen", type=int, default=32,
                    help="token serving: tokens to decode")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="token serving: 0 = greedy, else temperature "
                         "sampling")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain PyTorch path")
    bank = ap.add_mutually_exclusive_group()
    bank.add_argument("--plan-bank", default=None,
                      help="JSON bank of SolverPlans; serves every tier "
                           "from one step program (a cached bank wires "
                           "feature reuse)")
    bank.add_argument("--tiers", default=None,
                      help="comma-separated hand-set quality tiers "
                           "(fast,balanced,quality) served from one step "
                           "program")
    scale = ap.add_mutually_exclusive_group()
    scale.add_argument("--reduced", action="store_true",
                       help="reduced CPU-scale config (the default)")
    scale.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    family = get_config(args.arch).family
    # the reference's refusals of the diffusion-only flags for token archs
    if family != "dit" and args.cfg_scale:
        ap.error(f"--cfg-scale needs a class-conditional eps-net; --arch "
                 f"{args.arch} is family '{family}', not 'dit' (try "
                 f"dit-cifar or dit-i256)")
    if family != "dit" and (args.arrival_rate is not None or args.trace):
        ap.error(f"--arrival-rate/--trace drive the diffusion request "
                 f"scheduler; --arch {args.arch} is family '{family}' "
                 f"(token serving decodes a fixed batch)")
    if family != "dit" and (args.plan_bank or args.tiers):
        ap.error(f"--plan-bank/--tiers serve diffusion quality tiers; "
                 f"--arch {args.arch} is family '{family}'")
    if family != "dit" and args.eval_dtype != "float32":
        ap.error(f"--eval-dtype configures the diffusion engine's network "
                 f"eval; --arch {args.arch} is family '{family}'")
    if family != "dit" and args.quant != "none":
        ap.error(f"--quant configures the diffusion engine's denoiser; "
                 f"--arch {args.arch} is family '{family}'")
    if family != "dit" and args.pipeline_depth != 2:
        ap.error(f"--pipeline-depth configures the diffusion serving loop; "
                 f"--arch {args.arch} is family '{family}'")
    if family != "dit" and (args.trace_out or args.metrics_out
                            or args.probe_fraction):
        ap.error(f"--trace-out/--metrics-out/--probe-fraction instrument the "
                 f"diffusion serving loop; --arch {args.arch} is family "
                 f"'{family}'")
    wants_resilience = (args.max_queue is not None or args.ttl is not None
                        or args.max_retries or args.retry_fallback
                        or args.degrade_tier or args.shed_policy != "reject"
                        or args.recovery != "recover")
    if family != "dit" and (wants_resilience or args.inject_faults):
        ap.error(f"--max-queue/--ttl/--max-retries/--inject-faults and "
                 f"friends configure the diffusion serving scheduler; "
                 f"--arch {args.arch} is family '{family}'")
    if family != "dit":
        return serve(args.arch, reduced=not args.full, batch=args.batch,
                     prompt_len=args.prompt_len, gen=args.gen,
                     temperature=args.temperature, seed=args.seed,
                     device=args.device)
    if ((args.plan_bank or args.tiers)
            and (args.solver is not None or args.nfe is not None
                 or args.order is not None)):
        ap.error("--solver/--nfe/--order configure a single-plan program; "
                 "a plan bank / tier program takes its per-tier schedules "
                 "from the bank (drop those flags)")
    if args.arrival_rate is not None and args.arrival_rate <= 0:
        ap.error(f"--arrival-rate must be > 0 requests per tick, "
                 f"got {args.arrival_rate}")
    if args.pipeline_depth < 1:
        ap.error(f"--pipeline-depth must be >= 1, got {args.pipeline_depth}")
    if not 0.0 <= args.probe_fraction <= 1.0:
        ap.error(f"--probe-fraction must be in [0, 1], "
                 f"got {args.probe_fraction}")
    resilience = None
    if wants_resilience:
        from ..serving import ResilienceConfig
        resilience = ResilienceConfig(
            max_queue=args.max_queue, shed_policy=args.shed_policy,
            degrade_tier=args.degrade_tier, default_ttl=args.ttl,
            max_retries=args.max_retries,
            fallback=(tuple(args.retry_fallback.split(","))
                      if args.retry_fallback else ()),
            recovery=args.recovery)
    faults = None
    if args.inject_faults:
        from ..serving import parse_fault_spec
        faults = parse_fault_spec(args.inject_faults)
    return serve_diffusion(
        args.arch, reduced=not args.full, batch=args.batch, seed=args.seed,
        nfe=args.nfe if args.nfe is not None else 10,
        order=args.order if args.order is not None else 3,
        solver=args.solver if args.solver is not None else "unipc",
        fused_update=not args.no_fused_update, cfg_scale=args.cfg_scale,
        cfg_schedule=args.cfg_schedule, thresholding=args.thresholding,
        arrival_rate=args.arrival_rate, trace=args.trace,
        requests=args.requests, plan_bank=args.plan_bank,
        tiers=(args.tiers.split(",") if args.tiers else None),
        eval_dtype=args.eval_dtype, quant=args.quant,
        pipeline_depth=args.pipeline_depth, trace_out=args.trace_out,
        metrics_out=args.metrics_out, metrics_every=args.metrics_every,
        probe_fraction=args.probe_fraction,
        probe_ref_nfe=args.probe_ref_nfe, resilience=resilience,
        faults=faults, device=args.device)


if __name__ == "__main__":
    main()
