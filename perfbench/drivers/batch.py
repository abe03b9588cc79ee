"""The closed-loop batch driver: whole-trajectory replays of `batch` images,
back to back, as an offline sampling job (FID-50K) runs them.

Replay k samples the latents x_T and (guided) class ids that a generator
seeded with (seed, k) draws on the device, at the traffic's guidance scale,
and reads its latents back to the host. Two replays are kept in flight:
the next is queued before the host waits for the last one's readback. The
window runs at least `seconds` and ends when the last replay launched
before then has reached the host; `images` counts every latent that did.

The check keeps, for each row of the batch, the latent of one replay drawn
from the seed (a reservoir of one per row), so every row position and
replays from the whole window are compared.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from perfbench import harness, program

WARMUP_REPLAYS = 2


@dataclasses.dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    run: object
    bufs: list
    events: list
    tracer: object
    kept: dict = dataclasses.field(default_factory=dict)  # row -> (k, out)


def replay_seed(seed: int, k: int) -> int:
    return (int(seed) * 1_000_003 + k) % (1 << 63)


def inputs(cfg: dict, batch: int, seed: int, k: int, device):
    """Replay k's latents x_T (batch, *sample shape) and class ids (or
    None)."""
    gen = torch.Generator(device=device).manual_seed(replay_seed(seed, k))
    x_T = torch.randn((batch,) + harness.sample_shape(cfg), generator=gen,
                      device=device, dtype=torch.float32)
    ids = (torch.randint(0, cfg["num_classes"], (batch,), generator=gen,
                         device=device) if cfg["conditional"] else None)
    return x_T, ids


def setup(cfg, traffic, seed, device, params, quant, tracer,
          part=lambda name: None) -> State:
    """The engine built and every shape of the window warmed; `part(name)`
    marks the end of each part of set-up."""
    B = traffic["batch"]
    w = traffic.get("guidance_w")
    eng = program.engine(cfg, params, B, seed, quant, device)
    part("engine")
    run = eng.build(program.spec(cfg, traffic, quant, w))
    part("build")
    cuda = device.type == "cuda"
    shape = (B,) + harness.sample_shape(cfg)
    state = State(cfg, traffic, seed, device, run,
                  bufs=[torch.empty(shape, pin_memory=cuda)
                        for _ in range(2)],
                  events=[torch.cuda.Event() if cuda else None
                          for _ in range(2)],
                  tracer=tracer)
    # the first call captures the graph; every shape of the window is
    # warmed on replays the window does not count (seeds of their own)
    for k in range(WARMUP_REPLAYS):
        _launch(state, -1 - k)
        _land(state, -1 - k)
        part(f"replay{k}")
    return state


def _launch(s: State, k: int) -> None:
    B = s.traffic["batch"]
    x_T, ids = inputs(s.cfg, B, s.seed, k, s.device)
    with s.tracer.range("bench.replay"):
        y = s.run(x_T, class_ids=ids) if ids is not None else s.run(x_T)
    with s.tracer.range("bench.readback"):
        buf = s.bufs[k % 2]
        buf.copy_(y, non_blocking=True)
        if s.events[k % 2] is not None:
            s.events[k % 2].record()


def _land(s: State, k: int):
    with s.tracer.range("bench.wait"):
        if s.events[k % 2] is not None:
            s.events[k % 2].synchronize()
    return s.bufs[k % 2]


def window(s: State, seconds: float, tracer) -> harness.Run:
    B = s.traffic["batch"]
    rng = np.random.default_rng([int(s.seed), 7])
    s.kept = {}
    with tracer.range("bench.window"):
        t0 = time.perf_counter()
        _launch(s, 0)
        k = 0
        while True:
            more = time.perf_counter() - t0 < seconds
            if more:
                _launch(s, k + 1)
            out = _land(s, k)
            # a reservoir of one latent per row, drawn from the seed
            take = (np.arange(B) if k == 0 else
                    np.flatnonzero(rng.random(B) < 1.0 / (k + 1)))
            for j in take:
                s.kept[int(j)] = (k, out[j].numpy().copy())
            k += 1
            if not more:
                break
        window_s = time.perf_counter() - t0
    rows = 2 if s.cfg["conditional"] else 1   # cond + uncond under CFG
    n_rows = s.traffic["solver"]["nfe"] + 1   # the engine's init row too
    return harness.Run(cfg=s.cfg, traffic=s.traffic, window_s=window_s,
                       images=k * B, calls=k * n_rows, rows_per_call=B * rows,
                       notes={"replays": k})


def samples(s: State, run: harness.Run, seed: int) -> list:
    B = s.traffic["batch"]
    w = s.traffic.get("guidance_w")
    out = []
    by_replay: dict = {}
    for j, (k, lat) in sorted(s.kept.items()):
        by_replay.setdefault(k, []).append((j, lat))
    for k, rows in sorted(by_replay.items()):
        x_T, ids = inputs(s.cfg, B, s.seed, k, s.device)
        x_T = x_T.cpu()
        ids = ids.cpu() if ids is not None else None
        for j, lat in rows:
            out.append(harness.Sample(
                x_T=x_T[j], out=torch.from_numpy(lat),
                class_id=int(ids[j]) if ids is not None else None,
                w=float(w) if ids is not None else None))
    return out


def counts(s: State, run: harness.Run) -> tuple:
    """(attempted, failed): every image of the window; a replay either
    reaches the host or the run raises."""
    return run.images, 0


def release(s: State) -> None:
    s.run = None
    s.bufs = []
