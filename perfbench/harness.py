"""One run of one cell: the manifest, the files found by name, the run
record the metric readers read, the profiler's trace reduced to intervals,
the comparison with the reference, and the result line.

Everything that belongs to one configuration, traffic mix, driver or
metric is a file of its own, found by the name `BENCHMARK.json` gives it:

    configs/<config>.json      sizes and precision, and `reference`, the
                               module of reference/ that recomputes it;
                               optionally `weights` (params/<name>.py),
                               `port` and `sample_shape`
    traffic/<traffic>.json     parameters, and `driver`, the module of
                               drivers/ that runs them
    metrics/<metric>.py        `read(run) -> float | None`; a roofline's
                               `.json` names its bound, in yardstick.py or
                               as `<module>:<function>` of bounds/
    limits/<workload>.json     the limit of each number compared, and the
                               control it was set against
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# where a configuration's modules are found by name
PACKAGES = {"params": "perfbench.params", "reference": "perfbench.reference",
            "bounds": "perfbench.bounds"}
LIMITS = HERE / "limits"
REF_BLOCK = 32      # latents the reference samples at once


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in man['workloads']]}")


def config_entry(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def metrics_of(man: dict, cell: str, trace: bool) -> list:
    """The cell's metric entries: its end-to-end metrics in an untraced
    run (one without `workloads`, as `setup_s`, in every cell), its
    per-layer metrics, those whose `workloads` list it, in a traced one."""
    if not trace:
        return [m for m in man["end_to_end"]
                if cell in m.get("workloads", [cell])]
    return [m for m in man["per_layer"] if cell in m["workloads"]]


def load_module(path: Path, name: Optional[str] = None):
    """Import the file `path` as a module of its own (a file name may hold
    dots, as a metric's does)."""
    modname = name or "perfbench_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def driver_of(traffic: dict):
    return load_module(HERE / "drivers" / f"{traffic['driver']}.py")


def reader_of(metric: str):
    return load_module(HERE / "metrics" / f"{metric}.py")


def module_of(kind: str, name: str):
    """The module `name` of the package of `kind` (a key of PACKAGES)."""
    return importlib.import_module(f"{PACKAGES[kind]}.{name}")


def bound_of(name: str):
    """A roofline's bound `(cfg, rows, evals) -> seconds`: `<module>:
    <function>` of bounds/, or a bare name of yardstick.py."""
    if ":" in name:
        mod, fn = name.split(":")
        return getattr(module_of("bounds", mod), fn)
    from . import yardstick

    return getattr(yardstick, name)


def sample_shape(cfg: dict) -> tuple:
    """The shape of one sample, x_T and its latent: the configuration's
    `sample_shape`, else a DiT's (patch_tokens, latent_dim)."""
    if "sample_shape" in cfg:
        return tuple(cfg["sample_shape"])
    return (cfg["patch_tokens"], cfg["latent_dim"])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, Flax's
    or the JAX package's (the port's `repro_torch` is none of them)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# the trace: host ranges and device intervals
# ---------------------------------------------------------------------------

class Tracer:
    """The profiler around the measured window (`on`), and the
    benchmark's own host ranges (`range`), which cost nothing when off."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def range(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def start(self) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> Optional["Trace"]:
        if self.prof is None:
            return None
        self.prof.stop()
        from torch.autograd import DeviceType
        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if name.startswith("bench."):
                # a range is also mirrored on the device's timeline
                if e.device_type() != DeviceType.CUDA:
                    host.append((name, e.start_ns(), e.end_ns()))
            elif e.device_type() == DeviceType.CUDA:
                device.append((name, e.start_ns(), e.end_ns()))
        self.prof = None
        return Trace.of(device, host)


def union(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo, hi) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def covered(intervals) -> float:
    return float(sum(e - s for s, e in union(intervals)))


def gaps(busy, lo, hi) -> list:
    """The (start, end) stretches of [lo, hi] that no busy interval
    covers."""
    out, at = [], lo
    for s, e in union(clip(busy, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


class HostLabels:
    """What the host was doing at a time: the benchmark range running then,
    other than the window itself (the ranges inside the window do not
    nest), else the window's own name."""

    def __init__(self, host):
        inner = sorted((s, e, n) for n, s, e in host if n != "bench.window")
        self.starts = [s for s, _, _ in inner]
        self.inner = inner

    def at(self, t: int) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.inner[i][1] > t:
            return self.inner[i][2]
        return "bench.window"


@dataclasses.dataclass
class Trace:
    """The traced window (the `bench.window` range, ns) with every device
    operation in it, clipped to it, and the benchmark's host ranges."""
    device: list        # (name, start_ns, end_ns)
    host: list          # (name, start_ns, end_ns)
    lo: int
    hi: int

    @classmethod
    def of(cls, device, host) -> "Trace":
        win = [(s, e) for n, s, e in host if n == "bench.window"]
        if not win:
            raise RuntimeError("the trace has no bench.window range")
        lo, hi = win[0]
        dev = [(n, s2, e2) for n, s, e in device
               for s2, e2 in clip([(s, e)], lo, hi)]
        return cls(dev, host, lo, hi)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        return covered([(s, e) for _, s, e in self.device]) / 1e9

    def seconds_matching(self, patterns) -> Optional[float]:
        """Device seconds of the operations whose name matches any of the
        regular expressions `patterns` (None when none ran)."""
        rx = [re.compile(p, re.IGNORECASE) for p in patterns]
        names = {n for n, _, _ in self.device}
        hit = {n for n in names if any(r.search(n) for r in rx)}
        spans = [(s, e) for n, s, e in self.device if n in hit]
        return covered(spans) / 1e9 if spans else None

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle: dict = {}
        labels = HostLabels(self.host)
        for s, e in gaps([(s, e) for _, s, e in self.device],
                         self.lo, self.hi):
            label = labels.at((s + e) // 2)
            n, tot, big = idle.get(label, (0, 0.0, 0.0))
            idle[label] = (n + 1, tot + (e - s) / 1e9,
                           max(big, (e - s) / 1e9))
        gap_rows = sorted(idle.items(), key=lambda kv: -kv[1][1])[:top]
        return {"device_ops": [[n[:160], v] for n, v in ops],
                "idle_gaps": [[f"{k} ({n} gaps, longest {big:.6f} s)", tot]
                              for k, (n, tot, big) in gap_rows]}


# ---------------------------------------------------------------------------
# the run record the metric readers read
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """What a window measured, in host seconds unless named otherwise.

    Both kinds fill `calls` and `rows_per_call`: the eps-net evals the
    window executed and the rows of each (the work the kernels did, the
    engine's init row and a tick's idle slots included). Batch drivers
    fill `images`; the open-loop driver fills
    `requests` (each a dict of wall times: due, submit, admit, done; done
    None for one never completed) and the scheduler's counters over the
    window (`ticks`, `host_ns`). `trace` is the reduced profile of a traced
    run, None otherwise."""
    cfg: dict
    traffic: dict
    window_s: float
    setup_s: float = 0.0
    images: int = 0
    calls: int = 0
    rows_per_call: int = 0
    requests: list = dataclasses.field(default_factory=list)
    ticks: int = 0
    host_ns: int = 0
    drain_limit_s: float = 60.0
    trace: Optional[Trace] = None
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def guided(self) -> bool:
        return bool(self.cfg["conditional"])

    @property
    def nfe(self) -> int:
        return int(self.traffic["solver"]["nfe"])


def quantile(values, q: float) -> float:
    """The q-quantile of `values` by linear interpolation between the
    order statistics at q (n - 1) (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def roofline_share(run: Run, patterns: Path) -> Optional[float]:
    """A kernel family's share of its roofline, in %: the least time of the
    work the window's evals did, from their shapes (the `yardstick`
    function the file `patterns` names under `bound`), over the device
    time of the kernels that did it (the file's `kernels`, regular
    expressions on their names). None where no such kernel ran."""
    if run.trace is None or not run.calls:
        return None
    spec = load_json(patterns)
    spent = run.trace.seconds_matching(spec["kernels"])
    if not spent:
        return None
    bound = bound_of(spec["bound"])(run.cfg, run.rows_per_call, run.calls)
    return 100.0 * bound / spent


def latencies_s(run: Run) -> list:
    """Each request's latency, from its due time to its latent on the host;
    a request never completed counts as waiting to the end of the drain."""
    return [(r["done"] if r["done"] is not None else
             r["close"] + run.drain_limit_s) - r["due"]
            for r in run.requests]


# ---------------------------------------------------------------------------
# the comparison with the reference
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Sample:
    """One latent the timed path produced, with the inputs it was made
    from: x_T (T, C) on the host, its class and DiT guidance scale w
    (eps_u + w (eps_c - eps_u)) when guided, and the output."""
    x_T: object
    out: object
    class_id: Optional[int] = None
    w: Optional[float] = None


def compare(cfg: dict, traffic: dict, seed: int, samples: list,
            device) -> dict:
    """Recompute every sample with the configuration's reference, from
    weights made anew from the seed, in blocks; returns the numbers
    compared: the worst relative L2 distance of a sample from the
    reference's latent. A sample of another shape than the configuration's
    reads inf."""
    import torch

    from . import weights

    ref = module_of("reference", cfg["reference"])
    params = weights.make_params(cfg, seed, device)
    shape = sample_shape(cfg)
    worst = 0.0
    for i in range(0, len(samples), REF_BLOCK):
        part = samples[i:i + REF_BLOCK]
        if any(tuple(torch.as_tensor(v).shape) != shape
               for s in part for v in (s.x_T, s.out)):
            return {"worst_rel_l2": math.inf}
        x_T = torch.stack([torch.as_tensor(s.x_T) for s in part]).to(device)
        out = torch.stack([torch.as_tensor(s.out) for s in part]).to(
            device, torch.float64)
        if cfg["conditional"]:
            ids = torch.tensor([s.class_id for s in part], device=device)
            w = torch.tensor([s.w for s in part], device=device)
        else:
            ids = w = None
        want = ref.sample(cfg, params, x_T.to(torch.float32), ids, w,
                          traffic["solver"])
        err = ((out - want).flatten(1).norm(dim=1)
               / want.flatten(1).norm(dim=1))
        err = torch.where(torch.isfinite(err), err,
                          torch.full_like(err, math.inf))
        worst = max(worst, float(err.max()))
    return {"worst_rel_l2": worst}


def judge(readings: dict, limits: dict) -> bool:
    """Correct when every number compared is finite and within its limit."""
    return all(math.isfinite(v) and v <= limits[k]["limit"]
               for k, v in readings.items())


# ---------------------------------------------------------------------------
# one run of one cell
# ---------------------------------------------------------------------------

def port_config(cfg: dict):
    """The program's ModelConfig of a configuration file: its registry
    entry with the file's sizes and precision (`num_kv_heads` where the
    file gives it, else `num_heads`; `patch_tokens` where it gives it),
    then the fields of the file's `port`, a family's own. A `port` key that
    is no field of ModelConfig raises."""
    from repro_torch.configs.registry import get_config

    base = get_config(cfg["arch"])
    port = cfg.get("port", {})
    unknown = set(port) - {f.name for f in dataclasses.fields(base)}
    if unknown:
        raise ValueError(f"{cfg['name']}: `port` names no field of the "
                         f"port's ModelConfig: {sorted(unknown)}")
    sized = dataclasses.replace(
        base, num_layers=cfg["num_layers"],
        d_model=cfg["d_model"], num_heads=cfg["num_heads"],
        num_kv_heads=cfg.get("num_kv_heads", cfg["num_heads"]),
        head_dim=cfg["head_dim"], d_ff=cfg["d_ff"],
        patch_tokens=cfg.get("patch_tokens", base.patch_tokens),
        latent_dim=cfg["latent_dim"], dtype=cfg["dtype"],
        param_dtype=cfg["param_dtype"])
    return dataclasses.replace(sized, **port)


def split_control(control: Optional[str]) -> tuple:
    """(tier, rounding) of a control run in the program's place: a port
    tier ("fp8a16": the program's own lower-precision path), or the
    benchmark's own rounding of the program's weights ("round:e4m3", a key
    of weights.ROUNDINGS). (None, None) for the program as configured."""
    if control is None:
        return None, None
    if control.startswith("round:"):
        return None, control.split(":", 1)[1]
    return control, None


def quant_mode(cfg: dict, override: Optional[str] = None) -> str:
    if override is not None:
        return override
    return cfg["quant"]["mode"] if cfg.get("quant") else "none"


def free_device() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reads it (None without it)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(man: dict, cell: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, control: Optional[str] = None,
             cfg_override: Optional[dict] = None,
             traffic_override: Optional[dict] = None) -> dict:
    """Set up the cell, measure one window, compare, read the metrics.
    Returns the result dict (`correct`, `attempted`, `failed`, `metrics`,
    `device`, and with `trace` `breakdown`; `check` last). The control
    (`split_control`) and the overrides are for the calibration and the
    tests: a smaller configuration, a shorter traffic. The reference
    always computes from the exact weights."""
    import torch

    from . import weights

    from . import program

    w = workload(man, cell)
    cfg = cfg_override or load_json(HERE / "configs" / f"{w['config']}.json")
    traffic = traffic_override or load_json(
        HERE / "traffic" / f"{w['traffic']}.json")
    driver = driver_of(traffic)
    tracer = Tracer(trace)
    # set-up's parts, each timed apart, noted in the result
    parts, t = {}, time.perf_counter()

    def part(name: str) -> None:
        nonlocal t
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        parts[f"setup.{name}_s"] = now - t
        t = now

    parts["setup.before_cell_s"] = t - t_start
    program.import_port()
    part("port_import")
    tier, rounding = split_control(control)
    params = weights.make_params(cfg, seed, device)
    if rounding is not None:
        weights.rounded(params, rounding)
    part("weights")
    state = driver.setup(cfg, traffic, seed, device, params,
                         quant_mode(cfg, tier), tracer, part)
    del params
    part("rest")
    tracer.start()
    setup_s = time.perf_counter() - t_start
    run = driver.window(state, seconds, tracer)
    run.setup_s = setup_s
    run.notes.update(parts)
    run.trace = tracer.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    samples = driver.samples(state, run, seed)
    attempted, failed = driver.counts(state, run)
    driver.release(state)
    del state
    free_device()
    t_check = time.perf_counter()
    readings = compare(cfg, traffic, seed, samples, device)
    run.notes["check_s"] = time.perf_counter() - t_check
    run.notes["check_samples"] = len(samples)
    limits = load_json(LIMITS / f"{cell}.json")
    correct = judge(readings, limits) and failed == 0
    metrics = {}
    for m in metrics_of(man, cell, trace):
        value = reader_of(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(w["chips"]),
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    if trace and device.type == "cuda":
        dev["power"] = power_limit()
    out["notes"] = run.notes
    out["check"] = {k: {"value": v, "limit": limits[k]["limit"]}
                    for k, v in readings.items()}
    if failed:
        out["check"]["requests_failed"] = {"value": failed, "limit": 0}
    return out
