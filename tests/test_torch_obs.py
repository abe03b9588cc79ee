"""The port's serving observability against the JAX reference's
(`tests/test_obs.py` mirrored): the tracer, the metrics artifact and its
report, the quality probe and its reference runner, the scheduler's tracer
and probe call sites, `launch.serve`'s observability flags and
`launch.obsreport`.

* host-only pieces bit-equal: the same scripted `Tracer` calls export the
  same JSON, `validate_trace` / `validate_metrics` report the same
  violations, `write_metrics_artifact` writes the same JSON and
  `render_report` renders the same text, `probe_selected` picks the same
  rids;
* serving with observability: `serve_diffusion` of both packages on a
  reduced dit-cifar (fp32, perturbed params, cfg 2.0, per-request classes,
  the same x_T through a patched `_draw`), traced, with metrics and the
  probe: completion order equal, latents within 1e-5 relative L-inf, the
  deterministic metrics slice equal, the trace's request events equal
  as (name, ph, id), the same probed rids with discrepancies within 1e-5
  relative, and `obsreport --check` passing on the port's artifact;
* tracing and probing change nothing: traced against untraced latents
  bit-equal at depths 1 and 2, and so are runs under a recording
  `torch.profiler`; a traced completion's service stamps are its trace
  events' stamps;
* the profiler's sink: a tick's phases are `serve.*` ranges on the
  profiler's timeline, nested as the ring's spans and in their order, and
  `live` is a shared no-op without a profiler;
* `SamplerEngine.build`'s run counts its evals, eager here and graphed on
  the card, where `graph_run`'s ranges land on the profiler's timeline;
* `build_reference_fn`'s x_ref within 1e-5 of the reference's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.configs.registry import get_config as j_get_config
from repro.diffusion import VPLinear as JVP
from repro.engine import EngineSpec as JSpec
from repro.launch import obsreport as j_obsreport
from repro.launch import serve as j_serve
from repro.launch.sample import build_engine as j_build_engine
from repro.models import api as j_api
from repro.obs import probe as j_probe
from repro.obs import report as j_report
from repro.obs import trace as j_trace
from repro.serving import scheduler as j_sched
from repro_torch import serving as tsv
from repro_torch.configs import get_config as t_get_config
from repro_torch.diffusion import VPLinear as TVP
from repro_torch.engine import EngineSpec as TSpec
from repro_torch.launch import obsreport as t_obsreport
from repro_torch.launch import serve as t_serve
from repro_torch.launch.sample import NULL_CLASS_ID
from repro_torch.launch.sample import build_engine as t_build_engine
from repro_torch.models import api as t_api
from repro_torch.obs import (MetricsRegistry, QualityProbe, Tracer, delta,
                             span_stats, validate_trace)
from repro_torch.obs import metrics as t_obsm
from repro_torch.obs import probe as t_probe
from repro_torch.obs import report as t_report
from repro_torch.obs import trace as t_trace
from repro_torch.serving import scheduler as t_sched
from test_torch_serving import (D, _feed, _x_T, perturbed_tree,
                                t_engine)

torch.set_num_threads(2)

TOL = 1e-5                      # fp32 serving parity (tests/test_serving.py)


# ---------------------------------------------------------------------------
# host-only parity: tracer, validators, artifact, report, probe selection
# ---------------------------------------------------------------------------


def _script(tr):
    """Fixed-timestamp calls covering every record kind."""
    tr._t0 = 1_000
    tr.complete("tick", 2_000, 7_500, args={"tick": 1, "busy": 2})
    tr.complete("admission", 2_000, 2_300)
    tr.instant("note", args={"k": 1}, ts_ns=3_000)
    tr.counter("slots", {"busy": 2, "queue": 1}, ts_ns=2_000)
    tr.async_begin("request", 7, args={"tier": "fast", "arrival": 0.5},
                   ts_ns=1_500)
    tr.async_instant("admit", 7, args={"slot": 0}, ts_ns=2_100)
    tr.instant("reject", cat="request", args={"rid": 9}, ts_ns=2_200)
    tr.async_end("request", 7, args={"evals": 4}, ts_ns=9_000)
    tr.complete("readback", 8_000, 7_900)       # clamped to dur 0
    return tr


@pytest.mark.parametrize("capacity", [3, 64])
def test_tracer_exports_the_references_json(capacity, tmp_path):
    """The same scripted calls export identical trace JSON (the ring's drop
    of the oldest events included), and both validators agree."""
    meta = {"arch": "test", "slots": 2}
    t = _script(t_trace.Tracer(capacity=capacity, meta=meta))
    j = _script(j_trace.Tracer(capacity=capacity, meta=meta))
    assert json.dumps(t.to_json()) == json.dumps(j.to_json())
    assert t.dropped == j.dropped == max(9 - capacity, 0)
    obj = t.export(str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == obj
    assert t_trace.validate_trace(obj) == j_trace.validate_trace(obj) == []
    assert t_trace.TRACE_SCHEMA == j_trace.TRACE_SCHEMA


_OD = {"schema": "repro.obs.trace/v1", "dropped_events": 0}
BAD_TRACES = [
    [],
    {"traceEvents": "x"},
    {"traceEvents": [{"ph": "X", "name": "t", "ts": 0}], "otherData": _OD},
    {"traceEvents": [{"ph": "X", "name": "t", "ts": 0, "dur": -1}],
     "otherData": _OD},
    {"traceEvents": [{"ph": "Q", "name": "t", "ts": 0}, 3,
                     {"ph": "i", "ts": "x"}], "otherData": _OD},
    {"traceEvents": [{"ph": "b", "name": "request", "ts": 0, "id": 1,
                      "cat": "request"},
                     {"ph": "e", "name": "request", "ts": 1, "id": 2,
                      "cat": "request"},
                     {"ph": "n", "name": "admit", "ts": 1}],
     "otherData": _OD},
    {"traceEvents": [{"ph": "b", "name": "request", "ts": 0, "id": 1,
                      "cat": "request"}],
     "otherData": {**_OD, "dropped_events": 3}},
]


@pytest.mark.parametrize("obj", BAD_TRACES, ids=range(len(BAD_TRACES)))
def test_validate_trace_reports_the_references_violations(obj):
    got = t_trace.validate_trace(obj)
    assert got == j_trace.validate_trace(obj)
    assert got == [] if obj is BAD_TRACES[-1] else got != []


def _artifact_inputs():
    reg = MetricsRegistry()
    s0 = reg.snapshot()
    _feed(reg)
    reg.counter("probe_requests", {"tier": "fast"}).inc(2)
    return dict(metrics=delta(s0, reg.snapshot()),
                serve_metrics={"mode": "continuous", "slots": 3,
                               "pipeline_depth": 2, "n_rows": 6,
                               "requests": 6, "completed": 5, "ticks": 5,
                               "evals": 5, "occupancy": 0.8,
                               "evals_per_latent": 3.0, "tick_s": 0.01,
                               "host_phase_us_per_tick": {
                                   "admission": 10.0, "dispatch": 20.0,
                                   "readback": 30.0, "bookkeeping": 5.0},
                               "host_us_per_tick": 15.0, "rejected": 1,
                               "expired": 1,
                               "per_tier": {"fast": {
                                   "completed": 5, "evals": 6,
                                   "eval_cost": 6.0,
                                   "latency_ticks_p50": 4.0}}},
                static={"mode": "continuous", "slots": 3, "n_rows": 6,
                        "pipeline_depth": 2},
                exposition=reg.exposition(),
                rows=[{"tick": 3, "metrics": {}}],
                probe={"fast": {"count": 2, "mean": 1e-3, "max": 2e-3}})


def test_metrics_artifact_and_report_match_the_reference(tmp_path):
    """`write_metrics_artifact` writes the same JSON and `render_report`
    renders the same text (metrics and a trace) in both packages; both
    validators accept the artifact."""
    kw = _artifact_inputs()
    tp, jp = tmp_path / "t.json", tmp_path / "j.json"
    t_obj = t_report.write_metrics_artifact(str(tp), **kw)
    j_obj = j_report.write_metrics_artifact(str(jp), **kw)
    assert tp.read_text() == jp.read_text()
    assert t_obj == j_obj
    assert t_obsm.validate_metrics(t_obj) == []
    trace = _script(t_trace.Tracer(capacity=64)).to_json()
    text = t_report.render_report(trace=trace, metrics=t_obj)
    assert text == j_report.render_report(trace=trace, metrics=j_obj)
    assert "resilience ledger" in text and "quality probe" in text
    assert t_report.span_stats(trace) == j_report.span_stats(trace)
    assert (t_report.render_report() == j_report.render_report()
            == "(no artifacts given)")


BAD_METRICS = [
    [],
    {"schema": "repro.obs.metrics/v1", "run": {"metrics": {}}},
    {"schema": "repro.obs.metrics/v1",
     "run": {"metrics": {"h": {"type": "histogram", "buckets": [1.0],
                               "counts": [1], "count": 2, "sum": 0.5}}},
     "serve_metrics": {}, "exposition": "", "rows": []},
    {"schema": "other", "run": {"metrics": {"c": {"type": "nope"}}},
     "serve_metrics": {}, "exposition": ""},
]


@pytest.mark.parametrize("obj", BAD_METRICS, ids=range(len(BAD_METRICS)))
def test_validate_metrics_reports_the_references_violations(obj):
    from repro.obs import metrics as j_obsm

    got = t_obsm.validate_metrics(obj)
    assert got == j_obsm.validate_metrics(obj) and got != []


@pytest.mark.parametrize("fraction,salt", [(0.0, 0), (0.1, 0), (0.25, 3),
                                           (0.5, 7), (0.9, 1), (1.0, 0)])
def test_probe_selected_matches_the_reference(fraction, salt):
    rids = range(10000)
    got = [t_probe.probe_selected(r, fraction, salt) for r in rids]
    assert got == [j_probe.probe_selected(r, fraction, salt) for r in rids]
    assert abs(np.mean(got) - fraction) < 0.02


def test_quality_probe_rejects_a_bad_fraction_and_honours_max_probes():
    calls = []

    def reference_fn(x_T, g=None, extras=None):
        calls.append(1)
        return np.asarray(x_T)

    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        QualityProbe(reference_fn, fraction=1.5)
    program = t_engine().build_step(TSpec(nfe=3, order=2))
    probe = QualityProbe(reference_fn, fraction=1.0, max_probes=2)
    sched = tsv.SlotScheduler(program, 2, (D,), probe=probe)
    tsv.run_trace(sched, [tsv.Request(rid=i, arrival=float(i), x_T=_x_T(i))
                          for i in range(5)])
    assert len(calls) == 2 and len(probe.results) == 2
    assert probe.registry is sched.registry
    assert sched.registry.snapshot()[
        'probe_requests{tier="default"}']["value"] == 2
    # unselected rids never touch the reference runner
    probe0 = QualityProbe(reference_fn, fraction=0.0)
    sched0 = tsv.SlotScheduler(program, 2, (D,), probe=probe0)
    tsv.run_trace(sched0, [tsv.Request(rid=i, x_T=_x_T(i))
                           for i in range(3)])
    assert len(calls) == 2 and probe0.results == []


# ---------------------------------------------------------------------------
# the scheduler's tracer and probe on the analytic model
# ---------------------------------------------------------------------------


def _reqs(n=7):
    rng = np.random.default_rng(5)
    arrivals = np.cumsum(rng.exponential(2.0, n)) - 2.0
    return [tsv.Request(rid=i, arrival=float(max(a, 0.0)), x_T=_x_T(i))
            for i, a in enumerate(arrivals)]


def _profiled(fn):
    """fn() under a recording CPU profiler: (its result, kineto's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


@pytest.mark.parametrize("depth", [1, 2])
def test_tracer_and_probe_change_nothing_on_the_scheduler(depth):
    """Tracing, probing and a recording profiler are observation only:
    latents, completion records and the deterministic metrics slice (bar
    the probe's own series) EQUAL to the untraced run; the trace
    validates, with a tick span per executed tick and one balanced span
    per request; a traced completion's service stamps are its "admit" and
    "e" events' stamps, an untraced one has none."""
    program = t_engine().build_step(TSpec(nfe=4, order=3))

    def run(**kw):
        sched = tsv.SlotScheduler(program, 3, (D,), pipeline_depth=depth,
                                  **kw)
        return sched, tsv.run_trace(sched, _reqs())

    plain, m0 = run()
    tr = Tracer()
    probe = QualityProbe(lambda x, g=None, extras=None: np.asarray(x),
                         fraction=0.5)
    traced, m1 = run(tracer=tr, probe=probe)
    (profiled, m2), _ = _profiled(run)
    for other in (traced, profiled):
        assert ([(c.rid, c.admit_tick, c.finish_tick)
                 for c in plain.completions]
                == [(c.rid, c.admit_tick, c.finish_tick)
                    for c in other.completions])
        for a, b in zip(plain.completions, other.completions):
            np.testing.assert_array_equal(a.latent, b.latent)
    assert m2.ticks == m0.ticks
    assert plain.registry.snapshot(deterministic_only=True) == \
        profiled.registry.snapshot(deterministic_only=True)
    det = traced.registry.snapshot(deterministic_only=True)
    assert plain.registry.snapshot(deterministic_only=True) == {
        k: v for k, v in det.items() if not k.startswith("probe_")}
    assert all(c.admit_ns is None and c.emit_ns is None
               for c in plain.completions + profiled.completions)
    ring = tr.to_json()["traceEvents"]
    for c in traced.completions:
        admit = [e["ts"] for e in ring if e["name"] == "admit"
                 and e["id"] == c.rid]
        end = [e["ts"] for e in ring if e["ph"] == "e" and e["id"] == c.rid]
        assert c.admit_ns < c.emit_ns
        assert tr._us(c.admit_ns) == admit[-1] and tr._us(c.emit_ns) == end[0]
    assert probe.results and traced._probe_ns > 0
    obj = json.loads(json.dumps(tr.to_json()))
    assert validate_trace(obj) == []
    stats = span_stats(obj)
    assert stats["tick"]["count"] == m1.ticks == m0.ticks
    assert {"admission", "dispatch", "readback", "emit"} <= set(stats)
    begins = sum(1 for e in obj["traceEvents"] if e["ph"] == "b")
    ends = sum(1 for e in obj["traceEvents"] if e["ph"] == "e")
    probes = [e for e in obj["traceEvents"] if e["name"] == "probe"]
    assert begins == ends == 7 and len(probes) == len(probe.results)


@pytest.mark.parametrize("depth", [1, 2])
def test_profiler_gets_the_ticks_phases_nested_as_the_ring(depth):
    """Under a recording profiler a traced scheduler lays one `serve.tick`
    range per executed tick on the profiler's timeline, each admission and
    dispatch inside one, and its `serve.*` ranges are the ring's spans
    renamed, in the same order; with no profiler `live` hands back one
    shared no-op context."""
    program = t_engine().build_step(TSpec(nfe=4, order=3))
    tr = Tracer()
    sched = tsv.SlotScheduler(program, 3, (D,), pipeline_depth=depth,
                              tracer=tr)
    assert not t_trace.profiling()
    assert t_trace.live("serve.tick") is t_trace.live("engine.launch")
    (m, inside), events = _profiled(
        lambda: (tsv.run_trace(sched, _reqs()),
                 (t_trace.profiling(), t_trace.live("serve.tick"))))
    assert inside[0] and inside[1] is not t_trace.live("serve.tick")
    spans = sorted((e.start_ns(), -e.end_ns(), e.name()) for e in events
                   if e.name().startswith("serve."))
    ticks = [(s, -ne) for s, ne, n in spans if n == "serve.tick"]
    assert len(ticks) == m.ticks == sched.ticks > 0
    for s, ne, n in spans:
        if n in ("serve.admission", "serve.dispatch"):
            assert sum(a <= s and -ne <= b for a, b in ticks) == 1, n
    ring = sorted((e["ts"], -e["dur"], e["name"])
                  for e in tr.to_json()["traceEvents"] if e["ph"] == "X")
    assert [n for _, _, n in spans] == [f"serve.{n}" for _, _, n in ring]
    assert {"serve.readback", "serve.emit"} <= {n for _, _, n in spans}


def test_tracer_records_resilience_events_as_the_reference():
    """A NaN retry, a queue-full shed and a desync recovery: the port's
    trace carries the reference's event names on the same request ids."""
    from repro.serving import FaultPlan as JFP, MetaFault as JMF
    from repro.serving import NanFault as JNF, ResilienceConfig as JRC
    from test_torch_serving import j_engine, serve_both

    def sched_kw(pkg):
        j = pkg is not tsv
        FP, NF, MF, RC = ((JFP, JNF, JMF, JRC) if j else
                          (tsv.FaultPlan, tsv.NanFault, tsv.MetaFault,
                           tsv.ResilienceConfig))
        return {"tracer": (j_trace if j else t_trace).Tracer(),
                "resilience": RC(max_retries=1, max_queue=3),
                "faults": FP(nans=(NF(rid=1, step=1),),
                             metas=(MF(tick=9),))}

    def make(pkg):
        return [pkg.Request(rid=i, arrival=float(i // 3), x_T=_x_T(i))
                for i in range(8)]

    (js, _), (ts, _) = serve_both(j_engine().build_step(JSpec(nfe=3)),
                                  t_engine().build_step(TSpec(nfe=3)),
                                  make, slots=2, sched_kw=sched_kw)

    def events(s):
        return [(e["name"], e["ph"], e.get("id"))
                for e in s.tracer.to_json()["traceEvents"]
                if e["ph"] != "X" and e["ph"] != "C"]

    got = events(ts)
    assert got == events(js)
    names = {n for n, _, _ in got}
    assert {"retry", "fault_nan", "fault_meta", "desync_recover",
            "requeue", "reject"} <= names


# ---------------------------------------------------------------------------
# serve_diffusion with observability: the port against the reference
# ---------------------------------------------------------------------------

SERVE = dict(batch=2, nfe=3, order=2, cfg_scale=2.0, arrival_rate=0.7,
             requests=5, pipeline_depth=2)
PROBE = dict(probe_fraction=0.6, probe_ref_nfe=8)


def _x_for(seed, cfg):
    return np.random.default_rng(500 + seed).normal(
        size=(cfg.patch_tokens, cfg.latent_dim)).astype(np.float32)


@pytest.fixture(scope="module")
def dit():
    j_cfg = j_get_config("dit-cifar").reduced()
    t_cfg = t_get_config("dit-cifar").reduced()
    tree = perturbed_tree(j_cfg)
    return j_cfg, tree, t_cfg, t_api.params_from_numpy(tree, t_cfg, "cpu")


@pytest.fixture(scope="module")
def served(dit, tmp_path_factory):
    """Both packages' serve_diffusion on the same trace, params and x_T,
    traced, with the metrics artifact and the probe. The reference's call
    returns only its latents, so its scheduler is caught at construction."""
    j_cfg, tree, t_cfg, t_params = dit
    out = tmp_path_factory.mktemp("obs")
    mp = pytest.MonkeyPatch()
    draw = lambda self, req: _x_for(req.seed, t_cfg)  # noqa: E731
    mp.setattr(j_sched.SlotScheduler, "_draw", draw)
    mp.setattr(t_sched.SlotScheduler, "_draw", draw)
    mp.setattr(j_api, "init_params",
               lambda cfg, rng: jax.tree.map(jnp.asarray, tree))
    caught = []
    init = j_sched.SlotScheduler.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        caught.append(self)

    mp.setattr(j_sched.SlotScheduler, "__init__", spy)
    try:
        paths = {k: {p: str(out / f"{k}_{p}.json")
                     for p in ("trace", "metrics")} for k in "jt"}
        j_serve.serve_diffusion(
            "dit-cifar", trace_out=paths["j"]["trace"],
            metrics_out=paths["j"]["metrics"], metrics_every=3, **SERVE,
            **PROBE)
        run = t_serve.serve_diffusion(
            "dit-cifar", trace_out=paths["t"]["trace"],
            metrics_out=paths["t"]["metrics"], metrics_every=3,
            params=t_params, device="cpu", return_run=True, **SERVE, **PROBE)
    finally:
        mp.undo()
    return caught[-1], run, paths


def _close(a, b):
    """Equal, numbers within 1e-5 relative (the probe's discrepancies)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_close, a, b))
    if isinstance(a, float):
        return a == pytest.approx(b, rel=TOL)
    return a == b


def test_served_latents_and_order_match_the_reference(served):
    js, run, _ = served
    ts = run.sched
    assert ([(c.rid, c.admit_tick, c.finish_tick, c.evals)
             for c in ts.completions]
            == [(c.rid, c.admit_tick, c.finish_tick, c.evals)
                for c in js.completions])
    assert len(ts.completions) == SERVE["requests"]
    for a, b in zip(js.completions, ts.completions):
        want = np.asarray(a.latent, np.float64)
        err = np.abs(b.latent - want).max() / np.abs(want).max()
        assert err <= TOL, f"rid={a.rid}: {err:.3e}"


def test_served_metrics_slice_and_artifact_match_the_reference(served):
    """The deterministic registry slice equal (the probe's discrepancy
    series within 1e-5 relative), the artifacts' deterministic parts
    equal, and the port's artifact passes obsreport --check."""
    js, run, paths = served
    tdet = run.sched.registry.snapshot(deterministic_only=True)
    jdet = js.registry.snapshot(deterministic_only=True)
    assert set(tdet) == set(jdet)
    assert any(k.startswith("probe_discrepancy") for k in tdet)
    for k in tdet:
        if k.startswith("probe_discrepancy"):
            assert _close(tdet[k], jdet[k]), k
        else:
            assert tdet[k] == jdet[k], k
    tm = json.loads(open(paths["t"]["metrics"]).read())
    jm = json.loads(open(paths["j"]["metrics"]).read())
    assert len(tm["rows"]) == len(jm["rows"]) >= 1
    assert tm["run"]["static"] == jm["run"]["static"]
    assert set(tm["probe"]) == set(jm["probe"])
    for t in tm["probe"]:
        assert tm["probe"][t]["count"] == jm["probe"][t]["count"]
        assert tm["probe"][t]["mean"] == pytest.approx(
            jm["probe"][t]["mean"], rel=TOL)
    assert t_obsm.validate_metrics(tm) == []
    assert t_obsreport.check_metrics_roundtrip(tm) == []
    assert j_obsreport.check_metrics_roundtrip(tm) == []


def test_served_trace_request_events_match_the_reference(served):
    js, run, paths = served
    tt = json.loads(open(paths["t"]["trace"]).read())
    jt = json.loads(open(paths["j"]["trace"]).read())
    assert validate_trace(tt) == []

    def req_events(obj):
        return [(e["name"], e["ph"], e.get("id"))
                for e in obj["traceEvents"] if e.get("cat") == "request"]

    assert req_events(tt) == req_events(jt) != []
    assert (span_stats(tt)["tick"]["count"]
            == span_stats(jt)["tick"]["count"] == run.metrics.ticks)
    assert tt["otherData"]["arch"] == "dit-cifar"


def test_served_probe_matches_the_reference(served):
    js, run, _ = served
    tp, jp = run.probe, js.probe
    assert [r["rid"] for r in tp.results] == [r["rid"] for r in jp.results]
    assert 0 < len(tp.results) < SERVE["requests"]
    for a, b in zip(tp.results, jp.results):
        assert a["discrepancy"] > 0
        assert a["discrepancy"] == pytest.approx(b["discrepancy"], rel=TOL)
    assert run.probe.reference_fn.captures() == 0   # nothing to capture here


def test_obsreport_check_passes_on_the_port_artifact(served, capsys):
    _, _, paths = served
    t_obsreport.main(["--trace", paths["t"]["trace"],
                      "--metrics", paths["t"]["metrics"], "--check"])
    out = capsys.readouterr().out
    assert "check ok" in out and "where a tick goes" in out
    assert "quality probe" in out
    with pytest.raises(SystemExit):
        t_obsreport.main([])


def test_obsreport_check_names_a_drifted_artifact(served, tmp_path, capsys):
    _, _, paths = served
    obj = json.loads(open(paths["t"]["metrics"]).read())
    obj["serve_metrics"]["completed"] += 1
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(obj))
    with pytest.raises(SystemExit):
        t_obsreport.main(["--metrics", str(bad), "--check"])
    assert "CHECK FAIL: serve_metrics.completed" in capsys.readouterr().err


def test_reference_fn_matches_the_references(dit):
    """`build_reference_fn` on the port's engine against the reference's,
    guided, per-request scale and class: x_ref within 1e-5 relative, for a
    batch of 1 and of 2; one program serves every call."""
    j_cfg, tree, t_cfg, t_params = dit
    jeng = j_build_engine(j_cfg, jax.tree.map(jnp.asarray, tree), JVP(), 1,
                          0, want_cfg=True, per_request_cond=True)
    teng = t_build_engine(t_cfg, t_params, TVP(), 1, 0,
                          per_request_cond=True, device="cpu")
    spec_kw = dict(nfe=4, order=2, cfg_scale=2.0)
    jref = j_probe.build_reference_fn(jeng, JSpec(**spec_kw), ref_nfe=10)
    tref = t_probe.build_reference_fn(teng, TSpec(**spec_kw), ref_nfe=10)
    for x, g, ex in ((_x_for(1, t_cfg)[None], 1.5, {"class_ids": 7}),
                     (np.stack([_x_for(2, t_cfg), _x_for(3, t_cfg)]), None,
                      {"class_ids": np.array([3, NULL_CLASS_ID])}),
                     (_x_for(4, t_cfg)[None], 3.0, {"class_ids": 7})):
        want = np.asarray(jref(x, g=g, extras=ex), np.float64)
        got = tref(x, g=g, extras=ex)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= TOL, err
    assert tref.program.n_rows == 11


def test_serve_cli_takes_the_observability_flags(tmp_path, capsys):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    out = t_serve.main(["--arch", "dit-cifar", "--batch", "2", "--nfe", "2",
                        "--arrival-rate", "0.8", "--requests", "3",
                        "--trace-out", str(trace), "--metrics-out",
                        str(metrics), "--metrics-every", "2",
                        "--probe-fraction", "1.0", "--probe-ref-nfe", "4",
                        "--device", "cpu"])
    text = capsys.readouterr().out
    assert out.shape == (3, 64, 32)
    assert "trace:" in text and "metrics:" in text and "probe tier" in text
    obj = json.loads(metrics.read_text())
    assert obj["probe"]["default"]["count"] == 3
    assert validate_trace(json.loads(trace.read_text())) == []
    for bad in (["--probe-fraction", "1.5"], ["--probe-fraction", "-0.1"]):
        with pytest.raises(SystemExit):
            t_serve.main(["--arch", "dit-cifar", "--device", "cpu"] + bad)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        t_serve.serve_diffusion("dit-cifar", probe_fraction=2.0,
                                device="cpu")


@pytest.mark.parametrize("cfg", [False, True])
def test_build_counts_its_evals(cfg):
    """`SamplerEngine.build`'s run counts the table's rows but the last a
    call, every call (a guided row is one stacked eval; the last row, its
    corrector off, ends on its predictor), and nothing shallow without a
    reuse plan."""
    eng = t_engine(cfg=cfg)
    spec = TSpec(nfe=4, order=3, cfg_scale=2.0 if cfg else 0.0)
    run = eng.build(spec, jit=False)
    rows = eng.build_step(spec).n_rows
    assert (run.evals, run.shallow_evals) == (0, 0)
    x = torch.as_tensor(np.stack([_x_T(0), _x_T(1)]))
    outs = [run(x) for _ in range(3)]
    assert rows == 5 and run.evals == 3 * (rows - 1) and run.shallow_evals == 0
    assert run.elided_evals == 3
    np.testing.assert_array_equal(outs[0], eng.build(spec, jit=False)(x))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe's rows replay in a CUDA "
                    "graph")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_reference_fn_captures_once_and_syncs_only_to_read_back(cuda,
                                                                    dit):
    """On the card the probe's reference runner captures its step once for
    a batch signature, every later call replays it (another request's
    scale and class change no capture), and a call makes no host sync but
    the readback of x_ref: it runs clean under sync debug mode."""
    from repro_torch.engine.graphs import readback_sync

    _, tree, cfg, _ = dit       # perturbed: adaLN-zero would null eps
    params = t_api.params_from_numpy(tree, cfg, cuda)
    eng = t_build_engine(cfg, params, TVP(), 1, per_request_cond=True,
                         device=cuda)
    ref = t_probe.build_reference_fn(eng, TSpec(nfe=4, order=2,
                                                cfg_scale=2.0), ref_nfe=8)
    x = _x_for(1, cfg)[None]
    first = ref(x, g=1.5, extras={"class_ids": 3})
    assert ref.captures() == 1
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = ref(x, g=1.5, extras={"class_ids": 3})
        other = ref(x, g=3.0, extras={"class_ids": 8})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ref.captures() == 1
    np.testing.assert_array_equal(first, again)
    assert not np.array_equal(first, other) and np.isfinite(other).all()
    with readback_sync(cuda):
        assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.gpu
def test_card_graph_run_counts_its_evals_and_lays_its_ranges(cuda):
    """A graphed run counts its evals a call as the eager one does, and
    under a recording profiler each later call is an `engine.copy_in`, an
    `engine.launch` (the graph's one `cudaGraphLaunch` inside it) and an
    `engine.copy_out` on the profiler's timeline."""
    eng = t_engine(device=cuda)
    spec = TSpec(nfe=4, order=3)
    run = eng.build(spec)
    x = torch.as_tensor(np.stack([_x_T(0), _x_T(1)])).to(cuda)
    first = run(x)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = run(x)
        torch.cuda.synchronize()
    assert run.evals == 2 * (eng.build_step(spec).n_rows - 1)
    assert run.elided_evals == 2
    torch.testing.assert_close(first, again, rtol=0, atol=0)
    events = prof.profiler.kineto_results.events()
    names = [e.name() for e in sorted(events, key=lambda e: e.start_ns())
             if e.name().startswith("engine.")]
    assert names == ["engine.copy_in", "engine.launch", "engine.copy_out"]
    launch = [(e.start_ns(), e.end_ns()) for e in events
              if e.name() == "engine.launch"][0]
    calls = [e.start_ns() for e in events if e.name() == "cudaGraphLaunch"]
    assert len(calls) == 1 and launch[0] <= calls[0] <= launch[1]
