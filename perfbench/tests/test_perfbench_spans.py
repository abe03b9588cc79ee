"""`spans.py` on hand-built traces with known answers: host-bound gaps
(a gap inside a graph is not, a gap closed by a late launch is), idle gaps
labelled by the innermost program span, the counters' readings, None where
the inputs are absent; and one tiny window of a batch and a serving cell on
the CPU, read through the real drivers."""

import dataclasses

import pytest
import torch

from perfbench import harness, spans
from perfbench.tests import tiny


def records():
    """A window (0, 1000) of three device ops: two of one CUDA graph
    (correlation 7, launched at 50) with a gap between them, and one a late
    cudaLaunchKernel (correlation 9, called at 350) closes; the program's
    tick around the second gap."""
    cpu, dev = False, True
    return [
        ("bench.window", cpu, 0, 1000, 0),
        ("bench.window", dev, 100, 450, 0),
        ("bench.tick", cpu, 40, 500, 0),
        ("serve.tick", cpu, 45, 495, 0),
        ("serve.dispatch", cpu, 48, 70, 0),
        ("engine.launch", cpu, 49, 65, 0),
        ("serve.admission", cpu, 330, 370, 0),
        ("cudaGraphLaunch", cpu, 50, 60, 7),
        ("cudaLaunchKernel", cpu, 350, 360, 9),
        ("cudaEventSynchronize", cpu, 600, 700, 11),
        ("aten::copy_", cpu, 340, 365, 0),
        ("nvjet_tst_192x192", dev, 100, 200, 7),
        ("attn_mma_kernel<9>", dev, 210, 300, 7),
        ("gate_kernel", dev, 400, 450, 9),
    ]


def test_reduce_keeps_the_harness_lists_and_adds_the_program_and_calls():
    st = spans.reduce_events(records())
    want = harness.Trace.of(
        [(n, s, e) for n, d, s, e, _ in records()
         if d and not n.startswith("bench.")],
        [(n, s, e) for n, d, s, e, _ in records()
         if n.startswith("bench.") and not d])
    assert st.trace == want
    assert [n for n, _, _ in st.spans] == [
        "serve.tick", "serve.dispatch", "engine.launch", "serve.admission"]
    assert [(n, c) for n, _, _, c in st.calls] == [
        ("cudaGraphLaunch", 7), ("cudaLaunchKernel", 9),
        ("cudaEventSynchronize", 11)]
    assert st.ops == [(100, 200, 7), (210, 300, 7), (400, 450, 9)]


def test_a_gap_inside_a_graph_is_not_host_bound_a_late_launch_is():
    st = spans.reduce_events(records())
    share, bound, matched = spans.host_bound(st)
    # (0, 100) closes on the graph, launched at 50: host-bound; (200,
    # 210) on the graph's next kernel, launched with it at 50: not; (300,
    # 400) on a kernel called at 350: host-bound; (450, 1000) on nothing
    assert bound == pytest.approx((100 + 100) / 1e9)
    assert matched == 1.0 and share == pytest.approx(100.0 * 200 / 1000)


def test_host_bound_is_none_below_the_matched_share_or_without_ops():
    st = spans.reduce_events(records())
    unmatched = dataclasses.replace(
        st, calls=[c for c in st.calls if c[3] != 9])
    share, _, matched = spans.host_bound(unmatched)
    assert share is None and matched == pytest.approx(190 / 240)
    assert spans.host_bound(dataclasses.replace(st, ops=[])) == (None, 0.0,
                                                                 0.0)


def test_idle_gaps_take_the_innermost_program_span():
    st = spans.reduce_events(records())
    gaps = spans.idle_gaps(st)
    assert set(gaps) == {"bench.tick/engine.launch", "bench.tick/serve.tick",
                         "bench.tick/serve.admission", "bench.window"}
    assert gaps["bench.tick/serve.admission"][:2] == [1, pytest.approx(
        100e-9)]
    # every old line is the sum of its new ones
    old = {}
    for label, (n, tot, _) in gaps.items():
        key = label.split("/")[0]
        old[key] = old.get(key, 0.0) + tot
    for label, tot in st.trace.breakdown()["idle_gaps"]:
        assert old[label.split(" ")[0]] == pytest.approx(tot)


def test_one_clock_counts_calls_inside_their_spans():
    st = spans.reduce_events(records())
    checks = spans.one_clock(st)
    assert checks["cudaGraphLaunch in engine.launch"] == [1, 1]
    assert checks["cudaGraphLaunch in serve.dispatch"] == [1, 1]
    assert checks["cudaEventSynchronize in serve.readback"] == [0, 1]
    assert checks["program ranges on the device timeline"] == [0, 3]


def test_counter_readings_and_their_absence():
    edges = [{"perf_ns": 0, "ticks": 10, "active_slot_ticks": 100},
             {"perf_ns": 10**9, "ticks": 30, "active_slot_ticks": 580}]
    assert spans.idle_slot_share(edges, 32) == pytest.approx(25.0)
    assert spans.idle_slot_share(edges[:1], 32) is None
    assert spans.idle_slot_share([{"perf_ns": 0}] * 2, 32) is None
    ev = [{"perf_ns": 0, "evals": 22, "shallow_evals": 0},
          {"perf_ns": 1, "evals": 22 + 11 * 7, "shallow_evals": 0}]
    assert spans.evals_per_trajectory(ev, 7) == 11.0
    assert spans.evals_per_trajectory(ev, 0) is None
    assert spans.evals_per_trajectory([{"perf_ns": 0}] * 2, 7) is None

    @dataclasses.dataclass
    class C:
        admit_ns: object
        emit_ns: object

    done = [C(0, 400e6), C(100e6, 500e6), C(None, None), C(0, 2e9)]
    window = [{"perf_ns": 0}, {"perf_ns": 10**9}]
    assert spans.service_ms_p95(done, window, 0) == pytest.approx(400.0)
    assert spans.service_ms_p95(done, window, 3) is None
    assert spans.service_ms_p95(done[2:3], window, 0) is None


@pytest.mark.parametrize("name", ["dit-i256.batch32", "dit-i256.serve32"])
def test_tiny_window_reads_the_program(name):
    man, cfg, traffic = tiny.cell(name)
    out = spans.read_window(man, name, 2 ** 31 + 4242, 1.0,
                            torch.device("cpu"), cfg_override=cfg,
                            traffic_override=traffic)
    r = out["readings"]
    if name.endswith("serve32"):
        assert 0.0 <= r["serve.idle_slot_share"] < 100.0
        assert r["serve.service_ms_p95"] > 0 and out["ring_dropped"] == 0
        assert out["counts"]["ticks"] > 0
        assert all(k.startswith("bench.") for k in out["idle_gaps"])
    else:
        # a replay runs the sampler's nfe evals (the last row's is
        # elided); the driver's `calls` still count nfe + 1
        nfe = traffic["solver"]["nfe"]
        assert r["sample.evals_per_trajectory"] == float(nfe) == 10.0
        assert out["calls_per_replay"] == nfe + 1
        assert out["counts"]["evals"] > 0
