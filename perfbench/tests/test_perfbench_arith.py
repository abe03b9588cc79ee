"""The benchmark's arithmetic on synthetic inputs: interval unions and idle
shares, percentiles over all requests, the yardstick's work from shapes,
the metric readers, and the open-loop generator."""

import json
import math
import statistics

import numpy as np
import pytest

from perfbench import arrivals, harness, yardstick
from perfbench.tests import tiny

I256 = harness.load_json(harness.HERE / "configs" / "dit-i256.json")


def test_union_gaps_and_covered():
    spans = [(0, 10), (5, 15), (20, 30), (30, 31), (40, 45)]
    assert harness.union(spans) == [(0, 15), (20, 31), (40, 45)]
    assert harness.covered(spans) == 15 + 11 + 5
    assert harness.gaps(spans, -5, 50) == [(-5, 0), (15, 20), (31, 40),
                                           (45, 50)]
    assert harness.clip(spans, 8, 22) == [(8, 10), (8, 15), (20, 22)]


def trace():
    device = [("nvjet_tst_192x192", 100, 400), ("void attn_mma_kernel<9>",
                                                 400, 500),
              ("void modulate_kernel<bf16>", 600, 650),
              ("void gate_kernel<bf16>", 650, 700),
              ("Memset (Unknown)", 700, 710), ("early", 0, 120)]
    host = [("bench.window", 50, 1050), ("bench.replay", 60, 90),
            ("bench.wait", 500, 600), ("bench.readback", 710, 1000)]
    return harness.Trace.of(device, host)


def test_trace_busy_idle_and_breakdown():
    t = trace()
    assert t.window_s == pytest.approx(1000e-9)
    # (50, 400) + (400, 500) + (600, 710), the early op clipped to 50
    assert t.busy_s == pytest.approx((350 + 100 + 110) * 1e-9)
    assert t.seconds_matching(["attn_(?!bwd)"]) == pytest.approx(100e-9)
    assert t.seconds_matching(["modulate_kernel", "gate_kernel"]) == \
        pytest.approx(100e-9)
    assert t.seconds_matching(["qmm_"]) is None
    b = t.breakdown()
    assert b["device_ops"][0] == ["nvjet_tst_192x192", pytest.approx(
        300e-9)]
    gaps = dict((k.split(" ")[0], v) for k, v in b["idle_gaps"])
    assert gaps == {"bench.wait": pytest.approx(100e-9),
                    "bench.readback": pytest.approx(340e-9)}


def test_quantile_matches_numpy():
    rng = np.random.default_rng(0)
    v = rng.exponential(size=101).tolist()
    for q in (0.0, 0.5, 0.95, 1.0):
        assert harness.quantile(v, q) == pytest.approx(np.quantile(v, q))


def requests_run(dones):
    reqs = [{"due": float(i), "submit": float(i), "admit": float(i) + 0.1,
             "done": d, "close": 100.0} for i, d in enumerate(dones)]
    return harness.Run(cfg=I256, traffic={"solver": {"nfe": 10}},
                       window_s=100.0, requests=reqs, drain_limit_s=60.0)


def test_p95_counts_every_request_and_misses():
    dones = [i + 0.5 for i in range(19)] + [None]
    run = requests_run(dones)
    lat = harness.latencies_s(run)
    assert lat[:19] == [0.5] * 19
    assert lat[19] == pytest.approx(100.0 + 60.0 - 19.0)
    p95 = harness.reader_of("latency_p95_ms").read(run)
    assert p95 == pytest.approx(harness.quantile(lat, 0.95) * 1e3)
    assert p95 > 0.5e3                 # the miss moves the tail
    assert harness.reader_of("serve.latency_p50_ms").read(run) == \
        pytest.approx(500.0)
    assert harness.reader_of("serve.queue_wait_ms_p95").read(run) == \
        pytest.approx(100.0)


def brute_dense_flops(cfg, rows):
    d, f, L = cfg["d_model"], cfg["d_ff"], cfg["num_layers"]
    T, C = cfg["patch_tokens"], cfg["latent_dim"]
    per_row = (2 * T * C * d + 2 * 256 * d + 2 * d * d
               + L * (2 * d * 6 * d + 4 * 2 * T * d * d + 2 * 2 * T * d * f)
               + 2 * d * 2 * d + 2 * T * d * C)
    return per_row * rows


def test_dense_sites_count_every_product():
    rows = 64
    flops = sum(2.0 * m * rows * k * n
                for _, m, k, n, _, _ in yardstick.dense_sites(I256))
    assert flops == brute_dense_flops(I256, rows)


def test_bounds_by_hand():
    cfg = dict(I256)
    # one eval of one row: bf16 products at 989 TFLOP/s unless bytes bound
    b = yardstick.dense_bound_s(cfg, 64, 1)
    assert b >= brute_dense_flops(cfg, 64) / 989e12 * 0.999
    S, H, D, L = 256, 16, 72, 28
    att = max(4 * S * S * D * H / 989e12, 4 * S * H * D * 2 / 3.35e12) * L
    assert yardstick.attention_bound_s(cfg, 1, 1) == pytest.approx(att)
    T, d = 256, 1152
    ada = ((2 * L + 1) * (2 * T * d + 2 * d) + 2 * L * (3 * T * d + d)) * 2
    assert yardstick.adaln_bound_s(cfg, 1, 1) == pytest.approx(ada / 3.35e12)
    q = harness.load_json(harness.HERE / "configs" / "dit-i256-w8a16.json")
    assert yardstick.dense_bound_s(q, 1, 1) < yardstick.dense_bound_s(
        cfg, 1, 1)


def test_model_flops_is_the_programs_formula():
    from repro_torch.analysis import roofline
    from repro_torch.configs.registry import get_config

    ours = yardstick.model_flops_sample(I256, 10, 64)
    theirs = roofline.model_flops_sample(get_config("dit-i256"), 10, 64)
    assert ours == pytest.approx(theirs)


def test_readers_on_a_synthetic_run():
    run = harness.Run(cfg=I256, traffic={"solver": {"nfe": 10}},
                      window_s=2.0, images=64, calls=22, rows_per_call=64,
                      trace=trace())
    assert harness.reader_of("images_per_s").read(run) == 32.0
    mfu = harness.reader_of("mfu.sample").read(run)
    assert mfu == pytest.approx(100 * yardstick.model_flops_sample(
        I256, 10, 128) / 2.0 / 989e12)
    att = harness.reader_of("sample.attention_roofline").read(run)
    assert att == pytest.approx(
        100 * yardstick.attention_bound_s(I256, 64, 22) / 100e-9)
    idle = harness.reader_of("idle_share.sample").read(run)
    assert idle == pytest.approx(100 * (1 - 560 / 1000))
    run.trace = None
    for name in ("sample.dense_roofline", "idle_share.sample"):
        assert harness.reader_of(name).read(run) is None


def test_roofline_bound_by_name(monkeypatch, tmp_path):
    assert harness.bound_of("dense_bound_s") is yardstick.dense_bound_s
    tiny.hybrid(monkeypatch, tmp_path)
    spec = tmp_path / "ssm.proj_roofline.json"
    spec.write_text(json.dumps({"kernels": ["nvjet"],
                                "bound": "hybrid:ssm_proj_bound_s"}))
    bound = harness.bound_of("hybrid:ssm_proj_bound_s")
    assert bound.__module__ == "perfbench.tests.fixtures.bounds.hybrid"
    run = harness.Run(cfg=tiny.HYBRID, traffic={"solver": {"nfe": 10}},
                      window_s=2.0, images=4, calls=10, rows_per_call=4,
                      trace=trace())
    assert harness.roofline_share(run, spec) == pytest.approx(
        100 * bound(tiny.HYBRID, 4, 10) / 300e-9)
    with pytest.raises(ModuleNotFoundError):
        harness.bound_of("nonesuch:bound_s")


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 99, 2 ** 33 + 1])
def test_due_times_are_an_open_loop_at_the_rate(seed):
    spec = {"kind": "poisson", "rate_per_s": 64.0}
    due = arrivals.due_times(spec, seed, 50.0)
    assert np.all(np.diff(due) >= 0) and due[0] >= 0 and due[-1] < 50.0
    assert len(due) == 64 * 50
    other = arrivals.due_times(spec, seed + 1, 50.0)
    assert len(other) == len(due)
    assert not np.array_equal(due[:20], other[:20])
    assert np.array_equal(due, arrivals.due_times(spec, seed, 50.0))


def test_every_seed_offers_the_same_gaps():
    spec = {"kind": "poisson", "rate_per_s": 10.0}
    a, b = (np.diff(np.concatenate([[0.0], arrivals.due_times(
        spec, seed, 30.0), [30.0]])) for seed in (1, 2))
    assert np.allclose(np.sort(a), np.sort(b))
    # the gaps of a Poisson process: exponential, mean 1 / rate
    assert a.mean() == pytest.approx(0.1, rel=0.05)
    assert np.median(a) == pytest.approx(0.1 * math.log(2), rel=0.1)


def test_spread_is_the_contracts():
    # the interquartile distance over the median, as statistics gives it
    v = [100.0, 101.0, 99.0, 100.5, 100.2, 99.7]
    q = statistics.quantiles(v, n=4)
    assert (q[2] - q[0]) / statistics.median(v) < 0.02


def test_tiny_cell_is_what_the_cell_runs():
    man, cfg, traffic = tiny.cell("dit-i256.batch32")
    assert cfg["dtype"] == "bfloat16" and traffic["driver"] == "batch"
