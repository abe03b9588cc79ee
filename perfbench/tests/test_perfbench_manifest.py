"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import math
import re

import pytest

from perfbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("d_model", "d_ff", "head_dim", "latent_dim", "hidden")


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    cells = 24
    budget = ((2 + 14 * cells) * (MAN["run_seconds"] + 60)
              + cells * 2 * 90 + 1200)
    assert budget <= 43200


def test_names_units_and_entries():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert c["file"].startswith("perfbench/")
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
            assert k not in WIDTHS
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        names += [w["name"], w["config"], w["traffic"]]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end"):
        got = [e["name"] for e in MAN[group]]
        assert len(got) == len(set(got))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in MAN["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    assert "workloads" not in setup[0]


def test_every_cell_reports_what_the_contract_asks():
    for w in MAN["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(MAN, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = harness.metrics_of(MAN, w["name"], True)
        assert per
        for m in per:
            assert m["moves"] in e2e


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_files_found_by_name(w):
    cfg = harness.load_json(harness.HERE / "configs" / f"{w['config']}.json")
    entry = harness.config_entry(MAN, w["config"])
    assert entry["file"] == f"perfbench/configs/{w['config']}.json"
    assert cfg["name"] == w["config"]
    assert (harness.HERE / "reference" / f"{cfg['reference']}.py").exists()
    assert callable(harness.module_of("reference", cfg["reference"]).sample)
    name = cfg.get("weights", "dit")
    assert name == "dit" or callable(
        harness.module_of("params", name).make_params)
    harness.port_config(cfg)        # raises on a `port` key of no field
    assert len(harness.sample_shape(cfg)) >= 1
    traffic = harness.load_json(
        harness.HERE / "traffic" / f"{w['traffic']}.json")
    assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").exists()
    limits = harness.load_json(harness.HERE / "limits" / f"{w['name']}.json")
    for k, v in limits.items():
        assert v["limit"] > 0 and math.isfinite(v["limit"])
    for m in (harness.metrics_of(MAN, w["name"], False)
              + harness.metrics_of(MAN, w["name"], True)):
        assert callable(harness.reader_of(m["name"]).read)
        roofline = harness.HERE / "metrics" / f"{m['name']}.json"
        if roofline.exists():
            assert callable(harness.bound_of(
                harness.load_json(roofline)["bound"]))


def test_config_widths_are_the_published_ones():
    i256 = harness.load_json(harness.HERE / "configs" / "dit-i256.json")
    assert (i256["num_layers"], i256["d_model"], i256["num_heads"],
            i256["head_dim"], i256["d_ff"]) == (28, 1152, 16, 72, 4608)
    s4 = harness.load_json(harness.HERE / "configs" / "dit-s4-cifar.json")
    assert (s4["num_layers"], s4["d_model"], s4["num_heads"],
            s4["head_dim"], s4["d_ff"], s4["patch_tokens"]) == (
                12, 384, 6, 64, 1536, 64)
    for cfg in (i256, s4):
        assert cfg["num_heads"] * cfg["head_dim"] == cfg["d_model"]
        side = cfg["latent_size"] // cfg["patch_size"]
        assert side * side == cfg["patch_tokens"]
        assert (cfg["patch_size"] ** 2 * cfg["latent_channels"]
                == cfg["latent_dim"])


def test_metrics_of_splits_by_cell():
    per = {m["name"] for m in harness.metrics_of(MAN, "dit-i256.serve32",
                                                 True)}
    assert "serve.tick_ms" in per and "mfu.sample" not in per
    e2e = {m["name"] for m in harness.metrics_of(MAN, "dit-i256.batch32",
                                                 False)}
    assert e2e == {"images_per_s", "setup_s"}


def test_manifest_is_small_and_plain():
    raw = (harness.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    json.loads(raw)
