"""A cell cut to a size the CPU runs in about a second: the configuration's
widths and the traffic's load shrunk, everything else as the cell has it.

`hybrid` is a cell of the port's hybrid family (zamba2-7b at tiny widths),
brought as `perfbench/README.md` "Adding to it" says another family comes:
weights, reference and a bound in fixtures/ (the lookups pointed there),
the family's own ModelConfig fields under `port`, its `sample_shape`, a
limits file whose control is the weight rounding, and its entries in the
manifest. Nothing of it is a file of the benchmark."""

import copy
import json

from perfbench import harness

TINY = dict(num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=256,
            patch_tokens=16, latent_dim=8)

HYBRID_CELL = "zamba2-tiny.batch4"
HYBRID = {
    "name": "zamba2-tiny", "source": "arXiv:2411.15242", "arch": "zamba2-7b",
    "weights": "hybrid", "reference": "hybrid",
    "num_layers": 3, "d_model": 64, "num_heads": 4, "head_dim": 16,
    "d_ff": 128, "latent_dim": 8, "sample_shape": [16, 8],
    "num_classes": 0, "conditional": False,
    "dtype": "bfloat16", "param_dtype": "float32", "quant": None,
    "port": {"ssm_state": 16, "ssm_head_dim": 16, "ssm_expand": 2,
             "ssm_groups": 2, "attn_every": 2, "vocab_size": 64},
    "reduced": [], "assumed": {"widths": "tiny, for the CPU"},
}
# the tiny hybrid's limit, set as PERF.md sets a cell's from CPU readings
# (0.5 s windows): the bf16 program against the fp32 reference on 12 seeds
# 3000000011 + 7919 i, 0.005859-0.008093 (lower); its round:e4m3 control
# on 4 seeds, 0.047955-0.054781 (upper); lower^0.45 upper^0.55 = 0.0216
HYBRID_LIMITS = {"worst_rel_l2": {"limit": 0.02, "control": "round:e4m3"}}


def cell(name: str) -> tuple:
    man = harness.manifest()
    w = harness.workload(man, name)
    cfg = harness.load_json(harness.HERE / "configs" / f"{w['config']}.json")
    cfg.update(TINY)
    traffic = harness.load_json(
        harness.HERE / "traffic" / f"{w['traffic']}.json")
    return man, cfg, shrink(traffic)


def shrink(traffic: dict) -> dict:
    if traffic["driver"] == "batch":
        traffic["batch"] = 4
    else:
        traffic.update(slots=4, check_requests=1000,
                       arrivals={"kind": "poisson", "rate_per_s": 20.0})
    return traffic


def hybrid(monkeypatch, limits_dir) -> tuple:
    """(manifest, configuration, traffic) of the tiny hybrid cell, a closed
    loop of unconditional replays, with the lookups pointed at fixtures/
    and its limits file written into `limits_dir`."""
    for kind in harness.PACKAGES:
        monkeypatch.setitem(harness.PACKAGES, kind,
                            f"perfbench.tests.fixtures.{kind}")
    monkeypatch.setattr(harness, "LIMITS", limits_dir)
    (limits_dir / f"{HYBRID_CELL}.json").write_text(
        json.dumps(HYBRID_LIMITS))
    man = copy.deepcopy(harness.manifest())
    man["configs"].append({"name": HYBRID["name"], "source": HYBRID["source"],
                           "file": "perfbench/configs/zamba2-tiny.json",
                           "reduced": [], "why": "the CPU proof"})
    man["workloads"].append({"name": HYBRID_CELL, "config": HYBRID["name"],
                             "traffic": "batch1024", "chips": 1,
                             "why": "the CPU proof"})
    for m in man["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append(HYBRID_CELL)
    traffic = harness.load_json(harness.HERE / "traffic" / "batch1024.json")
    return man, copy.deepcopy(HYBRID), shrink(traffic)
