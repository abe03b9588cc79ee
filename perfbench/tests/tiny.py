"""A cell cut to a size the CPU runs in about a second: the configuration's
widths and the traffic's load shrunk, everything else as the cell has it."""

from perfbench import harness

TINY = dict(num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=256,
            patch_tokens=16, latent_dim=8)


def cell(name: str) -> tuple:
    man = harness.manifest()
    w = harness.workload(man, name)
    cfg = harness.load_json(harness.HERE / "configs" / f"{w['config']}.json")
    cfg.update(TINY)
    traffic = harness.load_json(
        harness.HERE / "traffic" / f"{w['traffic']}.json")
    if traffic["driver"] == "batch":
        traffic["batch"] = 4
    else:
        traffic.update(slots=4, check_requests=1000,
                       arrivals={"kind": "poisson", "rate_per_s": 20.0})
    return man, cfg, traffic
