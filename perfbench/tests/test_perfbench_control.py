"""The control of each cell: the program with its own lower-precision tier
switched on in its place (the tier each limits file names), at the cell's
own size on the card, has to come out not correct; the program as its
configuration states it, on the same seed, correct. A CPU run at a tiny
size shows the control reading well above the program's."""

import time

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
SEED = 3_300_000_017


def control_of(name: str) -> str:
    return harness.load_json(
        harness.HERE / "limits" / f"{name}.json")["worst_rel_l2"]["control"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    dev = torch.device("cuda", 0)
    program = harness.run_cell(MAN, name, SEED, 2.0, False, dev,
                               time.perf_counter())
    harness.free_device()
    control = harness.run_cell(MAN, name, SEED, 2.0, False, dev,
                               time.perf_counter(),
                               quant_override=control_of(name))
    assert program["correct"], program["check"]
    assert not control["correct"], control["check"]


@pytest.mark.parametrize("name", ["dit-i256.batch32",
                                  "dit-i256.batch32-w8a16"])
def test_control_reads_above_the_program_on_the_cpu(name):
    man, cfg, traffic = tiny.cell(name)
    cfg.update(num_layers=4, d_model=128, num_heads=4, head_dim=32,
               d_ff=512)

    def reading(tier):
        return harness.run_cell(
            man, name, SEED, 0.5, False, torch.device("cpu"),
            time.perf_counter(), quant_override=tier, cfg_override=cfg,
            traffic_override=traffic)["check"]["worst_rel_l2"]["value"]

    assert reading(control_of(name)) > 3 * reading(None)
