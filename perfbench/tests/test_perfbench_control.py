"""The control of each cell: the program with its own lower-precision tier
switched on in its place, or with its weights rounded below the precision
the configuration states (`round:e4m3`), whichever each limits file
names, at the cell's own size on the card, has to come out not correct;
the program as its configuration states it, on the same seed, correct. A
CPU run at a tiny size shows each control reading well above the
program's."""

import time

import pytest
import torch

from perfbench import harness, weights
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
                               time.perf_counter(), control=control_of(name))
    assert program["correct"], program["check"]
    assert not control["correct"], control["check"]


def widened(name: str) -> tuple:
    """A tiny DiT cell a little wider, so that a control shows."""
    man, cfg, traffic = tiny.cell(name)
    cfg.update(num_layers=4, d_model=128, num_heads=4, head_dim=32,
               d_ff=512)
    return man, cfg, traffic


def reading(man, name, cfg, traffic, control) -> float:
    return harness.run_cell(
        man, name, SEED, 0.5, False, torch.device("cpu"),
        time.perf_counter(), control=control, cfg_override=cfg,
        traffic_override=traffic)["check"]["worst_rel_l2"]["value"]


@pytest.mark.parametrize("name", ["dit-i256.batch32",
                                  "dit-i256.batch32-w8a16"])
def test_control_reads_above_the_program_on_the_cpu(name):
    man, cfg, traffic = widened(name)
    assert (reading(man, name, cfg, traffic, control_of(name))
            > 3 * reading(man, name, cfg, traffic, None))


@pytest.mark.parametrize("name", ["dit-i256.batch32", tiny.HYBRID_CELL])
def test_weight_rounding_reads_above_the_program_on_the_cpu(
        name, monkeypatch, tmp_path):
    if name == tiny.HYBRID_CELL:
        man, cfg, traffic = tiny.hybrid(monkeypatch, tmp_path)
    else:
        man, cfg, traffic = widened(name)
    program = reading(man, name, cfg, traffic, None)
    assert reading(man, name, cfg, traffic, "round:e4m3") > 3 * program


def test_split_control_names_both_kinds():
    assert harness.split_control(None) == (None, None)
    assert harness.split_control("fp8a16") == ("fp8a16", None)
    assert harness.split_control("round:e4m3") == (None, "e4m3")


def test_weight_rounding_rounds_every_matrix_leaf_per_column():
    gen = torch.Generator().manual_seed(5)
    w3 = torch.randn((2, 16, 8), generator=gen)
    w3[0, :, 3] *= 1000.0           # one column's scale leaves the others'
    tree = {"a": {"w": w3.clone()}, "b": torch.randn((4,), generator=gen),
            "m": torch.randn((16, 8), generator=gen).to(torch.bfloat16)}
    b = tree["b"].clone()
    weights.rounded(tree, "e4m3")
    assert torch.equal(tree["b"], b)                 # a vector stays exact
    assert tree["m"].dtype == torch.bfloat16
    got = tree["a"]["w"]
    assert not torch.equal(got, w3)
    rel = ((got - w3).abs() / w3.abs().amax(dim=-2, keepdim=True)).amax()
    assert 0 < float(rel) <= 2.0 ** -4                # e4m3's half-ulp at top
    scale = w3.abs().amax(dim=-2, keepdim=True) / 448.0
    assert torch.equal(got, (w3 / scale).to(torch.float8_e4m3fn).to(
        torch.float32) * scale)
