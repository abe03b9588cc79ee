"""A whole run of a cell, on the CPU at a tiny size (the look for a card
skipped), with the timed path broken underneath: `correct` has to come out
false for every fault the cell can have, and true without one. The tiny
hybrid cell (`tiny.hybrid`) is the proof that a configuration of another
family runs whole through the harness."""

import dataclasses
import time

import pytest
import torch

from perfbench import harness, program
from perfbench.tests import tiny

SEED = 2 ** 31 + 4242


class Broken:
    """The port's engine with its timed path broken by `fault`."""

    def __init__(self, engine, fault: str):
        self.engine, self.fault = engine, fault

    def build(self, spec):
        run = self.engine.build(spec)

        def broken(x_T, **kw):
            if self.fault == "unchanged":       # the state comes back as is
                return x_T.clone()
            out = run(x_T, **kw)
            B = out.shape[0]
            if self.fault == "half":            # half the batch never run
                out[B // 2:] = x_T[B // 2:]
            elif self.fault == "altered":       # a latent swapped for another
                out[0] = out[1]
            return out

        return broken

    def build_step(self, spec):
        prog = self.engine.build_step(spec)
        real = prog.step_flight

        def broken(state, meta, g=None, extras=None, deep=True):
            before = state[0].clone()
            state, meta, done = real(state, meta, g, extras, deep=deep)
            x = state[0]
            if self.fault == "unchanged":
                x.copy_(before)
            elif self.fault == "half":
                x[x.shape[0] // 2:] = before[x.shape[0] // 2:]
            elif self.fault == "altered":
                x[0] *= 1.02
            return state, meta, done

        return dataclasses.replace(prog, step_flight=broken)


def run_tiny(name: str, monkeypatch, tmp_path, fault=None) -> dict:
    if name == tiny.HYBRID_CELL:
        man, cfg, traffic = tiny.hybrid(monkeypatch, tmp_path)
    else:
        man, cfg, traffic = tiny.cell(name)
    if fault is not None:
        real = program.engine
        monkeypatch.setattr(program, "engine",
                            lambda *a, **k: Broken(real(*a, **k), fault))
    return harness.run_cell(man, name, SEED, 1.0, False,
                            torch.device("cpu"), time.perf_counter(),
                            cfg_override=cfg, traffic_override=traffic)


CELLS = ["dit-i256.batch32", "dit-s4-cifar.batch1024", "dit-i256.serve32",
         "dit-i256.batch32-w8a16", tiny.HYBRID_CELL]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, monkeypatch, tmp_path):
    out = run_tiny(name, monkeypatch, tmp_path)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch, tmp_path):
    out = run_tiny(name, monkeypatch, tmp_path, fault)
    assert not out["correct"], (fault, out["check"])
