"""The plain reference against the port's CPU path at a reduced width, in
fp32, where the two must agree to rounding: guided and unguided UniPC,
and the w8a16 tier's weights quantized again by the reference."""

import pytest
import torch

from perfbench import harness, program, weights
from perfbench.reference import dit as ref_dit
from perfbench.reference import unipc as ref_unipc
from perfbench.tests import tiny

TOL = 1e-5      # fp32 against fp32 (the reference's state is float64)

def fp32(cfg):
    return dict(cfg, dtype="float32")

@pytest.mark.parametrize("name,w", [("dit-i256.batch32", 1.5),
                                    ("dit-i256.batch32", 4.0),
                                    ("dit-s4-cifar.batch1024", None),
                                    ("dit-i256.batch32-w8a16", 1.5)])
def test_reference_agrees_with_the_port_in_fp32(name, w):
    _, cfg, traffic = tiny.cell(name)
    cfg = fp32(cfg)
    dev = torch.device("cpu")
    B, seed = 3, 2 ** 31 + 7
    quant = harness.quant_mode(cfg)
    eng = program.engine(cfg, weights.make_params(cfg, seed, dev), B, seed,
                         quant, dev)
    run = eng.build(program.spec(cfg, traffic, quant, w))
    gen = torch.Generator().manual_seed(5)
    x_T = torch.randn((B, cfg["patch_tokens"], cfg["latent_dim"]),
                      generator=gen)
    if cfg["conditional"]:
        ids = torch.tensor([3, 999, 0])
        out = run(x_T, class_ids=ids)
        ws = torch.full((B,), w)
    else:
        ids = ws = None
        out = run(x_T)
    want = ref_dit.sample(cfg, weights.make_params(cfg, seed, dev), x_T,
                          ids, ws, traffic["solver"])
    err = ((out.double() - want).flatten(1).norm(dim=1)
           / want.flatten(1).norm(dim=1))
    assert float(err.max()) < TOL

def test_reference_timesteps_are_uniform_in_log_snr():
    s = ref_unipc.VPLinear(0.1, 20.0, 1.0, 1e-3)
    ts = ref_unipc.timesteps(s, 10, "logsnr")
    lams = [s.lam(t) for t in ts]
    assert ts[0] == pytest.approx(1.0) and ts[-1] == pytest.approx(1e-3)
    steps = [b - a for a, b in zip(lams, lams[1:])]
    assert max(steps) - min(steps) < 1e-9

def test_quantize_channel_rounds_half_to_even_per_column():
    w = torch.tensor([[1.0, -2.0], [0.5 * 127 / 127, 1.0],
                      [-1.0, 0.0]])
    q = ref_dit.quantize_channel(w, 8)
    scale = torch.tensor([1.0, 2.0]) / 127
    assert torch.allclose(q, torch.round(w / scale) * scale)

def test_guidance_matters_and_the_class_does():
    _, cfg, traffic = tiny.cell("dit-i256.batch32")
    cfg = fp32(cfg)
    dev = torch.device("cpu")
    p = weights.make_params(cfg, 11, dev)
    x_T = torch.randn((2, cfg["patch_tokens"], cfg["latent_dim"]),
                      generator=torch.Generator().manual_seed(1))
    a = ref_dit.sample(cfg, p, x_T, torch.tensor([1, 2]),
                       torch.tensor([1.5, 1.5]), traffic["solver"])
    b = ref_dit.sample(cfg, p, x_T, torch.tensor([7, 8]),
                       torch.tensor([1.5, 1.5]), traffic["solver"])
    c = ref_dit.sample(cfg, p, x_T, torch.tensor([1, 2]),
                       torch.tensor([4.0, 4.0]), traffic["solver"])
    rel = lambda u, v: float((u - v).norm() / v.norm())  # noqa: E731
    assert rel(b, a) > 1e-2 and rel(c, a) > 1e-2
