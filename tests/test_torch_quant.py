"""The port's quantized path against the JAX reference's, same inputs.

Inputs are made with numpy (or, for the calibration probe, drawn by JAX and
handed to both). On the CPU the quant_matmul op runs its plain PyTorch
version; the reference runs its Pallas kernel in interpret mode and its jnp
oracle. Tolerances, each measured well inside:

* quantization tables (weights at bits 8 and 4, per channel and per
  tensor, fp8; activations): bit-equal;
* the plain quant_matmul vs the reference's kernel and oracle: 1e-5 (fp32
  sums in another order);
* calibration stats: 1e-5 relative (measured 5.4e-7);
* the quantized eps-net: 1e-5 relative for w8a16, fp8a16 and w4a16
  (measured 5-6e-7); w8a8 1e-3 (measured 4.0e-4: an activation that the
  two frameworks compute a few fp32 ulps apart can round to the
  neighbouring int8 level, which moves that product by one scale step);
* the quantized engine scan and the per-slot step: 1e-5 (measured 1.0e-6);
  the w8a8 scan over the reference's calibrated tree 1e-2 (measured
  3.3e-3: the eps-net's rounding flips, amplified by guidance 2.0 along
  the trajectory).

The `gpu` test holds the CUDA kernel against its plain version on the card
and skips elsewhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import VPLinear as JVP
from repro.engine import EngineSpec as JSpec
from repro.kernels.quant_matmul import ops as j_qops
from repro.kernels.quant_matmul import ref as j_qref
from repro.launch.sample import build_engine as j_build_engine
from repro.models import api as j_api
from repro.models import quant as j_quant
from repro_torch.configs import get_config as t_get_config
from repro_torch.diffusion import VPLinear as TVP
from repro_torch.engine import EngineSpec as TSpec
from repro_torch.kernels.dispatch import LAUNCHES
from repro_torch.kernels.quant_matmul import kernel as t_qkernel
from repro_torch.kernels.quant_matmul import ops as t_qops
from repro_torch.kernels.quant_matmul import ref as t_qref
from repro_torch.launch import sample as t_launch
from repro_torch.models import api as t_api
from repro_torch.models import dit as t_dit
from repro_torch.models import quant as t_quant
from test_torch_dit import reference_params

torch.set_num_threads(2)

MODES = ("w8a16", "w8a8", "fp8a16", "w4a16")
EPS_TOL = {"w8a16": 1e-5, "fp8a16": 1e-5, "w4a16": 1e-5, "w8a8": 1e-3}
W8A8_SCAN_TOL = 1e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _bits(a) -> np.ndarray:
    """Stored values as numpy, fp8 (torch or ml_dtypes) as its bytes."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            return a.view(torch.uint8).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _assert_trees_bit_equal(got: dict, want: dict, path=""):
    assert sorted(got) == sorted(want), f"keys differ at {path or '/'}"
    for k in want:
        if isinstance(want[k], dict):
            assert isinstance(got[k], dict), f"{path}/{k} is no dict"
            _assert_trees_bit_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                          err_msg=f"{path}/{k}")


# ---------------------------------------------------------------------------
# the plain version: quantization tables and the matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(37, 130), (3, 23, 17)])
@pytest.mark.parametrize("bits,granularity,fmt", [
    (8, "channel", "int"), (8, "tensor", "int"), (4, "channel", "int"),
    (4, "tensor", "int"), (8, "channel", "fp8"), (8, "tensor", "fp8")])
def test_quantize_bit_equal_to_reference(shape, bits, granularity, fmt):
    w = (0.3 * np.random.default_rng(0).normal(size=shape)).astype(np.float32)
    jq, js = j_qref.quantize(jnp.asarray(w), bits=bits,
                             granularity=granularity, fmt=fmt)
    tq, ts = t_qref.quantize(torch.as_tensor(w), bits=bits,
                             granularity=granularity, fmt=fmt)
    assert tq.dtype == (torch.float8_e4m3fn if fmt == "fp8" else torch.int8)
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(t_qref.dequantize(tq, ts).numpy(),
                                  np.asarray(j_qref.dequantize(jq, js)))


@pytest.mark.parametrize("sa", [0.013, 0.25, 1.0 / 3.0])
def test_quantize_act_bit_equal_to_reference(sa):
    rng = np.random.default_rng(1)
    x = (3.0 * rng.normal(size=(11, 37))).astype(np.float32)
    # values on the half-way points between int8 levels: both round to even
    x[0, :9] = (np.arange(-4, 5) + 0.5).astype(np.float32) * np.float32(sa)
    x[1, :2] = [1e4, -1e4]                      # clipped to +/-127
    want = np.asarray(j_qref.quantize_act(jnp.asarray(x), sa))
    got = t_qref.quantize_act(torch.as_tensor(x), sa)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_rejects_bad_args():
    w = torch.ones(4, 4)
    with pytest.raises(ValueError, match="granularity"):
        t_qref.quantize(w, granularity="row")
    with pytest.raises(ValueError, match="bits"):
        t_qref.quantize(w, bits=3)


ODD_SHAPES = ((5, 37, 130), (1, 7, 3))   # tests/test_quant.py's


@pytest.mark.parametrize("jbackend", ["interpret", "jnp"])
@pytest.mark.parametrize("M,K,N", ODD_SHAPES)
@pytest.mark.parametrize("mode", ["w8a16", "w8a8", "w4a16"])
def test_plain_quant_matmul_matches_reference(jbackend, M, K, N, mode):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    spec = t_quant.quant_spec(mode)
    qw, ws = j_qref.quantize(jnp.asarray(w), bits=spec.bits,
                             granularity=spec.granularity)
    sa = (float(np.abs(x).max()) / j_qref.ACT_QMAX if spec.act_bits == 8
          else None)
    want = j_qops.quant_matmul(jnp.asarray(x), qw, ws, sa=sa,
                               backend=jbackend)
    got = t_qops.quant_matmul(torch.as_tensor(x), torch.as_tensor(
        np.array(qw)), torch.as_tensor(np.array(ws)), sa=sa)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_plain_quant_matmul_keeps_leading_dims_and_bf16():
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(2, 3, 40)).astype(np.float32)).to(torch.bfloat16)
    qw, ws = t_qref.quantize(torch.randn(40, 24, generator=torch.Generator(
        ).manual_seed(0)))
    out = t_qops.quant_matmul(x, qw, ws)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 3, 24)
    np.testing.assert_array_equal(
        out.float().numpy(),
        t_qref.quant_matmul(x, qw, ws).float().numpy())


# ---------------------------------------------------------------------------
# calibration and the param tree
# ---------------------------------------------------------------------------


def _jax_probe(cfg, batch=2, seed=0):
    """The probe latents and class ids the reference's calibrate_act_stats
    draws (models/quant.py)."""
    k_x, k_c = jax.random.split(jax.random.PRNGKey(seed))
    x = jax.random.normal(k_x, (batch, cfg.patch_tokens, cfg.latent_dim),
                          jnp.float32)
    return np.array(x), np.array(jax.random.randint(k_c, (batch,), 0, 1000))


@pytest.fixture(scope="module")
def reduced_i256():
    """(jax cfg, port cfg, numpy params, jax params, port params) of the
    perturbed reduced dit-i256 (fp32)."""
    jcfg, tcfg, tree = reference_params("dit-i256")
    return (jcfg, tcfg, tree, jax.tree.map(jnp.asarray, tree),
            t_api.params_from_numpy(tree, tcfg, "cpu"))


@pytest.fixture(scope="module")
def jax_stats(reduced_i256):
    jcfg, _, _, jparams, _ = reduced_i256
    return j_quant.calibrate_act_stats(jcfg, jparams)


def test_calibration_matches_reference_on_its_probe(reduced_i256, jax_stats):
    jcfg, tcfg, _, _, tparams = reduced_i256
    x, cls = _jax_probe(jcfg)
    got = t_quant.calibrate_act_stats(tcfg, tparams,
                                      x_probe=torch.as_tensor(x),
                                      class_ids=torch.as_tensor(cls))
    assert sorted(got) == sorted(jax_stats)
    for k, want in jax_stats.items():
        assert got[k].dtype == np.float32 and got[k].shape == want.shape
        assert (want > 0).all()
        assert (np.abs(got[k] - want) <= 1e-5 * np.abs(want)).all(), k


def test_calibration_is_deterministic_and_draws_its_own_probe(reduced_i256):
    _, tcfg, _, _, tparams = reduced_i256
    s1 = t_quant.calibrate_act_stats(tcfg, tparams, nfe=2, batch=1, seed=4)
    s2 = t_quant.calibrate_act_stats(tcfg, tparams, nfe=2, batch=1, seed=4)
    s3 = t_quant.calibrate_act_stats(tcfg, tparams, nfe=2, batch=1, seed=5)
    for k in s1:
        np.testing.assert_array_equal(s1[k], s2[k])
    assert any(not np.array_equal(s1[k], s3[k]) for k in s1)


def test_tapped_replay_is_dit_apply(reduced_i256):
    """Calibration replays the functions dit_apply runs: with a tap that
    records every site, the output is bit-identical to dit_apply's."""
    _, tcfg, _, _, tparams = reduced_i256
    bk = tparams["backbone"]
    x = torch.as_tensor(np.random.default_rng(6).normal(
        size=(2, tcfg.patch_tokens, tcfg.latent_dim)).astype(np.float32))
    cls = torch.tensor([4, 1000])
    sites = []
    tap = lambda site, v: sites.append(site)
    h, c = t_dit._embed(bk, tcfg, x, 0.5, cls)
    for bp in t_dit._layers(bk["blocks"], tcfg.num_layers):
        h = t_dit._block(h, bp, tcfg, c, tap=tap)
    got = t_dit._head(bk, tcfg, h, c, tap=tap)
    np.testing.assert_array_equal(
        got.numpy(), t_dit.dit_apply(bk, tcfg, x, 0.5, cls).numpy())
    assert sites == ["ada", "qkv", "wo", "mlp_in", "mlp_mid"] * 2 + [
        "final_ada"]


@pytest.mark.parametrize("mode", MODES)
def test_quantize_params_bit_equal_to_reference(reduced_i256, jax_stats,
                                                mode):
    jcfg, tcfg, _, jparams, tparams = reduced_i256
    spec = t_quant.quant_spec(mode)
    stats = jax_stats if spec.act_bits == 8 else None
    want = jax.tree.map(np.asarray, j_quant.quantize_params(
        jcfg, jparams, j_quant.quant_spec(mode), act_stats=stats))
    got = t_quant.quantize_params(tcfg, tparams, spec, act_stats=stats)
    _assert_trees_bit_equal(got, want)
    blocks = got["backbone"]["blocks"]
    L, d = tcfg.num_layers, tcfg.d_model
    assert tuple(blocks["w1"]["qw"].shape) == (L, d, tcfg.d_ff)
    assert tuple(blocks["w1"]["ws"].shape) == (L, tcfg.d_ff)
    if spec.act_bits == 8:
        assert tuple(blocks["attn"]["wq"]["sa"].shape) == (L,)
    # the float tree is untouched
    assert not isinstance(tparams["backbone"]["blocks"]["w1"], dict)
    assert t_quant.quant_param_bytes(got) == j_quant.quant_param_bytes(want)


def test_quantize_params_needs_stats_for_a8(reduced_i256):
    _, tcfg, _, _, tparams = reduced_i256
    with pytest.raises(ValueError, match="act_bits=8"):
        t_quant.quantize_params(tcfg, tparams, t_quant.quant_spec("w8a8"))


def test_quant_spec_tiers_mirror_reference():
    assert sorted(t_quant.QUANT_MODES) == sorted(j_quant.QUANT_MODES)
    for mode, spec in t_quant.QUANT_MODES.items():
        assert (dataclasses.asdict(spec)
                == dataclasses.asdict(j_quant.QUANT_MODES[mode]))
    assert t_quant.PER_BLOCK_STATS == j_quant.PER_BLOCK_STATS
    assert t_quant._BLOCK_SITES == j_quant._BLOCK_SITES


# ---------------------------------------------------------------------------
# the quantized eps-net, and a JAX-quantized tree carried across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_quantized_eps_net_matches_reference(reduced_i256, mode):
    """The reference quantizes (and, for w8a8, calibrates); its tree crosses
    through params_from_numpy (fp8 as its bytes). The port's eps-net over
    that tree, and over its own quantization of the float params with the
    reference's stats, both agree with the reference's quantized eps-net."""
    jcfg, tcfg, _, jparams, tparams = reduced_i256
    qcfg, qparams, info = j_api.calibrate_and_quantize(jcfg, jparams, mode,
                                                       nfe=2, calib_batch=1)
    x = np.random.default_rng(2).normal(
        size=(3, jcfg.patch_tokens, jcfg.latent_dim)).astype(np.float32)
    t, cls = np.float32(0.37), np.array([3, 999, 1000])
    want = np.asarray(j_api.eps_network(qcfg)(
        qparams, jnp.asarray(x), jnp.asarray(t),
        {"class_ids": jnp.asarray(cls, jnp.int32)}))

    spec = t_quant.quant_spec(mode)
    carried = t_api.params_from_numpy(jax.tree.map(np.asarray, qparams),
                                      tcfg, "cpu")
    rec = carried["backbone"]["blocks"]["attn"]["wq"]
    assert rec["qw"].dtype == (torch.float8_e4m3fn if spec.fmt == "fp8"
                               else torch.int8)
    assert rec["ws"].dtype == torch.float32
    own = t_quant.quantize_params(tcfg, tparams, spec,
                                  act_stats=info["act_stats"])
    _assert_trees_bit_equal(own, carried)
    tq = dataclasses.replace(tcfg, quant=spec)
    got = t_api.eps_network(tq)(carried, torch.as_tensor(x),
                                torch.as_tensor(t),
                                {"class_ids": torch.as_tensor(cls).long()})
    assert np.abs(want).max() > 1e-3
    assert _rel(got.numpy(), want) <= EPS_TOL[mode]


def test_port_calibrate_and_quantize_tracks_fp32(reduced_i256):
    """The port's own calibration end to end (its own probe draws): every
    tier's eval stays within the reference's documented band of the fp32
    eval (tests/test_quant.py:test_quantized_eval_tracks_fp32)."""
    _, tcfg, _, _, tparams = reduced_i256
    net = t_api.eps_network(tcfg)
    x = torch.as_tensor(np.random.default_rng(5).normal(
        size=(2, tcfg.patch_tokens, tcfg.latent_dim)).astype(np.float32))
    t, batch = torch.full((2,), 0.4), {"class_ids": torch.zeros(2).long()}
    ref = net(tparams, x, t, batch).numpy()
    for mode, tol in {"w8a16": 2e-2, "w8a8": 5e-2, "fp8a16": 5e-2,
                      "w4a16": 3e-1}.items():
        qcfg, qparams, info = t_api.calibrate_and_quantize(
            tcfg, tparams, mode, nfe=2, calib_batch=1)
        assert info["spec"] is t_quant.QUANT_MODES[mode]
        assert qcfg.quant is info["spec"]
        q = t_api.eps_network(qcfg)(qparams, x, t, batch).numpy()
        rel = np.linalg.norm(q - ref) / np.linalg.norm(ref)
        assert rel < tol, f"{mode}: rel err {rel:.3e} >= {tol}"


# ---------------------------------------------------------------------------
# the engine: scan, handshake, per-slot step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nfe", [5, 10])
@pytest.mark.parametrize("mode", ["w8a16", "fp8a16", "w4a16"])
def test_quantized_sample_matches_reference_engine(reduced_i256, nfe, mode):
    jcfg, _, _, jparams, tparams = reduced_i256
    batch = 2
    x_T = np.random.default_rng(1).normal(
        size=(batch, jcfg.patch_tokens, jcfg.latent_dim)).astype(np.float32)
    eng = j_build_engine(jcfg, jparams, JVP(), batch, seed=0, want_cfg=True,
                         quant=mode)
    want = np.asarray(eng.build(JSpec(nfe=nfe, order=3, cfg_scale=2.0,
                                      quant=mode))(jnp.asarray(x_T)))
    got = t_launch.sample("dit-i256", reduced=True, nfe=nfe, order=3,
                          cfg_scale=2.0, batch=batch, seed=0, params=tparams,
                          x_T=x_T, quant=mode, device="cpu")
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-5


def test_w8a8_engine_with_carried_stats_matches_reference(reduced_i256):
    """w8a8 calibrates on probe draws that differ between the frameworks;
    with the reference's calibrated tree carried across (a cfg that already
    carries the spec is wired as it is), the scans agree within the w8a8
    w8a8 scan tolerance."""
    jcfg, tcfg, _, jparams, _ = reduced_i256
    qcfg, qparams, _ = j_api.calibrate_and_quantize(jcfg, jparams, "w8a8")
    batch = 2
    x_T = np.random.default_rng(1).normal(
        size=(batch, jcfg.patch_tokens, jcfg.latent_dim)).astype(np.float32)
    eng = j_build_engine(qcfg, qparams, JVP(), batch, seed=0, want_cfg=True)
    want = np.asarray(eng.build(JSpec(nfe=5, order=3, cfg_scale=2.0))(
        jnp.asarray(x_T)))
    tq = dataclasses.replace(tcfg, quant=t_quant.quant_spec("w8a8"))
    carried = t_api.params_from_numpy(jax.tree.map(np.asarray, qparams), tq,
                                      "cpu")
    teng = t_launch.build_engine(tq, carried, TVP(), batch, seed=0,
                                 quant="w8a8", device="cpu")
    got = teng.build(TSpec(nfe=5, order=3, cfg_scale=2.0, quant="w8a8"))(
        torch.as_tensor(x_T)).numpy()
    assert _rel(got, want) <= W8A8_SCAN_TOL


def test_quant_handshake_errors(reduced_i256, monkeypatch, capsys):
    _, tcfg, _, _, tparams = reduced_i256
    with pytest.raises(ValueError, match="quant mode"):
        TSpec(quant="w2a2").resolve()
    TSpec(quant="w8a16").resolve()
    plain = t_launch.build_engine(tcfg, tparams, TVP(), 2, device="cpu")
    quant = t_launch.build_engine(tcfg, tparams, TVP(), 2, quant="w8a16",
                                  device="cpu")
    assert (plain.quant, quant.quant) == ("none", "w8a16")
    for eng, spec_quant in ((plain, "w8a16"), (quant, "none"),
                            (quant, "fp8a16")):
        spec = TSpec(nfe=4, quant=spec_quant)
        with pytest.raises(ValueError, match="wired for"):
            eng.build(spec)
        with pytest.raises(ValueError, match="wired for"):
            eng.build_step(spec)
    # a cfg that already carries another tier's spec
    wrong = dataclasses.replace(tcfg, quant=t_quant.quant_spec("w4a16"))
    with pytest.raises(ValueError, match="tier's spec"):
        t_launch.build_engine(wrong, tparams, TVP(), 2, quant="w8a16",
                              device="cpu")
    # the quantized path needs the dit family (the port's registry holds
    # only dit archs, so the CLI guard is reached with a stand-in config)
    lm = dataclasses.replace(tcfg, family="transformer")
    with pytest.raises(ValueError, match="dit family"):
        t_launch.build_engine(lm, tparams, TVP(), 2, quant="w8a16",
                              device="cpu")
    monkeypatch.setattr(t_launch, "get_config", lambda arch: lm)
    with pytest.raises(SystemExit):
        t_launch.main(["--arch", "dit-i256", "--quant", "w8a16", "--device",
                       "cpu"])
    assert "--quant needs the dit family" in capsys.readouterr().err


REQS = [  # (arrival tick, guidance scale, class id)
    (0, 2.0, 7), (1, 1.0, 1000), (3, 3.5, 42)]


def test_staggered_quantized_step_matches_uniform_runs(reduced_i256):
    """Requests admitted at staggered ticks into a per-slot StepProgram of
    a w8a16 engine (the third into the slot the first one freed) against
    the batch-1 uniform quantized run of each, within 1e-5."""
    _, tcfg, _, _, tparams = reduced_i256
    engine = t_launch.build_engine(tcfg, tparams, TVP(), 2,
                                   per_request_cond=True, quant="w8a16",
                                   device="cpu")
    spec = TSpec(nfe=5, order=3, cfg_scale=2.0, quant="w8a16")
    program = engine.build_step(spec)
    shape = (tcfg.patch_tokens, tcfg.latent_dim)
    x_T = [torch.as_tensor(np.random.default_rng(50 + r).normal(
        size=shape).astype(np.float32)) for r in range(len(REQS))]
    slots = 2
    state, g = program.init_state(slots, shape), program.init_g(slots)
    cls = torch.zeros(slots, dtype=torch.long)
    row, owner = np.zeros(slots, np.int64), [None] * slots
    queue, done, tick = list(enumerate(REQS)), {}, 0
    LAUNCHES.clear()
    while len(done) < len(REQS):
        while queue and queue[0][1][0] <= tick and None in owner:
            rid, (_, scale, c) = queue.pop(0)
            s = owner.index(None)
            x, E = state
            x[s], E[:, s], g[s], cls[s] = x_T[rid], 0, scale, c
            row[s], owner[s] = 0, rid
        busy = np.array([o is not None for o in owner])
        state = program.step(state, torch.as_tensor(np.where(busy, row, 0)),
                             g, {"class_ids": cls})
        row[busy] += 1
        for s in range(slots):
            if owner[s] is not None and row[s] == program.n_rows:
                done[owner[s]] = state[0][s].clone()
                owner[s] = None
        tick += 1
    assert not LAUNCHES      # CPU tensors: the plain versions, no kernels
    for rid, (_, scale, c) in enumerate(REQS):
        uniform = engine.build(dataclasses.replace(spec, cfg_scale=scale))(
            x_T[rid][None], class_ids=torch.tensor([c]))[0]
        assert _rel(done[rid].numpy(), uniform.numpy()) <= 1e-5, rid


def test_params_from_numpy_keeps_record_dtypes():
    tree = {"backbone": {
        "blocks": {"w1": {"qw": np.ones((2, 3, 4), np.int8),
                          "ws": np.ones((2, 4), np.float32),
                          "sa": np.ones((2,), np.float32)}},
        "final_ada": {"qw": np.asarray(jnp.ones((3, 4), jnp.float8_e4m3fn)),
                      "ws": np.ones((4,), np.float32)},
        "out_proj": np.ones((3, 5), np.float64)}}
    cfg = t_get_config("dit-i256").reduced()
    got = t_api.params_from_numpy(tree, cfg, "cpu")["backbone"]
    assert got["blocks"]["w1"]["qw"].dtype == torch.int8
    assert got["blocks"]["w1"]["sa"].dtype == torch.float32
    assert got["final_ada"]["qw"].dtype == torch.float8_e4m3fn
    assert (got["final_ada"]["qw"].float() == 1).all()
    assert got["out_proj"].dtype == cfg.weight_dtype
    with pytest.raises(ValueError, match="stacked over 2 layers"):
        t_api.params_from_numpy(tree, dataclasses.replace(cfg, num_layers=3),
                                "cpu")


# ---------------------------------------------------------------------------
# the CUDA kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(4096, 1152, 1152), (16, 1152, 6912),
                                   (37, 130, 200), (100, 64, 48)])
@pytest.mark.parametrize("mode,x_dtype", [
    ("w8a16", torch.bfloat16), ("w8a8", torch.bfloat16),
    ("fp8a16", torch.bfloat16), ("w4a16", torch.bfloat16),
    ("w8a16", torch.float32), ("w8a8", torch.float32),
    ("fp8a16", torch.float32)])
def test_card_quant_matmul_matches_plain(cuda, M, K, N, mode, x_dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(M, K, generator=g, device=cuda).to(x_dtype)
    spec = t_quant.quant_spec(mode)
    qw, ws = t_qref.quantize(torch.randn(K, N, generator=g, device=cuda),
                             bits=spec.bits, granularity=spec.granularity,
                             fmt=spec.fmt)
    sa = x.float().abs().amax() / 127.0 if spec.act_bits == 8 else None
    got = t_qops.quant_matmul(x, qw, ws, sa=sa)
    want = t_qops.quant_matmul(x, qw, ws, sa=sa, backend="plain")
    torch.cuda.synchronize()
    assert got.dtype == x_dtype and got.shape == want.shape
    tol = 1e-2 if x_dtype == torch.bfloat16 else 1e-5
    assert _rel(got.float().cpu(), want.float().cpu()) <= tol


SITES = {"wq": (4096, 1152, 1152), "w1": (4096, 1152, 4608),
         "w2": (4096, 4608, 1152)}


def _card_case(dev, M, K, N, mode, x_dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=dev).to(x_dtype)
    spec = t_quant.quant_spec(mode)
    qw, ws = t_qref.quantize(torch.randn(K, N, generator=g, device=dev),
                             bits=spec.bits, granularity=spec.granularity,
                             fmt=spec.fmt)
    sa = x.float().abs().amax() / 127.0 if spec.act_bits == 8 else None
    got = t_qops.quant_matmul(x, qw, ws, sa=sa)
    want = t_qops.quant_matmul(x, qw, ws, sa=sa, backend="plain")
    torch.cuda.synchronize()
    body = t_qkernel.plan(t_qref.fold_act(x, ws, sa)[0], qw)["body"]
    return got, want, body


@pytest.mark.gpu
@pytest.mark.parametrize("site", sorted(SITES))
@pytest.mark.parametrize("mode", MODES)
def test_card_quant_matmul_token_sites_on_wgmma(cuda, site, mode):
    """Every tier at the three token sites of dit-i256, on the wgmma body."""
    got, want, body = _card_case(cuda, *SITES[site], mode, torch.bfloat16, 4)
    assert body == "wgmma"
    assert _rel(got.float().cpu(), want.float().cpu()) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,bodies", [
    # M, N, K off every tile edge
    (4100, 1168, 1168, {"w8a16": "wgmma", "w8a8": "wgmma"}),
    # qw rows of 1160 bytes: no TMA
    (4100, 1160, 1160, {"w8a16": "wmma", "w8a8": "wmma"}),
    # one partial tile; w8a8's int8 x rows of 40 bytes are no 16-byte
    # multiple, so TMA cannot take them
    (65, 40, 32, {"w8a16": "wgmma", "w8a8": "wmma"}),
    # one partial tile, int8 x rows of 48 bytes: wgmma under both
    (65, 48, 32, {"w8a16": "wgmma", "w8a8": "wgmma"}),
], ids=["4100-1168-1168", "4100-1160-1160", "65-40-32", "65-48-32"])
@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
def test_card_quant_matmul_ragged(cuda, M, K, N, bodies, mode):
    got, want, used = _card_case(cuda, M, K, N, mode, torch.bfloat16, 5)
    assert used == bodies[mode]
    assert _rel(got.float().cpu(), want.float().cpu()) <= 1e-2


# the skinny body's edges: M around its x-row tiles (8, 16, 32, 64 rows),
# N and K off its 64-column strips and 32-row ring tiles
SKINNY_MS = [1, 2, 15, 16, 17, 33, 64]


@pytest.mark.gpu
@pytest.mark.parametrize("M", SKINNY_MS)
@pytest.mark.parametrize("mode", MODES)
def test_card_skinny_matches_plain(cuda, M, mode):
    got, want, used = _card_case(cuda, M, 1000, 2000, mode, torch.bfloat16,
                                 6)
    assert used == "skinny"
    assert _rel(got.float().cpu(), want.float().cpu()) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 16, 64])
def test_card_skinny_byte_copies_and_fp32_out(cuda, M):
    """x rows 2 bytes off 16-byte alignment and qw rows of 1001 bytes take
    the byte copies; int8 x with an fp32 output (w8a8 of fp32
    activations); both against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(9)
    xb = torch.randn(M, 1153, generator=g, device=cuda).to(torch.bfloat16)
    qw, ws = t_qref.quantize(torch.randn(1130, 1001, generator=g,
                                         device=cuda))
    x, w = xb[:, 1:1131], qw[:, :1001]
    p = t_qkernel.plan(x, w)
    assert p["body"] == "skinny" and (p["access_x"], p["access_w"]) == (2, 1)
    got = t_qops.quant_matmul(x, w, ws[:1001].contiguous())
    want = t_qops.quant_matmul(x, w, ws[:1001].contiguous(), backend="plain")
    assert _rel(got.float().cpu(), want.float().cpu()) <= 1e-2
    x32 = torch.randn(M, 1130, generator=g, device=cuda)
    sa = x32.abs().amax() / 127.0
    got = t_qops.quant_matmul(x32, qw, ws, sa=sa)
    want = t_qops.quant_matmul(x32, qw, ws, sa=sa, backend="plain")
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _rel(got.cpu(), want.cpu()) <= 1e-5


@pytest.mark.gpu
def test_card_skinny_is_deterministic(cuda):
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(16, 1152, generator=g, device=cuda).to(torch.bfloat16)
    qw, ws = t_qref.quantize(torch.randn(1152, 6912, generator=g,
                                         device=cuda))
    first = t_qops.quant_matmul(x, qw, ws)
    for _ in range(3):
        assert torch.equal(t_qops.quant_matmul(x, qw, ws), first)


@pytest.mark.gpu
def test_card_skinny_refuses_what_it_cannot_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)
    xb = torch.randn(17, 1153, generator=g, device=cuda).to(torch.bfloat16)
    qw, ws = t_qref.quantize(torch.randn(1152, 1001, generator=g, device=cuda))
    x = xb[:, :1152]
    out = torch.empty(17, 1001, dtype=torch.bfloat16, device=cuda)
    p = t_qkernel.plan(x, qw)
    t_qkernel._launch(x, qw, ws, out, p)      # the plan itself launches
    for bad in (dict(p, m_tiles=2),           # 17 rows need 4 x-row tiles
                dict(p, split=0), dict(p, split=9),
                dict(p, grid=p["blocks"] + 1),            # a block a strip
                dict(p, vw=16), dict(p, m_tiles=8, vw=8),  # not compiled
                dict(p, access_w=p["vw"])):               # 1001-byte rows
        with pytest.raises(RuntimeError, match="launch failed"):
            t_qkernel._launch(x, qw, ws, out, bad)
    xu = xb[:, 1:1153]                        # 2 bytes off alignment
    with pytest.raises(RuntimeError, match="launch failed"):
        t_qkernel._launch(xu, qw, ws, out, dict(p, access_x=8))
    with pytest.raises(RuntimeError, match="launch failed"):  # not skinny
        t_qkernel._launch(x, qw, ws, out, dict(p, body="wgmma"))


@pytest.mark.parametrize("M,K,N,x_dtype,w_dtype,body,tiles", [
    (4096, 1152, 1152, torch.bfloat16, torch.int8, "wgmma", 29 * 9),
    (4096, 1152, 4608, torch.bfloat16, torch.int8, "wgmma", 29 * 36),
    (4096, 4608, 1152, torch.int8, torch.float8_e4m3fn, "wgmma", 29 * 9),
    (16, 1152, 6912, torch.bfloat16, torch.int8, "skinny", 108),
    (65, 1152, 1152, torch.bfloat16, torch.int8, "wgmma", 9),
    (4100, 1160, 1160, torch.bfloat16, torch.int8, "wmma", 33 * 10),
    (4096, 1152, 1152, torch.float32, torch.int8, "cuda_cores", 64 * 18),
])
def test_quant_matmul_plan_picks_body_and_tiles(M, K, N, x_dtype, w_dtype,
                                                 body, tiles):
    """The body and its tile count by dtype and shape: the token sites of
    dit-i256 on wgmma (144 x 128 tiles: 261 at N = 1152, 1.98 waves over
    132 SMs), the adaLN sites (M = 16) on the skinny body (a tile per
    64-column strip: 108 at N = 6912), rows TMA cannot
    take on WMMA, fp32 x on CUDA cores."""
    x = torch.zeros(M, K, dtype=x_dtype)
    qw = torch.zeros(K, N, dtype=torch.int8).view(w_dtype)
    p = t_qkernel.plan(x, qw)
    assert p["body"] == body and p["blocks"] == tiles
    assert p["tile"] == t_qkernel.BODIES[body][1]


def test_quant_matmul_plan_needs_aligned_rows_for_tma():
    x = torch.zeros(4096, 1160, dtype=torch.bfloat16)
    qw = torch.zeros(1152, 1152, dtype=torch.int8)
    assert t_qkernel.plan(x[:, :1152], qw)["body"] == "wgmma"  # 2320-byte rows
    assert t_qkernel.plan(x[:, 1:1153], qw)["body"] == "wmma"  # 2 bytes off


@pytest.mark.parametrize("M,K,N,m_tiles,vw,split,grid", [
    (16, 1152, 6912, 2, 8, 8, 108),    # ada: 108 strips of 64 columns
    (16, 1152, 2304, 2, 4, 8, 72),     # final_ada: 72 strips of 32
    (1, 1152, 6912, 2, 8, 8, 108),     # one request, no CFG
    (17, 1152, 6912, 4, 8, 8, 108),
    (64, 1152, 6912, 8, 4, 8, 132),    # 216 strips: a wave walks them
    (16, 1152, 36864, 2, 8, 8, 132),
    (64, 4608, 1152, 8, 4, 8, 36),
    (16, 40, 320, 2, 4, 3, 10),        # three 16-row groups of K
])
def test_skinny_plan_grid_split_and_tiles(M, K, N, m_tiles, vw, split, grid):
    """The skinny plan at the adaLN sites and at M = 1 / 17 / 64: x-row
    tiles by M; 8 weight bytes a lane (64-column strips) where those
    strips fill three quarters of the SMs, else 4; a warp per 16-row
    group of K up to 8; a block a strip, up to one an SM."""
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    qw = torch.zeros(K, N, dtype=torch.int8)
    p = t_qkernel.plan(x, qw)
    assert p["body"] == "skinny" and p["tile"] == (64, 8 * vw)
    assert p["blocks"] == -(-N // (8 * vw))
    assert (p["m_tiles"], p["vw"], p["split"], p["grid"]) == (
        m_tiles, vw, split, grid)
    assert (p["access_x"], p["access_w"]) == (8, vw)
    assert t_qkernel.skinny_smem(m_tiles, vw, split) <= 65536


def test_skinny_plan_access_width_from_alignment():
    """Whole loads where the operand's start and row stride allow them
    (four values of x: 8 bytes bf16, 4 int8; a lane's 8 or 4 bytes of a
    weight row), element loads (the element size) where not: x 2 bytes
    off, int8 x rows of 1002 bytes, qw rows of 1001 and 1004 bytes."""
    xb = torch.zeros(16, 1160, dtype=torch.bfloat16)
    qw = torch.zeros(1152, 6912, dtype=torch.int8)
    assert t_qkernel.plan(xb[:, :1152], qw)["access_x"] == 8
    assert t_qkernel.plan(xb[:, 1:1153], qw)["access_x"] == 2
    p = t_qkernel.plan(torch.zeros(16, 1000, dtype=torch.int8), qw[:1000])
    assert (p["access_x"], p["access_w"]) == (4, 8)
    p = t_qkernel.plan(torch.zeros(16, 1002, dtype=torch.int8), qw[:1002])
    assert p["access_x"] == 1
    p = t_qkernel.plan(xb[:, :1152], torch.zeros(1152, 1001,
                                                 dtype=torch.int8))
    assert (p["access_x"], p["access_w"]) == (8, 1)
    w1004 = torch.zeros(1152, 1004, dtype=torch.int8)
    assert t_qkernel.plan(xb[:, :1152], w1004)["access_w"] == 4


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.int8])
def test_skinny_plan_fits_shared_memory_for_every_m(x_dtype):
    """Every M the skinny body takes gets a plan its source compiles: x-row
    tiles that hold M, a compiled (x-row tiles, weight bytes) pair, at most
    8 warps and 64 KB of partial sums."""
    for M in range(1, t_qkernel.SKINNY_MAX_M + 1):
        for K, N in ((1, 64), (32, 64), (33, 6912), (1152, 6912), (4608, 200)):
            p = t_qkernel.plan(torch.zeros(M, K, dtype=x_dtype),
                               torch.zeros(K, N, dtype=torch.int8))
            assert p["m_tiles"] * 8 >= M > (p["m_tiles"] // 2) * 8 or M <= 16
            assert (p["m_tiles"], p["vw"]) in {(2, 8), (2, 4), (4, 8), (4, 4),
                                               (8, 4)}
            assert p["split"] == min(8, -(-K // 16))
            assert t_qkernel.skinny_smem(p["m_tiles"], p["vw"],
                                         p["split"]) <= 65536
