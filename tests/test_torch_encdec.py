"""The port's audio family (whisper-small: a bidirectional encoder over the
stub frontend's frames, a causal decoder with cross-attention to it)
against the JAX reference, from the model through serving, diffusion-LM
sampling and training, on the same params and inputs (the shared checks
and the params of `tests/test_torch_vlm.py`).

Configs are `reduced()`: 2 encoder and 2 decoder layers, 32 frames (and 3
+ 3 layers). fp32 on the CPU, where the attention op is its plain
version; tolerances 1e-5 relative L-inf, the loss 1e-6 relative, each
gradient leaf 1e-5 relative L2, five `train()` steps within 1e-5; greedy
tokens equal. `sinusoids` is not bit-equal to the reference's: the port
rounds each step of a float64 computation to fp32 (correctly rounded, the
same on every device), while XLA's fp32 exp is 1 ulp off the correctly
rounded value in 41 of whisper's 384 frequencies (measured), so each
position p of the table may differ by p ulps of its frequency plus one
ulp of the sine: at most 4.8e-7 over the reduced 32 frames, 1.2e-4 over
the full 1500 (measured; the tests hold that bound). The `gpu` tests
(skipped without a card) hold flash_attention and its backward at the
encoder's S 1500 (a ragged last tile) and the decoder's cross-attention
over 1500 frames against their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as j_api
from repro.models import encdec as j_encdec
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import api as t_api
from repro_torch.models import encdec as t_encdec
from test_torch_token_models import _rel, _t, _tokens
from test_torch_vlm import (LOSS_TOL, TOL, _jb, _tb, card_attention_case,
                            check_ar_loss_and_grads, check_batches,
                            check_clis, check_configs_and_trees,
                            check_decode_matches_forward,
                            check_diffusion_loss_and_grads,
                            check_engine_sampling, check_eps_network,
                            check_prefill_and_decode, check_remat,
                            check_sample_refuses, check_serve_greedy,
                            check_train_five_steps, check_weights_kept_once,
                            cond_inputs, family_params, token_batch)

torch.set_num_threads(2)

ARCH = "whisper-small"
DEPTHS = [{}, dict(num_layers=3, encoder_layers=3)]
DEPTH_IDS = ["2+2", "3+3"]


@pytest.mark.parametrize("length,d", [(32, 128), (448, 768), (1500, 768)])
def test_sinusoids_within_the_frequencies_ulps(length, d):
    """The table against the reference's: each frequency within 1 ulp,
    each entry within position x ulp(frequency) (the angles' distance)
    plus ulp(angle) (each side's rounding of its product) plus 2^-23 (each
    side's sine or cosine within an ulp at |x| <= 1); within the last two
    where the frequencies agree."""
    import math

    want = np.asarray(j_encdec.sinusoids(length, d), np.float64)
    got = t_encdec.sinusoids(length, d)
    assert got.dtype == torch.float32 and got.shape == (length, d)
    got = got.numpy().astype(np.float64)
    half = d // 2
    jf = np.asarray(jnp.exp(-math.log(10000.0) * jnp.arange(half)
                            / (half - 1)))
    tf = np.asarray(t_encdec._fp32(torch.exp(t_encdec._fp32(t_encdec._fp32(
        t_encdec._NEG_LOG_1E4 * torch.arange(half, dtype=torch.float64))
        / (half - 1)))).to(torch.float32))
    ulps = np.abs(jf.view(np.int32).astype(np.int64)
                  - tf.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    pos = np.arange(length, dtype=np.float32)[:, None]
    ang = pos * jf[None]
    own = np.spacing(np.abs(ang)).astype(np.float64) + 2.0**-23
    bound = pos * np.spacing(np.abs(jf)).astype(np.float64)[None] + own
    err = np.abs(got - want)
    assert (err <= np.concatenate([bound, bound], axis=1)).all()
    same = np.concatenate([ulps == 0, ulps == 0])
    assert (err[:, same] <= np.concatenate([own, own], axis=1)[:, same]).all()
    assert err.max() <= {32: 4.8e-7, 448: 3.1e-5, 1500: 1.3e-4}[length]


def test_configs_and_param_trees_match_the_reference():
    check_configs_and_trees(ARCH, DEPTHS)
    cfg = t_get_config(ARCH)
    assert (cfg.encoder_layers, cfg.audio_frames, cfg.head_dim) == (12, 1500,
                                                                    64)


@pytest.mark.parametrize("over", DEPTHS, ids=DEPTH_IDS)
def test_encoder_matches_reference(over):
    jcfg, tcfg, jp, tp = family_params(ARCH, **over)
    frames = cond_inputs(jcfg, 2)["audio_embeds"]
    want = j_encdec.encode(jp["backbone"], jcfg, jnp.asarray(frames))
    got = t_encdec.encode(tp["backbone"], tcfg, _t(frames))
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("over", DEPTHS, ids=DEPTH_IDS)
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_reference(over, causal):
    """The encoder and decoder from tokens (causal, the AR path) and from
    input embeddings (bidirectional, the diffusion LM's)."""
    jcfg, tcfg, jp, tp = family_params(ARCH, **over)
    frames = cond_inputs(jcfg, 2)["audio_embeds"]
    toks = _tokens(jcfg, 2, 23)
    jh, jaux = j_encdec.encdec_forward(jp["backbone"], jcfg,
                                       jnp.asarray(toks), jnp.asarray(frames),
                                       causal=causal)
    th, taux = t_encdec.encdec_forward(tp["backbone"], tcfg, _t(toks).long(),
                                       _t(frames), causal=causal)
    assert _rel(th, jh) <= TOL
    assert float(taux) == float(jaux) == 0.0
    e = np.random.default_rng(12).normal(size=(2, 9, 128)).astype(np.float32)
    jh, _ = j_encdec.encdec_forward(jp["backbone"], jcfg, None,
                                    jnp.asarray(frames),
                                    inputs_embeds=jnp.asarray(e),
                                    causal=causal)
    th, _ = t_encdec.encdec_forward(tp["backbone"], tcfg, None, _t(frames),
                                    inputs_embeds=_t(e), causal=causal)
    assert _rel(th, jh) <= TOL


def test_loss_matches_reference():
    jcfg, tcfg, jp, tp = family_params(ARCH, seed=3)
    b = token_batch(tcfg)
    want = j_encdec.encdec_loss(jp["backbone"], jcfg, *_jb(b).values())
    got = t_encdec.encdec_loss(tp["backbone"], tcfg, *_tb(b).values())
    assert abs(float(got) - float(want)) <= LOSS_TOL * float(want)


@pytest.mark.parametrize("over", DEPTHS, ids=DEPTH_IDS)
@pytest.mark.parametrize("S", [13, 2])
def test_prefill_and_decode_match_reference(over, S):
    """Logits and every cache leaf (the decoder's KV caches and the cross
    K/V over the encoder output) after prefill and each of three decode
    steps."""
    assert check_prefill_and_decode(ARCH, S, **over) >= 4 * (1 + 4)


def test_decode_matches_forward():
    check_decode_matches_forward(ARCH, t_encdec.encdec_forward)


def test_init_cache_is_refused_as_the_reference_does():
    """The audio cache comes from prefill only, in both packages."""
    jcfg, tcfg, _, _ = family_params(ARCH)
    with pytest.raises(ValueError, match="comes from encdec_prefill"):
        j_api.init_cache(jcfg, 2, 8)
    with pytest.raises(ValueError, match="comes from encdec_prefill"):
        t_api.init_cache(tcfg, 2, 8)


@pytest.mark.parametrize("over", DEPTHS, ids=DEPTH_IDS)
def test_eps_network_matches_reference(over):
    check_eps_network(ARCH, **over)


def test_ar_loss_and_grads_match_reference():
    check_ar_loss_and_grads(ARCH)


def test_diffusion_lm_loss_and_grads_match_reference():
    check_diffusion_loss_and_grads(ARCH)


def test_remat_is_bit_equal():
    check_remat(ARCH)


def test_weights_kept_once_are_bit_equal_to_per_use_casts():
    check_weights_kept_once(ARCH, ("/t_mlp1", "/t_mlp2"))


def test_serve_greedy_tokens_equal_reference(monkeypatch):
    check_serve_greedy(ARCH, monkeypatch)


def test_engine_sampling_matches_reference():
    check_engine_sampling(ARCH)


def test_sample_refuses_the_audio_family(capsys):
    check_sample_refuses(ARCH, capsys)


@pytest.mark.parametrize("objective", ["ar", "diffusion"])
def test_train_five_steps_match_reference(monkeypatch, objective):
    check_train_five_steps(ARCH, objective, monkeypatch)


def test_batches_are_bit_equal():
    check_batches(ARCH)


def test_clis_serve_and_train_on_the_cpu(tmp_path, capsys):
    check_clis(ARCH, tmp_path, capsys)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# whisper at full width, cut to 2 batch rows: the encoder's non-causal
# self-attention at S 1500 (23 tiles of 64 and a ragged 28), the decoder's
# cross-attention of its 384 prompt positions and of the diffusion LM's 64
# over 1500 frames; 12 heads of 64
AUDIO_SHAPES = [(2, 12, 12, 1500, 1500, 64), (2, 12, 12, 384, 1500, 64),
                (2, 12, 12, 64, 1500, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", AUDIO_SHAPES)
def test_card_audio_attention_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, D,
                                            dtype):
    card_attention_case(cuda, B, Hq, Hkv, Sq, Skv, D, False, dtype)
