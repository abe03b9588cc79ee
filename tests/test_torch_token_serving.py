"""The port's token serving and diffusion-LM sampling against the JAX
reference, on the same params and inputs.

* `prefill` and `decode_step`: last-position logits and the stacked KV
  caches within 1e-5 for every ported arch, decoding several steps, with
  the full cache and the rolling one (a `sliding_window` override, the
  prompt both longer and shorter than the window); prefill then decode
  equal to the full forward (the reference's `test_decode_matches_forward`);
* `launch.serve.serve(device="cpu")`: greedy tokens EQUAL to the
  reference's `serve` on the same params and prompts (monkeypatched into
  the reference's, which draws its own), for every ported arch;
* `launch.sample.sample` of a token arch with an explicit x_T against the
  reference's engine (<= 1e-5), and against the port's own python loop;
* the CLIs' token surfaces and the reference's refusals of the
  diffusion-only flags;
* on the card (`gpu`, skipped here): a graphed decode bit-equal to the
  eager one, and the attention kernel at the token paths' shapes against
  its plain version.

Params are the reference's `init_params`, perturbed (the helper of
`tests/test_torch_token_models.py`). The reference's prompts come from a
`TokenStream` whose block seed is Python's string hash, and its seeded
draws (init, x_T, temperature sampling) cannot be reproduced: prompts,
params and x_T are passed explicitly and only greedy decoding is held
across the frameworks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import VPLinear as JVP
from repro.engine import EngineSpec as JSpec
from repro.launch import serve as j_serve
from repro.launch.sample import build_engine as j_build_engine
from repro.models import api as j_api
from repro.models import transformer as j_tf
from repro_torch.launch import sample as t_sample
from repro_torch.launch import serve as t_serve
from repro_torch.models import api as t_api
from repro_torch.models import transformer as t_tf
from test_torch_token_models import (TOKEN_ARCHS, _rel, _t, _tokens,
                                     reference_params)

torch.set_num_threads(2)

TOL = 1e-5


def _decode_both(arch, S, max_len, steps, **over):
    """Prefill S tokens, then decode `steps` more in both frameworks; yields
    (label, port, reference) pairs of logits and caches."""
    jcfg, tcfg, jp, tp = reference_params(arch, **over)
    toks = _tokens(jcfg, 2, S + steps)
    jl, jc = j_api.prefill_fn(jcfg)(jp, {"tokens": jnp.asarray(toks[:, :S])},
                                    max_len)
    tl, tc = t_api.prefill_fn(tcfg)(tp, {"tokens": _t(toks[:, :S]).long()},
                                    max_len)
    yield "prefill logits", tl, jl
    for name in ("k", "v"):
        yield f"prefill cache {name}", tc[name], jc[name]
    for i in range(steps):
        tok = toks[:, S + i:S + i + 1]
        jl, jc = j_api.decode_fn(jcfg)(jp, jc, jnp.asarray(tok),
                                       jnp.int32(S + i))
        tl, tc = t_api.decode_fn(tcfg)(tp, tc, _t(tok).long(), S + i)
        yield f"decode {i} logits", tl, jl
        for name in ("k", "v"):
            yield f"decode {i} cache {name}", tc[name], jc[name]


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    for label, got, want in _decode_both(arch, S=10, max_len=14, steps=3):
        assert got.shape == want.shape, label
        assert _rel(got, want) <= TOL, label


@pytest.mark.parametrize("S,window", [(12, 8), (16, 8), (5, 8), (8, 8)])
def test_rolling_cache_matches_reference(S, window):
    """A sliding-window override: the rolling cache of W = min(window,
    max_len) slots, the prompt at least W (its tail placed at position mod
    W) and shorter than W (zero-padded), then decode steps wrapping
    around."""
    for label, got, want in _decode_both("qwen2-0.5b", S=S, max_len=S + 6,
                                         steps=4, sliding_window=window):
        assert got.shape[2 if "cache" in label else 1] == (
            window if "cache" in label else 1), label
        assert _rel(got, want) <= TOL, label


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmo-1b", "mixtral-8x7b",
                                  "granite-moe-3b-a800m"])
def test_decode_matches_forward(arch):
    """prefill(t[:S]) then decode(t[S]) equals the full forward's logits at
    S (the reference's test, here at fp32 to 1e-5); MoE with ample
    capacity, so the scatter dispatch drops no token."""
    _, tcfg, _, tp = reference_params(arch, capacity_factor=8.0)
    S = 17
    toks = _t(_tokens(tcfg, 2, S + 1)).long()
    hidden, _ = t_tf.forward(tp["backbone"], tcfg, toks)
    want = t_tf.logits_from_hidden(tp["backbone"], tcfg, hidden)[:, S]
    _, cache = t_api.prefill_fn(tcfg)(tp, {"tokens": toks[:, :S]}, S + 4)
    got, _ = t_api.decode_fn(tcfg)(tp, cache, toks[:, S:S + 1], S)
    assert _rel(got[:, 0], want) <= TOL


def test_init_cache_matches_reference():
    jcfg, tcfg, _, _ = reference_params("mixtral-8x7b", sliding_window=6)
    want = j_api.init_cache(jcfg, 3, 20)
    got = t_api.init_cache(tcfg, 3, 20)
    assert got["k"].shape == want["k"].shape == (2, 3, 6, 2, 32)
    assert not got["k"].any() and got["v"].dtype == torch.float32


class _Prompts:
    """Stands in for the reference serve's TokenStream: block(0) is the
    given prompts."""

    def __init__(self, tokens):
        self.tokens = tokens

    def __call__(self, *args, **kwargs):
        return self

    def block(self, index):
        return {"tokens": self.tokens}


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_serve_greedy_tokens_equal_reference(arch, monkeypatch):
    jcfg, tcfg, jp, tp = reference_params(arch)
    prompts = _tokens(jcfg, 3, 9, seed=20)
    monkeypatch.setattr(j_serve.api, "init_params", lambda cfg, rng: jp)
    monkeypatch.setattr(j_serve, "TokenStream", _Prompts(prompts))
    want = j_serve.serve(arch, batch=3, prompt_len=9, gen=6)
    got = t_serve.serve(arch, batch=3, prompt_len=9, gen=6, device="cpu",
                        params=tp, prompts=prompts)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)


def test_serve_decode_loop_is_the_decode_step_loop():
    """serve's decoder (static token / pos buffers, the cache in place) and
    its token choice give what a plain loop of decode_fn gives; temperature
    sampling is deterministic in the seed and in range."""
    _, tcfg, _, tp = reference_params("granite-moe-3b-a800m")
    prompts = _tokens(tcfg, 2, 7, seed=21)
    run = t_serve.serve("granite-moe-3b-a800m", batch=2, prompt_len=7, gen=5,
                        device="cpu", params=tp, prompts=prompts,
                        return_run=True)
    assert not run.decoder.graphed and run.decoder.graph is None
    logits, cache = t_api.prefill_fn(tcfg)(
        tp, {"tokens": _t(prompts).long()}, 12)
    assert torch.equal(logits, run.prefill_logits)
    toks = []
    tok = torch.argmax(logits[:, -1], -1)
    for i in range(5):
        toks.append(tok)
        logits, cache = t_api.decode_fn(tcfg)(tp, cache, tok[:, None], 7 + i)
        tok = torch.argmax(logits[:, -1], -1)
    np.testing.assert_array_equal(run.tokens, torch.stack(toks, 1).numpy())
    hot = [t_serve.serve("granite-moe-3b-a800m", batch=2, prompt_len=7,
                         gen=5, temperature=0.9, seed=s, device="cpu",
                         params=tp, prompts=prompts) for s in (3, 3)]
    np.testing.assert_array_equal(hot[0], hot[1])
    assert hot[0].min() >= 0 and hot[0].max() < tcfg.vocab_size


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-3b-a800m"])
def test_sample_matches_reference_engine(arch):
    """UniPC-3 on the diffusion-LM eps-net (out_proj perturbed): the port's
    `sample` with an explicit x_T against the reference's engine on the
    same params, and against the port's own python loop."""
    jcfg, tcfg, jp, tp = reference_params(arch)
    x_T = np.random.default_rng(22).normal(
        size=(2, 64, jcfg.latent_dim)).astype(np.float32)
    assert t_sample.latent_shape(tcfg, 2) == x_T.shape
    engine = j_build_engine(jcfg, jp, JVP(), 2)
    want = np.asarray(engine.build(JSpec(solver="unipc", nfe=6, order=3))(
        jnp.asarray(x_T)))
    got = t_sample.sample(arch, nfe=6, batch=2, params=tp, x_T=x_T,
                          device="cpu")
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert _rel(got, want) <= TOL
    loop = t_sample.sample(arch, nfe=6, batch=2, params=tp, x_T=x_T,
                           loop=True, device="cpu")
    assert _rel(loop, got) <= TOL


def test_sample_refuses_what_a_token_arch_has_not(capsys):
    _, _, _, tp = reference_params("olmo-1b")
    with pytest.raises(ValueError, match="dit family"):
        t_sample.sample("olmo-1b", cfg_scale=2.0, params=tp, device="cpu")
    with pytest.raises(ValueError, match="dit family"):
        t_sample.sample("olmo-1b", quant="w8a16", params=tp, device="cpu")
    for flags in (["--cfg-scale", "2.0"], ["--quant", "w8a16"]):
        with pytest.raises(SystemExit):
            t_sample.main(["--arch", "olmo-1b", "--device", "cpu"] + flags)
    with pytest.raises(SystemExit):
        t_sample.main(["--arch", "whisper-small", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "audio_embeds" in err and "fails there too" in err
    out = t_sample.main(["--arch", "qwen2-0.5b", "--device", "cpu",
                         "--nfe", "3", "--batch", "2"])
    assert out.shape == (2, 64, 32) and np.isfinite(out).all()


@pytest.mark.parametrize("flags", [
    ["--cfg-scale", "2.0"], ["--arrival-rate", "0.5"], ["--tiers", "fast"],
    ["--eval-dtype", "bfloat16"], ["--quant", "w8a16"],
    ["--pipeline-depth", "3"], ["--probe-fraction", "0.5"],
    ["--max-retries", "1"], ["--inject-faults", "meta:tick=2"]])
def test_serve_cli_refuses_diffusion_flags_for_token_archs(flags, capsys):
    with pytest.raises(SystemExit):
        t_serve.main(["--arch", "qwen2-0.5b", "--device", "cpu"] + flags)
    assert "family 'dense'" in capsys.readouterr().err


def test_serve_cli_decodes_a_token_arch_on_the_cpu(capsys):
    out = t_serve.main(["--arch", "qwen2-0.5b", "--batch", "2",
                        "--prompt-len", "12", "--gen", "4", "--device",
                        "cpu"])
    assert out.shape == (2, 4) and out.dtype == np.int32
    assert "token [cpu] qwen2-0.5b: prefill" in capsys.readouterr().out
    out = t_serve.main(["--arch", "whisper-small", "--batch", "2",
                        "--prompt-len", "6", "--gen", "3", "--device",
                        "cpu"])
    assert out.shape == (2, 3) and out.dtype == np.int32
    assert "token [cpu] whisper-small: prefill" in capsys.readouterr().out
    with pytest.raises(ValueError, match="serve_diffusion"):
        t_serve.serve("dit-cifar", device="cpu")
    with pytest.raises(ValueError, match="serve\\(\\) decodes"):
        t_serve.serve_diffusion("qwen2-0.5b", device="cpu")


def test_token_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.serve("qwen2-0.5b", batch=1, prompt_len=4, gen=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.main(["--arch", "olmo-1b", "--batch", "1", "--gen", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_sample.sample("granite-moe-3b-a800m", nfe=2, batch=1)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-3b-a800m"])
def test_card_graph_decode_is_bit_equal_to_eager(cuda, arch, monkeypatch):
    """The decode step as a CUDA graph replay against the eager step, bf16
    activations over the weights kept once, a reduced config at full head
    widths (patched into serve as its full config); the replayed loop
    makes no host sync."""
    cfg = t_serve.get_config(arch).reduced(dtype="bfloat16", head_dim=64)
    monkeypatch.setattr(t_serve, "get_config", lambda a: cfg)
    params = t_api.init_params(cfg, 0, cuda)
    prompts = _tokens(cfg, 4, 33, seed=23)
    kw = dict(reduced=False, batch=4, prompt_len=33, gen=12, device=cuda,
              params=params, prompts=prompts)
    eager = t_serve.serve(arch, jit=False, **kw)
    run = t_serve.serve(arch, return_run=True, **kw)
    assert run.decoder.graph is not None
    np.testing.assert_array_equal(run.tokens, eager)
    torch.cuda.set_sync_debug_mode("error")
    try:
        run.decoder.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)


ATTENTION_SHAPES = [  # B, Hq, Hkv, S, D, causal, window: the token paths'
    (2, 14, 2, 512, 64, True, None),      # qwen2 prefill, group 7
    (2, 14, 2, 64, 64, False, None),      # qwen2 diffusion LM
    (2, 24, 8, 256, 64, True, None),      # granite prefill
    (2, 16, 16, 512, 128, True, None),    # olmo prefill
    (2, 14, 2, 300, 64, True, 64),        # a sliding window, group 7
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,window", ATTENTION_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_attention_at_token_shapes_matches_plain(cuda, B, Hq, Hkv, S, D,
                                                      causal, window, dtype):
    from repro_torch.kernels.flash_attention import ops as fa_ops

    g = torch.Generator(device=cuda).manual_seed(S + D)
    # q/k/v as the models hand them over: head-major views of (B, S, H, D)
    q = torch.randn(B, S, Hq, D, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    got = fa_ops.attention(*args, causal=causal, window=window)
    want = fa_ops.attention(*args, causal=causal, window=window,
                            backend="plain")
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert _rel(got.float().cpu(), want.float().cpu()) <= tol
