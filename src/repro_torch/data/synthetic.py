"""Synthetic data pipeline (the port's own copy of `repro.data.synthetic`,
numpy only, bit-equal to it; no real corpora or image sets are used).

Deterministic, seekable streams so training is reproducible and resumable:

* `TokenStream` — a Zipf-ish Markov token source with bin-packing into fixed
  (tokens, targets) blocks; statistically non-trivial (learnable bigram
  structure) so train-loss decreases measurably in examples/.
* `latent_images` — smooth random-field latents for DiT training.
* `stub_embeds` — the modality-frontend stand-ins (audio frames / image
  patches) required by the [audio]/[vlm] carve-out.
"""

from __future__ import annotations

import numpy as np


class TokenStream:
    """Markov-chain token generator with packing. Seekable via block index."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int, seed: int = 0,
                 branching: int = 32):
        self.V = vocab_size
        self.S = seq_len
        self.B = batch
        rng = np.random.default_rng(seed)
        # sparse bigram table: each token can be followed by `branching` tokens
        self.next_tokens = rng.integers(0, vocab_size,
                                        size=(vocab_size, branching))
        probs = rng.dirichlet(0.5 * np.ones(branching), size=vocab_size)
        self.cum_probs = np.cumsum(probs, axis=-1)

    def block(self, index: int):
        """Return dict(tokens (B, S), targets (B, S)) for a block index."""
        rng = np.random.default_rng(hash(("block", index)) % (2**63))
        seq = np.empty((self.B, self.S + 1), np.int64)
        seq[:, 0] = rng.integers(0, self.V, size=self.B)
        u = rng.random((self.B, self.S))
        for s in range(self.S):
            cur = seq[:, s]
            choice = (u[:, s, None] < self.cum_probs[cur]).argmax(-1)
            seq[:, s + 1] = self.next_tokens[cur, choice]
        return {"tokens": seq[:, :-1].astype(np.int32),
                "targets": seq[:, 1:].astype(np.int32)}

    def __iter__(self):
        i = 0
        while True:
            yield self.block(i)
            i += 1


def latent_images(batch: int, tokens: int, latent_dim: int, seed: int = 0):
    """Smooth random-field latents in [-1, 1] (stand-in for VAE latents)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(batch, tokens, latent_dim))
    # smooth along the token axis (images have local structure)
    k = np.array([0.25, 0.5, 0.25])
    sm = np.apply_along_axis(lambda a: np.convolve(a, k, mode="same"), 1, base)
    return np.tanh(1.5 * sm).astype(np.float32)


def stub_embeds(batch: int, tokens: int, d_model: int, seed: int = 0):
    """Frontend-stub embeddings (audio frames / image patches)."""
    rng = np.random.default_rng(seed)
    return (0.02 * rng.normal(size=(batch, tokens, d_model))).astype(np.float32)


def frontend_embeds(cfg, batch: int, seed: int = 0) -> dict:
    """The stub inputs a family's frontend would give, as the reference's
    serve and train draw them: a vlm's `image_embeds` (batch, image_tokens,
    d_model), an audio model's `audio_embeds` (batch, audio_frames,
    d_model), from `stub_embeds(..., seed)`; {} for the other families."""
    if cfg.family == "vlm":
        return {"image_embeds": stub_embeds(batch, cfg.image_tokens,
                                            cfg.d_model, seed)}
    if cfg.family == "audio":
        return {"audio_embeds": stub_embeds(batch, cfg.audio_frames,
                                            cfg.d_model, seed)}
    return {}


def class_ids(batch: int, num_classes: int = 1000, seed: int = 0):
    return np.random.default_rng(seed).integers(
        0, num_classes, size=(batch,)).astype(np.int32)
