"""Deterministic sharded synthetic LM data pipeline (numpy).

Every batch is a pure function of ``(seed, step)`` — the property that makes
checkpoint/restart replay exact and lets any host regenerate any shard
without coordination (the scalable analogue of a deterministic tf.data
pipeline keyed by step).

Tokens follow a Zipfian unigram draw with a short Markov mixing term so the
loss actually decreases during the example runs (pure-uniform tokens give a
flat loss).  ``labels`` are next-token targets with the final position
masked (-1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    markov_order: int = 0      # >0 adds deterministic structure for learnability


class SyntheticLM:
    """Callable pipeline: ``pipeline(step) -> {"tokens", "labels"}``."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf over an effective vocab (cap avoids numerical tail issues)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.probs = p / p.sum()

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, 0xD5EC])
        )

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = self._rng(step)
        tok = rng.choice(cfg.vocab_size, size=(cfg.global_batch, cfg.seq_len + 1),
                         p=self.probs).astype(np.int32)
        if cfg.markov_order > 0:
            # deterministic mixing: token_t depends on token_{t-1} half the time
            mix = rng.random((cfg.global_batch, cfg.seq_len + 1)) < 0.5
            shifted = np.roll((tok * 7 + 3) % cfg.vocab_size, 1, axis=1)
            tok = np.where(mix, shifted, tok).astype(np.int32)
        tokens = tok[:, :-1]
        labels = tok[:, 1:].copy()
        labels[:, -1] = -1
        return {"tokens": tokens, "labels": labels}

    def __call__(self, step: int) -> dict:
        return self.batch(step)

    def shard(self, step: int, rank: int, world: int) -> dict:
        """Per-host slice of the global batch (layout identical on any host)."""
        b = self.batch(step)
        n = self.cfg.global_batch
        assert n % world == 0, (n, world)
        k = n // world
        return {k2: v[rank * k:(rank + 1) * k] for k2, v in b.items()}


class SyntheticEncDec(SyntheticLM):
    """Adds precomputed encoder frame embeddings (the audio-frontend stub)."""

    def __init__(self, cfg: DataConfig, n_frames: int, d_model: int):
        super().__init__(cfg)
        self.n_frames = n_frames
        self.d_model = d_model

    def batch(self, step: int) -> dict:
        out = super().batch(step)
        rng = self._rng(step + 1_000_003)
        out["embeds"] = rng.standard_normal(
            (self.cfg.global_batch, self.n_frames, self.d_model)
        ).astype(np.float32) * 0.02
        return out


class SyntheticVLM(SyntheticLM):
    """Precomputed patch/text embeddings + (B, 3, S) M-RoPE position streams."""

    def __init__(self, cfg: DataConfig, d_model: int):
        super().__init__(cfg)
        self.d_model = d_model

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        out = super().batch(step)
        rng = self._rng(step + 2_000_003)
        out["embeds"] = rng.standard_normal(
            (cfg.global_batch, cfg.seq_len, self.d_model)
        ).astype(np.float32) * 0.02
        pos = np.broadcast_to(
            np.arange(cfg.seq_len, dtype=np.int32)[None, None, :],
            (cfg.global_batch, 3, cfg.seq_len),
        ).copy()
        out["positions"] = pos
        del out["tokens"]
        return out


def pipeline_for(cfg_model, shape, *, seed: int = 0, markov: bool = True):
    """Pick the right pipeline family for an arch."""
    dcfg = DataConfig(
        vocab_size=cfg_model.vocab_size,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        seed=seed,
        markov_order=1 if markov else 0,
    )
    if cfg_model.family == "audio":
        return SyntheticEncDec(dcfg, cfg_model.encoder.n_frames, cfg_model.d_model)
    if cfg_model.embeds_input:
        return SyntheticVLM(dcfg, cfg_model.d_model)
    return SyntheticLM(dcfg)
