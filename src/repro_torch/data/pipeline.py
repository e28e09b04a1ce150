"""Synthetic LM data pipeline (a copy of the reference's: the same numpy
draws in the same order, so a seed gives the same batches bit for bit).

Deterministic, seeded, infinite token streams with a Zipfian unigram
distribution plus short-range Markov structure (so a ~100M model actually
has something learnable — loss decreases measurably within a few hundred
steps, unlike uniform noise).  Supplies the modality-stub tensors
(patches/frames) for VLM/audio backbones.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from ..models.spec import ArchConfig


class SyntheticLM:
    """Zipf unigram + first-order Markov synthetic corpus."""

    def __init__(self, vocab: int, seed: int = 0, alpha: float = 1.1,
                 markov_order_mix: float = 0.7):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.unigram = ranks ** (-alpha)
        self.unigram /= self.unigram.sum()
        # sparse deterministic successor table: token t prefers (a t + c) % V
        self.succ = (31 * np.arange(vocab) + 17) % vocab
        self.mix = markov_order_mix

    def sample_tokens(self, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), dtype=np.int64)
        out[:, 0] = self.rng.choice(self.vocab, size=batch, p=self.unigram)
        for t in range(1, seq):
            follow = self.rng.random(batch) < self.mix
            out[:, t] = np.where(
                follow, self.succ[out[:, t - 1]],
                self.rng.choice(self.vocab, size=batch, p=self.unigram))
        return out


def batch_iterator(cfg: ArchConfig, *, batch: int, seq: int,
                   seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    src = SyntheticLM(cfg.vocab, seed=seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        toks = src.sample_tokens(batch, seq)
        out = {"tokens": toks, "labels": toks}
        if cfg.n_patches:
            out["patches"] = rng.standard_normal(
                (batch, cfg.n_patches, cfg.d_model)).astype(np.float32) * 0.02
        if cfg.encoder is not None:
            out["frames"] = rng.standard_normal(
                (batch, cfg.encoder.n_frames, cfg.d_model)) \
                .astype(np.float32) * 0.02
        yield out
