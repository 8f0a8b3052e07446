"""Synthetic token data pipeline: deterministic, shardable, infinite.

Generates structured pseudo-text (a mixture of Zipfian unigrams and
repeated n-gram motifs) so a small model's loss visibly decreases. A copy
of the JAX package's numpy pipeline (``repro/training/data.py``): batch
``i`` is the same array for the same ``(seed, i)`` in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 8
    n_motifs: int = 64
    motif_prob: float = 0.5


class SyntheticTokens:
    """Deterministic batch iterator. Batch ``i`` is reproducible from
    (seed, i) alone, so data-parallel workers can slice their shard."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._motifs = rng.integers(
            0, v, size=(cfg.n_motifs, cfg.motif_len)).astype(np.int32)

    def batch(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens int32, loss_mask f32) of shape [global_batch,
        seq_len]."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, index))
        B, S = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(B, S), p=self._probs)
        # splice in repeated motifs (learnable structure)
        n_splice = int(S * cfg.motif_prob / cfg.motif_len)
        for b in range(B):
            ids = rng.integers(0, cfg.n_motifs, size=n_splice)
            pos = rng.integers(0, max(1, S - cfg.motif_len), size=n_splice)
            for i, p in zip(ids, pos):
                toks[b, p : p + cfg.motif_len] = self._motifs[i]
        mask = np.ones((B, S), np.float32)
        return toks.astype(np.int32), mask

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1
