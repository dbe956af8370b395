"""Synthetic LM token pipeline (sharding-aware host feed).

Real corpora are not available offline; training/serving examples and
benchmarks use a deterministic synthetic stream with enough structure that
loss decreases (n-gram-ish Markov source), produced per-host so a
multi-host launch feeds disjoint shards (data-parallel contract).

Generation is numpy-seeded, so this copy of the reference's module yields
its batches array for array; the launcher moves them to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int = 32000
    seq_len: int = 1024
    batch_size: int = 8
    seed: int = 0
    # data-parallel feed contract
    host_id: int = 0
    num_hosts: int = 1


def _markov_row(rng: np.random.Generator, vocab: int, k: int = 32) -> np.ndarray:
    """Sparse transition row: k successors with Zipf-ish mass."""
    succ = rng.integers(0, vocab, size=k)
    w = 1.0 / np.arange(1, k + 1)
    return succ, w / w.sum()


class MarkovTokenStream:
    """Deterministic pseudo-text: order-1 Markov chain over a hashed
    transition table (no O(vocab^2) storage)."""

    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(
            cfg.seed * 1_000_003 + cfg.host_id
        )

    def _step(self, tok: np.ndarray) -> np.ndarray:
        # hash token -> per-token rng -> next token; vectorized
        h = (tok.astype(np.uint64) * np.uint64(2654435761)) % np.uint64(2**31)
        u = self._rng.random(tok.shape)
        # mix hashed successor with occasional random jump (temperature)
        succ = ((h + np.uint64(1)) * np.uint64(48271)) % np.uint64(
            self.cfg.vocab_size
        )
        jump = self._rng.integers(0, self.cfg.vocab_size, tok.shape)
        return np.where(u < 0.85, succ.astype(np.int64), jump).astype(np.int32)

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        cfg = self.cfg
        tok = self._rng.integers(
            0, cfg.vocab_size, size=(cfg.batch_size,), dtype=np.int32
        )
        while True:
            seq = np.empty((cfg.batch_size, cfg.seq_len + 1), dtype=np.int32)
            seq[:, 0] = tok
            for t in range(1, cfg.seq_len + 1):
                seq[:, t] = self._step(seq[:, t - 1])
            tok = seq[:, -1]
            yield seq[:, :-1], seq[:, 1:]  # (inputs, targets)


def make_batch(
    vocab_size: int, batch: int, seq: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot batch for tests/benchmarks."""
    cfg = TokenStreamConfig(
        vocab_size=vocab_size, seq_len=seq, batch_size=batch, seed=seed
    )
    return next(MarkovTokenStream(cfg).batches())
