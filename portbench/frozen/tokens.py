"""A frozen copy of the port's synthetic token stream
(``repro_torch/data/tokens.py``, ``MarkovTokenStream``): an order-1
Markov chain over a hashed transition table, numpy-seeded, which the LM
launcher trains on.  Kept here with the same arithmetic, so the LM cells'
tokens stay what they are whatever the program does to its own copy."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class MarkovTokenStream:
    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, host_id: int = 0):
        self.vocab_size, self.seq_len, self.batch_size = (
            vocab_size, seq_len, batch_size)
        self._rng = np.random.default_rng(seed * 1_000_003 + host_id)

    def _step(self, tok: np.ndarray) -> np.ndarray:
        h = (tok.astype(np.uint64) * np.uint64(2654435761)) % np.uint64(2**31)
        u = self._rng.random(tok.shape)
        succ = ((h + np.uint64(1)) * np.uint64(48271)) % np.uint64(
            self.vocab_size)
        jump = self._rng.integers(0, self.vocab_size, tok.shape)
        return np.where(u < 0.85, succ.astype(np.int64), jump).astype(np.int32)

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Endless (inputs, targets) pairs of (batch, seq_len) int32."""
        tok = self._rng.integers(0, self.vocab_size, size=(self.batch_size,),
                                 dtype=np.int32)
        while True:
            seq = np.empty((self.batch_size, self.seq_len + 1), dtype=np.int32)
            seq[:, 0] = tok
            for t in range(1, self.seq_len + 1):
                seq[:, t] = self._step(seq[:, t - 1])
            tok = seq[:, -1]
            yield seq[:, :-1], seq[:, 1:]
