"""The rows of the traffic: ids into a session's inputs, good or bad."""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for one stream of a run, from ``--seed`` (any whole
    number) and the stream's number."""
    return np.random.default_rng([seed % (1 << 64), stream])


class RowStream:
    """Row ids in blocks of ``round(1 / bad_share)`` rows, each holding
    exactly one bad row: every seed gets the same mix of good and bad rows,
    in another order.  Good ids cycle through a seeded order of ``good``,
    bad ids through one of ``bad``, and each block is shuffled."""

    def __init__(self, gen: np.random.Generator, good, bad, bad_share: float):
        if not 0 < bad_share <= 0.5:
            raise ValueError(f"bad_share must be in (0, 0.5], got {bad_share}")
        self.gen = gen
        self.block = round(1 / bad_share)
        self.good = gen.permutation(np.asarray(good, dtype=np.int64))
        self.bad = gen.permutation(np.asarray(bad, dtype=np.int64))
        self.n_good = self.n_bad = 0
        self.pending = np.zeros(0, dtype=np.int64)

    def _next_block(self) -> np.ndarray:
        goods = self.good[(self.n_good + np.arange(self.block - 1)) % len(self.good)]
        self.n_good += self.block - 1
        bad = self.bad[self.n_bad % len(self.bad)]
        self.n_bad += 1
        return self.gen.permutation(np.append(goods, bad))

    def take(self, n: int) -> np.ndarray:
        while len(self.pending) < n:
            self.pending = np.concatenate([self.pending, self._next_block()])
        out, self.pending = self.pending[:n], self.pending[n:]
        return out
