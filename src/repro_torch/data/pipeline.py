"""Minimal batching over index arrays (numpy only), a copy of the
reference's ``repro/data/pipeline.py``: one generator gives the same
batches in both packages."""
from __future__ import annotations

from typing import Iterator

import numpy as np


class BatchIterator:
    """Epoch-shuffled minibatch iterator over index arrays."""

    def __init__(self, rng: np.random.Generator, n: int, batch_size: int):
        self.rng = rng
        self.n = n
        self.batch_size = min(batch_size, n)
        self._order = rng.permutation(n)
        self._cursor = 0

    def next_indices(self) -> np.ndarray:
        if self._cursor + self.batch_size > self.n:
            self._order = self.rng.permutation(self.n)
            self._cursor = 0
        out = self._order[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        return out


def epoch_batches(rng: np.random.Generator, n: int, batch_size: int
                  ) -> Iterator[np.ndarray]:
    """All minibatches of one shuffled epoch (drops the ragged tail)."""
    order = rng.permutation(n)
    for i in range(0, n - batch_size + 1, batch_size):
        yield order[i:i + batch_size]
