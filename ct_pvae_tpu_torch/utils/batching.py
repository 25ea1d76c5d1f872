"""Host-side index streams (copy of ``ct_pvae_tpu/utils/batching.py``).

``IndexStream`` reproduces the reference's shuffle-repeat-batch
(drop_remainder) pipelines with an explicit numpy seed.  It is pure numpy
and kept bitwise identical to the JAX package's, so the port draws the same
batch and angle index sequence from the same seed.
"""

from __future__ import annotations

import numpy as np


class IndexStream:
    """Infinite shuffled batches of ``arange(n)`` with drop_remainder."""

    def __init__(self, n: int, batch: int, seed: int = 0, shuffle: bool = True):
        if batch > n:
            raise ValueError(f"batch {batch} > population {n}")
        self.n = n
        self.batch = batch
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(n)
        self._pos = n  # trigger reshuffle on first call

    def _advance(self) -> int:
        if self._pos + self.batch > self.n:
            if self.shuffle:
                self._order = self._rng.permutation(self.n)
            self._pos = 0
        self._pos += self.batch
        return self._pos - self.batch

    def next(self) -> np.ndarray:
        pos = self._advance()
        return self._order[pos : pos + self.batch].astype(np.int32)

    def skip(self, k: int) -> None:
        """Advance past ``k`` draws, replaying the RNG (elastic resume)."""
        for _ in range(k):
            self._advance()
