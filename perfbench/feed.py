"""The token feed the harness makes from `--seed` and hands to both sides.

A fresh (batch, seq) batch of ids each step, uniform over the vocabulary,
drawn on the host by numpy; a dense model's speed does not depend on the ids.
The reference makes the first batches again from the seed alone. The
weights are the model kind's (`perfbench/layouts/<kind>.py`).
"""

from __future__ import annotations

import numpy as np


class Tokens:
    """The step feed: batch after batch of (batch, seq) int64 ids on the
    host, the same sequence for the same seed."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int):
        self._rng = np.random.default_rng([int(seed), 1])
        self.shape, self.vocab = (batch, seq), vocab

    def next(self) -> np.ndarray:
        return self._rng.integers(0, self.vocab, self.shape, dtype=np.int64)


def first_batches(seed: int, batch: int, seq: int, vocab: int, n: int) -> list:
    """The first `n` batches of the feed of `seed`."""
    feed = Tokens(seed, batch, seq, vocab)
    return [feed.next() for _ in range(n)]
