"""The one traffic generator: it reads a mix's parameters and the seed.

``closed_loop``: the mix's ``clients`` callers each send their next
invocation when the last returns. The invocations come from one sequence,
the same for every run of a seed: blocks of ``block`` invocations, each of
``batch`` sequences of one length, the lengths in the mix's exact
proportions (largest remainder) within every block and shuffled by the
seed. So every seed gets the same work in another order, and runs with
different seeds differ only as two runs of one seed do, whatever number
of invocations a window completes.

Tokens are uniform over the vocabulary, drawn from the seed.
"""
from __future__ import annotations

import threading

import numpy as np


def _counts(weights: list[float], n: int) -> list[int]:
    """``n`` split in proportion to ``weights`` by largest remainder."""
    w = np.asarray(weights, dtype=np.float64)
    share = w / w.sum() * n
    out = np.floor(share).astype(int)
    for i in np.argsort(-(share - out), kind="stable")[: n - int(out.sum())]:
        out[i] += 1
    return out.tolist()


def tokens(rng: np.random.Generator, vocab: int, batch: int, length: int) -> np.ndarray:
    return rng.integers(0, vocab, (batch, length), dtype=np.int32)


class Sequence:
    """The invocations of a closed loop, in the order the callers take
    them: ``next()`` gives ``(k, tokens)`` for k = 0, 1, ...; safe to call
    from several threads, and the same for every run of a seed."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.vocab = mix, vocab
        self.order = np.random.default_rng([seed, 0])      # the lengths
        self.draw = np.random.default_rng([seed, 2])       # the tokens
        self.block = np.repeat(mix["lengths"], _counts(mix["weights"], mix["block"]))
        self.lengths: list[int] = []
        self.k = 0
        self.lock = threading.Lock()

    def length(self, k: int) -> int:
        """The length of invocation ``k``; draws the blocks up to it."""
        while len(self.lengths) <= k:
            self.lengths += self.order.permutation(self.block).tolist()
        return int(self.lengths[k])

    def next(self) -> tuple[int, np.ndarray]:
        with self.lock:
            k = self.k
            self.k += 1
            L = self.length(k)
            return k, tokens(self.draw, self.vocab, self.mix["batch"], L)


def sample(mix: dict, seed: int) -> set:
    """The invocations whose outputs are checked: the first of the longest
    length, and ``sample - 1`` others drawn from the seed among the first
    ``sample_span`` (which every run completes)."""
    seq = Sequence(mix, seed, 1)
    lengths = [seq.length(k) for k in range(mix["sample_span"])]
    first = lengths.index(max(mix["lengths"]))
    others = [k for k in range(mix["sample_span"]) if k != first]
    rng = np.random.default_rng([seed, 1])
    return {first, *rng.choice(others, size=mix["sample"] - 1, replace=False).tolist()}
