"""Data pipeline: memmap token corpus + background-prefetch loader.

The prefetch thread double-buffers host batches so device compute never
waits on the data path (straggler mitigation at the input layer); shard-
aware slicing gives each data-parallel rank a disjoint stream.

The JAX package's ``repro.data.pipeline``, copied: it is numpy and threads
only, and ``synthesize_corpus`` writes the same bytes in both packages.
"""
from __future__ import annotations

import os
import queue
import threading

import numpy as np


def synthesize_corpus(path: str, n_tokens: int, vocab: int, seed: int = 0) -> str:
    """Deterministic Zipf-ish synthetic corpus (int32 memmap)."""
    if not os.path.exists(path):
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        toks = rng.choice(vocab, size=n_tokens, p=probs).astype(np.int32)
        tmp = path + ".tmp"
        toks.tofile(tmp)
        os.replace(tmp, path)
    return path


class TokenDataset:
    def __init__(self, path: str, seq_len: int):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len = seq_len
        self.n_seqs = len(self.tokens) // seq_len

    def batch(self, step: int, batch_size: int, *, rank: int = 0,
              world: int = 1) -> np.ndarray:
        """Deterministic batch for (step, rank): restart-safe."""
        idx = (step * batch_size * world + rank * batch_size
               + np.arange(batch_size)) % self.n_seqs
        out = np.empty((batch_size, self.seq_len), np.int32)
        for i, s in enumerate(idx):
            out[i] = self.tokens[s * self.seq_len:(s + 1) * self.seq_len]
        return out


class PrefetchLoader:
    """Background thread keeps ``depth`` batches ready."""

    def __init__(self, dataset: TokenDataset, batch_size: int, *,
                 start_step: int = 0, rank: int = 0, world: int = 1,
                 depth: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            b = self.dataset.batch(step, self.batch_size, rank=self.rank,
                                   world=self.world)
            try:
                self._q.put((step, b), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
