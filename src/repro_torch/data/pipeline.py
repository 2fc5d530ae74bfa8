"""Synthetic deterministic data pipeline: a copy of
``repro.data.pipeline`` (numpy only), so that the port imports nothing of
the JAX package.  For a seed it yields the reference's batches.

Offline container ⇒ no real corpora; the pipeline produces a deterministic
token stream with realistic statistics (Zipfian unigram mix + short-range
repetition so the loss is learnable), sharded per host, packed into fixed
(batch, seq) blocks, with a simple background-prefetch iterator.  The
interface (``batches()``) is what a real corpus loader would implement.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    repeat_p: float = 0.35  # P(copy a recent token) — gives learnable structure
    repeat_window: int = 16


class SyntheticTokens:
    """Deterministic, restartable synthetic token source."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.host_batch = cfg.global_batch // n_hosts
        self._rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, host_id])
        )
        # Zipfian unigram distribution over the vocab (stable across hosts).
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()

    def _sample_block(self) -> np.ndarray:
        cfg = self.cfg
        shape = (self.host_batch, cfg.seq_len)
        base = self._rng.choice(cfg.vocab, size=shape, p=self._probs)
        # Introduce short-range copies: tokens repeat from a recent window.
        rep = self._rng.random(shape) < cfg.repeat_p
        offsets = self._rng.integers(1, cfg.repeat_window + 1, size=shape)
        idx = np.arange(cfg.seq_len)[None, :] - offsets
        np.clip(idx, 0, None, out=idx)
        rows = np.arange(self.host_batch)[:, None]
        base = np.where(rep & (idx >= 0), base[rows, idx], base)
        return base.astype(np.int32)

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield {"tokens": self._sample_block()}


class Prefetcher:
    """Background-thread prefetch (host → device overlap stand-in)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def make_pipeline(
    cfg: DataConfig,
    host_id: int = 0,
    n_hosts: int = 1,
    prefetch: int = 2,
) -> Iterator[Dict[str, np.ndarray]]:
    src = SyntheticTokens(cfg, host_id, n_hosts)
    it = src.batches()
    return Prefetcher(it, depth=prefetch) if prefetch else it
