"""Deterministic, resumable data pipeline.

Port of `repro/data/pipeline.py` (numpy only; the port keeps its own
copy). The batch at step k is a pure function of (seed, k), bitwise the
reference's: restart-after-failure resumes mid-epoch with the same
batches (the checkpoint only needs to store the step counter). Sources:
synthetic LM token streams (default) or a memory-mapped binary token
file. A background prefetch thread keeps the input pipeline off the
training critical path. Batches are numpy arrays on the host; the
launcher moves them to the device.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class TokenSource:
    """Synthetic or file-backed token stream with deterministic indexing."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, path: Optional[str] = None):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self._tokens = None
        if path is not None:
            self._tokens = np.memmap(path, dtype=np.int32, mode="r")

    def batch_at(self, step: int) -> dict:
        """Batch for a given step — pure function of (seed, step)."""
        if self._tokens is None:
            rng = np.random.default_rng((self.seed, step))
            toks = rng.integers(
                0, self.vocab, (self.global_batch, self.seq_len + 1),
                dtype=np.int32)
            # Inject n-gram structure so losses are learnable, not flat:
            # token[t] depends on token[t-1] half the time.
            dep = rng.random((self.global_batch, self.seq_len)) < 0.5
            nxt = (toks[:, :-1] * 31 + 7) % self.vocab
            toks[:, 1:] = np.where(dep, nxt, toks[:, 1:])
            return {"tokens": toks}
        n = self._tokens.shape[0]
        span = self.seq_len + 1
        per = self.global_batch
        rng = np.random.default_rng((self.seed, step))
        starts = rng.integers(0, n - span, per)
        toks = np.stack([self._tokens[s:s + span] for s in starts])
        return {"tokens": toks.astype(np.int32)}

    def shard_for(self, batch: dict, rank: int, world: int) -> dict:
        """Per-host slice of the global batch (multi-host data loading)."""
        def sl(x):
            per = x.shape[0] // world
            return x[rank * per:(rank + 1) * per]
        return {k: sl(v) for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of upcoming batches (depth-bounded)."""

    def __init__(self, source: TokenSource, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
