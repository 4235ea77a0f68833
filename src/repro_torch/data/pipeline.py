"""Deterministic, resumable, shardable data pipeline: the port's own copy
of the JAX package's ``data/pipeline.py`` (numpy only), so that the port
imports nothing of that package.  Batches are bit-equal to the
reference's for every seed, step and host shard.

Production features the trainer relies on:

* **Deterministic indexing** — sample content is a pure function of
  (seed, step, index); restarting from a checkpoint replays the exact
  stream from the recorded step, so fault recovery is bit-exact.
* **Shardable** — each data-parallel host reads only its slice
  (``host_id / num_hosts``); no coordination needed.
* **Prefetch** — a small background thread keeps ``prefetch`` batches ahead
  (a bounded queue; the trainer moves each batch to the device itself).

``SyntheticLM`` generates token streams with a Zipfian unigram distribution
plus Markov bigram structure — enough signal for loss-goes-down smoke
training without external data.  A memmap-backed corpus source with the
same interface is provided for real token files.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticLM:
    """Deterministic synthetic LM token source."""

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        self.seed = seed
        rng = np.random.default_rng(seed)
        # Zipfian unigram distribution
        ranks = np.arange(1, min(vocab, 4096) + 1)
        p = 1.0 / ranks
        self.p = p / p.sum()
        self.support = rng.permutation(min(vocab, 4096))

    def sample(self, step: int, index: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 1_000_003 + index)
        base = rng.choice(self.support, size=seq_len, p=self.p)
        # Markov-ish bigram structure: every even position repeats a shifted
        # copy of the previous token (learnable signal).
        base[1::2] = (base[0::2][: len(base[1::2])] + 1) % self.vocab
        return base.astype(np.int32)


class MemmapCorpus:
    """Token-file source with the same (step, index) interface."""

    def __init__(self, path: str, seq_len_hint: int = 4096):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.n = len(self.tokens)

    def sample(self, step: int, index: int, seq_len: int) -> np.ndarray:
        start = ((step * 2_654_435_761 + index * 40_503) %
                 max(self.n - seq_len - 1, 1))
        return np.asarray(self.tokens[start:start + seq_len],
                          dtype=np.int32)


class DataPipeline:
    def __init__(self, source, *, global_batch: int, seq_len: int,
                 host_id: int = 0, num_hosts: int = 1, start_step: int = 0,
                 prefetch: int = 2, extras: Optional[Dict] = None):
        if num_hosts < 1 or global_batch % num_hosts:
            raise ValueError(f"global_batch {global_batch} must split evenly "
                             f"over num_hosts {num_hosts}")
        self.source = source
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.seq_len = seq_len
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.step = start_step
        self.extras = extras or {}
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make_batch(self, step: int) -> Dict[str, np.ndarray]:
        rows = []
        for i in range(self.local_batch):
            index = self.host_id * self.local_batch + i
            rows.append(self.source.sample(step, index, self.seq_len))
        batch = {"tokens": np.stack(rows)}
        for name, fn in self.extras.items():
            batch[name] = fn(step, self.local_batch)
        return batch

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put(self._make_batch(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self._q.get()
        self.step += 1
        return batch

    def state(self) -> Dict:
        """Checkpointable position (replayable after restart)."""
        return dict(step=self.step, host_id=self.host_id,
                    num_hosts=self.num_hosts)

    def close(self):
        self._stop.set()
