"""Deterministic synthetic LM data pipeline, host-sharded with prefetch —
the JAX package's ``data/pipeline.py``, verbatim (numpy and a thread).

Production layout: each host materializes only its slice of the global
batch (``host_slice``), determined by the mesh's batch axes — the same
contract a file-backed loader would honor.  A background thread keeps a
double buffer ahead of the training loop (overlaps host data work with
device steps).  Data is deterministic in (seed, step) so elastic restarts
resume mid-epoch without a data-order fork.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticLM:
    """Zipf-ish token stream with causal structure (next = f(prev) + noise),
    so cross-entropy actually decreases during smoke training runs."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, frontend_tokens: int = 0, d_model: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.frontend_tokens = frontend_tokens
        self.d_model = d_model

    def batch_at(self, step: int, host_start: int = 0,
                 host_size: int | None = None) -> dict:
        """The (sub-)batch for a given step; deterministic in (seed, step)."""
        host_size = host_size or self.batch
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) % (2 ** 63))
        # zipf-ish marginals with a deterministic bigram drift
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        tok = (z + np.arange(self.seq + 1)[None, :] * 7) % self.vocab
        tok = tok.astype(np.int32)
        sl = slice(host_start, host_start + host_size)
        out = {"tokens": tok[sl, :-1], "labels": tok[sl, 1:]}
        if self.frontend_tokens:
            out["frontend"] = rng.standard_normal(
                (host_size, self.frontend_tokens, self.d_model),
                dtype=np.float32) * 0.02
        return out


class Prefetcher:
    """Double-buffered background prefetch of host batches."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2, host_start: int = 0,
                 host_size: int | None = None):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._host = (host_start, host_size)
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        while not self._stop.is_set():
            b = self.source.batch_at(self._step, *self._host)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self.q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self) -> dict:
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
