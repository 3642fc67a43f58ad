"""Token data pipeline for LM training (port of ``repro.data.tokens``; the
numpy code is the port's own copy, with the same ``np.random`` calls in
the same order, so ``batch_at(step)`` equals JAX's bit for bit).

No corpus ships offline, so the source is a seeded sparse Markov chain
over the vocabulary: enough structure that a model's loss drops below
the uniform floor, while staying fully deterministic.

  * deterministic per-step batches (``batch_at(step)``): resuming from a
    checkpoint replays the exact stream position;
  * a background prefetch thread with a bounded buffer;
  * a placement hook; :func:`on_device` moves a batch to a device with
    int32 tokens.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch


class MarkovText:
    """Sparse first-order Markov chain token source."""

    def __init__(self, vocab: int, branching: int = 8, seed: int = 0):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        # each token can transition to `branching` successors
        self.succ = rng.integers(0, vocab, size=(vocab, branching))
        logits = rng.normal(size=(vocab, branching)) * 1.5
        p = np.exp(logits)
        self.p = p / p.sum(axis=1, keepdims=True)

    def sample(self, rng: np.random.Generator, batch: int, seq: int
               ) -> np.ndarray:
        out = np.empty((batch, seq), dtype=np.int32)
        cur = rng.integers(0, self.vocab, size=batch)
        out[:, 0] = cur
        for t in range(1, seq):
            choice = (rng.random(batch)[:, None] <
                      np.cumsum(self.p[cur], axis=1)).argmax(axis=1)
            cur = self.succ[cur, choice]
            out[:, t] = cur
        return out


def on_device(device: torch.device) -> Callable[[dict], dict]:
    """A ``place`` hook: each array of a batch as an int32 tensor on
    ``device``."""
    return lambda b: {k: torch.from_numpy(np.ascontiguousarray(
        v, dtype=np.int32)).to(device) for k, v in b.items()}


class TokenPipeline:
    def __init__(self, vocab: int, batch: int, seq: int, *, seed: int = 0,
                 place: Callable[[dict], Any] | None = None):
        self.source = MarkovText(vocab, seed=seed)
        self.batch, self.seq = batch, seq
        self.seed = seed
        self.place = place or (lambda b: b)

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a given step (resume-safe)."""
        rng = np.random.default_rng((self.seed, step))
        toks = self.source.sample(rng, self.batch, self.seq)
        return self.place({"tokens": toks, "labels": toks.copy()})

    def iterate(self, start_step: int = 0, prefetch: int = 2
                ) -> Iterator[dict]:
        """Prefetching iterator starting at ``start_step``."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            s = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(s), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
