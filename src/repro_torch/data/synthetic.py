"""Deterministic synthetic data: learnable LM token streams, clustered
image sets (MNIST/CIFAR stand-ins for the paper's benchmarks), and the
ticket-sharded data loader that feeds training through the Sashimi queue.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from repro_torch.core.tickets import TicketQueue


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------


def make_lm_batch(rng: np.random.Generator, batch: int, seq: int,
                  vocab: int, *, noise: float = 0.1):
    """Markov-structured token batch: next = (5·prev + 17) mod V with noise.

    Learnable by any of the assigned LMs, so training-loss decrease is a
    meaningful integration check.
    """
    toks = np.empty((batch, seq + 1), np.int64)
    toks[:, 0] = rng.integers(0, vocab, size=batch)
    for t in range(seq):
        nxt = (5 * toks[:, t] + 17) % vocab
        flip = rng.random(batch) < noise
        nxt = np.where(flip, rng.integers(0, vocab, size=batch), nxt)
        toks[:, t + 1] = nxt
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
        "mask": np.ones((batch, seq), np.float32),
    }


def lm_batches(batch: int, seq: int, vocab: int, *, seed: int = 0,
               noise: float = 0.1) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    while True:
        yield make_lm_batch(rng, batch, seq, vocab, noise=noise)


# ---------------------------------------------------------------------------
# Clustered images (MNIST / CIFAR stand-ins)
# ---------------------------------------------------------------------------


def clustered_images(n: int, *, num_classes: int = 10, image_size: int = 32,
                     channels: int = 3, seed: int = 0, spread: float = 0.35,
                     means_seed: int = 1234):
    """Gaussian class-cluster images: kNN/CNN-learnable, deterministic.
    Class means come from ``means_seed`` so train/test splits share them."""
    rng = np.random.default_rng(seed)
    means = np.random.default_rng(means_seed).normal(
        0.0, 1.0, (num_classes, image_size, image_size, channels))
    labels = rng.integers(0, num_classes, size=n)
    imgs = (means[labels]
            + rng.normal(0.0, spread,
                         (n, image_size, image_size, channels)))
    return imgs.astype(np.float32), labels.astype(np.int32)


# ---------------------------------------------------------------------------
# Ticket-sharded loader (Sashimi-driven input pipeline)
# ---------------------------------------------------------------------------


class TicketDataLoader:
    """Carves each global batch into microbatch *tickets* via the paper's
    queue, so stragglers/dead input workers are tolerated by redistribution.

    In the SPMD framework the actual step is synchronous; this loader covers
    the host-side input path (the analogue of browsers pulling work).
    """

    def __init__(self, make_microbatch, *, num_microbatches: int,
                 timeout: float = 5.0, redistribute_min: float = 0.05,
                 clock=None):
        import time as _time
        self.make_microbatch = make_microbatch
        self.num_microbatches = num_microbatches
        self.queue = TicketQueue(timeout=timeout,
                                 redistribute_min=redistribute_min,
                                 clock=clock or _time.monotonic)

    def global_batch(self, step: int, workers) -> dict:
        """Enqueue microbatch tickets, let ``workers`` produce them, then
        concatenate into a global batch (ordered, exactly-once)."""
        tids = self.queue.add_many(
            "microbatch", [(step, i) for i in range(self.num_microbatches)])
        for w in workers:
            w.drain(self.queue, self.make_microbatch)
        if not self.queue.wait_all(timeout=60):
            raise TimeoutError("input tickets unfinished")
        res = self.queue.results()
        parts = [res[t] for t in tids]
        return {
            k: np.concatenate([p[k] for p in parts], axis=0)
            for k in parts[0]
        }


class InlineWorker:
    """Trivial in-process worker for the ticket loader (tests/benchmarks
    swap in thread workers with failure profiles)."""

    def drain(self, queue: TicketQueue, fn):
        while True:
            t = queue.request()
            if t is None:
                return
            queue.submit(t.ticket_id, fn(*t.args), "inline")
