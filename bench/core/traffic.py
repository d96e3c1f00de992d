"""The one generator of every traffic mix: a mix is a JSON file of
parameters under ``bench/traffic/``, and this module makes its inputs
from the run's seed.

``kind: "train"``: closed-loop training, one step after another, each on
a batch of ``batch`` rows of ``seq`` tokens from :func:`make_lm_batch`
(a copy of the program's ``data/synthetic.py::make_lm_batch``: a Markov
stream, next = (5·prev + 17) mod V, each token replaced by a uniform one
with probability ``noise``).  ``pool`` batches are made in set-up and
the window cycles through them; the first ``compare_steps`` are the
steps the check follows.

``kind: "serve"``: closed-loop offline generation, one batched call
after another, each on ``batch`` prompts of ``prompt`` uniform tokens,
greedy, ``gen`` new tokens a prompt.  ``pool`` calls' prompts are made
in set-up; call i takes prompts ``i % pool``.
"""
from __future__ import annotations

import numpy as np
import torch


def make_lm_batch(rng: np.random.Generator, batch: int, seq: int,
                  vocab: int, *, noise: float = 0.1):
    """Markov-structured token batch: next = (5·prev + 17) mod V with
    noise."""
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


def train_batches(mix: dict, vocab: int, seed: int, device) -> list:
    """``mix["pool"]`` batches on ``device``, every row its own."""
    rng = np.random.default_rng(seed)
    return [{k: torch.from_numpy(v).to(device) for k, v in
             make_lm_batch(rng, mix["batch"], mix["seq"], vocab,
                           noise=mix["noise"]).items()}
            for _ in range(mix["pool"])]


def prompts(mix: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """(pool, batch, prompt) int32 uniform tokens on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, vocab, (mix["pool"], mix["batch"],
                                    mix["prompt"]),
                         generator=gen, dtype=torch.int32, device=device)
