"""The serving cells' loop: the program's ``launch.serve.generate``
(one batched eager prefill, then each decode step a replay of a
``DecodeGraph`` captured in the call), called one batch after another.

The api handed to ``generate`` is the program's own with its ``prefill``
timed by CUDA events (``prefill_ms.serve``).  Set-up draws the weights
from the seed and makes one call, which builds the kernels and warms the
shapes.  After the window the check samples finished requests, from the
seed, and runs the reference over each prompt with its served tokens.
"""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from bench.core import traffic, weights
from bench.core.train import arch_config, model_dims
from bench.reference import common


class ServeLoop:
    """``setup()``, ``step()`` (one whole ``generate`` call, finished on
    the device), ``release()`` and ``numbers()`` (the check)."""

    def __init__(self, cell, seed: int, device, faults=()):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.mix, self.dims = cell.mix, model_dims(cell.config)
        self.layout = cell.reference.layout(self.dims)
        self.faults = set(faults)
        self.served = []              # (B, gen) int32 of each window call
        self.call_ms, self.prefill_ms = [], []
        self.i = 0

    def setup(self) -> None:
        from repro_torch.launch.serve import generate
        from repro_torch.models.model import build_model

        cfg = arch_config(self.cell.config)
        self.vocab = cfg.vocab_size
        api = build_model(cfg, compute_dtype=getattr(
            torch, self.cell.config["dtype"]))
        self.prompts = traffic.prompts(self.mix, cfg.vocab_size, self.seed,
                                       self.device)
        self.params = weights.make(self.layout, self.seed, self.device)
        self._generate = generate
        self._timed = self.device.type == "cuda"
        self._span = None

        def prefill(*args, **kw):
            if not self._timed:
                return api.prefill(*args, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = api.prefill(*args, **kw)
            end.record()
            self._span = (start, end)
            return out

        self.api = dataclasses.replace(api, prefill=prefill)
        self._call(self.prompts[0])                       # warm

    def _call(self, prompts):
        toks = self._generate(self.api, self.params, prompts,
                              gen=self.mix["gen"])
        if "token_altered" in self.faults:    # one token of each request
            toks = toks.clone()
            mid = toks.shape[1] // 2
            toks[:, mid] = (toks[:, mid] + 1) % self.vocab
        return toks

    def step(self) -> None:
        prompts = self.prompts[self.i % len(self.prompts)]
        if self._timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        toks = self._call(prompts)
        if self._timed:
            end.record()
            end.synchronize()
            self.call_ms.append(start.elapsed_time(end))
            self.prefill_ms.append(self._span[0].elapsed_time(self._span[1]))
        self.served.append(toks)
        self.i += 1

    def work(self, calls: int) -> dict:
        b = self.mix["batch"]
        return {"tokens": calls * b * self.mix["gen"],
                "attempted": calls * b, "failed": 0}

    def release(self) -> None:
        self.served = [t.cpu() for t in self.served]
        self.api = self.params = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def sample(self) -> tuple:
        """Finished requests drawn from the seed: (prompts + served
        tokens (n, P + gen), served tokens (n, gen))."""
        b = self.mix["batch"]
        total = len(self.served) * b
        n = min(self.mix["sample_requests"], total)
        picks = np.random.default_rng(self.seed).choice(total, n,
                                                        replace=False)
        rows = [(int(i) // b, int(i) % b) for i in sorted(picks)]
        prompts = self.prompts.cpu()
        served = torch.stack([self.served[c][r] for c, r in rows])
        seqs = torch.stack([
            torch.cat([prompts[c % len(prompts), r], self.served[c][r]])
            for c, r in rows])
        return seqs, served

    def numbers(self) -> dict:
        seqs, served = self.sample()
        logits = reference_logits(self.cell, self.dims, self.layout,
                                  self.seed, seqs, self.mix, self.device,
                                  "f32")
        return {"served_logit_gap": logit_gap(logits, served)}


def reference_logits(cell, dims, layout, seed, seqs, mix, device, prec):
    """The reference's logits at the positions that predicted each served
    token: (n, gen, V), on the CPU, computed ``mix["ref_block"]``
    sequences at a time."""
    params = weights.make(layout, seed, device)
    model = cell.reference.Model(dims)
    p, gen = mix["prompt"], mix["gen"]
    out = []
    with torch.no_grad(), common.precision(prec, device):
        for i in range(0, len(seqs), mix["ref_block"]):
            block = seqs[i:i + mix["ref_block"]].to(device)
            feats = model.features(params, block)[:, p - 1:p - 1 + gen]
            out.append(model.logits(params["head"], feats).cpu())
            del feats
    del params
    gc.collect()
    return torch.cat(out)


def logit_gap(logits, tokens) -> float:
    """The widest gap by which a served token's logit lies below the
    reference's best at its position."""
    best = logits.max(-1).values
    got = torch.gather(logits, -1, tokens.long()[..., None])[..., 0]
    return float((best - got).max())


__all__ = ["ServeLoop", "logit_gap", "reference_logits"]
