"""Weights drawn from the run's seed, on the device, one call a leaf.

A configuration's reference gives the layout (``[(path, shape, init)]``,
its per-layer leaves stacked, so a model is a few dozen leaves).  Each
leaf has a generator of its own, seeded from the run's seed and the
leaf's place in the layout: the same seed gives the same weights, and any
one leaf can be drawn again alone (the training check compares each
leaf's change against its start without keeping a second copy of the
model).
"""
from __future__ import annotations

import torch

from bench.reference.common import unflat

_MASK = (1 << 63) - 1


def leaf_seed(seed: int, index: int) -> int:
    """A generator seed for leaf ``index`` of a run seeded ``seed``."""
    return (seed * 1_000_003 + index * 7_919 + 1) & _MASK


def draw(shape, init, seed: int, device) -> torch.Tensor:
    """One f32 leaf: ``init`` is ``("normal", mean, std)``, ``("uniform",
    lo, hi)`` or ``("decay", base, span, power, std)`` (a per-channel ramp
    ``base + span·(c/(C-1))^power`` along the last axis, plus normal
    noise of ``std``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    kind = init[0]
    if kind == "normal":
        return out.normal_(init[1], init[2], generator=gen)
    if kind == "uniform":
        return out.uniform_(init[1], init[2], generator=gen)
    if kind == "decay":
        base, span, power, std = init[1:]
        c = shape[-1]
        ramp = torch.arange(c, dtype=torch.float32, device=device)
        ramp = base + span * (ramp / max(c - 1, 1)) ** power
        return out.normal_(0.0, std, generator=gen).add_(ramp)
    raise ValueError(f"no init {kind!r}")


def make(layout, seed: int, device) -> dict:
    """The whole tree of ``layout`` drawn from ``seed``."""
    return unflat([(path, draw(shape, init, leaf_seed(seed, i), device))
                   for i, (path, shape, init) in enumerate(layout)])


def leaf(layout, seed: int, path, device) -> torch.Tensor:
    """The leaf at ``path`` as :func:`make` draws it."""
    for i, (p, shape, init) in enumerate(layout):
        if tuple(p) == tuple(path):
            return draw(shape, init, leaf_seed(seed, i), device)
    raise KeyError(path)
