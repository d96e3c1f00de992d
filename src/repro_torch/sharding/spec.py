"""Logical-axis parameter annotations, the single-device half.

Parameters are created as ``Param(value, axes)``: ``axes`` is a tuple of
*logical* axis names (or ``None``), one per dimension, as in
``repro.sharding.spec``.  On one device nothing is sharded, so
:func:`shard_act` is the identity, as the JAX package's is outside a mesh.
Meshes, rules and ``to_pspec`` come with the sharding slice.

The init rule is the JAX package's: ``normal`` draws N(0, 1) scaled by
``1/sqrt(shape[0])`` for a weight of two or more dimensions and by 0.02 for
a vector, unless ``scale`` is given.  The values are drawn on the
generator's device, so they differ from JAX's (another generator), but
their distribution is the same; tests carry JAX's values across instead.
With ``generator=None`` a parameter is made on the ``meta`` device: shapes
and dtypes only, nothing allocated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.tree import tree_map


@dataclass
class Param:
    """A parameter value annotated with logical sharding axes."""

    value: Any
    axes: tuple


def init_device(generator) -> torch.device:
    """Where the parameters drawn from ``generator`` live (``meta`` for
    ``None``)."""
    return torch.device("meta") if generator is None else generator.device


def values_tree(tree):
    """Strip the Param wrappers: a tree of plain tensors."""
    return tree_map(lambda p: p.value, tree)


def axes_tree(tree):
    """The logical-axes of every Param, in the same tree structure."""
    return tree_map(lambda p: p.axes, tree)


def param(generator, shape, axes, *, dtype=torch.float32,
          init: str = "normal", scale: float | None = None) -> Param:
    """An annotated parameter on ``generator``'s device."""
    if len(axes) != len(shape):
        raise ValueError(f"{len(axes)} axes for shape {tuple(shape)}")
    dev = init_device(generator)
    if init == "zeros":
        v = torch.zeros(shape, dtype=dtype, device=dev)
    elif init == "ones":
        v = torch.ones(shape, dtype=dtype, device=dev)
    elif init == "normal":
        if scale is None:
            scale = 1.0 / (shape[0] ** 0.5) if len(shape) >= 2 else 0.02
        v = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        v = v.mul_(scale).to(dtype)       # in place: no second copy
    else:
        raise ValueError(init)
    return Param(v, tuple(axes))


def shard_act(x, *axes):
    """Constrain an activation's sharding by logical axes: the identity on
    one device."""
    return x


__all__ = ["Param", "axes_tree", "init_device", "param", "shard_act",
           "values_tree"]
