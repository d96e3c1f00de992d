"""Trees of tensors, and the numpy boundary of the fabric.

A tree is what the JAX package calls a pytree: dicts, lists and tuples
nested around array leaves (``None`` is an empty subtree).  It is
flattened in JAX's order, with dict keys sorted, so that a reduction over
leaves (``member_grad_norms``) adds up in the same order in both packages.

The fabric's wire and delta codecs read every leaf with ``np.asarray``,
which cannot read a CUDA tensor or a bfloat16 one.  :func:`to_numpy` and
:func:`as_tensor` cross that boundary; bfloat16 goes through an int16 view,
and a bfloat16 numpy array exists only where some other module has
registered numpy's ``"bfloat16"`` dtype (``ml_dtypes``), which the port
never imports.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch


class TreeDef(NamedTuple):
    """The structure of a flattened tree: ``kind`` is ``dict``, ``list``,
    ``tuple``, ``None`` (an empty subtree) or ``"leaf"``."""

    kind: Any
    keys: Optional[tuple]
    children: tuple

    def unflatten(self, leaves) -> Any:
        it = iter(leaves)
        out = _build(self, it)
        if next(it, _END) is not _END:
            raise ValueError("more leaves than the tree structure holds")
        return out

    def flatten_up_to(self, tree) -> list:
        """The leaves of ``tree``, which must have this structure."""
        leaves, tdef = tree_flatten(tree)
        if tdef != self:
            raise ValueError("tree structure differs from the reference")
        return leaves


_LEAF = TreeDef("leaf", None, ())
_END = object()


def _flatten(x, leaves: list) -> TreeDef:
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return TreeDef(dict, keys, tuple(_flatten(x[k], leaves) for k in keys))
    if isinstance(x, (list, tuple)):
        return TreeDef(type(x), None, tuple(_flatten(v, leaves) for v in x))
    if x is None:
        return TreeDef(None, None, ())
    leaves.append(x)
    return _LEAF


def _build(td: TreeDef, it):
    if td.kind == "leaf":
        return next(it)
    if td.kind is None:
        return None
    kids = [_build(c, it) for c in td.children]
    if td.kind is dict:
        return dict(zip(td.keys, kids))
    return td.kind(kids)


def tree_flatten(tree) -> tuple[list, TreeDef]:
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(f: Callable, tree, *rest):
    """``f`` over the leaves of ``tree`` and, leaf by leaf, of ``rest``
    (each with the same structure)."""
    leaves, tdef = tree_flatten(tree)
    others = [tdef.flatten_up_to(r) for r in rest]
    return tdef.unflatten([f(*xs) for xs in zip(leaves, *others)])


def _numpy_bfloat16() -> np.dtype:
    try:
        return np.dtype("bfloat16")
    except TypeError:
        raise TypeError(
            "a bfloat16 tensor has no numpy form here: numpy's 'bfloat16' "
            "dtype is registered only by ml_dtypes") from None


def to_numpy(x) -> np.ndarray:
    """A leaf as a host numpy array (tensors copied off their device)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    t = x.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_numpy_bfloat16())
    return t.numpy()


def as_tensor(x, device=None) -> torch.Tensor:
    """A leaf as a tensor: a tensor stays as it is, a numpy array (or
    scalar) becomes a CPU tensor sharing its memory where it can; then, if
    ``device`` is given, the tensor is moved there."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if not (a.flags.c_contiguous and a.flags.writeable):
            a = a.copy(order="C")      # (ascontiguousarray lifts 0-d to 1-d)
        if a.dtype.name == "bfloat16":
            x = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            x = torch.from_numpy(a)
    return x if device is None else x.to(device)


def tree_to_numpy(tree):
    return tree_map(to_numpy, tree)


def tree_as_tensors(tree, device=None):
    return tree_map(lambda x: as_tensor(x, device), tree)


__all__ = ["TreeDef", "as_tensor", "to_numpy", "tree_as_tensors",
           "tree_flatten", "tree_leaves", "tree_map", "tree_to_numpy"]
