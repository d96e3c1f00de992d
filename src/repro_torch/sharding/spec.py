"""Logical-axis parameter and activation sharding on a torch
``DeviceMesh`` (port of ``repro.sharding.spec``).

Parameters are created as ``Param(value, axes)``: ``axes`` is a tuple of
*logical* axis names (or ``None``), one per dimension.  A strategy's rule
table (``repro_torch.sharding.rules``) maps logical names to mesh axes;
:func:`to_pspec` resolves them to a :class:`PartitionSpec` with the JAX
package's logic, and :func:`placements` turns that into DTensor
placements on a mesh whose dimensions are named (``("data", "model")`` or
``("pod", "data", "model")``): ``Shard(d)`` on each mesh dimension that
tensor dimension ``d`` is mapped to, ``Replicate()`` on the others.  A
dimension mapped to several mesh axes is split major-to-minor in mesh
order, as ``NamedSharding`` splits it.

:func:`shard_act` is the counterpart of ``with_sharding_constraint``: under
a :class:`ShardCtx` it redistributes a DTensor activation to the
placements its logical axes resolve to.  A plain tensor, or any tensor
outside a context, passes through unchanged, so the model code runs as
it did on one device.

The init rule is the JAX package's: ``normal`` draws N(0, 1) scaled by
``1/sqrt(shape[0])`` for a weight of two or more dimensions and by 0.02 for
a vector, unless ``scale`` is given.  The values are drawn on the
generator's device, so they differ from JAX's (another generator), but
their distribution is the same; tests carry JAX's values across instead.
With ``generator=None`` a parameter is made on the ``meta`` device: shapes
and dtypes only, nothing allocated.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

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


# ---------------------------------------------------------------------------
# Logical axis -> mesh axis resolution
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (not sharded), a mesh
    axis name, or a tuple of names (sharded over their product, the first
    major), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict:
    """{mesh axis name: size}: of a ``DeviceMesh`` (``mesh_dim_names``)
    or of any object whose ``shape`` already maps names to sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _flat(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_pspec(axes: Sequence, rules: Mapping[str, Any], *, mesh=None,
             shape: Sequence[int] | None = None) -> PartitionSpec:
    """Resolve a tuple of logical axes to a PartitionSpec under ``rules``.

    A mesh axis is never used twice: a later dimension whose rule names an
    axis already taken stays unsharded.  With ``mesh`` and ``shape``, a
    mapping whose mesh-axis product does not divide the dimension falls
    back to the longest run of its axes (in order, each kept while the
    product still divides) that does, e.g. 12 heads on a 16-way model
    axis stay unsharded."""
    sizes = axis_sizes(mesh) if mesh is not None else None
    out = []
    used: list = []
    for i, ax in enumerate(axes):
        if ax is None:
            out.append(None)
            continue
        mesh_ax = rules.get(ax)
        if mesh_ax is not None:
            flat = _flat(mesh_ax)
            if any(m in used for m in flat):
                mesh_ax = None
            elif sizes is not None and shape is not None:
                n = 1
                for m in flat:
                    n *= sizes[m]
                if shape[i] % n != 0:
                    kept = []
                    n = 1
                    for m in flat:
                        if shape[i] % (n * sizes[m]) == 0:
                            kept.append(m)
                            n *= sizes[m]
                    mesh_ax = (tuple(kept) if len(kept) > 1
                               else (kept[0] if kept else None))
                    if mesh_ax is not None:
                        used.extend(kept)
                else:
                    used.extend(flat)
            else:
                used.extend(flat)
        out.append(mesh_ax)
    return PartitionSpec(*out)


def placements(pspec: Sequence, mesh) -> tuple:
    """DTensor placements of ``pspec`` on ``mesh``, one per mesh dimension:
    ``Shard(d)`` where tensor dimension ``d`` is mapped to that mesh axis,
    else ``Replicate()``.  A dimension mapped to several axes must name
    them in mesh order (major first, as ``NamedSharding`` splits it);
    another order raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(pspec):
        flat = _flat(entry)
        idx = [names.index(a) for a in flat]
        if idx != sorted(idx):
            raise ValueError(f"dimension {d} is split over {flat}, not in "
                             f"the mesh's order {tuple(names)}")
        for j in idx:
            out[j] = Shard(d)
    return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def map_axes(f, axes, *rest):
    """``f(axes_tuple, *leaves)`` over an axes tree (dicts and lists around
    tuples of logical names; a tuple of names is a leaf) and, leaf by
    leaf, the trees ``rest`` of the same structure; dict keys are visited
    in sorted order, as trees are flattened."""
    if isinstance(axes, dict):
        return {k: map_axes(f, axes[k], *(r[k] for r in rest))
                for k in sorted(axes)}
    if isinstance(axes, list) or (isinstance(axes, tuple)
                                  and not _is_axes(axes)):
        return type(axes)(map_axes(f, a, *(r[i] for r in rest))
                          for i, a in enumerate(axes))
    return f(axes, *rest)


def spec_tree(axes: Any, rules: Mapping[str, Any], mesh=None):
    """Map an axes tree to PartitionSpecs, or, with ``mesh``, to their
    placements on it."""

    def one(ax):
        ps = to_pspec(ax, rules)
        return placements(ps, mesh) if mesh is not None else ps

    return map_axes(one, axes)


# ---------------------------------------------------------------------------
# Activation sharding context
# ---------------------------------------------------------------------------


@dataclass
class ShardCtx:
    """Ambient (mesh, rules) pair consulted by :func:`shard_act`."""

    mesh: Any
    rules: Mapping[str, Any]


_tls = threading.local()


def current_ctx() -> ShardCtx | None:
    """The thread-local sharding context, or None outside one."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def use_shard_ctx(ctx: ShardCtx | None):
    """Install ``ctx`` as the ambient sharding context for the block."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor for a plain
    tensor's sake)."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_act(x, *axes):
    """Constrain an activation's sharding by logical axes: under a
    :class:`ShardCtx`, a DTensor is redistributed to the placements its
    axes resolve to; anything else is returned unchanged."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None or not is_dtensor(x):
        return x
    want = placements(to_pspec(axes, ctx.rules, mesh=ctx.mesh,
                               shape=x.shape), ctx.mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(ctx.mesh, want)


def shard_heads(y, axis: str, heads: int):
    """``y`` (B, S, heads * hd), its heads flattened, placed as
    ``shard_act`` would place it split into heads (``"batch", "seq",
    axis, None``): a mesh axis that does not divide ``heads`` leaves the
    heads unsharded.  Split ``y`` into heads only after this: DTensor
    cannot unflatten a dimension whose shards cut a head."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None or not is_dtensor(y):
        return y
    want = placements(to_pspec(("batch", "seq", axis), ctx.rules,
                               mesh=ctx.mesh,
                               shape=(*y.shape[:2], heads)), ctx.mesh)
    if tuple(y.placements) == want:
        return y
    return y.redistribute(ctx.mesh, want)


class _GradAsPlaced(torch.autograd.Function):
    """Identity whose gradient comes back in its input's placements."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, tuple(t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_as_placed(t):
    """``t``, its gradient redistributed to ``t``'s placements on the way
    back (a DTensor that requires grad; anything else as it is).  Put it
    between a view and a product whose gradient DTensor may shard
    otherwise, where the view's backward could not split that gradient
    (a flattened weight's heads)."""
    if is_dtensor(t) and t.requires_grad:
        return _GradAsPlaced.apply(t)
    return t


def on_local_shards(fn, like, roles: dict, args, out_roles):
    """``fn(*args)`` shard by shard, for a function whose work is
    independent along some dimensions (a kernel's batch and heads, say).

    ``like`` is the DTensor that decides the split: each mesh dimension
    that shards one of its tensor dimensions named in ``roles`` ({dim:
    role}) keeps that split, every other mesh dimension is replicated.
    ``args`` are ``(tensor, {role: dim})`` pairs: each is placed to split
    its dimension of each kept role alike (and replicated where it has no
    such dimension) and passed as its local shard; a plain tensor is taken
    as the same on every rank.  ``out_roles`` ({role: dim} for each of
    ``fn``'s outputs) places the outputs, returned as DTensors.  A plain
    ``like`` calls ``fn`` on ``args`` as they are (made contiguous).

    Gradients flow through: an argument replicated on a mesh dimension
    whose work is split (it has no dimension of that role) gets a
    ``Partial()`` gradient there, each rank's holding its own part of the
    work's."""
    if not is_dtensor(like):
        return fn(*(t.contiguous() for t, _ in args))
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    mesh = like.device_mesh
    kept = [roles.get(q.dim) if isinstance(q, Shard) else None
            for q in like.placements]

    def pl(dims):
        return tuple(Shard(dims[r]) if r is not None and r in dims
                     else Replicate() for r in kept)

    local = []
    for t, dims in args:
        want = pl(dims)
        if is_dtensor(t):
            t = t if tuple(t.placements) == want else t.redistribute(mesh,
                                                                     want)
        else:
            t = distribute_tensor(t, mesh, want, src_data_rank=None)
        grads = [Partial() if r is not None and isinstance(q, Replicate)
                 else q for r, q in zip(kept, want)]
        local.append(t.to_local(grad_placements=grads).contiguous())
    outs = fn(*local)
    return tuple(DTensor.from_local(o, mesh, pl(dims), run_check=False)
                 for o, dims in zip(outs, out_roles))


__all__ = ["Param", "PartitionSpec", "ShardCtx", "axes_tree", "axis_sizes",
           "current_ctx", "grad_as_placed", "init_device", "is_dtensor",
           "map_axes", "on_local_shards", "param", "placements",
           "shard_act", "shard_heads", "spec_tree", "to_pspec",
           "use_shard_ctx", "values_tree"]
