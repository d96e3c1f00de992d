"""Autograd-aware collectives over a ``DeviceMesh``'s process groups, and
the local-shard bridges between DTensors and the code that runs on each
rank's shard with them: the expert-parallel MoE (``models/moe.py``), the
vocab-parallel embedding lookup (``models/layers.py``) and the
vocab-parallel cross-entropy (``models/model.py``), where DTensor has no
rule that keeps the vocab dimension sharded.

Gradients follow the JAX ``shard_map`` convention: what a rank computes is
its share of the whole, a collective's backward sums shares (the backward
of a sum is a sum, of a gather a reduce-scatter), and the cotangent of an
output replicated over some mesh axes is split evenly into shares, one a
rank (:class:`_Share`).  The gradient of an input is then a share on each
axis the input is replicated over: ``Partial()`` there.
"""
from __future__ import annotations

import torch

from repro_torch.sharding.spec import is_dtensor


class _Share(torch.autograd.Function):
    """Identity forward; the gradient divided by ``n`` (the ranks that
    hold copies of this output)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _Sum(torch.autograd.Function):
    """All-reduce (sum) over ``group``; the backward sums the gradient's
    shares likewise."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.group), None


def sum_over(x, mesh, axes):
    """``x`` summed over the ranks of each mesh axis in ``axes``."""
    for a in axes:
        x = _Sum.apply(x, mesh.get_group(a))
    return x


def max_over(x, mesh, axes):
    """``x``'s elementwise maximum over the ranks of each mesh axis in
    ``axes``, outside autograd (a shift, such as a logsumexp's)."""
    import torch.distributed as dist
    x = x.detach().clone(memory_format=torch.contiguous_format)
    for a in axes:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    return x


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``; the backward reduce-scatters
    (an all-reduce of the whole gradient, then this rank's slice: gloo has
    no reduce-scatter, and ``torch.distributed.nn``'s all-gather backward
    names sub-group ranks as global ones there)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        import torch.distributed as dist
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.size = dist.get_rank(group), x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.size,
                        ctx.size).contiguous(), None, None


def gather_over(x, mesh, axes, dim):
    """``x`` concatenated along ``dim`` over the ranks of each mesh axis in
    ``axes``, the last the minor (the backward reduce-scatters)."""
    for a in reversed(axes):
        x = _Gather.apply(x, mesh.get_group(a), dim)
    return x


def _grad_placements(pl) -> list:
    """A local input's gradient placements: its shard where it is sharded,
    a share (``Partial()``) where it is replicated."""
    from torch.distributed.tensor import Partial, Replicate
    return [Partial() if isinstance(q, Replicate) else q for q in pl]


def local_in(t, mesh, pl):
    """The local shard of ``t`` under placements ``pl``: a DTensor is
    redistributed, a plain tensor (the same on every rank) distributed
    without communication."""
    from torch.distributed.tensor import distribute_tensor
    if not is_dtensor(t):
        t = distribute_tensor(t, mesh, pl, src_data_rank=None)
    elif tuple(t.placements) != tuple(pl):
        t = t.redistribute(mesh, pl)
    return t.to_local(grad_placements=_grad_placements(pl))


def local_out(y, mesh, pl):
    """A local result replicated on the mesh axes where ``pl`` replicates,
    as a DTensor with placements ``pl``."""
    from torch.distributed.tensor import DTensor, Replicate
    n = 1
    for q, size in zip(pl, mesh.shape):
        if isinstance(q, Replicate):
            n *= size
    return DTensor.from_local(_Share.apply(y, n) if n > 1 else y, mesh,
                              pl, run_check=False)


def shard_offset(t, dim: int, pl=None) -> int:
    """Where this rank's shard of DTensor ``t`` (placed by ``pl``, its own
    placements by default) starts along ``dim`` (the mesh axes that shard
    it split it major-to-minor, evenly)."""
    from torch.distributed.tensor import Shard
    mesh, idx, n = t.device_mesh, 0, 1
    for j, q in enumerate(t.placements if pl is None else pl):
        if isinstance(q, Shard) and q.dim == dim:
            idx = idx * mesh.size(j) + mesh.get_local_rank(j)
            n *= mesh.size(j)
    return idx * (t.shape[dim] // n)


def sharding_axes(pl, mesh, dim: int) -> tuple:
    """The names of the mesh axes on which placements ``pl`` shard tensor
    dimension ``dim``, major first."""
    from torch.distributed.tensor import Shard
    return tuple(name for name, q in zip(mesh.mesh_dim_names, pl)
                 if isinstance(q, Shard) and q.dim == dim)


__all__ = ["gather_over", "local_in", "local_out", "max_over",
           "shard_offset", "sharding_axes", "sum_over"]
