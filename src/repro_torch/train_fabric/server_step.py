"""The server-side round update (port of ``repro.train_fabric.server_step``).

After a federated round's barrier closes, the server turns the arrived
per-member gradients into the next round's weights:

    clip each member's gradient  →  work-weighted mean  →  optimizer

  * :class:`TreeServerStep` — the reference: a leafwise weighted mean (f32,
    left to right over members) followed by the optimizer.  Works with any
    :class:`~repro_torch.optim.Optimizer`.
  * :class:`FusedServerStep` — the paper's modified AdaGrad as ONE kernel
    launch per round: every leaf is flattened into one f32 buffer on the
    params' device, the member gradients into the rows of one pitched
    stack (:func:`gradient_stack`), and ``kernels/server_step`` (CUDA on
    the card, its plain version on the CPU) does clip-weighted mean +
    accumulator + update in one pass.  With ``mesh=`` the flat buffer's
    elements are split over the mesh's ``data_axis``: each rank runs the
    kernel on its own contiguous block and the blocks are gathered back.

Gradients may arrive as host numpy trees (from the wire) or as tensors;
both steps move them to the params' device.  Both consume the same
per-member coefficients from :func:`member_coeffs`, computed once per round
on the unflattened trees, and replay one operation order, so the two are
bitwise equal on the CPU and on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.server_step.ops import server_step_update
from repro_torch.optim import Optimizer
from repro_torch.tree import as_tensor, tree_flatten, tree_leaves, tree_map

__all__ = ["ServerStep", "TreeServerStep", "FusedServerStep",
           "ROW_ALIGN", "gradient_stack", "member_coeffs",
           "member_grad_norms", "param_count", "row_pitch"]

#: The gradient stack's row pitch is a multiple of this many f32, so that
#: every row starts on a 128-byte line and K1 takes its 16-byte path.
ROW_ALIGN = 32


def param_count(params) -> int:
    """Total scalar parameters in a tree."""
    return int(sum(leaf.numel() if isinstance(leaf, torch.Tensor)
                   else np.size(leaf) for leaf in tree_leaves(params)))


def member_grad_norms(grads: Sequence) -> torch.Tensor:
    """(M,) f32 global L2 norm of each member's gradient tree.

    Per-leaf squared sums are added left to right in flatten order (dict
    keys sorted, as in JAX) — one reduction order shared by every
    ServerStep, so clip coefficients never differ between them."""
    norms = []
    for g in grads:
        s = None
        for leaf in tree_leaves(g):
            q = torch.sum(torch.square(as_tensor(leaf).float()))
            s = q if s is None else s + q
        norms.append(torch.sqrt(s).cpu())
    return torch.stack(norms)


def member_coeffs(grads: Sequence, works: Sequence[float],
                  clip_norm: Optional[float] = None) -> torch.Tensor:
    """(M,) f32 CPU tensor: each member's normalised work weight times its
    clip scale ``min(1, clip_norm / ‖g_m‖₂)``.  The weighted mean of
    clipped gradients is then simply ``Σ_m coeff_m · g_m``."""
    w = torch.tensor(list(works), dtype=torch.float32)
    w = w / torch.sum(w)
    if clip_norm is not None:
        norms = member_grad_norms(grads)
        w = w * torch.clamp(clip_norm / torch.clamp(norms, min=1e-12),
                            max=1.0)
    return w


class ServerStep:
    """Interface: ``step(grads, works, params, opt_state)`` →
    ``(new_params, new_opt_state)``, where ``grads`` is the round's list
    of arrived per-member gradient trees and ``works`` their work weights
    (same order)."""

    name = "abstract"

    def step(self, grads: Sequence, works: Sequence[float], params,
             opt_state):
        raise NotImplementedError


class TreeServerStep(ServerStep):
    """Reference implementation: clip → leafwise weighted mean (f32, left
    to right over members, each leaf reduced in one pass) →
    ``opt.update``.  The operation order is the one the fused kernel
    replays."""

    name = "tree_map"

    def __init__(self, opt: Optimizer, *, clip_norm: Optional[float] = None):
        self.opt = opt
        self.clip_norm = clip_norm

    def step(self, grads, works, params, opt_state):
        coeffs = member_coeffs(grads, works, self.clip_norm)
        dev = as_tensor(tree_leaves(params)[0]).device
        c = coeffs.to(dev)

        def fuse(*leaves):
            acc = c[0] * as_tensor(leaves[0], dev).float()
            for m in range(1, len(leaves)):
                acc = acc + c[m] * as_tensor(leaves[m], dev).float()
            return acc

        gmean = tree_map(fuse, *grads)
        return self.opt.update(gmean, opt_state, params)


def _flat32(leaves) -> torch.Tensor:
    return torch.cat([as_tensor(leaf).reshape(-1).float()
                      for leaf in leaves])


def _fill_rows(buf: torch.Tensor, rows) -> None:
    """Write member m's leaves, flattened in order, into ``buf[m]``
    (widened to f32), each straight from where it lies."""
    for row, leaves in zip(buf, rows):
        off = 0
        for leaf in leaves:
            t = as_tensor(leaf)
            row[off:off + t.numel()].copy_(t.reshape(-1))
            off += t.numel()


def row_pitch(n: int) -> int:
    """The gradient stack's row pitch for ``n`` elements a row."""
    return -(-n // ROW_ALIGN) * ROW_ALIGN


def gradient_stack(grads, tdef, n: int, device,
                   staging: torch.Tensor) -> torch.Tensor:
    """The round's member gradient trees (structure ``tdef``, ``n``
    elements each) as an (M, n) f32 view of one (M, ld) buffer on
    ``device``, ``ld`` being :func:`row_pitch` of ``n``.  Host gradients
    (numpy from the wire, or CPU tensors) are written leaf by leaf into
    the first M rows of ``staging``, a host (rows >= M, ld) f32 buffer,
    which are uploaded at once; any other gradients are copied into the
    rows of a new buffer on ``device``.  Pad columns are left as they are:
    the kernel never reads them."""
    rows = [tdef.flatten_up_to(g) for g in grads]
    on_host = all(not isinstance(leaf, torch.Tensor)
                  or leaf.device.type == "cpu"
                  for leaves in rows for leaf in leaves)
    if on_host:
        buf = staging[:len(rows)]
    else:
        buf = torch.empty((len(rows), row_pitch(n)), dtype=torch.float32,
                          device=device)
    _fill_rows(buf, rows)
    return buf.to(device)[:, :n]


class FusedServerStep(ServerStep):
    """The modified-AdaGrad server step as one fused kernel launch.

    Every leaf is flattened and concatenated into a single f32 buffer on
    the params' device (each leaf's dtype is restored on the way out), the
    M member gradients are written into the rows of one pitched (M, n)
    stack (:func:`gradient_stack`), and ``server_step_update`` performs
    clip-weighted mean + accumulator + parameter update in one pass.  Only
    the paper's optimizer is fused; constructing this against another
    optimizer raises.

    Gradients from the wire are staged in one host buffer kept from round
    to round, page-locked when the params are on CUDA: on the H100's host
    a new 9.7 MB buffer each round (the FIG4 net, 4 members) filled about
    4x slower than a kept one, its pages faulted in at first write, and a
    page-locked buffer uploads as one DMA (PERF.md).  The upload is
    synchronous, so a round never overwrites a buffer the card still
    reads.

    ``mesh`` (a ``DeviceMesh``; the JAX package's ``shard_map`` over the
    flat rows): rank r of the ``data_axis`` takes the r-th block of
    :func:`row_pitch` ``(ceil(n / ranks))`` elements (the last block may
    be short or empty), uploads only its block of the gradient stack, runs
    K1 on it on its own device, and the new parameters and accumulator
    are all-gathered over the axis, so the caller keeps its one-device
    view.  Every element's update is independent of the others, so the
    result is bitwise the unsharded step's.  Every rank of the axis must
    call :meth:`step` with the same round."""

    name = "fused"

    def __init__(self, opt: Optimizer, *, lr: float, beta: float = 1.0,
                 weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None, mesh=None,
                 data_axis: str = "data"):
        if opt.name != "adagrad":
            raise ValueError(
                f"FusedServerStep fuses the paper's modified AdaGrad; "
                f"got optimizer {opt.name!r} (use TreeServerStep)")
        self.opt = opt
        self.lr, self.beta, self.weight_decay = lr, beta, weight_decay
        self.clip_norm = clip_norm
        self.mesh, self.data_axis = mesh, data_axis
        self._staging: Optional[torch.Tensor] = None

    def _staging_for(self, members: int, n: int, device) -> torch.Tensor:
        """The kept host buffer, grown when a round brings more members
        or a longer row than it holds."""
        buf = self._staging
        if (buf is None or buf.shape[0] < members
                or buf.shape[1] != row_pitch(n)):
            buf = self._staging = torch.empty(
                (members, row_pitch(n)), dtype=torch.float32,
                pin_memory=torch.device(device).type == "cuda")
        return buf

    def step(self, grads, works, params, opt_state):
        coeffs = member_coeffs(grads, works, self.clip_norm)
        leaves_p, tdef = tree_flatten(params)
        leaves_p = [as_tensor(leaf) for leaf in leaves_p]
        dev = leaves_p[0].device
        pf = _flat32(leaves_p)
        af = _flat32(tdef.flatten_up_to(opt_state["acc"])).to(dev)
        n = pf.numel()
        if self.mesh is None:
            gf = gradient_stack(grads, tdef, n, dev,
                                self._staging_for(len(grads), n, dev))
            po, ao = server_step_update(
                pf, gf, af, coeffs.to(dev), lr=self.lr, beta=self.beta,
                weight_decay=self.weight_decay)
        else:
            po, ao = self._step_rows(grads, tdef, pf, af, coeffs)
        new_p, new_a, off = [], [], 0
        for leaf in leaves_p:
            sz = leaf.numel()
            new_p.append(po[off:off + sz].view(leaf.shape).to(leaf.dtype))
            new_a.append(ao[off:off + sz].view(leaf.shape))
            off += sz
        return tdef.unflatten(new_p), {"acc": tdef.unflatten(new_a)}

    def _step_rows(self, grads, tdef, pf, af, coeffs):
        """K1 on this rank's block of the flat buffer, on the rank's own
        device; the blocks all-gathered over ``data_axis`` and returned on
        ``pf``'s device."""
        import torch.distributed as dist
        mesh, axis = self.mesh, self.data_axis
        ranks = mesh.size(mesh.mesh_dim_names.index(axis))
        r = mesh.get_local_rank(axis)
        n = pf.numel()
        block = row_pitch(-(-n // ranks))
        lo, hi = min(r * block, n), min((r + 1) * block, n)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if mesh.device_type == "cuda" else torch.device("cpu"))
        # the whole stack in host memory (the kept staging buffer when the
        # gradients came from the host), then only this rank's columns
        # uploaded
        host = gradient_stack(grads, tdef, n, "cpu",
                              self._staging_for(len(grads), n, dev))
        po, ao = server_step_update(
            pf[lo:hi].to(dev), host[:, lo:hi].to(dev), af[lo:hi].to(dev),
            coeffs.to(dev), lr=self.lr, beta=self.beta,
            weight_decay=self.weight_decay)
        out = []
        for t in (po, ao):
            padded = torch.zeros(block, dtype=t.dtype, device=dev)
            padded[:hi - lo] = t
            parts = [torch.empty_like(padded) for _ in range(ranks)]
            dist.all_gather(parts, padded, group=mesh.get_group(axis))
            out.append(torch.cat(parts)[:n].to(pf.device))
        return out
