"""Roofline terms of one eager step (port of ``repro.launch.hlo_analysis``).

The JAX package reads FLOPs and bytes from XLA's ``cost_analysis`` of a
compiled program and parses the collectives out of its HLO text.  An eager
torch step has no HLO: :class:`Accounting`, a ``TorchDispatchMode``, sees
every op the step dispatches and counts, per device:

* product FLOPs, through ``torch.utils.flop_counter``'s formulas (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, convolutions, attention ops), by op;
* bytes read plus written by each op that is not a view: its tensor
  inputs read once and its tensor outputs written once.  Eager ops are
  counted unfused, so this is not XLA's ``bytes accessed`` of a fused
  program: an element-wise chain that XLA would fuse into one pass reads
  and writes its intermediates here;
* each collective of ``torch.distributed`` (``_c10d_functional`` and
  ``c10d`` ops) by kind, its count and result bytes, as the JAX package
  sums the result-shape bytes of each collective op, and the all-reduces
  that reduce another all-reduce's result (one mesh axis after another);
* the high-water mark of live storage bytes made during the step (the
  arguments, pinned with :meth:`Accounting.pin`, are counted apart);
* each of the port's kernels as one opaque call, whatever its route
  (the card's launch, the CPU's plain version, the meta device's empty
  outputs): its wrapper reports the kernel's useful work
  (``kernels/<name>/ops.py::work``) and the ops run inside it are not
  counted again.

Only ops on plain tensors are counted.  An op on a DTensor is left to
DTensor, which runs it as ops on each rank's local shards (and
collectives), and those are what this rank does: counting both would
count the global product and the local one.

:class:`Roofline` keeps the JAX package's arithmetic; the peaks are those
of one NVIDIA H100 SXM5 from NVIDIA's data sheet (dense, at the full 700 W
power limit; the card measured here reads ``NVIDIA H100 80GB HBM3,
700.00 W``), not measurements.
"""
from __future__ import annotations

import weakref
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import build

#: H100 SXM5 data-sheet peaks (dense), by the compute dtype of a step's
#: products: f32 outside the tensor cores (the port's f32 products run
#: with TF32 off), TF32 and bf16 on the tensor cores.
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
HBM_BW = 3.35e12             # bytes/s, HBM3 (data sheet)
#: bytes/s one way over NVLink 4 (900 GB/s both ways, data sheet): the
#: counterpart of the TPU's per-link ICI figure
LINK_BW = 450e9

#: collective op names (``_c10d_functional`` and ``c10d``) -> the JAX
#: package's kinds
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
}
#: ops that move no data: allocations without a fill, aliases
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "detach", "alias", "lift_fresh",
            "wait_tensor", "_local_scalar_dense", "set_", "resize_",
            "_unsafe_view", "_wrap_tensor_autograd"}
#: ops that hand a collective's result on as it is
_PASS_ON = {"wait_tensor", "_wrap_tensor_autograd"}


_PLAIN = (torch.Tensor, torch.nn.Parameter)


@dataclass
class CollectiveStats:
    """Collective-op traffic, bucketed by kind."""

    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        """All collective result bytes across kinds."""
        return sum(self.bytes_by_kind.values())


@dataclass
class Roofline:
    """Roofline terms for one step on a ``chips``-wide fleet; ``t_*`` are
    per-step lower-bound times against the H100's data-sheet peaks, the
    compute peak that of ``compute_dtype``'s products."""

    flops: float                 # whole-step FLOPs (all chips)
    hbm_bytes: float             # whole-step bytes accessed (all chips)
    collective_bytes: float      # whole-step collective result bytes
    chips: int
    model_flops: float = 0.0     # 6·N·D analytic useful FLOPs
    compute_dtype: str = "float32"

    @property
    def t_compute(self) -> float:
        """Seconds if compute-bound (flops / fleet peak FLOP/s)."""
        return self.flops / (self.chips * PEAK_FLOPS[self.compute_dtype])

    @property
    def t_memory(self) -> float:
        """Seconds if HBM-bound (bytes / fleet HBM bandwidth)."""
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        """Seconds if interconnect-bound (collective bytes / link bw)."""
        return self.collective_bytes / (self.chips * LINK_BW)

    @property
    def dominant(self) -> str:
        """Which roofline term bounds the step: compute/memory/collective."""
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """Analytic model FLOPs over counted FLOPs (rematerialisation and
        padding show up as a ratio below 1)."""
        return self.model_flops / self.flops if self.flops else 0.0

    def as_dict(self) -> dict:
        """Flatten to the JSONL record emitted by the dry-run."""
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
        }


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):   # a tensor without storage
        return None


class CollectiveCalls(TorchDispatchMode):
    """Counts the calls of ``torch.distributed``'s collectives
    (``_c10d_functional`` and ``c10d`` ops, by the JAX package's kinds)
    made under it, DTensor's redistributions and the port's own
    (``sharding.collectives``) alike: ``calls`` ({kind: calls}).  An op on
    a DTensor is left to DTensor, whose collectives on the local shards
    come back through the mode.  Around a CUDA graph's capture it counts
    the collectives the graph records, where a one-rank collective may
    launch no kernel to see in a trace."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self.calls: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        name = func.__name__.split(".")[0]
        if func.namespace in ("_c10d_functional", "c10d") \
                and name in _COLLECTIVES:
            self.calls[_COLLECTIVES[name]] += 1
        return func(*args, **(kwargs or {}))


class Accounting(TorchDispatchMode):
    """Counts what one rank's step does (see the module docstring).  Use
    as a context manager around the step; :meth:`counts` reads it."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._flop_registry = flop_registry
        self.flops_by_op: Counter = Counter()
        self.bytes_by_op: Counter = Counter()
        self.kernels: dict = {}
        self.collectives = CollectiveStats()
        self.live = 0
        self.peak = 0
        self._in_kernel = 0
        self._pinned: set = set()
        self._storages: dict = {}     # key -> [nbytes, live tensor refs]
        self._refs: dict = {}         # id(tensor) -> weakref
        self._reduced: set = set()    # storages an all-reduce wrote
        self.sequential_all_reduces = 0

    # -- arguments and kernels ------------------------------------------

    def pin(self, tensors) -> int:
        """Count the storages of ``tensors`` (the step's arguments, local
        shards) as held before the step: never as made by it.  Returns
        their bytes."""
        total = 0
        for t in _tensors(tensors):
            key = _storage_key(t)
            if key is not None and key not in self._pinned:
                self._pinned.add(key)
                total += t.untyped_storage().nbytes()
        return total

    def kernel(self, name: str, flops: int, nbytes: int) -> None:
        """One call of the port's kernel ``name`` (from its wrapper)."""
        if not self._in_kernel:
            k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                               "bytes": 0})
            k["calls"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
        self._in_kernel += 1

    def kernel_done(self) -> None:
        self._in_kernel -= 1

    # -- the mode --------------------------------------------------------

    def __enter__(self):
        build.ACCOUNTS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        build.ACCOUNTS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented        # DTensor runs it on local shards
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(t not in _PLAIN for t in types) or any(
                type(t) not in _PLAIN for t in outs):
            return out       # fake tensors: DTensor's shape propagation
        name = func.__name__.split(".")[0]
        if func.namespace in ("_c10d_functional", "c10d") \
                and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            st = self.collectives
            st.bytes_by_kind[kind] = st.bytes_by_kind.get(kind, 0) + sum(
                _nbytes(t) for t in outs)
            st.count_by_kind[kind] = st.count_by_kind.get(kind, 0) + 1
            if kind == "all-reduce":
                key = _storage_key(_tensors(args)[0])
                self.sequential_all_reduces += key in self._reduced
                self._reduced.update(_storage_key(t) for t in outs)
        elif name in _PASS_ON and _tensors(args) and _storage_key(
                _tensors(args)[0]) in self._reduced:
            self._reduced.update(_storage_key(t) for t in outs)
        elif not self._in_kernel:
            packet = func._overloadpacket
            if packet in self._flop_registry:
                self.flops_by_op[str(packet)] += self._flop_registry[
                    packet](*args, **kwargs, out_val=out)
            if not func.is_view and name not in _NO_DATA:
                self.bytes_by_op[str(packet)] += sum(
                    _nbytes(t) for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key is None or key in self._pinned or id(t) in self._refs:
            return
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        self._refs[id(t)] = weakref.ref(t, lambda _, i=id(t), k=key:
                                        self._release(i, k))

    def _release(self, ident: int, key) -> None:
        self._refs.pop(ident, None)
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]
            self._reduced.discard(key)

    # -- results ---------------------------------------------------------

    @property
    def product_flops(self) -> int:
        return int(sum(self.flops_by_op.values()))

    def counts(self) -> dict:
        """This rank's counts: ``product_flops`` (and ``flops_by_op``),
        ``kernels`` ({name: calls, flops, bytes}), ``flops`` (products
        and kernels), ``bytes`` (ops, by op in ``bytes_by_op``, and
        kernels), ``collectives``
        (bytes) and ``collective_counts`` by kind,
        ``sequential_all_reduces`` (all-reduces of what another
        all-reduce wrote: DTensor makes a ``(Partial, Partial)`` tensor
        replicated on a 2-D mesh with one all-reduce a mesh axis, in
        turn), and ``temp_bytes``, the high-water mark of storage the step
        made."""
        kflops = sum(k["flops"] for k in self.kernels.values())
        kbytes = sum(k["bytes"] for k in self.kernels.values())
        return {
            "product_flops": self.product_flops,
            "flops_by_op": dict(self.flops_by_op),
            "bytes_by_op": dict(self.bytes_by_op),
            "kernels": {n: dict(k) for n, k in self.kernels.items()},
            "flops": self.product_flops + kflops,
            "bytes": sum(self.bytes_by_op.values()) + kbytes,
            "collectives": dict(self.collectives.bytes_by_kind),
            "collective_counts": dict(self.collectives.count_by_kind),
            "sequential_all_reduces": self.sequential_all_reduces,
            "temp_bytes": self.peak,
        }


def roofline_from_counts(counts: dict, chips: int, *,
                         model_flops: float = 0.0,
                         compute_dtype: str = "float32") -> Roofline:
    """A :class:`Roofline` from one rank's :meth:`Accounting.counts`,
    scaled to the fleet (every rank does the same work, as XLA's
    per-partition numbers are scaled in the JAX package)."""
    return Roofline(flops=float(counts["flops"]) * chips,
                    hbm_bytes=float(counts["bytes"]) * chips,
                    collective_bytes=float(sum(
                        counts["collectives"].values())) * chips,
                    chips=chips, model_flops=model_flops,
                    compute_dtype=compute_dtype)


__all__ = ["Accounting", "CollectiveCalls", "CollectiveStats", "HBM_BW",
           "LINK_BW", "PEAK_FLOPS", "Roofline", "roofline_from_counts"]
