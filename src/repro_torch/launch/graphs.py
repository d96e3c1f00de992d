"""CUDA graphs of the port's compiled steps: the counterparts of the JAX
package's ``jax.jit``.

:class:`Capture` is the capture both runners share: a function run once
eagerly on a side stream (its kernels build and load, cuBLAS and autograd
set up), then captured on that stream, and replayed with the kernel
launches the capture recorded (``build.capturing``) added to their
wrappers' counts at each replay.  ``launch.serve.DecodeGraph`` replays the
decode step with it; :class:`StepGraph` replays a step ``fn(state,
inputs) -> (new_state, out)`` (the training step of ``launch.train``, the
CNN's value-and-grad and the quickstart's step of ``models.cnn``).

Both take DTensors too (a step on a ``DeviceMesh``, the counterpart of a
``jax.jit`` under a mesh's shardings; ``launch.steps.StepBundle.lower``):
a buffer is then a DTensor whose local shard is its own storage, placed
as the tensor it holds; loads and copies go local shard to local shard,
and a leaf placed otherwise than its buffer is refused, so that no
redistribution (a collective) hides in a copy.  The step's own
collectives, DTensor's and ``sharding.collectives``', are captured with
it.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.kernels import build
from repro_torch.sharding.spec import is_dtensor
from repro_torch.tree import tree_flatten, tree_leaves


class Capture:
    """One function's CUDA graph on ``device``.

    :meth:`warm` runs the function eagerly on a side stream (its kernels
    build and load, cuBLAS and autograd set up); :meth:`record` then
    captures it on that stream (the capture runs nothing); :meth:`first`
    does both.  :meth:`replay` replays the graph and adds the launches the
    capture recorded to their wrappers' counts.  A capture that fails
    raises.  ``capture_s`` and ``instantiate_s``: the host seconds of the
    capture and of the graph's instantiation.  Its captures check CUDA's
    unsafe calls in this thread alone (``thread_local``): another thread
    may use the card meanwhile (NCCL's watchdog, a fabric's workers)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graph = None
        self.stream = torch.cuda.Stream(self.device)
        self.per_replay: dict = {}
        self.capture_s = self.instantiate_s = None

    def warm(self, body):
        """``body()`` run eagerly on the capture stream."""
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = body()
        main.wait_stream(self.stream)
        return out

    def record(self, body):
        """``body()`` captured; returns its result (the graph's
        outputs)."""
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        with build.capturing() as launched, torch.cuda.graph(
                graph, stream=self.stream,
                capture_error_mode="thread_local"):
            t0 = time.perf_counter()
            captured = body()
            t1 = time.perf_counter()
        self.capture_s, self.instantiate_s = t1 - t0, time.perf_counter() - t1
        main.wait_stream(self.stream)
        self.graph, self.per_replay = graph, launched
        return captured

    def first(self, body):
        """``(body() run eagerly, body()'s captured result)``."""
        return self.warm(body), self.record(body)

    def copies(self, pairs) -> torch.cuda.CUDAGraph:
        """A graph of ``dst.copy_(src)`` for each ``(dst, src)`` of
        ``pairs``, captured on this capture's stream."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            for dst, src in pairs:
                dst.copy_(src)
        return graph

    def replay(self) -> None:
        self.graph.replay()
        for wrapper, n in self.per_replay.items():
            wrapper.launches += n


def _as_tree(x):
    """A dataclass (``TrainState``) as a dict of its fields; other trees
    as they are."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    return x


def _leaves(x) -> list:
    return tree_leaves(_as_tree(x))


def local(x):
    """A DTensor's local shard; any other tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def _placing(x) -> str:
    return str(tuple(x.placements)) if is_dtensor(x) else "plain"


def check_placed_as(buf, x, what: str) -> None:
    """``ValueError`` naming ``what`` unless ``x`` has ``buf``'s shape and
    dtype and is placed as ``buf`` is: both plain, or DTensors on the
    same mesh with the same placements.  A runner copies local shard to
    local shard and never across placements, which would redistribute (a
    collective) inside the copy."""
    if x.shape != buf.shape or x.dtype != buf.dtype:
        raise ValueError(f"{what}: {tuple(x.shape)} {x.dtype} for a buffer "
                         f"{tuple(buf.shape)} {buf.dtype}")
    if is_dtensor(x) != is_dtensor(buf) or is_dtensor(x) and (
            x.device_mesh != buf.device_mesh
            or tuple(x.placements) != tuple(buf.placements)):
        raise ValueError(f"{what}: placed {_placing(x)} for a buffer placed "
                         f"{_placing(buf)}; a runner never copies across "
                         f"placements (place it before the call)")


def buffer_of(x):
    """A buffer of its own holding ``x``: a contiguous clone, and for a
    DTensor its local shard cloned and placed as ``x`` is."""
    if not is_dtensor(x):
        return x.clone(memory_format=torch.contiguous_format)
    from torch.distributed.tensor import DTensor
    stride, n = [], 1
    for size in reversed(x.shape):
        stride.insert(0, n)
        n *= size
    return DTensor.from_local(
        x.to_local().clone(memory_format=torch.contiguous_format),
        x.device_mesh, x.placements, run_check=False, shape=x.shape,
        stride=tuple(stride))


def on_mesh(*trees) -> bool:
    """Whether any leaf of ``trees`` is a DTensor."""
    return any(is_dtensor(x) for t in trees for x in _leaves(t))


def _own_buffers(state, taken=()):
    """``state`` with every tensor leaf a buffer of its own: a leaf whose
    storage (a DTensor's local shard's) an earlier leaf, or a tensor of
    ``taken``, already uses is cloned (:func:`buffer_of`)."""
    leaves, tdef = tree_flatten(_as_tree(state))
    seen = {local(x).untyped_storage().data_ptr() for x in taken
            if x.numel()}
    out = []
    for x in leaves:
        if isinstance(x, torch.Tensor) and x.numel():
            key = local(x).untyped_storage().data_ptr()
            if key in seen:
                x = buffer_of(x)
            seen.add(key)
        out.append(x)
    tree = tdef.unflatten(out)
    if _as_tree(state) is not state:
        return dataclasses.replace(state, **tree)
    return tree


class StepGraph:
    """``fn(state, inputs) -> (new_state, out)``, captured once as a CUDA
    graph and replayed for every later call: the counterpart of the JAX
    package's ``jax.jit(fn, donate_argnums=(0,))``.

    ``state`` (a tree of tensors, or a ``TrainState``) is donated: its
    tensors become the runner's state buffers, each a buffer of its own
    (a leaf that shares another's storage is cloned).  Each call copies
    the last step's new state into them (so until the next call they hold
    what the step read, and its new state is apart), loads ``inputs`` (a
    tree of tensors of one shape a runner) into static input buffers, and
    runs the step on the buffers.  ``new_state`` must have ``state``'s
    structure; a leaf it hands back that is an input buffer (a batch's
    labels kept as the next step's) is copied too, before the next inputs
    load.  Returns ``(new_state, out)``: after a replay, the graph's own
    outputs, which the next call overwrites (clone what is kept).

    On a CUDA device the first call runs ``fn`` eagerly on the buffers, on
    the stream the capture then uses, and its new state becomes the state
    buffers (each leaf a buffer of its own; the donated ones are let go),
    so no more than one state and one new state ever live; the second
    call captures ``fn`` itself (a fault planted in it is captured with
    it) and replays it, and every later call is a replay, its state
    copies a graph of their own.  The kernel launches
    the capture records are added to their wrappers' counts at each
    replay.  A capture that fails raises: nothing falls back to an eager
    loop.  On the CPU every call runs ``fn`` eagerly on the same buffers.

    On a mesh (DTensor leaves: ``launch.steps.StepBundle.lower``) each
    buffer is a DTensor placed as its leaf, with a local shard of its own;
    the inputs come placed (placing them, a redistribution, stays outside
    the graph) and load local shard to local shard, and a new-state leaf
    placed otherwise than its buffer raises ``ValueError``.  ``fn`` enters
    whatever contexts it needs (the bundle's ``ShardCtx``) itself, in the
    eager call and in the capture; a replay runs no Python."""

    #: the capture a runner on the card makes (a test may put a stand-in
    #: in its place, with ``graphed`` set, to run the graph route's
    #: bookkeeping on the CPU)
    capture_type = Capture

    def __init__(self, fn, state, *, device=None):
        leaves = [x for x in _leaves(state) if isinstance(x, torch.Tensor)]
        if device is None:
            if not leaves:
                raise ValueError("StepGraph of an empty state needs a "
                                 "device")
            device = leaves[0].device
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"no step graph for device {self.device}")
        elsewhere = {x.device for x in leaves
                     if x.device.type != self.device.type}
        if elsewhere:
            raise ValueError(f"a StepGraph on {self.device} keeps its state "
                             f"there; leaves are on {elsewhere}")
        self.fn = fn
        self.graphed = self.device.type == "cuda"
        self.state = _own_buffers(state)
        self.inputs = None
        self.new = self.out = None
        self.capture = None
        self._captured = None            # (new_state, out) of the capture
        self._copy_graph = None

    def _pairs(self, new) -> list:
        """(state buffer, new leaf) for each leaf ``new`` hands back that
        is not the buffer itself."""
        got, tdef = tree_flatten(_as_tree(new))
        want, want_def = tree_flatten(_as_tree(self.state))
        if tdef != want_def:
            raise ValueError("the step's new state has another structure "
                             "than its state")
        pairs = []
        for i, (s, n) in enumerate(zip(want, got)):
            if not isinstance(s, torch.Tensor):
                continue
            try:
                check_placed_as(s, n, "the new state leaf")
            except ValueError as e:
                raise ValueError(f"{e} (at {_paths(want_def, len(want))[i]})"
                                 ) from None
            if n is not s:
                pairs.append((local(s), local(n)))
        return pairs

    def _advance(self) -> None:
        """The last step's new state into the state buffers."""
        if self.new is None:
            return
        if self._copy_graph is not None and self.new is self._captured[0]:
            self._copy_graph.replay()
            return
        with torch.no_grad():
            for s, n in self._pairs(self.new):
                s.copy_(n)

    def _load(self, inputs) -> None:
        if self.inputs is None:
            self.inputs = tree_flatten(inputs)[1].unflatten(
                [buffer_of(x if is_dtensor(x) else x.to(self.device))
                 for x in tree_leaves(inputs)])
            return
        bufs, tdef = tree_flatten(self.inputs)
        new = tdef.flatten_up_to(inputs)
        for b, x in zip(bufs, new):
            check_placed_as(b, x, "a StepGraph replays one input shape and "
                            "placing")
            local(b).copy_(local(x))

    def _body(self):
        return self.fn(self.state, self.inputs)

    def __call__(self, inputs):
        self._advance()
        self._load(inputs)
        if not self.graphed:
            self.new, self.out = self._body()
        elif self.capture is None:
            self.capture = self.capture_type(self.device)
            new, self.out = self.capture.warm(self._body)
            self._pairs(new)
            self.state = self.new = _own_buffers(
                new, tree_leaves(self.inputs))
        else:
            if self._captured is None:
                self.new = self.out = None
                self._captured = self.capture.record(self._body)
                self._copy_graph = self.capture.copies(
                    self._pairs(self._captured[0]))
            self.capture.replay()
            self.new, self.out = self._captured
        return self.new, self.out

    @property
    def per_replay(self) -> dict:
        """Each wrapper's kernel launches a replay."""
        return self.capture.per_replay if self.capture else {}


def _paths(tdef, n: int) -> list:
    """A name for each of the ``n`` leaves of a flattened tree: its keys
    and indices, joined."""
    from torch.utils._pytree import keystr, tree_flatten_with_path
    names = {i: keystr(path) for path, i in
             tree_flatten_with_path(tdef.unflatten(range(n)))[0]
             if isinstance(i, int)}
    return [names.get(i, f"leaf {i}") for i in range(n)]


__all__ = ["Capture", "StepGraph", "buffer_of", "check_placed_as", "local",
           "on_mesh"]
