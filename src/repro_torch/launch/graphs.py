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
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.kernels import build
from repro_torch.sharding.spec import is_dtensor
from repro_torch.tree import tree_flatten, tree_leaves


def refuse_dtensors(owner: str, **trees) -> None:
    """``TypeError`` if any leaf of ``trees`` is a DTensor: a step on a
    mesh runs eagerly."""
    for name, tree in trees.items():
        for leaf in tree_leaves(_as_tree(tree)):
            if is_dtensor(leaf):
                raise TypeError(
                    f"{owner} captures plain tensors; the {name} hold a "
                    f"DTensor {tuple(leaf.shape)} placed "
                    f"{tuple(leaf.placements)} (a step on a mesh runs "
                    f"eagerly)")


class Capture:
    """One function's CUDA graph on ``device``.

    :meth:`warm` runs the function eagerly on a side stream (its kernels
    build and load, cuBLAS and autograd set up); :meth:`record` then
    captures it on that stream (the capture runs nothing); :meth:`first`
    does both.  :meth:`replay` replays the graph and adds the launches the
    capture recorded to their wrappers' counts.  A capture that fails
    raises.  ``capture_s`` and ``instantiate_s``: the host seconds of the
    capture and of the graph's instantiation."""

    def __init__(self, device, *, error_mode: str = "global"):
        self.device = torch.device(device)
        self.error_mode = error_mode
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
                capture_error_mode=self.error_mode):
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
                              capture_error_mode=self.error_mode):
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


def _own_buffers(state, taken=()):
    """``state`` with every tensor leaf a buffer of its own: a leaf whose
    storage an earlier leaf, or a tensor of ``taken``, already uses is
    cloned."""
    leaves, tdef = tree_flatten(_as_tree(state))
    seen = {x.untyped_storage().data_ptr() for x in taken if x.numel()}
    out = []
    for x in leaves:
        if isinstance(x, torch.Tensor) and x.numel():
            key = x.untyped_storage().data_ptr()
            if key in seen:
                x = x.clone()
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
    A DTensor state or input is refused with ``TypeError``.
    ``error_mode``: the capture's ``capture_error_mode`` (``thread_local``
    where other threads may use the card while it captures)."""

    #: the capture a runner on the card makes (a test may put a stand-in
    #: in its place, with ``graphed`` set, to run the graph route's
    #: bookkeeping on the CPU)
    capture_type = Capture

    def __init__(self, fn, state, *, device=None, error_mode="global"):
        refuse_dtensors("StepGraph", state=state)
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
        self.fn, self.error_mode = fn, error_mode
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
        for s, n in zip(want, got):
            if not isinstance(s, torch.Tensor):
                continue
            if n.shape != s.shape or n.dtype != s.dtype:
                raise ValueError(f"a new state leaf {tuple(n.shape)} "
                                 f"{n.dtype} for a buffer {tuple(s.shape)} "
                                 f"{s.dtype}")
            if n is not s:
                pairs.append((s, n))
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
            refuse_dtensors("StepGraph", inputs=inputs)
            self.inputs = tree_flatten(inputs)[1].unflatten(
                [x.to(self.device).clone(
                    memory_format=torch.contiguous_format)
                 for x in tree_leaves(inputs)])
            return
        bufs, tdef = tree_flatten(self.inputs)
        new = tdef.flatten_up_to(inputs)
        for b, x in zip(bufs, new):
            if x.shape != b.shape or x.dtype != b.dtype:
                raise ValueError(f"a StepGraph replays one input shape: "
                                 f"{tuple(x.shape)} {x.dtype} for "
                                 f"{tuple(b.shape)} {b.dtype}")
            b.copy_(x)

    def _body(self):
        return self.fn(self.state, self.inputs)

    def __call__(self, inputs):
        self._advance()
        self._load(inputs)
        if not self.graphed:
            self.new, self.out = self._body()
        elif self.capture is None:
            self.capture = self.capture_type(self.device,
                                             error_mode=self.error_mode)
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


__all__ = ["Capture", "StepGraph", "refuse_dtensors"]
