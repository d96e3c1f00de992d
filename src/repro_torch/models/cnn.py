"""The paper's deep CNN (Sukiyaki), ported from ``repro.models.cnn``:
conv -> ReLU -> max-pool stacks and a fully-connected softmax classifier
(Figures 2/4 of the paper).

The public functions keep the JAX package's layouts, so weights move
between the packages unchanged (:func:`params_from_numpy` /
:func:`params_to_numpy`): conv weights are HWIO, FC weights (in, out),
images NHWC, and the conv features are flattened in (H, W, C) order.
Inside, the convolutions run NCHW/OIHW through ``F.conv2d`` (cuDNN on the
card; the JAX package leaves them to XLA, outside any Pallas kernel).

Also exposed as **fabric ticket work**: :class:`CnnGradShard` is a
picklable task computing the CNN's loss and gradients for one row slice of
a deterministic synthetic set against the round's served weights.
"""
from __future__ import annotations

import functools
import math
import threading
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.device import resolve_device
from repro_torch.launch.graphs import StepGraph
from repro_torch.tree import (tree_as_tensors, tree_flatten, tree_leaves,
                              tree_map, tree_to_numpy)


def init_cnn(generator: torch.Generator, ccfg: CNNConfig, device="cuda"):
    """Random weights: N(0, 1/fan_in) conv and FC weights, zero biases.

    ``generator`` is a CPU generator; the values are drawn on the CPU and
    then moved, so one seed gives one net on every device."""
    dev = resolve_device(device)

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * (1.0 / math.sqrt(fan_in))).to(dev)

    convs = []
    cin = ccfg.in_channels
    for spec in ccfg.convs:
        convs.append({
            "w": normal((spec.kernel, spec.kernel, cin, spec.out_channels),
                        spec.kernel ** 2 * cin),
            "b": torch.zeros(spec.out_channels, device=dev),
        })
        cin = spec.out_channels
    dims = [ccfg.feature_dim, *ccfg.fc_hidden, ccfg.num_classes]
    fc = [{"w": normal((dims[i], dims[i + 1]), dims[i]),
           "b": torch.zeros(dims[i + 1], device=dev)}
          for i in range(len(dims) - 1)]
    return {"convs": convs, "fc": fc}


def params_from_numpy(tree, device="cuda"):
    """A JAX-layout param tree of numpy arrays (e.g. ``jax.device_get`` of
    the JAX package's ``values_tree(init_cnn(...))``) as the same tree of
    tensors on ``device``; bf16 goes through an int16 view."""
    return tree_as_tensors(tree, resolve_device(device))


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`: host numpy arrays."""
    return tree_to_numpy(tree)


def conv_features(params, ccfg: CNNConfig, images):
    """images: (B, H, W, C) -> flat features (B, feature_dim), in the JAX
    package's (H, W, C) flatten order."""
    x = images.permute(0, 3, 1, 2)                       # NHWC -> NCHW
    for spec, cp in zip(ccfg.convs, params["convs"]):
        w = cp["w"].to(x.dtype).permute(3, 2, 0, 1)      # HWIO -> OIHW
        # SAME padding for the odd kernels of the paper's nets
        x = F.conv2d(x, w, cp["b"].to(x.dtype), padding=spec.kernel // 2)
        x = F.max_pool2d(F.relu(x), spec.pool, spec.pool)   # VALID
    x = x.permute(0, 2, 3, 1)                            # back to NHWC
    return x.reshape(x.shape[0], -1)


def fc_logits(params, ccfg: CNNConfig, feats):
    """The server-side fully-connected classifier (optionally deep)."""
    x = feats
    layers_ = params["fc"]
    for i, lp in enumerate(layers_):
        x = x @ lp["w"].to(x.dtype) + lp["b"].to(x.dtype)
        if i < len(layers_) - 1:
            x = F.relu(x)
    return x


def forward(params, ccfg: CNNConfig, images):
    return fc_logits(params, ccfg, conv_features(params, ccfg, images))


def nll_loss(logits, labels):
    """Mean softmax cross-entropy in f32; labels: (B,) int."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def error_rate(logits, labels):
    return (logits.argmax(-1) != labels).float().mean()


# ---------------------------------------------------------------------------
# The CNN as fabric ticket work
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def value_and_grad(ccfg: CNNConfig):
    """``(params, images, labels) -> (mean NLL, grad tree)`` by
    ``torch.autograd``, run eagerly: the function :func:`loss_and_grads`
    captures and :func:`train_step` calls."""

    def f(params, images, labels):
        leaves, tdef = tree_flatten(params)
        leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
        loss = nll_loss(forward(tdef.unflatten(leaves), ccfg, images),
                        labels)
        grads = torch.autograd.grad(loss, leaves)
        # a conv weight's gradient comes back in the OIHW strides of the
        # permuted view; hand back each leaf's own (contiguous) layout
        return loss.detach(), tdef.unflatten([g.contiguous() for g in grads])

    return f


@functools.lru_cache(maxsize=None)
def loss_and_grads(ccfg: CNNConfig):
    """``(params, images, labels) -> (mean NLL, grad tree)``, one function
    per config, as the JAX package caches one jitted function per config.

    Each input shape, dtype and device has its runner of
    :func:`value_and_grad` (``launch.graphs.StepGraph``), as ``jax.jit``
    traces once per shape: a call loads the params, images and labels
    into that runner's buffers and runs it (on the card its first call
    runs eagerly and captures, and every later one replays the CUDA
    graph; on the CPU it runs eagerly), and hands back a copy of the loss
    and gradients.  One lock lets one thread at a time use the runners
    (the fabric's clients may be threads)."""
    grad = value_and_grad(ccfg)
    graphs, lock = {}, threading.Lock()

    def step(_, inputs):
        return (), grad(*inputs)

    def f(params, images, labels):
        inputs = (params, images, labels)
        device = images.device
        key = tuple((tuple(x.shape), x.dtype, x.device)
                    for x in tree_leaves(inputs))
        with lock:
            if key not in graphs:
                graphs[key] = StepGraph(step, (), device=device)
            _, (loss, grads) = graphs[key](inputs)
            return loss.clone(), tree_map(torch.clone, grads)

    return f


def train_step(ccfg: CNNConfig, opt):
    """The quickstart's step, ``(state, batch) -> (state, loss)`` with
    ``state = (params, opt_state)`` and ``batch = (images, labels)``: the
    loss and gradients (:func:`value_and_grad`) and the optimizer's update
    in one function, as the JAX quickstart jits them together
    (``examples/quickstart.py:42-48``); run it through
    ``launch.graphs.StepGraph`` to replay it as one CUDA graph."""
    grad = value_and_grad(ccfg)

    def step(state, batch):
        params, opt_state = state
        loss, grads = grad(params, *batch)
        with torch.no_grad():
            params, opt_state = opt.update(grads, opt_state, params)
        return (params, opt_state), loss

    return step


@functools.lru_cache(maxsize=None)
def shard_dataset(ccfg: CNNConfig, n_rows: int, seed: int):
    """The deterministic synthetic classification set the fabric shards by
    row slice (numpy, from ``data.clustered_images``).  Cached: every shard
    of every round slices the same arrays."""
    from repro_torch.data import clustered_images
    return clustered_images(n_rows, image_size=ccfg.image_size,
                            channels=ccfg.in_channels, seed=seed)


@dataclass(frozen=True)
class CnnGradShard:
    """Picklable fabric task: paper-CNN loss + gradients of one row slice.

    ``args`` is a ``(lo, hi)`` row slice of :func:`shard_dataset`;
    ``static[weights_key]`` is the round's versioned weight publish
    ``{"round": t, "params": <numpy tree>}``.  Returns the training-loop
    contract ``{"grad", "loss", "round"}`` with the gradients as host numpy
    arrays, so the result crosses the v2 wire protocol.  The work runs on
    ``device`` (``cuda`` unless the caller asks for ``cpu``)."""

    ccfg: CNNConfig
    n_rows: int = 512
    seed: int = 0
    weights_key: str = "weights"
    device: str = "cuda"

    def __post_init__(self):
        resolve_device(self.device)

    def __call__(self, args, static):
        lo, hi = args
        dev = resolve_device(self.device)
        images, labels = shard_dataset(self.ccfg, self.n_rows, self.seed)
        served = static[self.weights_key]
        loss, grads = loss_and_grads(self.ccfg)(
            params_from_numpy(served["params"], dev),
            torch.from_numpy(images[lo:hi]).to(dev),
            torch.from_numpy(labels[lo:hi]).to(dev))
        return {"grad": params_to_numpy(grads), "loss": float(loss),
                "round": served.get("round", -1)}


__all__ = ["CnnGradShard", "conv_features", "error_rate", "fc_logits",
           "forward", "init_cnn", "loss_and_grads", "nll_loss",
           "params_from_numpy", "params_to_numpy", "shard_dataset",
           "train_step", "value_and_grad"]
