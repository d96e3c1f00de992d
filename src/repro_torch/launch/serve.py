"""Serving driver: batched prefill + greedy decode with the KV-cache/state
path, the port of ``repro.launch.serve``.  Each decode step is replayed
from a CUDA graph (:class:`DecodeGraph`), as the JAX package runs it
under ``jax.jit``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --batch 4 --prompt-len 64 --gen 32            # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --smoke --device cpu                         # anywhere
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small
                                     # 1,500 encoder frames, on the card
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.graphs import (Capture, buffer_of, check_placed_as,
                                       local, on_mesh)
from repro_torch.models.model import build_model
from repro_torch.sharding.spec import is_dtensor, values_tree
from repro_torch.tree import tree_leaves


class DecodeGraph:
    """``api.decode_step`` on ``params`` and a prefill's ``cache``, captured
    once as a CUDA graph and replayed for every token: the counterpart of
    the JAX package's ``jax.jit`` of the decode step.

    Static buffers: a (B, 1) int32 token, a 0-d int32 index, the cache
    (the prefill's own tensors, read and written in place), and for each
    cache leaf that the step hands back anew (RWKV's states, Mamba's SSM
    state and conv tail) ``fresh[key]``, its new value, copied into the
    cache at the start of the next step: until then every tensor a step
    read keeps what it read.  :meth:`step` loads a token and an index
    into the buffers and runs the step.

    On a CUDA device the first step runs eagerly on the buffers, on the
    stream the capture then uses: its kernels build and load at their
    first launch, and cuBLAS sets up its workspace, outside the capture.
    Then ``api.decode_step`` itself is captured (a fault planted in the
    api's step is captured with it), and every later step is a replay
    (``launch.graphs.Capture``).  The kernel launches the capture records
    (``build.capturing``) are added to their wrappers' counts at each
    replay, so the counts are the eager loop's.  A capture that fails
    raises: nothing falls back to an eager loop.  On the CPU, where no
    graph exists, every step runs the
    same function on the same buffers eagerly.

    On a mesh (``launch.steps.StepBundle.lower`` of a decode bundle) the
    parameters and the cache are DTensors, placed once; the cache's local
    shards are written in place as the plain cache is, the index is the
    same plain 0-d buffer (``models.layers.write_row``), and ``token``,
    an example token placed as every token will be, makes the token
    buffer a DTensor placed alike: each token loads local shard to local
    shard, and a token or a new cache leaf placed otherwise than its
    buffer raises ``ValueError``.  ``context`` (a function returning a
    context manager: the bundle's ``ShardCtx``) is entered around the
    step in the eager call and in the capture; a replay runs no Python.

    The prefill is not captured: a graph of a call made once a
    ``generate`` would be replayed never."""

    #: the capture a runner on the card makes (a test may put a stand-in
    #: in its place, with ``graphed`` set)
    capture_type = Capture

    def __init__(self, api, params, cache, batch: int, *, token=None,
                 context=None):
        self.device = tree_leaves(cache)[0].device
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"no decode graph for device {self.device}")
        self.api, self.params, self.cache = api, params, cache
        self.mesh = on_mesh(params, cache)
        self.token = (torch.zeros((batch, 1), dtype=torch.int32,
                                  device=self.device)
                      if token is None else buffer_of(token))
        self.index = torch.zeros((), dtype=torch.int32, device=self.device)
        self.context = context or contextlib.nullcontext
        self.graphed = self.device.type == "cuda"
        self.fresh = {}
        self.logits = None           # the graph's output buffer
        self.capture = None          # graphs.Capture, once captured

    def _load(self, token, index) -> None:
        if is_dtensor(self.token) or is_dtensor(token):
            check_placed_as(self.token, token, "a decode token")
        local(self.token).copy_(local(token))
        if isinstance(index, torch.Tensor):
            self.index.copy_(index)
        else:
            self.index.fill_(index)

    def _body(self):
        """One decode step on the buffers: the last step's new leaves into
        the cache, the step, its new leaves into ``fresh``."""
        with self.context():
            for key, new in self.fresh.items():
                local(self.cache[key]).copy_(local(new))
            logits, cache = self.api.decode_step(self.params, self.cache,
                                                 self.token, self.index)
            for key, leaf in cache.items():
                if leaf is self.cache[key]:
                    continue
                if self.mesh:
                    check_placed_as(self.cache[key], leaf,
                                    f"the new cache leaf {key!r}")
                if key in self.fresh:
                    local(self.fresh[key]).copy_(local(leaf))
                else:
                    self.fresh[key] = leaf
        return logits

    def step(self, token, index):
        """The logits (B, 1, V) of ``token`` (B, 1) at position ``index``
        (an int or a 0-d int32 tensor).  After a replay they are the
        graph's output buffer, which the next step overwrites."""
        self._load(token, index)
        if not self.graphed:
            return self._body()
        if self.capture is None:
            self.capture = self.capture_type(self.device)
            logits, self.logits = self.capture.first(self._body)
            return logits
        self.capture.replay()
        return self.logits

    def new_cache(self) -> dict:
        """The cache after the last step: each leaf the step hands back
        anew is its ``fresh`` buffer (the cache's own holds the step
        before until the next step copies it in)."""
        return dict(self.cache, **self.fresh)

    @property
    def per_replay(self) -> dict:
        """Each wrapper's kernel launches a replay."""
        return self.capture.per_replay if self.capture else {}


def generate(api, params, prompts, *, gen: int, extra_inputs=None):
    """Greedy decode ``gen`` tokens after one batched prefill.

    prompts: (B, S) int on the params' device; ``extra_inputs`` go into the
    prefill's batch (vlm ``patches`` (B, P, D), encdec ``frames``).
    Returns (B, gen) int32.  The prefill runs eagerly; each decode step is
    a :class:`DecodeGraph` step (a CUDA graph's replay on the card, the
    same step run eagerly on the CPU), and the argmax of its logits is
    taken outside the graph, as the JAX package's loop takes it outside
    its jitted step.

    A vlm sequence starts with its P patch positions, so its cache covers
    P + S + gen positions and step i decodes at P + S + i.  The JAX
    package's ``generate`` sizes the cache S + gen and decodes at S + i,
    which overwrites prompt slots and departs from the model's own
    forward (ROADMAP.md, Queue 3, notes on the reference)."""
    cfg = api.cfg
    s = prompts.shape[1]
    if cfg.family == "vlm":
        s += cfg.num_patches
    with torch.inference_mode():
        logits, cache = api.prefill(params,
                                    dict(extra_inputs or {}, tokens=prompts),
                                    cache_len=s + gen)
        decode = DecodeGraph(api, params, cache, prompts.shape[0])
        out = []
        tok = logits[:, :, :cfg.vocab_size].argmax(-1).to(torch.int32)
        for i in range(gen):
            out.append(tok[:, 0])
            logits = decode.step(tok, s + i)
            tok = logits[:, :, :cfg.vocab_size].argmax(-1).to(torch.int32)
        return torch.stack(out, dim=1)


def main(argv=None):
    """CLI entry: serve a model (prefill + decode loop) from a config id."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_arch_config(args.arch))
    api = build_model(cfg, compute_dtype=torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = values_tree(api.init(gen))
    rng = np.random.default_rng(0)
    s_text = args.prompt_len - (cfg.num_patches if cfg.family == "vlm"
                                else 0)
    if s_text < 1:
        ap.error(f"--prompt-len {args.prompt_len} leaves no text after "
                 f"{cfg.num_patches} patch positions")
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, s_text))
    ).to(device=dev, dtype=torch.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = rng.normal(
            0, 0.02, (args.batch, cfg.num_patches, cfg.d_model))
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(
            0, 0.02, (args.batch, cfg.encoder_seq_len, cfg.d_model))
    extra = {k: torch.from_numpy(v).to(device=dev, dtype=torch.float32)
             for k, v in extra.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    toks = generate(api, params, prompts, gen=args.gen, extra_inputs=extra)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"generated {tuple(toks.shape)} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {where}")
    print("sample:", toks[0][:16].cpu().numpy())


if __name__ == "__main__":
    main()
