"""One rank of a gloo world that runs the port's sharded paths on the CPU,
for ``tests/test_torch_mesh.py``.  It imports torch and ``repro_torch``
alone (never jax), so a rank starts in a few seconds.

    python tests/torch_mesh_worker.py RANK WORLD STORE JOBS OUT

``STORE`` is the ``FileStore`` path of the world's rendezvous, ``JOBS`` a
pickle of a list of jobs (dicts with a ``kind``) and their numpy inputs;
rank 0 pickles the list of their results to ``OUT``.  Every gather is
made on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import InputShape, RunConfig, get_smoke_config  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.model import params_from_numpy  # noqa: E402
from repro_torch.sharding.spec import (ShardCtx, is_dtensor, placements,  # noqa: E402
                                       to_pspec, use_shard_ctx)
from repro_torch.tree import tree_leaves, tree_map, to_numpy  # noqa: E402


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=("data", "model"))


def _cfg(job):
    """The job's smoke config; ``moe_capacity``: its MoE capacity factor
    replaced."""
    cfg = get_smoke_config(job["arch"])
    if job.get("moe_capacity") and cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=job["moe_capacity"]))
    return cfg


def _np(x):
    """A leaf gathered whole (on every rank) as numpy."""
    if is_dtensor(x):
        x = x.full_tensor()
    return to_numpy(x) if isinstance(x, torch.Tensor) else x


def _np_tree(tree):
    return tree_map(_np, tree)


def _state_np(state):
    return {k: _np_tree(v) for k, v in vars(state).items()}


def _train(job):
    from repro_torch.launch.steps import build_train_step
    cfg = _cfg(job)
    b, s = job["batches"][0]["tokens"].shape
    run = RunConfig(arch=job["arch"], strategy=job["strategy"],
                    learning_rate=job["lr"], compute_dtype="float32",
                    remat=True)
    bundle = build_train_step(cfg, run, InputShape("custom", s, b, "train"),
                              job["mesh_obj"])
    batches = [{k: torch.from_numpy(v) for k, v in bt.items()}
               for bt in job["batches"]]
    state = bundle.init(params=params_from_numpy(bundle.cfg, job["params"],
                                                 "cpu"),
                        batch=batches[0])
    out = {"states": [], "metrics": [], "placements": {}}
    for bt in batches:
        state, metrics = bundle(state, bt)
        out["states"].append(_state_np(state))
        out["metrics"].append(_np_tree(metrics))
    out["placements"] = {
        k: str(tuple(v.placements)) for k, v in
        state.params["blocks"].items() if is_dtensor(v)} if isinstance(
            state.params.get("blocks"), dict) else {}
    return out


def _serve(job):
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step)
    cfg = _cfg(job)
    tokens = torch.from_numpy(job["tokens"])
    b, s = tokens.shape
    gen = job["gen"]
    run = RunConfig(arch=job["arch"], strategy="fsdp_tp",
                    compute_dtype="float32", decode_layout=job["layout"])
    mesh = job["mesh_obj"]
    pre = build_prefill_step(cfg, run, InputShape("p", s, b, "prefill"),
                             mesh)
    dec = build_decode_step(cfg, run, InputShape("d", s + gen, b, "decode"),
                            mesh)
    params = params_from_numpy(cfg, job["params"], "cpu")
    calls, sums = [], []
    real, real_sum = M._apply_moe_sharded, M.sum_over

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    def summing(t, mesh_, axes_):
        sums.append(tuple(axes_))
        return real_sum(t, mesh_, axes_)

    M._apply_moe_sharded, M.sum_over = counting, summing
    try:
        logits, cache = pre(params, {"tokens": tokens}, cache_len=s + gen)
        # each leaf of the prefill's cache: its placements, rank 0's local
        # bytes and the whole leaf's
        out = {"logits": [_np(logits)], "tokens": [],
               "cache_placements": {},
               "prefill_cache": {k: (str(tuple(v.placements)),
                                     v.to_local().numel() * v.element_size(),
                                     v.numel() * v.element_size())
                                 for k, v in cache.items()}}
        v = cfg.vocab_size
        tok = torch.from_numpy(_np(logits)[:, -1, :v].argmax(-1)[:, None]
                               .astype(np.int32))
        for i in range(gen):
            out["tokens"].append(tok.numpy())
            logits, cache = dec(params, cache, tok, s + i)
            out["cache_placements"] = {k: str(tuple(v.placements))
                                       for k, v in cache.items()}
            out["logits"].append(_np(logits))
            tok = torch.from_numpy(_np(logits)[:, -1, :v].argmax(-1)[:, None]
                                   .astype(np.int32))
    finally:
        M._apply_moe_sharded, M.sum_over = real, real_sum
    out["moe_sharded_calls"] = len(calls)
    out["sums"] = sums
    return out


def _moe(job):
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.sharding.rules import rules_for_strategy
    cfg = get_smoke_config(job["arch"])
    mesh = job["mesh_obj"]
    rules = dict(rules_for_strategy("fsdp_tp", ("data", "model")))
    rules.update(job.get("rules", {}))
    vals = {k: torch.from_numpy(v) for k, v in job["params"].items()}
    axes = {"router": ("embed", None), "w_up": ("expert", "embed", "mlp"),
            "w_gate": ("expert", "embed", "mlp"),
            "w_down": ("expert", "mlp", "embed")}

    def dist_(t, ax):
        pl = placements(to_pspec(ax, rules, mesh=mesh, shape=t.shape), mesh)
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    p = {k: dist_(v, axes[k]).requires_grad_(True) for k, v in vals.items()}
    x = dist_(torch.from_numpy(job["x"]), ("batch", None, None))
    x.requires_grad_(True)
    w = torch.from_numpy(job["w"])
    calls = []
    real_sum = M.sum_over

    def summing(t, mesh_, axes_):
        calls.append(tuple(axes_))
        if job.get("fault") and tuple(axes_) == ("model",):
            return t                          # the planted fault
        return real_sum(t, mesh_, axes_)

    M.sum_over = summing
    try:
        with use_shard_ctx(ShardCtx(mesh, rules)), implicit_replication():
            y, aux = M.apply_moe(p, cfg, x,
                                 capacity_factor=job["capacity_factor"])
            loss = (y * distribute_tensor(w, mesh, y.placements,
                                          src_data_rank=None)).mean() + aux
            keys = sorted(p)
            grads = torch.autograd.grad(loss, [x] + [p[k] for k in keys])
    finally:
        M.sum_over = real_sum
    return {"y": _np(y), "aux": _np(aux), "gx": _np(grads[0]),
            "gp": {k: _np(g) for k, g in zip(keys, grads[1:])},
            "sums": calls, "y_placements": str(tuple(y.placements))}


def _vocab(job):
    """The vocab-parallel embedding lookup and cross-entropy (whole and
    vocab-chunked) under ``fsdp_tp`` rules, forward and backward, with the
    local shapes that reach each rank's lookup and losses; ``fault``: the
    embedding's sum over the vocab shards left out."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import layers as L
    from repro_torch.models import model as Mdl
    from repro_torch.sharding.rules import rules_for_strategy
    mesh = job["mesh_obj"]
    rules = rules_for_strategy("fsdp_tp", ("data", "model"))

    def dist_(name, ax):
        t = torch.from_numpy(job[name])
        pl = placements(to_pspec(ax, rules, mesh=mesh, shape=t.shape), mesh)
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    table = dist_("table", ("vocab", "embed")).requires_grad_(True)
    logits = dist_("logits", ("batch", "seq", "head_vocab"))
    logits.requires_grad_(True)
    tokens, labels, mask = (dist_(k, ("batch", None))
                            for k in ("tokens", "labels", "mask"))
    feats = dist_("feats", ("batch", "seq", None)).requires_grad_(True)
    head_w = dist_("head_w", ("head_embed", "head_vocab"))
    head_w.requires_grad_(True)
    shapes = []
    real = L.local_in, Mdl.local_in, L.sum_over

    def seeing(local_in):
        def run(t, mesh_, pl):
            out = local_in(t, mesh_, pl)
            shapes.append(tuple(out.shape))
            return out
        return run

    L.local_in, Mdl.local_in = seeing(real[0]), seeing(real[1])
    if job.get("fault"):
        L.sum_over = lambda t, mesh_, axes_: t         # the planted fault
    try:
        with use_shard_ctx(ShardCtx(mesh, rules)), implicit_replication():
            y = L.embed_tokens({"table": table}, None, tokens, torch.float32)
            loss = Mdl.lm_loss(logits, labels, mask)
            chunked = Mdl.lm_loss_chunked(feats, head_w, labels, mask,
                                          n_chunks=job["n_chunks"])
            w = distribute_tensor(torch.from_numpy(job["w"]), mesh,
                                  y.placements, src_data_rank=None)
            grads = torch.autograd.grad(
                (y * w).sum() + loss + 2 * chunked,
                [table, logits, feats, head_w])
    finally:
        L.local_in, Mdl.local_in, L.sum_over = real
    return {"y": _np(y), "loss": _np(loss), "chunked": _np(chunked),
            **{k: _np(g) for k, g in zip(
                ("g_table", "g_logits", "g_feats", "g_head_w"), grads)},
            "shapes": shapes}


def _server_step(job):
    from repro_torch.optim import adagrad
    from repro_torch.train_fabric.server_step import FusedServerStep
    mesh = job["mesh_obj"]
    params = {k: torch.from_numpy(v) for k, v in job["params"].items()}
    acc = {k: torch.from_numpy(v) for k, v in job["acc"].items()}
    step = FusedServerStep(adagrad(job["lr"]), lr=job["lr"],
                           weight_decay=job["wd"], clip_norm=job["clip"],
                           mesh=mesh)
    new_p, new_opt = step.step(job["grads"], job["works"], params,
                               {"acc": acc})
    return {"params": _np_tree(new_p), "acc": _np_tree(new_opt["acc"]),
            "ranks": mesh.size()}


def _refusals(job):
    """Every kernel wrapper called with a DTensor: the messages of the
    ``TypeError`` each raises (None where one did not)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels.adagrad.ops import (adagrad_update,
                                                 adagrad_update_leaves)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.mamba.ops import mamba_scan
    from repro_torch.kernels.rwkv6.ops import wkv
    from repro_torch.kernels.server_step.ops import server_step_update
    mesh = job["mesh_obj"]
    rep = [Replicate()] * mesh.ndim

    def d(*shape):
        return distribute_tensor(torch.zeros(shape), mesh, rep,
                                 src_data_rank=None)

    calls = {
        "adagrad_update": lambda: adagrad_update(d(8), d(8), d(8), lr=0.1),
        "adagrad_update_leaves": lambda: adagrad_update_leaves(
            [torch.zeros(8)], [d(8)], [torch.zeros(8)], lr=0.1),
        "flash_attention": lambda: flash_attention(d(1, 4, 2, 32),
                                                   d(1, 4, 2, 32),
                                                   d(1, 4, 2, 32)),
        "mamba_scan": lambda: mamba_scan(d(1, 2, 4), d(1, 2, 4), d(1, 2, 8),
                                         d(1, 2, 8), d(4, 8), d(1, 4, 8)),
        "wkv": lambda: wkv(d(1, 2, 1, 32), d(1, 2, 1, 32), d(1, 2, 1, 32),
                           d(1, 2, 1, 32), d(1, 32), d(1, 1, 32, 32)),
        "server_step_update": lambda: server_step_update(
            torch.zeros(8), d(2, 8), torch.zeros(8), torch.ones(2),
            lr=0.1),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except TypeError as e:
            out[name] = str(e)
    return out


def _decode_graph(job):
    """``launch.serve.DecodeGraph`` adopting a DTensor cache, through the
    decode bundle's ``lower()``: qwen3-4b's smoke config under fsdp_tp,
    prefilled by the bundle, then one step of the runner beside one of the
    bundle's eager call on a copy of the same cache.  Returns each buffer's
    placements, whether its local storage is its own (no other buffer's),
    and whether the logits and the cache equal the eager call's bit for
    bit."""
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step)
    from repro_torch.launch.graphs import buffer_of, local
    from repro_torch.sharding.spec import values_tree
    cfg = get_smoke_config("qwen3-4b")
    mesh = job["mesh_obj"]
    b, s = 4, 12
    run = RunConfig(arch="qwen3-4b", strategy="fsdp_tp",
                    compute_dtype="float32")
    pre = build_prefill_step(cfg, run, InputShape("p", s, b, "prefill"),
                             mesh)
    dec = build_decode_step(cfg, run, InputShape("d", s + 1, b, "decode"),
                            mesh)
    params = values_tree(pre.api.init(torch.Generator().manual_seed(0)))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32))
    with torch.no_grad():
        _, cache = pre(params, {"tokens": tokens}, cache_len=s + 1)
        cache = _placed_cache(dec, cache)
        twin = {k: buffer_of(v) for k, v in cache.items()}
        tok = tokens[:, -1:]
        runner = dec.lower()
        got, got_cache = runner(params, cache, tok, s)
        want, want_cache = dec(params, twin, tok, s)
    graph = runner.graph
    buffers = dict(graph.cache, token=graph.token)
    ptrs = [local(v).untyped_storage().data_ptr() for v in buffers.values()]
    return {
        "placements": {k: str(tuple(v.placements)) if is_dtensor(v) else None
                       for k, v in buffers.items()},
        "want_placements": {
            **{k: str(tuple(v)) for k, v in dec.in_placements[1].items()},
            "token": str(tuple(dec.in_placements[2]))},
        "own_storage": len(set(ptrs)) == len(ptrs),
        "logits_equal": bool(torch.equal(_np_t(got), _np_t(want))),
        "cache_equal": all(bool(torch.equal(_np_t(got_cache[k]),
                                            _np_t(want_cache[k])))
                           for k in want_cache)}


def _placed_cache(dec, cache):
    """A prefill's cache placed as the decode bundle places it."""
    from repro_torch.launch.steps import place
    return place(cache, dec.in_placements[1], dec.mesh)


def _np_t(x):
    """A leaf gathered whole, as a tensor."""
    return x.full_tensor() if is_dtensor(x) else x


# --- tests/test_torch_mesh_graph.py -------------------------------------------


def _parent_write_rows(dst, dim: int, rows, src) -> None:
    """A copy of the sharded cache write the decode step made before its
    index was a device value: host rows, each rank writing the ones in its
    own shard (``models.layers.write_rows``' DTensor branch as it was)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.sharding.collectives import shard_offset
    if isinstance(rows, int):
        rows = range(rows, rows + 1)
    mesh = dst.device_mesh
    pl = tuple(Replicate() if q == Shard(dim) else q for q in dst.placements)
    if is_dtensor(src):
        src = src.redistribute(mesh, pl).to_local()
    else:
        src = distribute_tensor(src, mesh, pl, src_data_rank=None).to_local()
    local = dst.to_local()
    lo = shard_offset(dst, dim)
    hi = lo + local.shape[dim]
    sel = [i for i, r in enumerate(rows) if lo <= r < hi]
    if sel:
        index = torch.tensor(sel, device=local.device)
        local.index_copy_(dim, torch.tensor([rows[i] - lo for i in sel],
                                            device=local.device),
                          src.index_select(dim, index).to(local.dtype))


@contextlib.contextmanager
def _parent_write():
    """Within the block the decode step's sharded cache writes take the
    planted host-int path: the slot read to the host (``int(slot)``, the
    parent's ``int(cache_index)``), then :func:`_parent_write_rows`."""
    from repro_torch.models import layers as L
    real = L.write_row

    def write_row(dst, dim, slot, src):
        if not is_dtensor(dst):
            return real(dst, dim, slot, src)
        return _parent_write_rows(dst, dim, int(slot), src)

    L.write_row = write_row
    try:
        yield
    finally:
        L.write_row = real


def _graph_cfg(job):
    cfg = _cfg(job)
    if job.get("window"):
        cfg = cfg.with_sliding_window(job["window"])
    return cfg


def _graph_bundles(job, cfg, mesh, prompt, cache_len, b):
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step)
    run = RunConfig(arch=job["arch"], strategy="fsdp_tp",
                    compute_dtype="float32", decode_layout=job["layout"])
    pre = build_prefill_step(cfg, run, InputShape("p", prompt, b, "prefill"),
                             mesh)
    dec = build_decode_step(cfg, run, InputShape("d", cache_len, b,
                                                 "decode"), mesh)
    return pre, dec


def _decode_write(job):
    """(a) The decode step's sharded cache write at a device index against
    the parent's host-int write: from one prefill, each index of
    ``indices`` decoded once through the bundle's eager call, the same
    token, on two copies of the cache, one of them written through
    :func:`_parent_write`; the logits and every cache leaf compared bit
    for bit after each step.  Then greedy decoding from the prefill at
    the prompt's next positions, each step's logits returned."""
    from repro_torch.launch.graphs import buffer_of
    cfg = _graph_cfg(job)
    mesh = job["mesh_obj"]
    tokens = torch.from_numpy(job["tokens"])
    b, s = tokens.shape
    pre, dec = _graph_bundles(job, cfg, mesh, s, s + job["gen"], b)
    params = params_from_numpy(cfg, job["params"], "cpu")
    v = cfg.vocab_size
    out = {"steps": [], "served": []}
    with torch.no_grad():
        logits, cache = pre(params, {"tokens": tokens},
                            cache_len=s + job["gen"])
        first = logits
        cache = _placed_cache(dec, cache)
        start = {k: buffer_of(x) for k, x in cache.items()}
        mine = {k: buffer_of(x) for k, x in start.items()}
        theirs = {k: buffer_of(x) for k, x in start.items()}
        tok = tokens[:, -1:]
        out["shard_rows"] = cache["pos"].to_local().shape[1]
        out["cache_rows"] = cache["pos"].shape[1]
        for i in job["indices"]:
            got, mine = dec(params, mine, tok, i)
            with _parent_write():
                want, theirs = dec(params, theirs, tok, i)
            out["steps"].append((i, bool(torch.equal(_np_t(got),
                                                     _np_t(want))),
                                 all(bool(torch.equal(_np_t(mine[k]),
                                                      _np_t(theirs[k])))
                                     for k in mine)))
        logits, cache = first, start
        out["served"].append(_np(logits))
        for i in range(job["gen"]):
            tok = torch.from_numpy(_np(logits)[:, -1, :v].argmax(-1)[:, None]
                                   .astype(np.int32))
            logits, cache = dec(params, cache, tok, s + i)
            out["served"].append(_np(logits))
    return out


class _ReplayedCapture:
    """A stand-in for ``graphs.Capture`` on the CPU that keeps what a CUDA
    graph keeps: the captured call's outputs, which each replay rewrites
    (local shard by local shard) by running the function again on the
    same buffers; so a runner's graph-route bookkeeping runs here.  Its
    capture runs the function for its outputs and then puts back what
    the call wrote into the runner's buffers (a decode graph's cache and
    new leaves), as a capture, which runs nothing, leaves them; it counts
    the collective calls the function makes (``collectives``, by kind:
    ``launch.hlo_analysis.CollectiveCalls``), as a graph records them."""

    def __init__(self, device):
        self.per_replay = {}
        self.collectives = None

    def warm(self, body):
        return body()

    def record(self, body):
        from repro_torch.launch.graphs import local
        runner = body.__self__
        written = [local(t) for t in list(getattr(runner, "cache", {})
                                          .values())
                   + list(getattr(runner, "fresh", {}).values())]
        from repro_torch.launch.hlo_analysis import CollectiveCalls
        kept = [t.clone() for t in written]
        with CollectiveCalls() as calls:
            self.body, self.outs = body, body()
        self.collectives = dict(calls.calls)
        for t, k in zip(written, kept):
            t.copy_(k)
        return self.outs

    def first(self, body):
        return self.warm(body), self.record(body)

    def copies(self, pairs):
        import types
        return types.SimpleNamespace(
            replay=lambda: [dst.copy_(src) for dst, src in pairs])

    def replay(self):
        from repro_torch.launch.graphs import local
        for out, new in zip(_out_leaves(self.outs),
                            _out_leaves(self.body())):
            local(out).copy_(local(new))


def _out_leaves(outs) -> list:
    from repro_torch.launch.graphs import _leaves
    if isinstance(outs, tuple):
        return [x for o in outs for x in _leaves(o)
                if isinstance(x, torch.Tensor)]
    return [outs]


def _graphed_on_the_cpu(base):
    """``base`` (a runner class) on the stand-in capture, its graph route
    taken on the CPU."""
    class Graphed(base):
        capture_type = _ReplayedCapture

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.graphed = True
    return Graphed


@contextlib.contextmanager
def _graphed(on: bool = True):
    """Within the block (``on``), ``launch.steps``' runners are built on
    the stand-in capture."""
    from repro_torch.launch import steps
    real = steps.StepGraph, steps.DecodeGraph
    if on:
        steps.StepGraph, steps.DecodeGraph = map(_graphed_on_the_cpu, real)
    try:
        yield
    finally:
        steps.StepGraph, steps.DecodeGraph = real


def _state_leaves(state) -> list:
    return [_np_t(x) for x in tree_leaves(vars(state))]


def _lower_train(job):
    """(b) ``bundle.lower()`` of a training bundle against a plain loop of
    the bundle's eager call over the same batches, from the same init:
    after each step, whether the loss and every state leaf are equal bit
    for bit; on the stand-in capture's graph route with ``graphed``, and
    the collective calls its capture counted."""
    from repro_torch.launch.steps import build_train_step
    cfg = _cfg(job)
    batches = [{k: torch.from_numpy(v) for k, v in bt.items()}
               for bt in job["batches"]]
    b, s = batches[0]["tokens"].shape
    run = RunConfig(arch=job["arch"], strategy=job["strategy"],
                    learning_rate=job["lr"], compute_dtype="float32")
    bundle = build_train_step(cfg, run, InputShape("custom", s, b, "train"),
                              job["mesh_obj"])
    def init():
        return bundle.init(params=params_from_numpy(
            bundle.cfg, job["params"], "cpu"), batch=batches[0])

    plain, lowered = init(), init()
    with _graphed(job["graphed"]):
        runner = bundle.lower()
        same = []
        for bt in batches:
            plain, m0 = bundle(plain, bt)
            lowered, m1 = runner(lowered, bt)
            same.append((bool(torch.equal(_np_t(m0["loss"]),
                                          _np_t(m1["loss"]))),
                         all(bool(torch.equal(x, y)) for x, y in zip(
                             _state_leaves(plain), _state_leaves(lowered)))))
    graph = runner.graph
    return {"same": same, "collectives": _collectives(graph),
            "captured": graph.capture is not None,
            "placed_as": all(
                (is_dtensor(x) and tuple(x.placements) == pl) or pl is None
                for x, pl in zip(tree_leaves(vars(graph.state)),
                                 _pl_leaves(bundle.in_placements[0])))}


def _pl_leaves(pls) -> list:
    """The placement tuples (or None) of a placement tree, in leaf
    order."""
    from torch.distributed.tensor import Placement
    out = []

    def walk(x):
        if x is None or (isinstance(x, tuple) and x and all(
                isinstance(q, Placement) for q in x)):
            out.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif dataclasses.is_dataclass(x):
            walk(vars(x))
    walk(pls)
    return out


def _lower_decode(job):
    """(b) ``bundle.lower()`` of a decode bundle against a plain loop of
    the bundle's eager call: one prefill, then greedy steps through each
    from copies of its cache; after each step whether the logits and every
    cache leaf are equal bit for bit (the graph route's on the stand-in
    capture with ``graphed``)."""
    from repro_torch.launch.graphs import buffer_of
    cfg = _graph_cfg(job)
    mesh = job["mesh_obj"]
    tokens = torch.from_numpy(job["tokens"])
    b, s = tokens.shape
    pre, dec = _graph_bundles(job, cfg, mesh, s, s + job["gen"], b)
    params = params_from_numpy(cfg, job["params"], "cpu")
    v = cfg.vocab_size
    same = []
    with torch.no_grad(), _graphed(job["graphed"]):
        logits, cache = pre(params, {"tokens": tokens},
                            cache_len=s + job["gen"])
        cache = _placed_cache(dec, cache)
        plain = {k: buffer_of(x) for k, x in cache.items()}
        lowered = {k: buffer_of(x) for k, x in cache.items()}
        runner = dec.lower()
        tok = torch.from_numpy(_np(logits)[:, -1, :v].argmax(-1)[:, None]
                               .astype(np.int32))
        for i in range(job["gen"]):
            want, plain = dec(params, plain, tok, s + i)
            got, lowered = runner(params, lowered, tok, s + i)
            same.append((bool(torch.equal(_np_t(got), _np_t(want))),
                         all(bool(torch.equal(_np_t(lowered[k]),
                                              _np_t(plain[k])))
                             for k in plain)))
            tok = torch.from_numpy(_np(want)[:, -1, :v].argmax(-1)[:, None]
                                   .astype(np.int32))
    return {"same": same, "collectives": _collectives(runner.graph),
            "captured": runner.graph.capture is not None}


def _collectives(graph):
    """The collective calls ``graph``'s stand-in capture counted (None
    where it made none: the CPU route)."""
    return graph.capture.collectives if graph.capture else None


class _NoHostRead(TorchDispatchMode):
    """A dispatch mode that refuses to read a tensor's value on the host
    (``aten._local_scalar_dense``: ``int()``, ``float()``, ``.item()``):
    what a CUDA graph of the step would freeze at the captured call.  An
    op on a DTensor is left to DTensor, whose ops on the local shards
    come back through the mode."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if func is torch.ops.aten._local_scalar_dense.default:
            raise RuntimeError("the step read a tensor's value on the host")
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        return func(*args, **(kwargs or {}))


def _host_read(job):
    """(c) Decode steps of the lowered runner at a device index, under
    :class:`_NoHostRead`: the message it raises (None where the steps ran
    through), with the step as it is and with the planted host-int write
    (:func:`_parent_write`)."""
    cfg = _graph_cfg(job)
    mesh = job["mesh_obj"]
    tokens = torch.from_numpy(job["tokens"])
    b, s = tokens.shape
    pre, dec = _graph_bundles(job, cfg, mesh, s, s + job["gen"], b)
    params = params_from_numpy(cfg, job["params"], "cpu")
    out = {}
    for name, ctx in (("as_is", contextlib.nullcontext),
                      ("planted", _parent_write)):
        with torch.no_grad():
            _, cache = pre(params, {"tokens": tokens},
                           cache_len=s + job["gen"])
            runner = dec.lower()
            index = torch.full((), s, dtype=torch.int32)
            try:
                with ctx(), _NoHostRead():
                    for i in range(job["gen"]):
                        index.fill_(s + i)
                        _, cache = runner(params, cache, tokens[:, -1:],
                                          index)
                out[name] = None
            except RuntimeError as e:
                out[name] = str(e)
    return out


def _placement_mismatch(job):
    """(d) A ``StepGraph`` whose step hands back a leaf placed otherwise
    than its buffer (sharded over ``model``, handed back replicated): the
    ``ValueError`` it raises on the CPU route and on the stand-in
    capture's graph route (None where none was raised)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.graphs import StepGraph
    mesh = job["mesh_obj"]
    out = {}
    for route in ("cpu", "graphed"):
        w = distribute_tensor(torch.arange(16.0).reshape(4, 4), mesh,
                              (Replicate(), Shard(0)), src_data_rank=None)

        def step(state, batch):
            new = (state["w"] + batch["x"]).redistribute(
                mesh, (Replicate(), Replicate()))
            return {"w": new}, None

        runner = StepGraph(step, {"w": w})
        if route == "graphed":
            runner.graphed, runner.capture_type = True, _ReplayedCapture
        x = distribute_tensor(torch.ones(4, 4), mesh, (Replicate(),
                                                       Shard(0)),
                              src_data_rank=None)
        try:
            for _ in range(3):
                runner({"x": x})
            out[route] = None
        except ValueError as e:
            out[route] = str(e)
    return out


JOBS = {"train": _train, "serve": _serve, "moe": _moe,
        "server_step": _server_step, "refusals": _refusals,
        "vocab": _vocab, "decode_graph": _decode_graph,
        "decode_write": _decode_write, "lower_train": _lower_train,
        "lower_decode": _lower_decode, "host_read": _host_read,
        "placement_mismatch": _placement_mismatch}


def main(rank: int, world: int, store: str, jobs: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        with open(jobs, "rb") as f:
            todo = pickle.load(f)
        meshes = {}
        results = []
        for job in todo:
            shape = tuple(job.get("mesh", (1, world)))
            if shape not in meshes:
                meshes[shape] = _mesh(shape)
            job = dict(job, mesh_obj=meshes[shape])
            results.append(JOBS[job["kind"]](job))
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
