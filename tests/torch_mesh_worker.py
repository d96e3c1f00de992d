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

import dataclasses
import os
import pickle
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import InputShape, RunConfig, get_smoke_config  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.model import params_from_numpy  # noqa: E402
from repro_torch.sharding.spec import (ShardCtx, is_dtensor, placements,  # noqa: E402
                                       to_pspec, use_shard_ctx)
from repro_torch.tree import tree_map, to_numpy  # noqa: E402


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
    """``launch.serve.DecodeGraph`` given DTensor parameters, then a
    DTensor cache: the message of the ``TypeError`` each raises (None
    where one did not)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch.serve import DecodeGraph
    mesh = job["mesh_obj"]
    d = distribute_tensor(torch.zeros(4, 8), mesh,
                          [Replicate()] * mesh.ndim, src_data_rank=None)
    plain = {"w": torch.zeros(4, 8)}
    out = {}
    for name, params, cache in (("params", {"w": d}, plain),
                                ("cache", plain, {"k": d})):
        try:
            DecodeGraph(None, params, cache, 1)
            out[name] = None
        except TypeError as e:
            out[name] = str(e)
    return out


JOBS = {"train": _train, "serve": _serve, "moe": _moe,
        "server_step": _server_step, "refusals": _refusals,
        "vocab": _vocab, "decode_graph": _decode_graph}


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
