"""Training driver: LM training with the paper's split strategies, the
port of ``repro.launch.train``, on one device or on a ``(data, model)``
device mesh.

With ``--data-par D --model-par M`` (D x M > 1) the run is sharded: start
D x M ranks with ``torchrun`` (one card a rank on ``cuda``; gloo ranks on
the CPU); every rank makes the same batches and init from the seed, and
the step builder places them on the mesh (``launch/steps.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 20 --batch 8 --seq 512                  # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --smoke --steps 6 --device cpu                  # anywhere
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
      --smoke --steps 6 --lr 0.1 --compute-dtype bfloat16 --device cpu
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch qwen3-4b --smoke --steps 3 \
      --batch 4 --seq 16 --strategy fsdp_tp --data-par 2 --model-par 2 \
      --device cpu                                    # a 2x2 gloo mesh
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import (InputShape, RunConfig, get_arch_config,
                                      get_smoke_config)
from repro_torch.core.split_parallel import merge_params
from repro_torch.data import TicketDataLoader, make_lm_batch
from repro_torch.data.synthetic import InlineWorker
from repro_torch.device import resolve_device
from repro_torch.launch.graphs import StepGraph
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import build_train_step, train_parts
from repro_torch.sharding.spec import is_dtensor
from repro_torch.tree import tree_map


def _whole(x):
    """A leaf gathered whole (a collective: every rank must call it)."""
    return x.full_tensor() if is_dtensor(x) else x


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def train_loop(cfg, run: RunConfig, *, steps: int, batch: int, seq: int,
               mesh=None, log_every: int = 10, checkpoint_path=None,
               device="cuda"):
    """Train ``cfg`` for ``steps`` on synthetic LM batches with the
    strategy named in ``run``; returns (per-step losses, final state).

    Params are f32 and the model computes in ``run.compute_dtype``, as the
    JAX package's ``train_loop``; the model, init and step are
    ``train_parts``'s, with or without a mesh, so ``run.grad_accum`` and
    ``run.loss_chunks`` apply as in the step builders (the JAX
    ``train_loop`` reads neither).  The adagrad optimizer runs its kernel
    (K2) on the card and its plain version on the CPU.  The batches are
    tokens alone (``make_lm_batch``), so the ``vlm`` and ``encdec``
    families, whose batches also carry patches or frames, are refused:
    they train through ``make_train_step`` with those in the batch.

    Without a mesh the step runs through a :class:`StepGraph`, the
    counterpart of the JAX loop's ``jax.jit(step_fn, donate_argnums=(0,))``:
    on the card the first step runs eagerly and every later one is a
    replay of one CUDA graph of the step, K2 inside it; on the CPU each
    step runs eagerly on the runner's buffers.  The state returned is the
    runner's last new state.

    ``mesh`` (a ``DeviceMesh`` on ``device``'s type, e.g.
    ``make_local_mesh``): every rank makes the same init and batches, and
    ``build_train_step`` wraps the same step to place the state and each
    batch on the mesh by the run's rules; the step runs through the
    bundle's ``lower()``, the counterpart of the JAX loop's ``jax.jit``
    under ``use_shard_ctx``: on the card the first step runs eagerly and
    every later one is a replay of one CUDA graph of the step on the mesh
    (DTensor's dispatch and the NCCL collectives captured, K2 on the
    local shards inside); on the CPU (gloo) each step runs eagerly on the
    runner's buffers.  The returned state is of DTensors.
    Only rank 0 logs and writes the checkpoint, gathered whole on every
    rank."""
    dev = resolve_device(device)
    if cfg.family in ("vlm", "encdec"):
        raise ValueError(
            f"train_loop makes token batches alone, and a {cfg.family!r} "
            f"batch ({cfg.name}) also needs "
            f"{'patches' if cfg.family == 'vlm' else 'frames'}; the JAX "
            f"package's train_loop fails on it too (KeyError). Train it "
            f"through make_train_step with them in the batch")
    shape = InputShape("custom", seq, batch, "train")
    if mesh is None:
        api, init_all, step_fn = train_parts(cfg, run, shape)
    else:
        step_fn = build_train_step(cfg, run, shape, mesh)
        api, init_all = step_fn.api, step_fn.init
    cfg = api.cfg

    rng = np.random.default_rng(run.seed)
    loader = TicketDataLoader(
        lambda step, i: make_lm_batch(rng, batch // run.microbatch_per_ticket
                                      if run.microbatch_per_ticket > 1
                                      else batch, seq, cfg.vocab_size),
        num_microbatches=1)

    def batch_at(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in
                loader.global_batch(i, [InlineWorker()]).items()}

    generator = torch.Generator(device=dev)
    generator.manual_seed(run.seed)
    first = batch_at(0)
    state = init_all(generator, batch=first)
    if mesh is None:
        graph = StepGraph(step_fn, state)

        def runner(_, b):
            return graph(b)
    else:
        runner = step_fn.lower()
    losses = []
    t0 = time.time()
    for i in range(steps):
        b = first if i == 0 else batch_at(i)
        state, metrics = runner(state, b)
        loss = float(_whole(metrics["loss"]))
        losses.append(loss)
        if (i % log_every == 0 or i == steps - 1) and _rank() == 0:
            dt = time.time() - t0
            print(f"step {i:5d} loss {loss:.4f} "
                  f"({dt/(i+1):.3f}s/step)", flush=True)
    if checkpoint_path:
        from repro_torch.checkpoint import save_npz
        whole = tree_map(_whole, merge_params(state.params, state.head))
        if _rank() == 0:
            save_npz(checkpoint_path, whole)
            print(f"checkpoint -> {checkpoint_path}")
    return losses, state


def main(argv=None):
    """CLI entry: train an arch config with a chosen strategy/optimizer."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--strategy", default="split_concurrent")
    ap.add_argument("--optimizer", default="adagrad")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--adagrad-beta", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--compute-dtype", default="float32")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = None
    if args.data_par * args.model_par > 1:
        mesh = make_local_mesh(args.data_par, args.model_par, device=dev)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_arch_config(args.arch))
    run = RunConfig(arch=args.arch, strategy=args.strategy,
                    optimizer=args.optimizer, learning_rate=args.lr,
                    adagrad_beta=args.adagrad_beta,
                    compute_dtype=args.compute_dtype)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rank = 0
    try:
        losses, _ = train_loop(cfg, run, steps=args.steps, batch=args.batch,
                               seq=args.seq, mesh=mesh,
                               checkpoint_path=args.checkpoint, device=dev)
        rank = _rank()
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
    where = "cpu"
    if dev.type == "cuda":
        where = (f"{torch.cuda.get_device_name(dev)}, peak "
                 f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    if mesh is not None:
        where += (f", rank {rank} of a {args.data_par}x{args.model_par} "
                  f"mesh")
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}) on {where}")
    return losses


if __name__ == "__main__":
    main()
