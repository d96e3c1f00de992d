"""Training driver: LM training with the paper's split strategies, the
port of ``repro.launch.train`` on one device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 20 --batch 8 --seq 512                  # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --smoke --steps 6 --device cpu                  # anywhere
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
      --smoke --steps 6 --lr 0.1 --compute-dtype bfloat16 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import (InputShape, RunConfig, get_arch_config,
                                      get_smoke_config)
from repro_torch.core.split_parallel import (init_prev_features,
                                             make_train_step, merge_params)
from repro_torch.data import TicketDataLoader, make_lm_batch
from repro_torch.data.synthetic import InlineWorker
from repro_torch.device import resolve_device
from repro_torch.launch.steps import arch_for_run
from repro_torch.models.model import build_model
from repro_torch.optim import get_optimizer

def train_loop(cfg, run: RunConfig, *, steps: int, batch: int, seq: int,
               log_every: int = 10, checkpoint_path=None, device="cuda"):
    """Train ``cfg`` for ``steps`` on synthetic LM batches with the
    strategy named in ``run``; returns (per-step losses, final state).

    Params are f32 and the model computes in ``run.compute_dtype``, as the
    JAX package's ``train_loop``; the adagrad optimizer runs its kernel
    (K2) on the card and its plain version on the CPU.  The batches are
    tokens alone (``make_lm_batch``), so the ``vlm`` and ``encdec``
    families, whose batches also carry patches or frames, are refused:
    they train through ``make_train_step`` with those in the batch."""
    dev = resolve_device(device)
    if cfg.family in ("vlm", "encdec"):
        raise ValueError(
            f"train_loop makes token batches alone, and a {cfg.family!r} "
            f"batch ({cfg.name}) also needs "
            f"{'patches' if cfg.family == 'vlm' else 'frames'}; the JAX "
            f"package's train_loop fails on it too (KeyError). Train it "
            f"through make_train_step with them in the batch")
    dtype = getattr(torch, run.compute_dtype)
    shape = InputShape("custom", seq, batch, "train")
    cfg = arch_for_run(cfg, shape, run.strategy)
    api = build_model(cfg, compute_dtype=dtype, remat=run.remat)
    kw = {"use_kernel": True} if run.optimizer == "adagrad" else {}
    opt = get_optimizer(run.optimizer, run.learning_rate,
                        adagrad_beta=run.adagrad_beta,
                        weight_decay=run.weight_decay, **kw)
    init_state, step_fn = make_train_step(
        api, opt, strategy=run.strategy,
        head_sync_period=run.head_sync_period)

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
    state = init_state(generator)
    first = batch_at(0)
    if run.strategy in ("split_concurrent", "split_server_sharded"):
        state = init_prev_features(state, api, first, dtype=dtype)
    losses = []
    t0 = time.time()
    for i in range(steps):
        b = first if i == 0 else batch_at(i)
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])
        losses.append(loss)
        if i % log_every == 0 or i == steps - 1:
            dt = time.time() - t0
            print(f"step {i:5d} loss {loss:.4f} "
                  f"({dt/(i+1):.3f}s/step)", flush=True)
    if checkpoint_path:
        from repro_torch.checkpoint import save_npz
        save_npz(checkpoint_path, merge_params(state.params, state.head))
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
    if args.data_par * args.model_par > 1:
        raise NotImplementedError(
            "--data-par/--model-par > 1 (a device mesh) comes with a later "
            "slice of the port (ROADMAP.md, Queue 1 item 7 (sharding))")
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_arch_config(args.arch))
    run = RunConfig(arch=args.arch, strategy=args.strategy,
                    optimizer=args.optimizer, learning_rate=args.lr,
                    adagrad_beta=args.adagrad_beta,
                    compute_dtype=args.compute_dtype)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, _ = train_loop(cfg, run, steps=args.steps, batch=args.batch,
                           seq=args.seq, checkpoint_path=args.checkpoint,
                           device=dev)
    where = "cpu"
    if dev.type == "cuda":
        where = (f"{torch.cuda.get_device_name(dev)}, peak "
                 f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}) on {where}")
    return losses


if __name__ == "__main__":
    main()
