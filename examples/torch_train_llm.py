"""End-to-end LLM training on the PyTorch port (``repro_torch``; the JAX
package's twin is ``examples/train_llm.py``): a qwen-family model trained
on the synthetic Markov stream with the paper's split_concurrent strategy
and the modified AdaGrad.

Defaults are a ~20M model for 200 steps; pass --d-model 768 --layers 12
--steps 300 for a ~100M run.  The optimizer runs the fused AdaGrad kernel
(K2) on the card, one launch for the backbone's tree and one for the
head's a step under split_concurrent; the demo prints the launch count.
``--device cpu`` runs its plain version.  The step runs through a
``StepGraph``, as the JAX example jits it: on the card the first step runs
eagerly and every later one replays one CUDA graph, K2 inside it.

  PYTHONPATH=src python examples/torch_train_llm.py --steps 200
  PYTHONPATH=src python examples/torch_train_llm.py --device cpu --steps 20
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.split_parallel import (  # noqa: E402
    init_prev_features, make_train_step)
from repro_torch.data import make_lm_batch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.adagrad.ops import adagrad_update_leaves  # noqa: E402
from repro_torch.launch.graphs import StepGraph  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    build_model, count_params_analytic)
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.tree import tree_as_tensors  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=384)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--strategy", default="split_concurrent")
    ap.add_argument("--optimizer", default="adagrad")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        get_smoke_config("qwen3-4b"),
        name="qwen3-mini",
        num_layers=args.layers, d_model=args.d_model,
        num_heads=max(args.d_model // 64, 1),
        num_kv_heads=max(args.d_model // 128, 1),
        head_dim=64, d_ff=args.d_model * 4, vocab_size=args.vocab,
        tie_embeddings=False)
    n_params = count_params_analytic(cfg)
    print(f"model: {cfg.name} {cfg.num_layers}L d={cfg.d_model} "
          f"({n_params/1e6:.1f}M params), strategy={args.strategy}")

    api = build_model(cfg, compute_dtype=torch.float32)
    kw = {"use_kernel": True} if args.optimizer == "adagrad" else {}
    opt = get_optimizer(args.optimizer, args.lr, adagrad_beta=1.0, **kw)
    init_state, step = make_train_step(api, opt, strategy=args.strategy)
    state = init_state(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)

    def batch():
        return tree_as_tensors(make_lm_batch(
            rng, args.batch, args.seq, cfg.vocab_size), dev)

    first = batch()
    if args.strategy in ("split_concurrent", "split_server_sharded"):
        state = init_prev_features(state, api, first, dtype=torch.float32)

    runner = StepGraph(step, state)
    adagrad_update_leaves.launches = 0
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        b = first if i == 0 else batch()
        state, m = runner(b)
        losses.append(float(m["loss"]))
        if i % 20 == 0 or i == args.steps - 1:
            dt = time.time() - t0
            tok_s = (i + 1) * args.batch * args.seq / dt
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"({tok_s:,.0f} tok/s)", flush=True)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(noise floor ~{np.log(1/0.9):.2f} for 10% flip noise)")
    launches = adagrad_update_leaves.launches
    print(f"kernel launches: adagrad={launches} ({args.steps} steps on "
          f"{dev.type})", flush=True)
    if dev.type == "cuda" and args.optimizer == "adagrad":
        assert launches == 2 * args.steps if args.strategy.startswith(
            "split") else launches == args.steps, launches
    assert losses[-1] < losses[0], "training must reduce loss"


if __name__ == "__main__":
    main()
