#!/usr/bin/env python3
"""Train one of ``chip_smoke.py``'s phase-13b rows (an LM family at every
published width) at other learning rates and step counts, on one CUDA
card: how each row's lr was chosen.

    python3 tools/torch_train_zoo_lr.py --arch qwen3-moe-30b-a3b \\
        --lr 0.3 1 3 --steps 8 20 [--beta 1e-8]

Each (lr, steps) runs ``chip_smoke._zoo_full`` on the row's config, batch
and sequence, at AdaGrad's β ``--beta`` (the paper's 1 by default; 1e-8
is plain AdaGrad, as ``benchmarks/fig3_convergence.py`` sets it):
``split_concurrent`` steps from a seeded init through the step's CUDA
graph (``launch.graphs.StepGraph``), K2 on every step with its first and
last launch re-run bitwise, no K3-K5 call, one traced replay, the first
``chip_smoke.GRAPH_CMP_STEPS`` steps held to an eager loop and the
planted graph faults (so at least that many steps).
It prints the phase's ``[13b train zoo]`` line (the losses among it),
then whether the loss fell (the mean of the last 3 steps below the first
3's) or what else failed.  Needs one card.
"""
from __future__ import annotations

import argparse
import gc
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    rows = {row[0]: row for row in chip_smoke.ZOO_FULL}
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(rows))
    ap.add_argument("--lr", type=float, nargs="+", required=True)
    ap.add_argument("--steps", type=int, nargs="+", default=[8])
    ap.add_argument("--beta", type=float, default=1.0)
    args = ap.parse_args(argv)
    if min(args.steps) < chip_smoke.GRAPH_CMP_STEPS:
        ap.error(f"--steps below {chip_smoke.GRAPH_CMP_STEPS}, the steps "
                 f"the row holds to its eager loop")
    chip_smoke.phase_environment()
    chip_smoke.build.build()
    arch, changes, reduced, batch, seq = rows[args.arch][:5]
    for steps in args.steps:
        for lr in args.lr:
            t0 = time.perf_counter()
            try:
                chip_smoke._zoo_full(arch, changes, reduced, batch, seq, lr,
                                     steps, args.beta)
                verdict = "ok"
            except RuntimeError as err:     # a failed check of the row
                verdict = f"failed: {err}"[:400]
            print(f"[lr] arch={arch} lr={lr} beta={args.beta} "
                  f"steps={steps} seconds={time.perf_counter() - t0:.1f} "
                  f"{verdict}", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
