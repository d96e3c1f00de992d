#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper
card: the quickest proof that the port still builds, starts and trains on
the GPU.

    python3 chip_smoke.py

Phases, one line each:

  1. environment: versions, the card, ``nvidia-smi`` name and power limit;
     TF32 off and cuDNN deterministic, so the checks below are exact;
  2. build: both CUDA kernels from the checkout's sources (nvcc, first use);
  3. each kernel against its plain PyTorch version on the card, over edge
     and main-path sizes, bitwise; the kernel's and the plain version's
     times on the card at the main path's shapes beside the card's bound,
     and the kernel's time as a caller that issues one call at a time
     waits for it (``unheld``);
  4. the Fig. 3 path at full width: the FIG4 CNN (609,258 params) trained
     through a FederatedDistributor behind a TransportServer with 3 remote
     v2-wire clients on loopback, K-of-N reticket barrier, FusedServerStep
     on the card; held to its in-process twin (TreeServerStep), and a
     round checkpoint written and reloaded bit-exactly;
  5. the quickstart path: the FIG2 CNN trained in-process with
     ``adagrad(use_kernel=True)``.

The launch counts of each kernel are set to 0 just before the path that
runs it and read just after.  The line before the last is one JSON object
with every kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; so does a host without CUDA.
"""
from __future__ import annotations

import asyncio
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.paper_cnn import FIG2_CNN, FIG4_CNN  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.adagrad.ops import adagrad_update  # noqa: E402
from repro_torch.kernels.adagrad.ref import adagrad_ref  # noqa: E402
from repro_torch.kernels.server_step.ops import server_step_update  # noqa: E402
from repro_torch.kernels.server_step.ref import server_step_ref  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

#: H100 SXM data-sheet peaks (dense): HBM3 bytes/s and f32 (non-tensor-core)
#: flop/s; the bound of a kernel is the larger of its two times.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

KERNEL_SIZES = (1, 127, 8192, 609_258, 1_000_003)
#: (p, g) dtypes K2 takes: g in p's dtype, or f32 under bf16 params
#: (TreeServerStep's mean is f32)
K2_DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.bfloat16, torch.float32))
FABRIC_ROUNDS = 6
FABRIC_SHARDS = 4
FABRIC_BATCH = 50                       # the paper's mini-batch
FABRIC_LR = 0.05
QUICKSTART_STEPS = 30
QUICKSTART_LR = 0.02


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# --- 1. environment ---------------------------------------------------------


def phase_environment() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is "
                           "available")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"a Hopper card (capability 9.0), got {cap}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    say("1 environment", python=sys.version.split()[0],
        torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(dev["kind"]), capability=f"{cap[0]}.{cap[1]}",
        count=dev["count"], tf32="off", cudnn_deterministic="on")
    print(smi.splitlines()[0], flush=True)
    return dev


# --- 3. kernels against their plain versions ---------------------------------


class ColdTimer:
    """Median CUDA-event time of ``fn`` with the 50 MB L2 flushed before
    every run (writing a 256 MB buffer), so each input is read from device
    memory as the bound assumes.

    With ``hold`` (the default) the card also spins before every run for
    twice the host's time to issue ``fn``, so all of ``fn``'s launches are
    queued before the first starts and the events time the card's work,
    not the host's launch rate.  Without it the time is what a caller that
    issues one call at a time waits for."""

    def __init__(self, reps: int = 50, warmup: int = 5, hold: bool = True):
        self.reps, self.warmup, self.hold = reps, warmup, hold
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                                 device="cuda")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(1_000_000)
        end.record()
        torch.cuda.synchronize()
        self.spin_cycles_per_ms = 1e6 / start.elapsed_time(end)

    def __call__(self, fn) -> float:
        t0 = time.perf_counter()
        for _ in range(self.warmup):
            fn()
        torch.cuda.synchronize()
        issue_ms = 1e3 * (time.perf_counter() - t0) / self.warmup
        spin = int(2 * issue_ms * self.spin_cycles_per_ms) + 1
        pairs = []
        for _ in range(self.reps):
            self.flush.zero_()
            if self.hold:
                torch.cuda._sleep(spin)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def phase_kernels(timer: ColdTimer, unheld: ColdTimer) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    # K1: the fused server step
    k1_err, k1_cases = 0.0, 0
    for n in KERNEL_SIZES:
        for members in (1, 4):
            for wd in (0.0, 1e-2):
                p, acc = rand(n), rand(n).abs()
                g = rand(members, n)
                c = torch.rand(members, generator=gen, device="cuda")
                kw = dict(lr=FABRIC_LR, beta=1.0, weight_decay=wd)
                got = server_step_update(p, g, acc, c, **kw)
                want = server_step_ref(p, g, acc, c, **kw)
                torch.cuda.synchronize()
                for x, y, what in zip(got, want, ("p'", "acc'")):
                    check(torch.equal(x, y), f"K1 {what} bitwise equal to "
                          f"the plain version at n={n} M={members} wd={wd}")
                    k1_err = max(k1_err, _max_err(x, y))
                k1_cases += 1
    # K2: the per-leaf AdaGrad step, at edge sizes for every (p, g) dtype
    # pair the wrapper takes, then at the quickstart's own leaves
    k2_err, k2_cases = 0.0, 0
    kw2 = dict(lr=QUICKSTART_LR, beta=1.0)

    def k2_check(p, g, acc, where):
        nonlocal k2_err, k2_cases
        got = adagrad_update(p, g, acc, **kw2)
        want = adagrad_ref(p, g, acc, **kw2)
        torch.cuda.synchronize()
        for x, y, what in zip(got, want, ("p'", "acc'")):
            check(x.dtype == y.dtype and torch.equal(x, y),
                  f"K2 {what} bitwise equal to the plain version at {where}")
            k2_err = max(k2_err, _max_err(x, y))
        k2_cases += 1

    for n in KERNEL_SIZES:
        for pt, gt in K2_DTYPES:
            k2_check(rand(n, dtype=pt), rand(n, dtype=gt), rand(n).abs(),
                     f"n={n} p={pt} g={gt}")

    # times at the main path's shapes
    n4 = sum(x.numel() for x in tree_leaves(cnn.init_cnn(
        torch.Generator().manual_seed(0), FIG4_CNN, "cuda")))
    members = FABRIC_SHARDS
    p, acc, g = rand(n4), rand(n4).abs(), rand(members, n4)
    c = torch.full((members,), 1.0 / members, device="cuda")
    kw = dict(lr=FABRIC_LR, beta=1.0)
    k1_ms = timer(lambda: server_step_update(p, g, acc, c, **kw))
    k1_plain = timer(lambda: server_step_ref(p, g, acc, c, **kw))
    k1_unheld = unheld(lambda: server_step_update(p, g, acc, c, **kw))
    k1_bytes = (members + 4) * 4 * n4 + 4 * members
    k1_flops = (2 * members + 7) * n4
    k1_bound = 1e3 * max(k1_bytes / PEAK_BYTES_S, k1_flops / PEAK_F32_FLOP_S)

    leaves = tree_leaves(cnn.init_cnn(torch.Generator().manual_seed(0),
                                      FIG2_CNN, "cuda"))
    grads = [rand(*x.shape) for x in leaves]
    accs = [rand(*x.shape).abs() for x in leaves]
    for p_, g_, a_ in zip(leaves, grads, accs):
        k2_check(p_, g_, a_, f"FIG2 leaf {tuple(p_.shape)}")

    def step(fn):
        return lambda: [fn(p_, g_, a_, **kw2)
                        for p_, g_, a_ in zip(leaves, grads, accs)]

    k2_ms = timer(step(adagrad_update))
    k2_plain = timer(step(adagrad_ref))
    k2_unheld = unheld(step(adagrad_update))
    n2 = sum(x.numel() for x in leaves)
    k2_bound = 1e3 * max(5 * 4 * n2 / PEAK_BYTES_S,
                         7 * n2 / PEAK_F32_FLOP_S)

    say("3 kernels", k1_cases=k1_cases, k1_bitwise="yes",
        k1_ms=f"{k1_ms:.6f}", k1_plain_ms=f"{k1_plain:.6f}",
        k1_bound_ms=f"{k1_bound:.6f}", k1_unheld_ms=f"{k1_unheld:.6f}",
        k1_shape=f"n={n4},M={members}",
        k2_cases=k2_cases, k2_bitwise="yes", k2_step_ms=f"{k2_ms:.6f}",
        k2_plain_step_ms=f"{k2_plain:.6f}", k2_bound_ms=f"{k2_bound:.6f}",
        k2_unheld_step_ms=f"{k2_unheld:.6f}",
        k2_shape=f"{len(leaves)}_leaves,n={n2}")
    return {
        "server_step": {
            "name": "server_step", "route": "cuda",
            "source": "src/repro_torch/kernels/server_step/kernel.cu",
            "replaces": "src/repro/kernels/server_step/kernel.py:36",
            "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
            "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": None},
        "adagrad": {
            "name": "adagrad", "route": "cuda",
            "source": "src/repro_torch/kernels/adagrad/kernel.cu",
            "replaces": "src/repro/kernels/adagrad/kernel.py:21",
            "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
            "bound_ms": k2_bound, "bound_by": "bytes", "library_ms": None},
    }


# --- 4. the Fig. 3 path through the fabric ------------------------------------


def _fabric_plan():
    rows = FABRIC_SHARDS * FABRIC_BATCH
    args = [(lo, lo + FABRIC_BATCH) for lo in range(0, rows, FABRIC_BATCH)]
    return rows, args, [float(FABRIC_BATCH)] * FABRIC_SHARDS


def _train_state(params, opt):
    from repro_torch.core.split_parallel import TrainState
    return TrainState(params=params, head={}, head_stale={},
                      opt_state=opt.init(params), head_opt_state={},
                      prev_features=(), prev_labels=(), prev_mask=(),
                      step=torch.zeros((), dtype=torch.int32))


async def _fabric_train(rounds: int, n_clients: int = 3):
    from repro_torch.core.distributor import ClientProfile, TaskDef
    from repro_torch.core.federation import FederatedDistributor
    from repro_torch.core.transport import (TransportServer,
                                            spawn_remote_clients)
    from repro_torch.optim import adagrad
    from repro_torch.train_fabric import (FederatedTrainer,
                                          FederatedTrainingLoop,
                                          FusedServerStep)

    rows, args, work = _fabric_plan()
    fed = FederatedDistributor(2, n_shards=4, timeout=20.0,
                               redistribute_min=0.02,
                               watchdog_interval=0.01, grace=2.0,
                               project_name="Fig3Fabric")
    fed.register_task(TaskDef(
        "cnn_grad_shard", cnn.CnnGradShard(FIG4_CNN, n_rows=rows),
        static_files=("weights",)))
    server = TransportServer(fed)
    host, port = await server.start()
    clients, tasks = spawn_remote_clients(
        (host, port),
        [ClientProfile(name=f"r{i}", speed=500.0) for i in range(n_clients)],
        reconnect_delay=0.02)
    opt = adagrad(FABRIC_LR, beta=1.0)
    params = cnn.init_cnn(torch.Generator().manual_seed(0), FIG4_CNN)
    trainer = FederatedTrainer(fed, task_name="cnn_grad_shard",
                               barrier_k=0.75, straggler_policy="reticket",
                               timeout=60.0)
    loop = FederatedTrainingLoop(
        trainer, opt, _train_state(params, opt),
        server_step=FusedServerStep(opt, lr=FABRIC_LR, beta=1.0))
    try:
        async with trainer:
            for _ in range(rounds):
                await loop.run_round(args, work)
        await asyncio.wait_for(asyncio.gather(*tasks), 60.0)
    finally:
        # bounded: TransportServer.stop() waits for open connections
        await asyncio.wait_for(server.stop(), 60.0)
        await fed.shutdown()
    errors = (sum(c.errors for c in clients)
              + fed.queue.snapshot()["errors"] + server.protocol_errors)
    return loop, trainer, errors


def _in_process_twin(rounds: int):
    """The fabric run's twin: the same CnnGradShard calls over the same
    round shards, folded by the TreeServerStep reference.  Returns its
    per-round losses, final params and final optimizer state."""
    from repro_torch.optim import adagrad
    from repro_torch.train_fabric import TreeServerStep

    rows, args, work = _fabric_plan()
    task = cnn.CnnGradShard(FIG4_CNN, n_rows=rows)
    opt = adagrad(FABRIC_LR, beta=1.0)
    params = cnn.init_cnn(torch.Generator().manual_seed(0), FIG4_CNN)
    opt_state = opt.init(params)
    step = TreeServerStep(opt)
    losses = []
    for t in range(rounds):
        served = {"round": t, "params": cnn.params_to_numpy(params)}
        outs = [task(a, {"weights": served}) for a in args]
        params, opt_state = step.step([o["grad"] for o in outs], work,
                                      params, opt_state)
        losses.append(sum(o["loss"] * w for o, w in zip(outs, work))
                      / sum(work))
    return losses, params, opt_state


def _same_bits(a, b) -> bool:
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def phase_fabric() -> int:
    from repro_torch.train_fabric import (load_round_checkpoint,
                                          param_count, state_to_tree)

    server_step_update.launches = 0
    t0 = time.perf_counter()
    loop, trainer, errors = asyncio.run(_fabric_train(FABRIC_ROUNDS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = server_step_update.launches
    check(launches == FABRIC_ROUNDS,
          f"server_step launched once per round: {launches} launches in "
          f"{FABRIC_ROUNDS} rounds")
    check(loop.stale_executions == 0,
          f"no stale-weight executions, got {loop.stale_executions}")
    check(errors == 0, f"no task or protocol errors, got {errors}")
    losses = loop.losses
    check(len(losses) == FABRIC_ROUNDS and all(np.isfinite(losses)),
          f"finite loss every round: {losses}")
    check(losses[-1] < losses[0], f"the loss falls: {losses}")
    twin, twin_params, twin_opt = _in_process_twin(FABRIC_ROUNDS)
    delta = max(abs(a - b) for a, b in zip(losses, twin))
    check(delta < 1e-6, f"fabric trajectory within 1e-6 of its in-process "
          f"twin: {losses} vs {twin}")
    # the last round's update reaches no loss: hold the final state itself
    for what, a, b in (("params", loop.state.params, twin_params),
                       ("acc", loop.state.opt_state["acc"], twin_opt["acc"])):
        fa, fb = tree_leaves(a), tree_leaves(b)
        check(len(fa) == len(fb)
              and all(_same_bits(x, y) for x, y in zip(fa, fb)),
              f"final {what} of the fused fabric run bit-identical to the "
              f"TreeServerStep twin's")
    with tempfile.TemporaryDirectory() as tmp:
        loop.checkpoint_dir = tmp
        state, rnd, extra = load_round_checkpoint(loop.checkpoint())
    check(rnd == FABRIC_ROUNDS and extra["losses"] == losses,
          "checkpoint round index and losses")
    want = tree_leaves(state_to_tree(loop.state))
    got = tree_leaves(state_to_tree(state))
    check(len(want) == len(got)
          and all(_same_bits(a, b) for a, b in zip(want, got)),
          "round checkpoint reloads bit-exactly")
    say("4 fabric", model=FIG4_CNN.name,
        params=param_count(loop.state.params), rounds=FABRIC_ROUNDS,
        shards=f"{FABRIC_SHARDS}x{FABRIC_BATCH}", clients="3_remote_v2",
        loss_first=f"{losses[0]:.6f}", loss_final=f"{losses[-1]:.6f}",
        max_delta_vs_twin=f"{delta:.3g}", final_state_vs_twin="bitwise",
        stale=loop.stale_executions,
        errors=errors, reticketed=trainer.reticketed_total,
        server_step_launches=launches, checkpoint="bit-exact",
        wall_s=f"{wall:.3f}")
    return launches


# --- 5. the quickstart path ----------------------------------------------------


def phase_quickstart() -> int:
    from repro_torch.data import clustered_images
    from repro_torch.optim import adagrad

    ccfg = FIG2_CNN
    params = cnn.init_cnn(torch.Generator().manual_seed(0), ccfg)
    n_leaves = len(tree_leaves(params))
    opt = adagrad(QUICKSTART_LR, beta=1.0, use_kernel=True)
    opt_state = opt.init(params)
    images, labels = clustered_images(4096, image_size=ccfg.image_size,
                                      channels=ccfg.in_channels, seed=0)
    test_x, test_y = clustered_images(512, image_size=ccfg.image_size,
                                      channels=ccfg.in_channels, seed=9)
    images = torch.from_numpy(images).cuda()
    labels = torch.from_numpy(labels).cuda()
    grad_fn = cnn.loss_and_grads(ccfg)
    bs = ccfg.batch_size
    adagrad_update.launches = 0
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(QUICKSTART_STEPS):
        j = (i * bs) % (len(images) - bs)
        loss, grads = grad_fn(params, images[j:j + bs], labels[j:j + bs])
        params, opt_state = opt.update(grads, opt_state, params)
        losses.append(loss)
    torch.cuda.synchronize()
    per_step_ms = 1e3 * (time.perf_counter() - t0) / QUICKSTART_STEPS
    launches = adagrad_update.launches
    check(launches == QUICKSTART_STEPS * n_leaves,
          f"adagrad launched once per leaf per step: {launches} launches, "
          f"{QUICKSTART_STEPS} steps x {n_leaves} leaves")
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"finite losses: {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check(last < first, f"mean loss of the last 5 steps ({last}) below the "
          f"first 5 ({first})")
    with torch.no_grad():
        err = float(cnn.error_rate(
            cnn.forward(params, ccfg, torch.from_numpy(test_x).cuda()),
            torch.from_numpy(test_y).cuda()))
    check(0.0 <= err <= 1.0, f"test error rate in [0, 1]: {err}")
    say("5 quickstart", model=ccfg.name, steps=QUICKSTART_STEPS,
        batch=bs, loss_first5=f"{first:.6f}", loss_last5=f"{last:.6f}",
        test_error=f"{err:.4f}", adagrad_launches=launches,
        step_ms=f"{per_step_ms:.3f}")
    return launches


def main() -> int:
    device = phase_environment()
    built = build.build()
    say("2 build", kernels=",".join(build.KERNELS), seconds=f"{built:.3f}",
        flags=repr(" ".join(build.NVCC_FLAGS)))
    kernels = phase_kernels(ColdTimer(), ColdTimer(hold=False))
    kernels["server_step"]["launches"] = phase_fabric()
    kernels["adagrad"]["launches"] = phase_quickstart()
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
