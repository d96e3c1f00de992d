#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper
card: the quickest proof that the port still builds, starts and trains on
the GPU.

    python3 chip_smoke.py

Phases, one line each:

  1. environment: versions, the card, ``nvidia-smi`` name and power limit;
     TF32 off and cuDNN deterministic, so the checks below are exact;
  2. build: the five CUDA kernels from the checkout's sources (nvcc, first
     use, all at once), and ptxas's registers and spills for each CUDA
     function (none may spill);
  3. each kernel against its plain PyTorch version on the card, over edge
     and main-path sizes: K1, K2 and K5 (WKV) bitwise, K3 (flash
     attention) within ``tests/test_kernels.py::_tol``; K1 at every member
     count it instantiates (1-5, 8) and its generic loop (9), on a pitched
     gradient stack and a contiguous one, with p aligned and at a
     1-element offset; K2 one leaf a call and in lists (the FIG2 step,
     mixed dtype pairs, empty, 0-d and unaligned leaves, more leaves than a
     launch takes); K3 also with fewer or more queries than keys
     (Whisper's cross-attention shape among them); each kernel's and its
     plain version's times on the card at the main path's shapes beside
     the card's bound (K1 at the
     FIG4 step with M 4 and 8 on both stacks and at a 537 MB bandwidth
     shape; K1 and K2 beside one launch of a 1-element ``add_``, and also
     as a caller that issues one call at a time waits for them,
     ``unheld``; K2 also one launch a leaf; K3 also beside PyTorch's
     ``scaled_dot_product_attention``, which nothing on the path calls; and
     at Whisper's encoder and cross-attention shapes, non-causal);
     3c. K4 (the Mamba selective scan) likewise, bitwise in every case,
     ragged DI, T 1-3 and 65 for every ds and B 3 included, and its exp
     bitwise equal to ``torch.exp`` (a case isolates the exp); its decode
     step also beside one copy of its state;
  4. the Fig. 3 path at full width: the FIG4 CNN (609,258 params) trained
     through a FederatedDistributor behind a TransportServer with 3 remote
     v2-wire clients on loopback, K-of-N reticket barrier, FusedServerStep
     on the card; held to its in-process twin (TreeServerStep), and a
     round checkpoint written and reloaded bit-exactly; each round's whole
     ``FusedServerStep.step`` timed (host clock to a synchronize) and split
     into the host stack build, its upload, K1 and the rest, beside the
     twin's ``TreeServerStep.step``; and the stack's build and upload
     three ways: as the step builds it (a kept page-locked host buffer),
     into a new pageable buffer, and the contiguous ``torch.stack`` it
     replaced;
  5. the quickstart path: the FIG2 CNN trained in-process with
     ``adagrad(use_kernel=True)``, one K2 launch a step for all 8 leaves:
     its step (``cnn.train_step``: loss, gradients and update) through a
     ``launch.graphs.StepGraph``, the first step eager and every later
     one a replay of one CUDA graph with K2 inside it (counted a replay);
     held to an eager loop of the same step on the same batches (bit for
     bit where the eager step is bit for bit against itself run to run,
     measured first by running it twice from one state (``_eager_twice``);
     else within the f32 model bar), and a runner that never refreshes
     its batch buffer must fail that check; captured and eager ms a step,
     each one's traced device ms and idle share, peaks, and the capture's
     and instantiation's seconds;
  6. serving qwen3-4b at full width and depth (f32, random weights from a
     seed): ``generate`` with batch 4, prompt 512, 16 new tokens, one K3
     launch per layer of the prefill, each decode step a replay of one
     CUDA graph of ``decode_step`` (``launch.serve.DecodeGraph``: the
     first step runs eagerly, then is captured; its kernel launches are
     counted at each replay); every served position's logits against a
     teacher-forced ``forward_features`` over prompt + generated tokens,
     and the first and last K3 launch re-run through the plain version;
     the same prompts served by a plain loop of ``decode_step``, whose
     tokens and logits the captured run must equal (bit for bit; within
     the cell's tolerance with a MoE), each decode's median ms a step, and
     each one more step traced for its idle share; then a planted fault
     (each decode step one cache slot early, captured with the step) and
     a graph runner that never updates its index buffer (every replay at
     index 0; not for rwkv6, whose step reads no index) must each fail
     the served-vs-forward check;
  7. the same for rwkv6-1.6b, with one K5 launch per layer of the prefill
     and of each decode step (inside the graph; its launch re-run is the
     last replay's); its planted fault drops the WKV state the prefill
     hands over;
  8. the same for jamba-1.5-large-398b at every published width, cut to 2
     layers (a Mamba layer with a dense FFN, then an attention layer with
     the 16-expert MoE FFN): one K4 launch for the prefill and one for
     each decode step (inside the graph), one K3 launch; the MoE's dropped
     assignments are counted in the served prefill, the plain loop's
     decode steps and the forward (a batch row that a drop touched is
     left out of the comparison); its planted fault drops the SSM state
     the prefill hands over;
  9. training qwen1.5-0.5b at every published width and depth (untied for
     the split strategies, f32, random weights from a seed) through
     ``repro_torch.launch.train.train_loop`` at lr 3 (``TRAIN_LR``), whose
     step runs through a ``StepGraph`` as in phase 5 (every training run
     of phases 9 and 13 but 13c's one-step checks does):
     a. 20 ``split_concurrent`` steps at batch 8, sequence 512, with K2
     launched twice a step (the backbone's tree and the head's), both
     inside the graph, its first and last launch re-run through the plain
     version bitwise, the step-0 head and K = 4 stale-head rules held
     bitwise, the loss falling, and no call of K3, K4 or K5; the run held
     to an eager loop of the same step from the same init on the same
     batches as in phase 5, and two planted graph faults (a stale batch
     buffer; the refresh decided on the host, so frozen at the captured
     step) that must each fail that check over 5 steps; b. one
     ``dp_full`` and one ``split_sequential`` step from the same weights
     and batch, equal within 1e-6, then each timed over 6 steps; c. 3
     ``split_concurrent`` steps at every width with depth cut to 2, on the
     card and on the host CPU from the same weights, every loss and state
     leaf within atol 2e-4 / rtol 1e-3 and every update and accumulator
     within 1e-3 of its scale, and a planted fault (the head trained on
     the current step's features) that must fail that check; d. step
     times captured and eager, tokens/s, peak memory, a traced replay, and
     one traced eager step split into matrix products, K2 and the rest,
     for the clients' half and the server's (split at a mark kernel
     launched where the server's half starts);
 10. serving qwen3-moe-30b-a3b at every published width (128 experts, top
     8), cut to 24 of 48 layers (``MOE_CUT``), as phase 6 with the MoE's
     dropped assignments counted as in phase 8; if drops touch every batch
     row, the same prompts are served and held to their forward again at a
     capacity factor where nothing drops, and both are printed;
 11. serving internvl2-26b at every published width, cut to 24 of 48
     layers (``VLM_CUT``): 256 patch embeddings (normal(0, 0.02)) before
     256 text tokens, decoded at P + S + i; its planted fault decodes at
     the JAX package's ``generate``'s index, S + i;
 12. serving whisper-small whole: 1,500 encoder frames (normal(0, 0.02))
     and a decoder prompt of 64 (``WHISPER_PROMPT``), one K3 launch for
     each encoder layer and two for each decoder layer (self and cross) of
     the prefill; the first encoder launch (Skv 1,500, non-causal), the
     first cross launch (Sq 64, Skv 1,500) and the last re-run through the
     plain version; its planted fault zeroes the cross K/V the prefill
     hands over;
 13. training the other five LM families (qwen3-moe-30b-a3b, internvl2-26b,
     whisper-small, rwkv6-1.6b, jamba-1.5-large-398b; f32 unless said,
     ``split_concurrent``, K2 on every step): a. each smoke config, batch
     2, text sequence 512 (two 256-step chunks of the recurrent scans), 3
     steps on the card and on the host CPU from one init, held as 9c
     (every loss and state leaf within ``TRAIN_TOL``, every update within
     1e-3 of its scale or one f32 spacing, the ``ZERO_GRAD`` leaves
     unmoved), and a planted fault per family that must fail (``ZOO_FAULTS``:
     the aux loss dropped, the loss over the patch positions too, the
     encoder's output detached before the cross-attention, the scan's
     state reset at the chunk boundary); b. each at every published width
     (``ZOO_FULL``: qwen3-moe-30b-a3b and internvl2-26b cut to 4 layers,
     whisper-small and rwkv6-1.6b whole, the Jamba cut with both FFNs
     dense), batch 4, one family at a time, captured: the loss's mean
     over the last 3 steps below the first 3's, K2's launches as
     ``adagrad_update_leaves`` makes them (one a tree a step, inside the
     graph) with the first and last re-run bitwise, no call of K3, K4 or
     K5, the step's ms, tokens/s and peaks, and one replay traced (CUDA
     activity only) and split into matrix products, K2 and the rest; the
     eager step run twice from one state first (bit for bit or not: the
     bar of the check; its ms, peaks and trace beside the captured ones),
     then the first 5 steps held to an eager loop of the same step (states
     compared by digest where the bar is bit for bit), and the two planted
     graph faults of 9a over 5 steps, each of which must fail (rwkv6-1.6b's
     comparison and faults at 2 of its 24 layers, ``GRAPH_CMP_CUT``, its
     eager ms and peaks its runner's first call); c. qwen1.5-0.5b at bf16
     through ``train_loop`` as 9a (20 steps, K2 twice a step inside the
     graph, held to its eager loop, the planted faults, the loss falling,
     params and accumulators f32), then one bf16 ``dp_full`` step of the
     dense, ssm and encdec smoke configs on the card against the host CPU
     within the CPU tests' bf16 training bars;
 14. the sharded paths on a 1x1 NCCL mesh, the steps on the mesh
     through ``StepBundle.lower()`` (one CUDA graph of the step, DTensor's
     dispatch and the collectives inside, replayed after the first call;
     the collective calls each capture records counted and printed, more
     than zero): a. phase 9's step through ``train_loop(mesh=)`` (5
     steps, K2 inside the graph) held to an eager mesh loop of the same
     bundle (bit for bit where that step is bitwise run to run, measured
     first) and to the unsharded ``train_loop`` (the f32 model bar), the
     two planted graph faults of 9a (through ``launch.steps``) each
     failing the first; b. the FIG4 server step row-sharded, bitwise; c.
     the qwen3-moe cut at 4 layers served under ``fsdp_tp`` through the
     expert-parallel MoE, the prefill's cache placed as the JAX prefill's
     compile places it (k and v: the batch over data; pos replicated),
     the prefill eager and the decode captured; d. rwkv6-1.6b whole, the
     same way, K5 inside the decode graph (and in the traced replay); c
     and d held to two eager mesh loops (their bar) and to the plain
     unsharded loop of ``decode_step`` (``SERVE_TOL``, equal tokens), c's
     runner that never updates its index buffer failing the first; each
     row prints captured, eager-mesh and unsharded (captured and, for c
     and d, eager) ms a step, traced device ms and idle share, peaks and
     the capture's seconds;
 15. the dry-run against real steps: phase 9's ``split_concurrent`` step
     and phase 6's prefill (f32) through ``python -m
     repro_torch.launch.dryrun`` (meta device, a 1x1 shape-only mesh, a
     subprocess each) and through the same bundles on a real 1x1 NCCL
     mesh under the same accounting mode, each after one uncounted step:
     product FLOPs equal (or within 1%, every op's difference printed),
     K2's and K3's meta launches equal the card's, the dry-run's peak
     within 15% of ``max_memory_allocated``, the step no faster than its
     roofline bound;
 16. the four torch examples (``examples/torch_*.py``) at their smallest
     flags, subprocesses on the card: each exits 0 and prints its kernel
     launches (K2 for the quickstart and the training example, K5 for
     serving, K1 for the simulator's ``--train``).

The launch counts of each kernel are set to 0 just before the path that
runs it and read just after.  The card's ``nvidia-smi`` name and power
limit line is printed in phase 1 and again before the last two lines; the
line before the last is one JSON object with every kernel's numbers; the
last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; so does a host without CUDA.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import json
import os
import re
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
from repro_torch.kernels.adagrad.ops import (  # noqa: E402
    MAX_LEAVES, adagrad_update, adagrad_update_leaves)
from repro_torch.kernels.adagrad.ops import work as k2_work  # noqa: E402
from repro_torch.kernels.adagrad.ref import adagrad_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import work as k3_work  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.mamba.ops import mamba_scan  # noqa: E402
from repro_torch.kernels.mamba.ops import work as k4_work  # noqa: E402
from repro_torch.kernels.mamba.ref import mamba_scan_ref  # noqa: E402
from repro_torch.kernels.rwkv6.ops import wkv  # noqa: E402
from repro_torch.kernels.rwkv6.ops import work as k5_work  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv_ref  # noqa: E402
from repro_torch.kernels.server_step.ops import server_step_update  # noqa: E402
from repro_torch.kernels.server_step.ops import work as k1_work  # noqa: E402
from repro_torch.kernels.server_step.ref import server_step_ref  # noqa: E402
from repro_torch.launch import graphs  # noqa: E402
from repro_torch.launch.graphs import StepGraph  # noqa: E402
from repro_torch.models import (  # noqa: E402
    cnn, hybrid, layers, mamba, rwkv, transformer)
from repro_torch.models.moe import dispatch_load  # noqa: E402
from repro_torch.train_fabric import server_step as step_mod  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves, tree_map  # noqa: E402

#: H100 SXM data-sheet peaks (dense): HBM3 bytes/s, f32 (non-tensor-core)
#: flop/s and TF32 tensor-core flop/s; the bound of a kernel is the larger
#: of its bytes' and its operations' times.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
PEAK_TF32_FLOP_S = 495e12

KERNEL_SIZES = (1, 127, 8192, 609_258, 1_000_003)
#: K1's member counts: each instantiation of its kernel (1-5, 8) and the
#: generic loop (9)
K1_MEMBERS = (1, 2, 3, 4, 5, 8, 9)
#: K1's bandwidth shape: 537 MB at M 4, where one launch's cost is small
K1_BIG_N = 16_777_219
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

#: tests/test_kernels.py::_tol: the bars K3 and K5 are held to
TOL_F32 = dict(atol=3e-5, rtol=1e-4)
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)
#: K2, K4 and K5 are held to their plain versions bit for bit
BITWISE = dict(atol=0.0, rtol=0.0)
#: test_flash_attention_sweep's grid (b, s, hq, hkv, hd), plus sequences
#: that no 32- or 64-row tile divides (1, 65, 100)
K3_SHAPES = ((1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 512, 4, 1, 128),
             (2, 192, 6, 2, 32), (2, 100, 4, 2, 64), (1, 1, 4, 1, 64),
             (2, 65, 8, 2, 128), (2, 65, 6, 2, 32))
K3_MASKS = ((True, 0), (False, 0), (True, 64))
#: K3 with fewer or more queries than keys (b, sq, skv, hq, hkv, hd), as
#: Whisper's cross-attention (Sq 64 against Skv 1,500 frames) and decode-
#: and prompt-sized ragged cases
K3_CROSS_SHAPES = ((2, 64, 1500, 12, 12, 64), (2, 1, 100, 4, 2, 64),
                   (1, 100, 37, 8, 2, 128), (2, 65, 200, 6, 2, 32))
#: Whisper's K3 shapes on the serve path (b, sq, skv, h, hd), non-causal:
#: the encoder's self-attention over 1,500 frames and the decoder's
#: cross-attention from its 64-token prompt
K3_WHISPER = {"whisper_encoder": (4, 1500, 1500, 12, 64),
              "whisper_cross": (4, 64, 1500, 12, 64)}
#: test_rwkv6_wkv_sweep's grid (b, t, h, hd), plus the short sequences that
#: only fill and drain the row groups' wavefront
K5_SHAPES = ((1, 64, 2, 64), (2, 200, 4, 64), (1, 128, 8, 32)) + tuple(
    (2, t, 4, hd) for hd in (64, 32) for t in (1, 2, 3, 5))
#: test_mamba_scan_sweep's grid (b, t, di, ds); then for every ds the
#: short sequences that only fill and drain the lanes' skew; then ragged DI
#: (no multiple of a block's channels, and 100 no multiple of 8 bf16s: the
#: element-wise staging) and B 3
K4_SHAPES = ((1, 64, 512, 16), (2, 96, 1024, 8), (1, 64, 512, 32)) + tuple(
    (2, t, 256, ds) for ds in (8, 16, 32) for t in (1, 2, 3, 65)) + (
    (2, 33, 100, 16), (1, 40, 1000, 8), (1, 20, 100, 32), (3, 40, 512, 32),
    (3, 17, 1000, 16))
#: the serve path: batch, prompt length, new tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 512, 16
#: served logits against the teacher-forced forward over the same tokens,
#: per architecture: the same f32 model, once as 1 + SERVE_GEN incremental
#: steps (decode attention in torch ops, matrix products of 4 rows) and
#: once as one full forward (K3, or one K4 or K5 call, over the whole
#: sequence, products of 2112 rows), so only the rounding of f32 sums
#: differs.  The largest gaps seen are 2.65e-5 (qwen3-4b), 9.13e-4
#: (rwkv6-1.6b, whose slowest decay, ~0.993 a step, carries the rounding
#: through ~150 steps of state) and 4.03e-5 (the Jamba cut, over the batch
#: rows no MoE drop touched; PERF.md).  Each phase also plants a fault and
#: requires the same check to fail on it.
SERVE_TOL = {"qwen3-4b": dict(atol=1e-3, rtol=0.0),
             "rwkv6-1.6b": dict(atol=3e-3, rtol=0.0),
             "jamba-1.5-large-398b": dict(atol=1e-3, rtol=0.0),
             "qwen3-moe-30b-a3b": dict(atol=1e-3, rtol=0.0),
             "internvl2-26b": dict(atol=1e-3, rtol=0.0),
             "whisper-small": dict(atol=1e-3, rtol=0.0)}
#: the Jamba deployment served on one card: every published width, depth
#: cut to one period of 2 layers (the JAX package's smoke layout)
JAMBA_CUT = dict(num_layers=2, attn_layer_period=2, attn_layer_offset=1)
#: qwen3-moe-30b-a3b and internvl2-26b served on one card: every published
#: width, 24 of 48 layers (15,577,751,552 and 10,538,489,856 params, 62.31
#: and 42.15 GB in f32; whole, 122.13 and 79.60 GB)
MOE_CUT = dict(num_layers=24)
VLM_CUT = dict(num_layers=24)
#: Whisper's decoder prompt (its decoder context is 448 tokens,
#: arXiv:2212.04356), beside the 1,500 encoder frames
WHISPER_PROMPT = 64


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


#: every kernel's wrapper, whose ``launches`` counts its kernel's launches
WRAPPERS = (server_step_update, adagrad_update, adagrad_update_leaves,
            flash_attention, wkv, mamba_scan)


def _zero_counts() -> None:
    """Set every kernel's launch count to 0 (just before a path runs)."""
    for wrapper in WRAPPERS:
        wrapper.launches = 0


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
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    say("1 environment", python=sys.version.split()[0],
        torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(dev["kind"]), capability=f"{cap[0]}.{cap[1]}",
        count=dev["count"], tf32="off", cudnn_deterministic="on")
    print(_smi(), flush=True)
    return dev


def _smi() -> str:
    """The card's ``nvidia-smi --query-gpu=name,power.limit`` line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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

    @staticmethod
    def _spin_cycles_per_ms() -> float:
        """The spin kernel's rate at the card's present clock (measured
        after the warm-ups: an idle card's lower clock would make every
        later spin too short to hold the card)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(1_000_000)
        end.record()
        torch.cuda.synchronize()
        return 1e6 / start.elapsed_time(end)

    def __call__(self, fn, reps: int | None = None) -> float:
        """``reps`` (default: the timer's) runs after the warm-ups."""
        t0 = time.perf_counter()
        for _ in range(self.warmup):
            fn()
        torch.cuda.synchronize()
        issue_ms = 1e3 * (time.perf_counter() - t0) / self.warmup
        if self.hold:
            spin = int(2 * issue_ms * self._spin_cycles_per_ms()) + 1
        pairs = []
        for _ in range(reps or self.reps):
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


def _within(got, want, atol: float, rtol: float) -> bool:
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def phase_kernels(timer: ColdTimer, unheld: ColdTimer) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # K1: the fused server step, bitwise against its plain version for
    # every member count it instantiates, on a pitched stack (rows padded to
    # 128-byte lines: the 16-byte path) and a contiguous one (rows at odd
    # offsets where n mod 4 != 0 and M > 1: the scalar path), and with p a
    # view at a 1-element offset (the scalar path)
    k1_err, k1_cases = 0.0, 0
    for n in KERNEL_SIZES:
        for members in K1_MEMBERS:
            for wd in (0.0, 1e-2):
                for pitched in (True, False):
                    for offset in (0, 1):
                        p = rand(n + offset)[offset:]
                        acc = rand(n).abs()
                        g = _k1_stack(rand, members, n, pitched)
                        c = torch.rand(members, generator=gen, device="cuda")
                        kw = dict(lr=FABRIC_LR, beta=1.0, weight_decay=wd)
                        before = server_step_update.launches
                        got = server_step_update(p, g, acc, c, **kw)
                        want = server_step_ref(p, g, acc, c, **kw)
                        torch.cuda.synchronize()
                        where = (f"n={n} M={members} wd={wd} "
                                 f"{'pitched' if pitched else 'contiguous'} "
                                 f"stack, p offset {offset}")
                        check(server_step_update.launches == before + 1,
                              f"K1 one launch at {where}")
                        for x, y, what in zip(got, want, ("p'", "acc'")):
                            check(torch.equal(x, y), f"K1 {what} bitwise "
                                  f"equal to the plain version at {where}")
                            k1_err = max(k1_err, _max_err(x, y))
                        k1_cases += 1
    # K2, each leaf bitwise equal to its own plain version: one leaf a
    # call at edge sizes for every (p, g) dtype pair the wrapper takes; then
    # lists in one call, each making the launches its pairs and the
    # per-launch cap call for
    k2_err, k2_cases = 0.0, 0
    kw2 = dict(lr=QUICKSTART_LR, beta=1.0)

    def k2_check(leaves, where, launches=None, weight_decay=0.0):
        """Each (p, g, acc) of ``leaves`` against ``adagrad_ref``: one leaf
        through ``adagrad_update`` (``launches`` None), else the list
        through ``adagrad_update_leaves``, which must make ``launches``."""
        nonlocal k2_err, k2_cases
        kw = dict(kw2, weight_decay=weight_decay)
        before = adagrad_update_leaves.launches
        if launches is None:
            got = [adagrad_update(*leaves[0], **kw)]
        else:
            got = list(zip(*adagrad_update_leaves(*zip(*leaves), **kw)))
            made = adagrad_update_leaves.launches - before
            check(made == launches, f"K2 {where}: {launches} launches, "
                  f"made {made}")
        torch.cuda.synchronize()
        check(len(got) == len(leaves), f"K2 {where}: a result a leaf")
        for i, (leaf, out) in enumerate(zip(leaves, got)):
            want = adagrad_ref(*leaf, **kw)
            for x, y, what in zip(out, want, ("p'", "acc'")):
                check(x.dtype == y.dtype and x.shape == y.shape
                      and torch.equal(x, y), f"K2 {what} bitwise equal to "
                      f"the plain version at {where}, leaf {i}")
                k2_err = max(k2_err, _max_err(x, y))
        k2_cases += 1

    def k2_leaf(shape, pt=torch.float32, gt=torch.float32, offset=0):
        """(p, g, acc); with ``offset`` p is a view that many elements into
        a larger tensor, so not 16-byte aligned."""
        n = int(np.prod(shape))
        p = rand(n + offset, dtype=pt)[offset:].view(shape)
        return p, rand(*shape, dtype=gt), rand(*shape).abs()

    for n in KERNEL_SIZES:
        for pt, gt in K2_DTYPES:
            k2_check([k2_leaf((n,), pt, gt)], f"n={n} p={pt} g={gt}")
    mixed = [k2_leaf((n,), pt, gt) for n in (1, 127, 1000, 8192)
             for pt, gt in K2_DTYPES]
    for wd in (0.0, 1e-2):
        k2_check(mixed, f"three dtype pairs, wd={wd}", len(K2_DTYPES),
                 weight_decay=wd)
    k2_check([k2_leaf((0,)), k2_leaf(()), k2_leaf((5, 0)), k2_leaf((7,))],
             "empty and 0-d leaves", 1)
    for pt, gt in K2_DTYPES:
        k2_check([k2_leaf((n,), pt, gt, offset=1) for n in (1, 1000, 4099)]
                 + [k2_leaf((4099,), pt, gt)],
                 f"views at a 1-element offset p={pt} g={gt}", 1)
    sizes = np.random.default_rng(0).integers(1, 3000, 2 * MAX_LEAVES + 22)
    k2_check([k2_leaf((int(n),)) for n in sizes],
             f"{len(sizes)} leaves, {MAX_LEAVES} a launch", 3)

    # times at the main path's shapes
    n4 = sum(x.numel() for x in tree_leaves(cnn.init_cnn(
        torch.Generator().manual_seed(0), FIG4_CNN, "cuda")))
    # one launch that does nearly nothing: the timer's floor for any launch
    one = torch.zeros(1, device="cuda")
    launch_floor = timer(lambda: one.add_(1.0))
    k1_times = {}
    for name, n, members, pitched in _k1_timed_cases(n4):
        p, acc = rand(n), rand(n).abs()
        g = _k1_stack(rand, members, n, pitched)
        c = torch.full((members,), 1.0 / members, device="cuda")
        kw = dict(lr=FABRIC_LR, beta=1.0)
        got = server_step_update(p, g, acc, c, **kw)
        want = server_step_ref(p, g, acc, c, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"K1 bitwise equal to the plain version at {name}")
        k1_times[name] = dict(
            ms=timer(lambda: server_step_update(p, g, acc, c, **kw)),
            bound_ms=_k1_bound(n, members)[0])
        if name in ("fig4_m4_pitched", "big_m4_pitched"):
            k1_times[name]["plain_ms"] = timer(
                lambda: server_step_ref(p, g, acc, c, **kw))
        if name == "fig4_m4_pitched":
            k1_times[name]["unheld_ms"] = unheld(
                lambda: server_step_update(p, g, acc, c, **kw))
        del p, acc, g, got, want
    k1 = k1_times["fig4_m4_pitched"]
    k1_bound, k1_by = _k1_bound(n4, FABRIC_SHARDS)

    leaves = tree_leaves(cnn.init_cnn(torch.Generator().manual_seed(0),
                                      FIG2_CNN, "cuda"))
    grads = [rand(*x.shape) for x in leaves]
    accs = [rand(*x.shape).abs() for x in leaves]
    fig2 = list(zip(leaves, grads, accs))
    for leaf in fig2:
        k2_check([leaf], f"FIG2 leaf {tuple(leaf[0].shape)}")
    k2_check(fig2, "the FIG2 step's 8 leaves", 1)

    def per_leaf(fn):
        return lambda: [fn(p_, g_, a_, **kw2) for p_, g_, a_ in fig2]

    def one_call():
        return adagrad_update_leaves(leaves, grads, accs, **kw2)

    k2_ms = timer(one_call)
    k2_per_leaf = timer(per_leaf(adagrad_update))
    k2_plain = timer(per_leaf(adagrad_ref))
    k2_unheld = unheld(one_call)
    k2_bound, _ = _k2_bound(leaves, grads)
    n2 = sum(x.numel() for x in leaves)
    big = k2_leaf((KERNEL_SIZES[-1],))
    k2_big_ms = timer(lambda: adagrad_update_leaves(*([z] for z in big),
                                                    **kw2))
    k2_big_plain = timer(lambda: adagrad_ref(*big, **kw2))
    k2_big_bound, k2_big_by = _k2_bound([big[0]], [big[1]])

    say("3 kernels", k1_cases=k1_cases, k1_bitwise="yes",
        k1_ms=f"{k1['ms']:.6f}", k1_plain_ms=f"{k1['plain_ms']:.6f}",
        k1_bound_ms=f"{k1_bound:.6f}", k1_unheld_ms=f"{k1['unheld_ms']:.6f}",
        k1_shape=f"n={n4},M={FABRIC_SHARDS},pitched",
        **{f"k1_{name}_{key}": f"{t[key]:.6f}"
           for name, t in k1_times.items()
           for key in ("ms", "bound_ms", "plain_ms") if key in t},
        **{f"k1_{name}_above_floor_ms": f"{t['ms'] - launch_floor:.6f}"
           for name, t in k1_times.items()},
        k1_big_shape=f"n={K1_BIG_N},M=4",
        k2_cases=k2_cases, k2_bitwise="yes", k2_step_ms=f"{k2_ms:.6f}",
        k2_per_leaf_step_ms=f"{k2_per_leaf:.6f}",
        k2_launch_floor_ms=f"{launch_floor:.6f}",
        k2_plain_step_ms=f"{k2_plain:.6f}",
        k2_step_bound_ms=f"{k2_bound:.6f}",
        k2_unheld_step_ms=f"{k2_unheld:.6f}",
        k2_step_shape=f"{len(leaves)}_leaves,n={n2}",
        k2_ms=f"{k2_big_ms:.6f}", k2_plain_ms=f"{k2_big_plain:.6f}",
        k2_bound_ms=f"{k2_big_bound:.6f}", k2_bound_by=k2_big_by,
        k2_shape=f"n={KERNEL_SIZES[-1]},f32")
    return {
        "server_step": {
            "name": "server_step", "route": "cuda",
            "source": "src/repro_torch/kernels/server_step/kernel.cu",
            "replaces": "src/repro/kernels/server_step/kernel.py:36",
            "max_abs_err": k1_err, "ms": k1["ms"],
            "plain_ms": k1["plain_ms"], "bound_ms": k1_bound,
            "bound_by": k1_by, "library_ms": None},
        "adagrad": {
            "name": "adagrad", "route": "cuda",
            "source": "src/repro_torch/kernels/adagrad/kernel.cu",
            "replaces": "src/repro/kernels/adagrad/kernel.py:21",
            "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
            "bound_ms": k2_bound, "bound_by": "bytes", "library_ms": None},
    }


def _k1_stack(rand, members: int, n: int, pitched: bool):
    """(members, n) f32 gradients: the first n columns of an (members, ld)
    buffer, ld being n rounded up as ``FusedServerStep`` pads its rows
    (``pitched``), or one contiguous buffer."""
    if not pitched:
        return rand(members, n)
    return rand(members, step_mod.row_pitch(n))[:, :n]


def _k1_timed_cases(n4: int) -> tuple:
    """K1's timed cases (name, n, M, pitched): the fabric's FIG4 step at
    M 4 (its main path: pitched) and M 8, each on both stacks, and the
    bandwidth shape."""
    return tuple((f"fig4_m{m}_{'pitched' if pitched else 'contiguous'}",
                  n4, m, pitched) for m in (4, 8) for pitched in (True, False)
                 ) + (("big_m4_pitched", K1_BIG_N, 4, True),)


def _meta(*shape, dtype=torch.float32):
    """A shape-only tensor, for a kernel's ``work`` (which reads shapes)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _k1_bound(n: int, members: int) -> tuple:
    """K1's bound at n elements and M members, from its ``work``."""
    flops, nbytes = k1_work(_meta(n), _meta(members, n), None, None)
    return _bound(nbytes, flops)


def _k2_bound(ps, gs) -> tuple:
    """K2's bound over leaves ``ps`` with gradients ``gs``, from its
    ``work``."""
    flops, nbytes = k2_work(ps, gs)
    return _bound(nbytes, flops)


# --- 3b. attention (K3) and WKV (K5) against their plain versions -----------


def _bound(nbytes: int, flops: float, peak: float = PEAK_F32_FLOP_S) -> tuple:
    """(ms, what bounds it): the larger of the bytes' and the operations'
    times at the card's peaks (operations at ``peak`` flop/s)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _k3_bound(q, k, causal: bool = True) -> tuple:
    """K3's bound from its ``work`` (q, k, v read and out written once;
    the two products over the visible pairs), its operations on the route
    that meets the bar: the tensor cores' TF32 in three passes for f32
    inputs (hi/lo split), in one pass for q.K^T and two for P V under bf16
    (exact in TF32).  Returns (ms, what bounds it, the operations' ms on
    the f32 CUDA cores)."""
    flops, nbytes = k3_work(q, k, k, causal=causal)
    passes = 3 if q.dtype == torch.float32 else 1.5
    ms, by = _bound(nbytes, passes * flops, PEAK_TF32_FLOP_S)
    return ms, by, 1e3 * flops / PEAK_F32_FLOP_S


def _k5_bound(r, s0) -> tuple:
    """K5's bound from its ``work``, for f32 decay and bonus beside r."""
    b, t, h, hd = r.shape
    flops, nbytes = k5_work(r, r, r, _meta(*r.shape), _meta(h, hd), s0)
    return _bound(nbytes, flops)


def phase_lm_kernels(timer: ColdTimer) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    # K3 against attention_ref on the same inputs
    k3_err, k3_cases = {"float32": 0.0, "bfloat16": 0.0}, 0
    for b, sq, skv, hq, hkv, hd in tuple(
            (b, s, s, hq, hkv, hd) for b, s, hq, hkv, hd in K3_SHAPES
    ) + K3_CROSS_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = rand(b, sq, hq, hd, dtype=dtype)
            k, v = (rand(b, skv, hkv, hd, dtype=dtype) for _ in range(2))
            for causal, window in K3_MASKS:
                got = flash_attention(q, k, v, causal=causal, window=window)
                want = attention_ref(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal, window=window).transpose(1, 2)
                torch.cuda.synchronize()
                tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
                name = str(dtype).split(".")[1]
                check(got.dtype == dtype and _within(got, want, **tol),
                      f"K3 within {tol} of its plain version at "
                      f"{(b, sq, skv, hq, hkv, hd)} {name} causal={causal} "
                      f"window={window}: max err {_max_err(got, want)}")
                k3_err[name] = max(k3_err[name], _max_err(got, want))
                k3_cases += 1
    # the main path's shapes: qwen3-4b's prefill (GQA 32:8) and the Jamba
    # cut's (64:8), each checked and timed, and phase 14c's sharded
    # qwen3-moe prefill (32:4 at its shorter prompt), checked
    k3_times = {}
    for model, s, hq, hkv in (("qwen3-4b", SERVE_PROMPT, 32, 8),
                              ("jamba", SERVE_PROMPT, 64, 8),
                              ("14c qwen3-moe", SHARD_PROMPT, 32, 4)):
        q = rand(SERVE_BATCH, s, hq, 128)
        k, v = (rand(SERVE_BATCH, s, hkv, 128) for _ in range(2))
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        got = flash_attention(q, k, v)
        want = attention_ref(qt, kt, vt).transpose(1, 2)
        torch.cuda.synchronize()
        check(_within(got, want, **TOL_F32), f"K3 within {TOL_F32} at "
              f"{model}'s prefill shape: max err {_max_err(got, want)}")
        k3_err["float32"] = max(k3_err["float32"], _max_err(got, want))
        k3_cases += 1
        if model.startswith("14c"):
            continue
        k3_times[model] = dict(
            ms=timer(lambda: flash_attention(q, k, v)),
            plain_ms=timer(lambda: attention_ref(qt, kt, vt)),
            library_ms=timer(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
            bound=_k3_bound(q, k))
        del q, k, v, qt, kt, vt, got, want
    # Whisper's shapes, non-causal: the encoder and the cross-attention
    for model, (b, sq, skv, h, hd) in K3_WHISPER.items():
        q = rand(b, sq, h, hd)
        k, v = (rand(b, skv, h, hd) for _ in range(2))
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        got = flash_attention(q, k, v, causal=False)
        want = attention_ref(qt, kt, vt, causal=False).transpose(1, 2)
        torch.cuda.synchronize()
        check(_within(got, want, **TOL_F32), f"K3 within {TOL_F32} at "
              f"{model}'s shape: max err {_max_err(got, want)}")
        k3_err["float32"] = max(k3_err["float32"], _max_err(got, want))
        k3_cases += 1
        k3_times[model] = dict(
            ms=timer(lambda: flash_attention(q, k, v, causal=False)),
            plain_ms=timer(lambda: attention_ref(qt, kt, vt, causal=False)),
            library_ms=timer(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt)),
            bound=_k3_bound(q, k, causal=False))
        del q, k, v, qt, kt, vt, got, want
    k3 = k3_times["qwen3-4b"]
    (k3_bound, k3_by, k3_core), jam = k3["bound"], k3_times["jamba"]

    # K5 against wkv_ref on the same inputs: bitwise (same operations in
    # the same order, each rounded once)
    k5_err, k5_cases = 0.0, 0

    def wkv_inputs(b, t, h, hd, dtype=torch.float32, s0_scale=0.1):
        r, k, v = (rand(b, t, h, hd, dtype=dtype, scale=0.5)
                   for _ in range(3))
        w = 0.7 + 0.299 * torch.rand(b, t, h, hd, generator=gen,
                                     device="cuda")
        return (r, k, v, w, rand(h, hd, scale=0.1),
                rand(b, h, hd, hd, scale=s0_scale))

    def k5_check(ins, where):
        nonlocal k5_err, k5_cases
        (y, sT), (y_ref, sT_ref) = wkv(*ins), wkv_ref(*ins)
        torch.cuda.synchronize()
        k5_err = max(k5_err, _max_err(y, y_ref), _max_err(sT, sT_ref))
        check(y.dtype == ins[0].dtype and torch.equal(y, y_ref)
              and torch.equal(sT, sT_ref),
              f"K5 bitwise equal to its plain version at {where}: max err "
              f"{_max_err(y, y_ref)} (y), {_max_err(sT, sT_ref)} (sT)")
        k5_cases += 1
        return y, sT

    for shape in K5_SHAPES + ((SERVE_BATCH, 1, 32, 64),):
        for dtype in (torch.float32, torch.bfloat16):
            k5_check(wkv_inputs(*shape, dtype=dtype), f"{shape} {dtype}")
    # two calls chained through sT give one call over the whole sequence
    r, k, v, w, u, s0 = wkv_inputs(1, 64, 2, 64)
    y_full, s_full = k5_check((r, k, v, w, u, s0), "chain, one shot")
    y1, s1 = k5_check(tuple(z[:, :40].contiguous() for z in (r, k, v, w))
                      + (u, s0), "chain, first half")
    y2, s2 = k5_check(tuple(z[:, 40:].contiguous() for z in (r, k, v, w))
                      + (u, s1), "chain, second half")
    check(torch.equal(torch.cat([y1, y2], 1), y_full)
          and torch.equal(s2, s_full),
          "K5 chained through sT bitwise equal to one shot")
    # the main path's shapes: rwkv6-1.6b's prefill and one decode step
    prefill_in = wkv_inputs(SERVE_BATCH, SERVE_PROMPT, 32, 64)
    k5_check(prefill_in, "the prefill's shape")
    decode_in = wkv_inputs(SERVE_BATCH, 1, 32, 64)
    k5_ms = timer(lambda: wkv(*prefill_in))
    # ~70,000 small launches a call: a few runs suffice
    k5_plain = timer(lambda: wkv_ref(*prefill_in), reps=3)
    k5_bound, k5_by = _k5_bound(prefill_in[0], prefill_in[5])
    k5_step_ms = timer(lambda: wkv(*decode_in))
    k5_step_plain = timer(lambda: wkv_ref(*decode_in))
    k5_step_bound, _ = _k5_bound(decode_in[0], decode_in[5])

    say("3b lm kernels", k3_cases=k3_cases,
        k3_max_err_f32=f"{k3_err['float32']:.3g}",
        k3_max_err_bf16=f"{k3_err['bfloat16']:.3g}",
        k3_ms=f"{k3['ms']:.6f}", k3_plain_ms=f"{k3['plain_ms']:.6f}",
        k3_sdpa_ms=f"{k3['library_ms']:.6f}", k3_bound_ms=f"{k3_bound:.6f}",
        k3_bound_by=k3_by, k3_bound_cuda_core_ms=f"{k3_core:.6f}",
        k3_shape=f"B{SERVE_BATCH},S{SERVE_PROMPT},Hq32,Hkv8,hd128,f32,causal",
        k3_jamba_ms=f"{jam['ms']:.6f}",
        k3_jamba_plain_ms=f"{jam['plain_ms']:.6f}",
        k3_jamba_sdpa_ms=f"{jam['library_ms']:.6f}",
        k3_jamba_bound_ms=f"{jam['bound'][0]:.6f}",
        k3_jamba_bound_cuda_core_ms=f"{jam['bound'][2]:.6f}",
        k3_jamba_shape=f"B{SERVE_BATCH},S{SERVE_PROMPT},Hq64,Hkv8,hd128,f32,"
                       f"causal",
        **{f"k3_{model}_{key}": f"{k3_times[model][key]:.6f}"
           for model in K3_WHISPER
           for key in ("ms", "plain_ms", "library_ms")},
        **{f"k3_{model}_bound_ms": f"{k3_times[model]['bound'][0]:.6f}"
           for model in K3_WHISPER},
        **{f"k3_{model}_bound_by": k3_times[model]["bound"][1]
           for model in K3_WHISPER},
        **{f"k3_{model}_shape": "B{},Sq{},Skv{},H{},hd{},f32,noncausal"
           .format(*shape) for model, shape in K3_WHISPER.items()},
        k5_cases=k5_cases, k5_bitwise="yes", k5_max_err=f"{k5_err:.3g}",
        k5_ms=f"{k5_ms:.6f}", k5_plain_ms=f"{k5_plain:.6f}",
        k5_bound_ms=f"{k5_bound:.6f}", k5_bound_by=k5_by,
        k5_shape=f"B{SERVE_BATCH},T{SERVE_PROMPT},H32,hd64,f32",
        k5_step_ms=f"{k5_step_ms:.6f}",
        k5_step_plain_ms=f"{k5_step_plain:.6f}",
        k5_step_bound_ms=f"{k5_step_bound:.6f}", k5_library="none")
    return {
        "flash_attention": {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/kernel.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:30",
            "max_abs_err": max(k3_err["float32"], k3_err["bfloat16"]),
            "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3_bound,
            "bound_by": k3_by, "library_ms": k3["library_ms"]},
        "rwkv6": {
            "name": "wkv", "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv6/kernel.cu",
            "replaces": "src/repro/kernels/rwkv6/kernel.py:26",
            "max_abs_err": k5_err, "ms": k5_ms,
            "plain_ms": k5_plain, "bound_ms": k5_bound,
            "bound_by": k5_by, "library_ms": None},
    }


# --- 3c. the Mamba selective scan (K4) against its plain version -------------


def _k4_bound(ins) -> tuple:
    """K4's bound on its inputs ``ins``, from its ``work``."""
    flops, nbytes = k4_work(*ins)
    return _bound(nbytes, flops)


def phase_mamba_kernel(timer: ColdTimer) -> dict:
    """K4 against ``mamba_scan_ref`` on the same inputs.  Both do the same
    separately rounded operations in the same order, so they must agree
    bit for bit in every case; one case checks the kernel's exp alone
    against ``torch.exp``.  Returns K4's entry of the kernels line."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)

    def scan_inputs(b, t, di, ds, dtype=torch.float32, h0_scale=0.1):
        """test_mamba_scan_sweep's distributions."""
        def u(*shape):
            return torch.rand(*shape, generator=gen, device="cuda")

        def n(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")
        return (0.001 + 0.099 * u(b, t, di), n(b, t, di).to(dtype),
                n(b, t, ds).to(dtype), n(b, t, ds).to(dtype),
                -(0.5 + 3.5 * u(di, ds)), h0_scale * n(b, di, ds))

    cases = []                               # (where, max err, bitwise)

    def k4_check(ins, where):
        (y, hT), (y_ref, h_ref) = mamba_scan(*ins), mamba_scan_ref(*ins)
        torch.cuda.synchronize()
        err = max(_max_err(y, y_ref), _max_err(hT, h_ref))
        check(y.dtype == hT.dtype == torch.float32
              and _within(y, y_ref, **TOL_F32)
              and _within(hT, h_ref, **TOL_F32),
              f"K4 within {TOL_F32} of its plain version at {where}: max "
              f"err {err}")
        cases.append((where, err, torch.equal(y, y_ref)
                      and torch.equal(hT, h_ref)))
        return y, hT

    for b, t, di, ds in K4_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            k4_check(scan_inputs(b, t, di, ds, dtype), f"{b}x{t}x{di}x{ds}"
                     f"_{name}")
    # the exp alone: with x = 0 and h0 = 1 one step leaves hT = exp(dt a),
    # here over dt * a in [-40, 0]
    di, ds = 16384, 16
    dt_e = torch.rand(SERVE_BATCH, 1, di, generator=gen, device="cuda")
    a_e = -40.0 * torch.rand(di, ds, generator=gen, device="cuda")
    exp_in = (dt_e, torch.zeros_like(dt_e),
              torch.randn(SERVE_BATCH, 1, ds, generator=gen, device="cuda"),
              torch.randn(SERVE_BATCH, 1, ds, generator=gen, device="cuda"),
              a_e, torch.ones(SERVE_BATCH, di, ds, device="cuda"))
    _, h_exp = k4_check(exp_in, "exp_only")
    exp_want = torch.exp(dt_e[:, 0, :, None] * a_e)
    exp_bitwise = torch.equal(h_exp, exp_want)
    exp_err = _max_err(h_exp, exp_want)
    # two calls chained through hT give one call over the whole sequence
    ins = scan_inputs(1, 64, 512, 16)
    y_full, h_full = k4_check(ins, "chain_one_shot")
    y1, h1 = k4_check(tuple(z[:, :40].contiguous() for z in ins[:4])
                      + ins[4:], "chain_first")
    y2, h2 = k4_check(tuple(z[:, 40:].contiguous() for z in ins[:4])
                      + (ins[4], h1), "chain_second")
    check(torch.equal(torch.cat([y1, y2], 1), y_full)
          and torch.equal(h2, h_full),
          "K4 chained through hT bitwise equal to one shot")
    # the main path's shapes: the Jamba cut's prefill and a decode step
    # from a state
    prefill_in = scan_inputs(SERVE_BATCH, SERVE_PROMPT, di, ds)
    k4_check(prefill_in, "prefill")
    decode_in = scan_inputs(SERVE_BATCH, 1, di, ds, h0_scale=1.0)
    k4_check(decode_in, "decode_step")
    check(exp_bitwise, f"K4's exp bitwise equal to torch.exp: max err "
          f"{exp_err}")
    check(all(bw for _, _, bw in cases),
          "K4 bitwise equal to its plain version: differs at "
          + ", ".join(w for w, _, bw in cases if not bw))
    k4_ms = timer(lambda: mamba_scan(*prefill_in))
    # ~20,000 small launches a call: a few runs suffice
    k4_plain = timer(lambda: mamba_scan_ref(*prefill_in), reps=3)
    k4_bound, k4_by = _k4_bound(prefill_in)
    k4_step_ms = timer(lambda: mamba_scan(*decode_in))
    k4_step_plain = timer(lambda: mamba_scan_ref(*decode_in))
    k4_step_bound, k4_step_by = _k4_bound(decode_in)
    # the decode step's yardstick: one copy of its state h0
    state = torch.empty_like(decode_in[5])
    k4_copy = timer(lambda: state.copy_(decode_in[5]))
    k4_err = max(err for _, err, _ in cases)

    say("3c mamba kernel", k4_cases=len(cases), k4_bitwise="yes",
        k4_exp_bitwise="yes",
        k4_exp_max_err=f"{exp_err:.3g}", k4_max_err=f"{k4_err:.3g}",
        k4_case_errs=",".join(f"{w}:{err:.3g}{'' if bw else '(not_bitwise)'}"
                              for w, err, bw in cases),
        k4_ms=f"{k4_ms:.6f}", k4_plain_ms=f"{k4_plain:.6f}",
        k4_bound_ms=f"{k4_bound:.6f}", k4_bound_by=k4_by,
        k4_shape=f"B{SERVE_BATCH},T{SERVE_PROMPT},DI{di},ds{ds},f32",
        k4_step_ms=f"{k4_step_ms:.6f}",
        k4_step_plain_ms=f"{k4_step_plain:.6f}",
        k4_step_bound_ms=f"{k4_step_bound:.6f}", k4_step_bound_by=k4_step_by,
        k4_state_copy_ms=f"{k4_copy:.6f}",
        k4_library="none")
    return {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/mamba/kernel.cu",
        "replaces": "src/repro/kernels/mamba/kernel.py:26",
        "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain,
        "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None}


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


def _breaching_slos():
    """The planted fault of phase 4: a round-latency objective of 1 us,
    which no round over the wire meets."""
    from repro_torch.obs import Slo
    return (Slo("round-latency-p95-1us", "round.duration_seconds", "<=",
                1e-6, stat="p95"),)


async def _fabric_train(rounds: int, n_clients: int = 3, slos=None):
    """``rounds`` FIG4 rounds over remote v2-wire clients, with the round
    SLOs ``slos`` evaluated against a metrics registry and a shard
    rebalancer at each round boundary.  Returns (loop, trainer, errors,
    each round's RoundResult)."""
    from repro_torch.core.distributor import ClientProfile, TaskDef
    from repro_torch.core.federation import FederatedDistributor
    from repro_torch.core.transport import (TransportServer,
                                            spawn_remote_clients)
    from repro_torch.obs import MetricsRegistry
    from repro_torch.optim import adagrad
    from repro_torch.train_fabric import (FederatedTrainer,
                                          FederatedTrainingLoop,
                                          FusedServerStep, Rebalancer)

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
                               timeout=60.0, metrics=MetricsRegistry(),
                               slos=slos, rebalancer=Rebalancer(fed))
    loop = FederatedTrainingLoop(
        trainer, opt, _train_state(params, opt),
        server_step=FusedServerStep(opt, lr=FABRIC_LR, beta=1.0))
    results = []
    try:
        async with trainer:
            for _ in range(rounds):
                results.append(await loop.run_round(args, work))
        await asyncio.wait_for(asyncio.gather(*tasks), 60.0)
    finally:
        # bounded: TransportServer.stop() waits for open connections
        await asyncio.wait_for(server.stop(), 60.0)
        await fed.shutdown()
    errors = (sum(c.errors for c in clients)
              + fed.queue.snapshot()["errors"] + server.protocol_errors)
    return loop, trainer, errors, results


def _synced(fn, *args, **kwargs) -> tuple:
    """(``fn``'s result, its host seconds from a ``torch.cuda.synchronize()``
    before the call to one after it, so they hold the card's work)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def _timed(owner, attr: str):
    """Within the block, every call of ``owner.attr`` (a function of a
    module, or a method of a class) is timed by :func:`_synced`; yields
    the list of seconds, one a call."""
    fn = getattr(owner, attr)
    seconds = []

    def timed(*args, **kwargs):
        out, took = _synced(fn, *args, **kwargs)
        seconds.append(took)
        return out

    setattr(owner, attr, timed)
    try:
        yield seconds
    finally:
        setattr(owner, attr, fn)


def _ms_median(seconds) -> str:
    return f"{1e3 * statistics.median(seconds):.3f}"


def _host_ms(fn, reps: int = 10) -> float:
    """Median host milliseconds of ``fn`` from a synchronize before it to
    one after it."""
    return 1e3 * statistics.median(_synced(fn)[1] for _ in range(reps))


def _in_process_twin(rounds: int):
    """The fabric run's twin: the same CnnGradShard calls over the same
    round shards, folded by the TreeServerStep reference.  Returns its
    per-round losses, final params and final optimizer state, the seconds
    of each round's ``TreeServerStep.step`` and the last round's gradient
    trees (numpy, as the wire delivers them)."""
    from repro_torch.optim import adagrad
    from repro_torch.train_fabric import TreeServerStep

    rows, args, work = _fabric_plan()
    task = cnn.CnnGradShard(FIG4_CNN, n_rows=rows)
    opt = adagrad(FABRIC_LR, beta=1.0)
    params = cnn.init_cnn(torch.Generator().manual_seed(0), FIG4_CNN)
    opt_state = opt.init(params)
    step = TreeServerStep(opt)
    losses = []
    with _timed(TreeServerStep, "step") as step_s:
        for t in range(rounds):
            served = {"round": t, "params": cnn.params_to_numpy(params)}
            outs = [task(a, {"weights": served}) for a in args]
            grads = [o["grad"] for o in outs]
            params, opt_state = step.step(grads, work, params, opt_state)
            losses.append(sum(o["loss"] * w for o, w in zip(outs, work))
                          / sum(work))
    return losses, params, opt_state, step_s, grads


def _same_bits(a, b) -> bool:
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def phase_fabric() -> int:
    from repro_torch.obs import DEFAULT_ROUND_SLOS
    from repro_torch.train_fabric import (load_round_checkpoint,
                                          param_count, state_to_tree)

    # each round's FusedServerStep.step, split into the host stack build
    # (the leaves written into the rows of one host buffer), its upload
    # (gradient_stack less the build), K1 and the rest (coefficients, the
    # params' and accumulator's concatenation, slicing the results back)
    with contextlib.ExitStack() as timing:
        step_s, stack_s, build_s, k1_s = (
            timing.enter_context(_timed(owner, attr)) for owner, attr in (
                (step_mod.FusedServerStep, "step"),
                (step_mod, "gradient_stack"),
                (step_mod, "_fill_rows"),
                (step_mod, "server_step_update")))
        _zero_counts()
        t0 = time.perf_counter()
        loop, trainer, errors, rounds = asyncio.run(_fabric_train(
            FABRIC_ROUNDS, slos=DEFAULT_ROUND_SLOS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = server_step_update.launches
    slo_names = {slo.name for slo in DEFAULT_ROUND_SLOS}
    check(len(rounds) == FABRIC_ROUNDS and all(
        r.slos is not None and {x["name"] for x in r.slos} == slo_names
        for r in rounds),
          f"every default round SLO evaluated at every round close: "
          f"{[r.slos for r in rounds]}")
    check(all(r.slo_ok for r in rounds),
          f"every round meets the default SLOs: "
          f"{[[x for x in r.slos if not x['ok']] for r in rounds]}")
    check(sum(r.migrations for r in rounds)
          == len(trainer.rebalancer.history),
          f"the rounds count the rebalancer's migrations: "
          f"{[r.migrations for r in rounds]} vs "
          f"{trainer.rebalancer.history}")
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
    check(len(step_s) == len(stack_s) == len(build_s) == len(k1_s)
          == FABRIC_ROUNDS, f"one timed server step a round: "
          f"{len(step_s)} steps, {len(k1_s)} K1 calls")
    twin, twin_params, twin_opt, tree_s, grads = _in_process_twin(
        FABRIC_ROUNDS)
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
    # the stack as FusedServerStep builds it (pitched, in a kept
    # page-locked host buffer) against the same in a new pageable buffer
    # each call and against the contiguous stack it replaced (one
    # torch.cat a member, then torch.stack), each uploaded, on the last
    # round's gradients, in turns
    tdef = tree_flatten(twin_params)[1]
    n = param_count(twin_params)
    staging = torch.empty((len(grads), step_mod.row_pitch(n)),
                          pin_memory=True)
    builds = {
        "staged": lambda: step_mod.gradient_stack(grads, tdef, n, "cuda",
                                                  staging),
        "fresh": lambda: step_mod.gradient_stack(
            grads, tdef, n, "cuda", torch.empty(staging.shape)),
        "cat_stack": lambda: torch.stack(
            [step_mod._flat32(tdef.flatten_up_to(g)) for g in grads]
        ).to("cuda")}
    want = builds["cat_stack"]()
    check(all(torch.equal(fn(), want) for fn in builds.values()),
          "every stack build holds the same gradients")
    order = list(builds) + list(builds)[::-1]
    turns = [(name, _host_ms(builds[name])) for name in order]
    stack_ms = {name: statistics.mean(ms for k, ms in turns if k == name)
                for name in builds}
    # the planted fault: one more round, under an SLO no round meets
    _, _, _, (bad,) = asyncio.run(_fabric_train(1, slos=_breaching_slos()))
    check(not bad.slo_ok and bad.slos[0]["value"] > 1e-6,
          f"a round-latency SLO of 1 us breaches: {bad.slos}")
    say("4 fabric", model=FIG4_CNN.name,
        params=param_count(loop.state.params), rounds=FABRIC_ROUNDS,
        shards=f"{FABRIC_SHARDS}x{FABRIC_BATCH}", clients="3_remote_v2",
        loss_first=f"{losses[0]:.6f}", loss_final=f"{losses[-1]:.6f}",
        max_delta_vs_twin=f"{delta:.3g}", final_state_vs_twin="bitwise",
        stale=loop.stale_executions,
        errors=errors, reticketed=trainer.reticketed_total,
        slo_ok=",".join(str(r.slo_ok).lower() for r in rounds),
        slo_round_p95_s=",".join(
            str(next(x["value"] for x in r.slos
                     if x["name"] == "round-latency-p95")) for r in rounds),
        migrations=",".join(str(r.migrations) for r in rounds),
        planted_slo=bad.slos[0]["name"],
        planted_slo_ok=str(bad.slo_ok).lower(),
        planted_slo_value_s=bad.slos[0]["value"],
        server_step_launches=launches, checkpoint="bit-exact",
        wall_s=f"{wall:.3f}",
        fused_step_ms_median=_ms_median(step_s),
        fused_build_ms_median=_ms_median(build_s),
        fused_upload_ms_median=_ms_median(
            [a - b for a, b in zip(stack_s, build_s)]),
        fused_k1_ms_median=_ms_median(k1_s),
        fused_rest_ms_median=_ms_median(
            [a - b - c for a, b, c in zip(step_s, stack_s, k1_s)]),
        fused_step_ms=",".join(f"{1e3 * x:.3f}" for x in step_s),
        **{f"stack_{name}_ms": f"{ms:.3f}" for name, ms in stack_ms.items()},
        stack_turns_ms=",".join(f"{name}:{ms:.3f}" for name, ms in turns),
        tree_step_ms_median=_ms_median(tree_s),
        tree_step_ms=",".join(f"{1e3 * x:.3f}" for x in tree_s))
    return launches


# --- 5. the quickstart path ----------------------------------------------------


# --- captured training steps against their eager loops ---------------------

#: 13b holds each row's captured steps to an eager loop of the same step
#: over its first GRAPH_CMP_STEPS batches (step 0's zero head gradient,
#: the K = 4 refresh after step 3, a step through the refreshed head),
#: and runs each planted graph fault over as many
GRAPH_CMP_STEPS = 5
#: 13b rows whose comparison and planted faults run at a depth cut: at
#: every width and depth rwkv6-1.6b's eager step takes 18-31 s and its
#: capture 51-66 s (465k kernels; PERF.md), which a run held to 1200 s
#: cannot hold five times over.  Such a row's eager ms and peaks
#: are its runner's first call (an eager step), its eager idle share
#: against the replay's device ms (the same kernels)
GRAPH_CMP_CUT = {"rwkv6-1.6b": dict(num_layers=2)}


def _moved(tree, device):
    """``tree`` (a ``TrainState`` too) with every tensor leaf copied to
    ``device``."""
    as_tree = graphs._as_tree(tree)
    leaves, tdef = tree_flatten(as_tree)
    out = tdef.unflatten([x.to(device, copy=True)
                          if isinstance(x, torch.Tensor) else x
                          for x in leaves])
    return dataclasses.replace(tree, **out) if as_tree is not tree else out


def _host(tree) -> list:
    """Every tensor leaf of ``tree`` copied to the host."""
    return [x.to("cpu", copy=True) for x in graphs._leaves(tree)
            if isinstance(x, torch.Tensor)]


def _digest(tree) -> torch.Tensor:
    """One int64 a tensor leaf of ``tree``: the sum of its elements' bit
    patterns, so two runs' states compare bit for bit without a copy."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return torch.stack([
        x.detach().contiguous().view(ints[x.element_size()]).long().sum()
        for x in graphs._leaves(tree)
        if isinstance(x, torch.Tensor) and x.numel()]).cpu()


def _gap(got: list, want: list, bar: dict) -> tuple:
    """(every tensor of ``got`` within ``bar`` of the one of ``want`` at
    its place, bit for bit when ``bar`` is ``BITWISE``; the largest
    absolute gap)."""
    ok, gap = len(got) == len(want), 0.0
    for x, y in zip(got, want):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False, float("inf")
        ok = ok and (torch.equal(x, y) if bar is BITWISE
                     else _within(x, y, **bar))
        gap = max(gap, _max_err(x, y))
    return ok, gap


class _Eager:
    """A plain loop of ``step``, called as a runner is: ``runner(batch)
    -> (new state, out)``."""

    def __init__(self, step, state):
        self.step, self.state = step, state

    def __call__(self, batch):
        self.state, out = self.step(self.state, batch)
        return self.state, out


class _StaleBatch(StepGraph):
    """A planted fault: the runner loads its batch buffer once, so every
    replay trains on the first batch."""

    def _load(self, inputs):
        if self.inputs is None:
            super()._load(inputs)


def _frozen_refresh(step_fn, k: int):
    """A planted fault: the stale-head refresh decided on the host from a
    count of the step's own calls, as a step counter kept on the host
    decides it.  Eagerly it refreshes when it should; a capture freezes
    the decision of the captured call (the second: none) into every
    replay."""
    calls = [0]

    def step(state, batch):
        new, metrics = step_fn(state, batch)
        sync = (calls[0] + 1) % k == 0
        calls[0] += 1
        return dataclasses.replace(
            new, head_stale=tree_map(torch.clone, new.head) if sync
            else state.head_stale), metrics
    return step


def _run_steps(runner, batches, *, loss=lambda out: out["loss"],
               keep_at=None, host=False, first=None) -> dict:
    """``runner`` (a ``StepGraph``, a planted one, or ``_Eager``) over
    ``batches``, each call timed by ``_synced``: the losses (a host
    tensor), the seconds of each call, the state after ``keep_at`` calls
    (its ``_digest``, and with ``host`` its leaves copied to the host),
    and the peaks (allocated and reserved, GB) of the first call and from
    call ``TRAIN_WARM`` on.  ``first(new)`` runs after the first call."""
    losses, secs, kept, digest, out0 = [], [], None, None, {}
    torch.cuda.reset_peak_memory_stats()
    for i, b in enumerate(batches):
        if i == TRAIN_WARM:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        (new, out), took = _synced(runner, b)
        secs.append(took)
        losses.append(loss(out).detach().float().cpu())
        if i == 0:
            out0 = {"first_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "first_reserved_gb":
                        torch.cuda.max_memory_reserved() / 1e9}
            if first is not None:
                first(new)
        if keep_at == i + 1:
            digest, kept = _digest(new), _host(new) if host else None
    return {"losses": torch.stack(losses), "secs": secs, "kept": kept,
            "digest": digest, **out0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.max_memory_reserved() / 1e9}


def _eager_twice(step, state, batch, *, loss=lambda out: out["loss"]):
    """The eager step run twice from ``state`` on ``batch``, the second
    run traced: (the captured-vs-eager bar, measured first: bit for bit
    where the two runs' new states and losses are, else ``TRAIN_TOL``;
    the first run's ms; the second's device split (``
    _traced_device_split``); peaks allocated and reserved, GB)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (new, out), took = _synced(step, state, batch)
    first = torch.cat([_digest(new), _digest([loss(out)])])
    del new, out
    runs = []
    split, _, _ = _traced_device_split(
        lambda: runs.append(step(state, batch)))
    new, out = runs.pop()
    second = torch.cat([_digest(new), _digest([loss(out)])])
    del new, out
    return dict(bar=BITWISE if torch.equal(first, second) else TRAIN_TOL,
                ms=1e3 * took, split=split,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                reserved_gb=torch.cuda.max_memory_reserved() / 1e9)


def _held(got: dict, want: dict, bar: dict) -> tuple:
    """(``got``'s losses and kept state within ``bar`` of ``want``'s (over
    ``want``'s steps), the largest gap): their host leaves where both runs
    kept them, else, bit for bit, the losses and the states' digests (the
    gap then the losses')."""
    n = len(want["losses"])
    if got["kept"] is not None and want["kept"] is not None:
        return _gap([got["losses"][:n], *got["kept"]],
                    [want["losses"], *want["kept"]], bar)
    ok, gap = _gap([got["losses"][:n]], [want["losses"]], bar)
    return (ok and bar is BITWISE
            and torch.equal(got["digest"], want["digest"])), gap


def _graph_held(what: str, step, state0, batches, bar: dict, k: int,
                captured=None) -> tuple:
    """The first GRAPH_CMP_STEPS steps of ``step`` from ``state0()`` over
    ``batches``: captured (``captured``, a ``_run_steps`` result that kept
    its state at that step, or a run made here) and held at ``bar``
    (``_held``) to an eager loop of the same step, then the two planted
    graph faults (``_StaleBatch``; ``_frozen_refresh`` with period ``k``),
    each of which must fail that check: (the gap, {fault: its gap})."""
    n = GRAPH_CMP_STEPS

    def run(runner):
        return _run_steps(runner, batches[:n], keep_at=n,
                          host=bar is not BITWISE)

    if captured is None:
        captured = run(StepGraph(step, state0()))
    eager = run(_Eager(step, state0()))
    ok, gap = _held(captured, eager, bar)
    check(ok, f"{what}: {n} captured steps' losses and state at {bar} of "
          f"the eager loop's: max gap {gap}")
    planted = {}
    for name, make in (
            ("stale_batch", lambda: _StaleBatch(step, state0())),
            ("frozen_refresh",
             lambda: StepGraph(_frozen_refresh(step, k), state0()))):
        gc.collect()
        torch.cuda.empty_cache()
        fault_ok, planted[name] = _held(run(make()), eager, bar)
        check(not fault_ok, f"{what}: the planted graph fault {name} fails "
              f"the check against the eager loop: gap only "
              f"{planted[name]}")
    return gap, planted


def _capture_numbers(runner) -> dict:
    """A ``StepGraph``'s capture and instantiation seconds and launches a
    replay (numbers alone: the graph and its memory go with the runner)."""
    return dict(capture_s=runner.capture.capture_s,
                instantiate_s=runner.capture.instantiate_s,
                per_replay=dict(runner.per_replay))


def _graph_fields(captured: dict, eager: dict, numbers: dict, bar: dict,
                  gap: float) -> dict:
    """The say() fields of a captured run (``numbers``:
    ``_capture_numbers``) beside its eager loop (a ``_run_steps`` or an
    ``_eager_twice`` result)."""
    eager_ms = (eager["ms"] if "ms" in eager else 1e3 * statistics.median(
        eager["secs"][TRAIN_WARM:]))
    return dict(
        captured_ms_median=_ms_median(captured["secs"][TRAIN_WARM:]),
        eager_ms=f"{eager_ms:.3f}",
        first_step_ms=f"{1e3 * captured['secs'][0]:.3f}",
        second_step_ms=f"{1e3 * captured['secs'][1]:.3f}",
        capture_s=f"{numbers['capture_s']:.3f}",
        instantiate_s=f"{numbers['instantiate_s']:.3f}",
        peak_gb=f"{captured['peak_gb']:.2f}",
        reserved_gb=f"{captured['reserved_gb']:.2f}",
        eager_peak_gb=f"{eager['peak_gb']:.2f}",
        eager_reserved_gb=f"{eager['reserved_gb']:.2f}",
        eager_run_to_run="bitwise" if bar is BITWISE else "not_bitwise",
        graph_vs_eager_bar=("bitwise" if bar is BITWISE else
                            f"atol={bar['atol']},rtol={bar['rtol']}"),
        graph_vs_eager_max_gap=f"{gap:.3g}",
        per_replay=",".join(f"{w.__name__}:{n}" for w, n in
                            sorted(numbers["per_replay"].items(),
                                   key=lambda kv: kv[0].__name__)))


def phase_quickstart() -> int:
    """Phase 5 (the module docstring): returns K2's launches on the path."""
    from repro_torch.data import clustered_images
    from repro_torch.optim import adagrad

    ccfg = FIG2_CNN
    params = cnn.init_cnn(torch.Generator().manual_seed(0), ccfg)
    n_leaves = len(tree_leaves(params))
    opt = adagrad(QUICKSTART_LR, beta=1.0, use_kernel=True)
    step = cnn.train_step(ccfg, opt)
    images, labels = clustered_images(4096, image_size=ccfg.image_size,
                                      channels=ccfg.in_channels, seed=0)
    test_x, test_y = clustered_images(512, image_size=ccfg.image_size,
                                      channels=ccfg.in_channels, seed=9)
    images = torch.from_numpy(images).cuda()
    labels = torch.from_numpy(labels).cuda()
    bs = ccfg.batch_size
    batches = [(images[j:j + bs], labels[j:j + bs]) for j in (
        (i * bs) % (len(images) - bs) for i in range(QUICKSTART_STEPS))]

    def state0():
        return _moved((params, opt.init(params)), "cuda")

    def run(runner_cls):
        return _run_steps(runner_cls(step, state0()), batches,
                          loss=lambda out: out, keep_at=QUICKSTART_STEPS,
                          host=True)

    _zero_counts()
    runner = StepGraph(step, state0())
    captured = _run_steps(runner, batches, loss=lambda out: out,
                          keep_at=QUICKSTART_STEPS, host=True)
    launches = adagrad_update_leaves.launches
    check(launches == QUICKSTART_STEPS and adagrad_update.launches == 0
          and runner.per_replay == {adagrad_update_leaves: 1},
          f"adagrad launched once a step for the {n_leaves} f32 leaves, "
          f"one in each replay: {launches} launches of "
          f"adagrad_update_leaves and {adagrad_update.launches} of "
          f"adagrad_update in {QUICKSTART_STEPS} steps, "
          f"{runner.per_replay} a replay")
    with torch.no_grad():
        err = float(cnn.error_rate(
            cnn.forward(runner.new[0], ccfg, torch.from_numpy(test_x).cuda()),
            torch.from_numpy(test_y).cuda()))
    check(0.0 <= err <= 1.0, f"test error rate in [0, 1]: {err}")
    graph_split, _, _ = _traced_device_split(lambda: runner(batches[-1]))
    numbers = _capture_numbers(runner)
    del runner
    twice = _eager_twice(step, state0(), batches[0], loss=lambda out: out)
    bar = twice["bar"]
    eager = run(_Eager)
    ok, gap = _held(captured, eager, bar)
    check(ok, f"quickstart: the captured steps' losses and state equal the "
          f"eager loop's at {bar}: max gap {gap}")
    stale_ok, stale_gap = _held(run(_StaleBatch), eager, bar)
    check(not stale_ok, f"quickstart: a runner that never refreshes its "
          f"batch buffer departs from the eager loop: gap only {stale_gap}")
    losses = [float(x) for x in captured["losses"]]
    check(all(np.isfinite(losses)), f"finite losses: {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check(last < first, f"mean loss of the last 5 steps ({last}) below the "
          f"first 5 ({first})")
    graph_ms, eager_ms = (statistics.median(r["secs"][TRAIN_WARM:]) * 1e3
                          for r in (captured, eager))
    graph_dev, eager_dev = (sum(x.values()) for x in (graph_split,
                                                      twice["split"]))
    say("5 quickstart", model=ccfg.name, steps=QUICKSTART_STEPS,
        batch=bs, loss_first5=f"{first:.6f}", loss_last5=f"{last:.6f}",
        test_error=f"{err:.4f}", leaves=n_leaves, adagrad_launches=launches,
        step_ms=f"{graph_ms:.3f}",
        **_graph_fields(captured, eager, numbers, bar, gap),
        captured_device_ms=f"{graph_dev:.3f}",
        captured_idle_share=f"{1 - graph_dev / graph_ms:.3f}",
        eager_device_ms=f"{eager_dev:.3f}",
        eager_idle_share=f"{1 - eager_dev / eager_ms:.3f}",
        planted_stale_batch_gap=f"{stale_gap:.3g}")
    return launches


# --- 6, 7. serving the LM zoo ------------------------------------------------


@contextlib.contextmanager
def _recording(module, attr: str, every: bool = False):
    """While open, ``module.attr`` keeps the arguments and the result of
    its first and its last call (with ``every``, of every call, in order)
    in the list it yields.  It keeps references, not
    copies, so the served run it times does no extra work: the models hand
    each kernel fresh tensors and change none of them afterwards (the KV
    cache is written by copy, the RWKV and SSM states are stacked anew each
    step, and the decode graph copies them into the cache only when the
    next step starts).  A call made while the decode graph was captured
    keeps the graph's own tensors, which hold the last replay's inputs and
    outputs.  Were one changed, its re-run would disagree and fail the
    check, not pass it."""
    original = getattr(module, attr)
    calls = []

    def call(*args, **kwargs):
        out = original(*args, **kwargs)
        if every or not calls:
            calls.append((args, kwargs, out))
        else:
            calls[1:] = [(args, kwargs, out)]
        return out

    setattr(module, attr, call)
    try:
        yield calls
    finally:
        setattr(module, attr, original)


def _plain_flash_attention(q, k, v, *, causal=True, window=0):
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal,
                         window=window).transpose(1, 2)


#: the repository's kernels, by the names of their CUDA functions, and the
#: marks of cuBLAS's matrix-product kernels, to split a trace's device time
REPO_KERNELS = ("server_step_kernel", "adagrad_kernel", "flash_kernel",
                "wkv_kernel", "mamba_scan_kernel")
MATMUL_MARKS = ("gemm", "gemv", "xmma", "cutlass", "nvjet")


def _part(kernel: str) -> str:
    """Which part of a device-time split a kernel (its traced name) is:
    the repository's kernels, matrix products, or the rest."""
    if any(k in kernel for k in REPO_KERNELS):
        return "repo_kernels"
    if any(m in kernel.lower() for m in MATMUL_MARKS):
        return "matmul"
    return "other"


def _device_split(fn) -> dict:
    """The device time (ms) of the kernels of one call of ``fn``, from a
    ``torch.profiler`` trace of it (one call first, untraced, so the trace
    sees no first-call work): in all, and split into the repository's
    kernels, matrix products and the rest; and ``warm``, the CUDA-event
    time of the untraced call (host issue included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():           # the cache is an inference tensor
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    split = {"repo_kernels": 0.0, "matmul": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        split[_part(e.key)] += e.self_device_time_total / 1e3
    check(any(split.values()), "the profiler traced the call's kernels")
    return dict(split, all=sum(split.values()),
                warm=start.elapsed_time(end))


def _off_by_one_slot(api):
    """A planted fault: every decode step writes its key and value into the
    cache slot before its own (over the last token's) and ropes them one
    position early."""
    return dataclasses.replace(
        api, decode_step=lambda params, cache, token, index, **kw:
        api.decode_step(params, cache, token, index - 1, **kw))


def _reference_index(api):
    """A planted fault: each decode step at the index the JAX package's
    ``generate`` gives a vlm, S_text + i, which leaves out the P patch
    positions before the text (ROADMAP.md, Queue 3, notes on the
    reference)."""
    patches = api.cfg.num_patches
    return dataclasses.replace(
        api, decode_step=lambda params, cache, token, index, **kw:
        api.decode_step(params, cache, token, index - patches, **kw))


def _state_dropped(*keys: str):
    """A planted fault: decoding starts from zeros under cache ``keys``
    (RWKV's ``wkv``, Mamba's ``ssm``, Whisper's ``cross_k`` and
    ``cross_v``), not from what the prefill hands over."""
    def fault(api):
        def prefill(*args, **kwargs):
            logits, cache = api.prefill(*args, **kwargs)
            return logits, dict(cache, **{k: torch.zeros_like(cache[k])
                                          for k in keys})
        return dataclasses.replace(api, prefill=prefill)
    fault.__name__ = f"{'+'.join(keys)}_state_dropped"
    return fault


def _event_timed(fn, spans: list, served: list, vocab: int):
    """``fn`` (a prefill, a decode step or a ``DecodeGraph.step``) timed by
    CUDA events around each call, outside any graph, with its last
    position's logits cloned into ``served``."""
    def call(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        spans.append((start, end))
        logits = out[0] if isinstance(out, tuple) else out
        served.append(logits[:, -1, :vocab].clone())
        return out
    return call


def _serve(api, params, prompts, extras, graph=None):
    """``generate`` (``extras``: its ``extra_inputs``) through the decode
    graph runner ``graph`` (``launch.serve.DecodeGraph`` by default, or a
    subclass with a planted fault), its prefill and each runner step timed
    by CUDA events and the last position's logits kept: (tokens, logits
    (B, 1 + GEN, V), the calls' ms (the prefill, the first step, run
    eagerly and then captured, and the replays), the runner)."""
    from repro_torch.launch import serve

    base = graph or serve.DecodeGraph
    served, spans, made = [], [], []

    class Timed(base):
        step = _event_timed(base.step, spans, served, api.cfg.vocab_size)

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    timed = dataclasses.replace(api, prefill=_event_timed(
        api.prefill, spans, served, api.cfg.vocab_size))
    with _patched(serve, "DecodeGraph", lambda _: Timed):
        toks = serve.generate(timed, params, prompts, gen=SERVE_GEN,
                              extra_inputs=extras)
    torch.cuda.synchronize()
    # emptied, so that the runner (and the weights and cache it holds) is
    # freed with the caller's last reference, not at a later collection
    runner, = made
    made.clear()
    return (toks, torch.stack(served, 1),
            [s.elapsed_time(e) for s, e in spans], runner)


def _serve_eager(api, params, prompts, extras):
    """The plain loop ``generate`` ran before its decode graph: the prefill,
    then ``api.decode_step`` called from Python for each token, each call
    timed by CUDA events: (tokens, logits (B, 1 + GEN, V), the calls' ms,
    the last cache)."""
    served, spans = [], []
    vocab = api.cfg.vocab_size
    prefill = _event_timed(api.prefill, spans, served, vocab)
    step = _event_timed(api.decode_step, spans, served, vocab)
    s = _prefix(api.cfg) + prompts.shape[1]
    with torch.inference_mode():
        logits, cache = prefill(params, dict(extras, tokens=prompts),
                                cache_len=s + SERVE_GEN)
        out = []
        tok = logits[:, :, :vocab].argmax(-1).to(torch.int32)
        for i in range(SERVE_GEN):
            out.append(tok[:, 0])
            logits, cache = step(params, cache, tok, s + i)
            tok = logits[:, :, :vocab].argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    return (torch.stack(out, 1), torch.stack(served, 1),
            [s_.elapsed_time(e) for s_, e in spans], cache)


def _stale_index():
    """A planted fault: a decode graph runner that never updates its index
    buffer, so every replay decodes at index 0."""
    from repro_torch.launch.serve import DecodeGraph

    class StaleIndex(DecodeGraph):
        def _load(self, token, index):
            self.token.copy_(token)

    return StaleIndex


def _prefix(cfg) -> int:
    """Positions before the text: a vlm sequence starts with its
    patches."""
    return cfg.num_patches if cfg.family == "vlm" else 0


def _extra_inputs(cfg, rng) -> dict:
    """The extra inputs of a family's prefill, drawn as the serve CLI
    draws them: normal(0, 0.02) from the prompts' generator, f32."""
    b = SERVE_BATCH
    shapes = {"vlm": ("patches", (b, cfg.num_patches, cfg.d_model)),
              "encdec": ("frames", (b, cfg.encoder_seq_len, cfg.d_model))}
    if cfg.family not in shapes:
        return {}
    name, shape = shapes[cfg.family]
    return {name: torch.from_numpy(rng.normal(0, 0.02, shape)).to(
        "cuda", torch.float32)}


def _teacher_forced(api, params, prompts, toks, extras):
    """One forward over prompt + served tokens: the logits of positions
    P+S-1 .. P+S+GEN-1 (P: a vlm's patch positions), which the served steps
    produced one by one."""
    with torch.inference_mode():
        tf, _, _ = api.forward_features(
            params, dict(extras, tokens=torch.cat([prompts, toks], 1)))
    start = _prefix(api.cfg) + prompts.shape[1] - 1
    return tf[:, start:, :api.cfg.vocab_size]


@dataclasses.dataclass(frozen=True)
class OnPath:
    """A kernel on a serve path: its wrapper, which the model calls as
    ``module.attr``; its plain version and the bar of a launch re-run
    through it (one per output); the launches the path must make; and the
    launches re-run, (name, index in the order of launch)."""
    wrapper: object
    module: object
    attr: str
    plain: object
    tol: tuple
    launches: int
    rerun: tuple = (("first", 0), ("last", -1))


def _moe_drops(calls) -> dict:
    """Over recorded ``apply_moe`` calls (args, kwargs): the assignments
    dropped, the largest expert load and the capacity, and the (B,) batch
    rows that held a token with a dropped assignment."""
    dropped, load, cap, rows = 0, 0, 0, None
    for args, kwargs, _ in calls:
        c, loads, tokens = dispatch_load(*args, **kwargs)
        dropped += int((loads - c).clamp_min(0).sum())
        load, cap = max(load, int(loads.max())), max(cap, c)
        hit = tokens.any(-1)
        rows = hit if rows is None else rows | hit
    return {"dropped": dropped, "max_load": load, "capacity": cap,
            "rows": rows}


def _no_drop(cfg):
    """``cfg`` at the MoE capacity factor E/k, where every expert has a
    slot for every token: no assignment drops."""
    moe = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.num_experts_per_tok))


def phase_serve(phase: str, cfg, kernels, fault, moe=None,
                prompt: int = SERVE_PROMPT) -> dict:
    """``generate`` on ``cfg`` at its widths, f32, each decode step a replay
    of a CUDA graph (``launch.serve.DecodeGraph``), with every launch of
    each kernel of ``kernels`` (``OnPath``) counted and the ones it names
    recorded; then the checks described in the module docstring.  Each
    kernel must launch its ``launches`` times while serving (the graph's
    launches counted at each replay).  ``prompt`` positions: a vlm's
    patches, then its text; an encdec model's decoder prompt, beside its
    ``encoder_seq_len`` frames.

    The same prompts are then served by a plain loop of
    ``api.decode_step`` (``_serve_eager``): its tokens must equal the
    captured ones, and its logits too, bit for bit, or within the cell's
    ``SERVE_TOL`` with a MoE (whose dispatch accumulates; the gap is
    printed).  With ``moe`` (the module through which the model calls
    ``apply_moe``) the dropped assignments of the served prefill, of the
    plain loop's decode steps (a replay runs no Python to record) and of
    the teacher-forced forward are counted, and a batch row that any drop
    touched is left out of the served-vs-forward comparison; if no row is
    left, the same prompts are served and compared again at a capacity
    factor where nothing drops (``_no_drop``), and both are printed.  Then
    ``fault`` (the api with a planted fault, captured with the step) and a
    runner that never updates its index buffer (``_stale_index``; not for
    a family whose step reads no index) serve the same prompts, and the
    served-vs-forward check must fail on each.  Last, one more decode step
    is traced as a replay and as an eager call, and one more prefill: each
    step's device time beside its median as served gives the device's idle
    share while decoding, and all are split into the repository's
    kernels, matrix products and the rest; the prefill is timed once more
    warm (``prefill_warm_ms``; the served prefill is the model's first
    call, which pays for first use).  Returns each kernel's launches by
    name."""
    from repro_torch.launch.serve import DecodeGraph
    from repro_torch.models.model import build_model, count_params_analytic
    from repro_torch.sharding.spec import values_tree

    arch = cfg.name
    tol = SERVE_TOL[arch]
    vocab = cfg.vocab_size
    api = build_model(cfg, compute_dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = values_tree(api.init(gen))
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == count_params_analytic(cfg),
          f"{arch}: {n_params} params, the analytic count says "
          f"{count_params_analytic(cfg)}")
    rng = np.random.default_rng(0)
    s_text = prompt - _prefix(cfg)
    prompts = torch.from_numpy(rng.integers(
        0, vocab, (SERVE_BATCH, s_text))).to("cuda", torch.int32)
    extras = _extra_inputs(cfg, rng)

    with contextlib.ExitStack() as routing:
        moe_calls = (routing.enter_context(_recording(moe, "apply_moe",
                                                      every=True))
                     if moe is not None else [])
        with contextlib.ExitStack() as launching:
            launched = [launching.enter_context(_recording(
                k.module, k.attr,
                every=any(i not in (0, -1) for _, i in k.rerun)))
                for k in kernels]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t0 = time.perf_counter()
            toks, served, ms, runner = _serve(api, params, prompts, extras)
            wall = time.perf_counter() - t0
            counts = {w.__name__: w.launches for w in WRAPPERS}
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        per_replay = {w.__name__: n for w, n in runner.per_replay.items()}
        served_moe = moe_calls[:]
        del moe_calls[:]
        # the plain loop the graph replaces, on the same prompts
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eager_toks, eager_served, eager_ms, eager_cache = _serve_eager(
            api, params, prompts, extras)
        eager_wall = time.perf_counter() - t0
        eager_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        eager_moe = moe_calls[:]
        del moe_calls[:]
        # the served logits against one teacher-forced forward over the
        # same tokens
        tf = _teacher_forced(api, params, prompts, toks, extras)
    for k in kernels:
        got = counts[k.wrapper.__name__]
        check(got == k.launches,
              f"{arch}: {k.wrapper.__name__} launched {k.launches} times "
              f"while serving, got {counts}")
    check(toks.shape == (SERVE_BATCH, SERVE_GEN) and toks.dtype == torch.int32
          and bool(((toks >= 0) & (toks < vocab)).all()),
          f"{arch}: tokens of shape {(SERVE_BATCH, SERVE_GEN)} in the "
          f"vocabulary, got {tuple(toks.shape)} {toks.dtype}")
    check(bool(torch.isfinite(served).all()), f"{arch}: finite logits")
    check(torch.equal(toks, eager_toks),
          f"{arch}: the captured decode's tokens equal the plain loop's")
    graph_err = _max_err(served, eager_served)
    graph_bitwise = torch.equal(served, eager_served)
    if moe is None:
        check(graph_bitwise, f"{arch}: the captured decode's logits equal "
              f"the plain loop's bit for bit: max err {graph_err}")
    else:
        check(_within(served, eager_served, **tol),
              f"{arch}: the captured decode's logits within {tol} of the "
              f"plain loop's: max err {graph_err}")
    del eager_served

    rows = torch.ones(SERVE_BATCH, dtype=torch.bool, device="cuda")
    row_fields = {}
    if moe is not None:
        n_moe = len(moe_calls)
        check(n_moe > 0 and len(served_moe) == 3 * n_moe
              and len(eager_moe) == (1 + SERVE_GEN) * n_moe,
              f"{arch}: one apply_moe call a MoE layer and pass (the "
              f"served prefill, its first step and the capture; the plain "
              f"loop's prefill and steps; the forward)")
        drops = {"prefill": _moe_drops(served_moe[:n_moe]),
                 "decode": _moe_drops(eager_moe[n_moe:]),
                 "forward": _moe_drops(moe_calls)}
        for name, d in drops.items():
            rows &= ~d["rows"]
            row_fields[f"moe_{name}_dropped"] = d["dropped"]
            row_fields[f"moe_{name}_max_load"] = (f"{d['max_load']}/"
                                                  f"{d['capacity']}")
    del served_moe, eager_moe, moe_calls
    row_fields["rows_compared"] = f"{int(rows.sum())}/{SERVE_BATCH}"
    # the api whose served run is held to its forward (and planted with
    # the fault): the published one, unless drops touched every row
    held = api
    if not rows.any():
        held = build_model(_no_drop(cfg), compute_dtype=torch.float32)
        with _recording(moe, "apply_moe", every=True) as calls:
            held_toks, served = _serve(held, params, prompts, extras)[:2]
            tf = _teacher_forced(held, params, prompts, held_toks, extras)
        nodrop = _moe_drops(calls)
        del calls, held_toks
        check(nodrop["dropped"] == 0,
              f"{arch}: nothing drops at the capacity factor "
              f"{held.cfg.moe.capacity_factor}: {nodrop}")
        rows = torch.ones(SERVE_BATCH, dtype=torch.bool, device="cuda")
        row_fields["nodrop_capacity_factor"] = held.cfg.moe.capacity_factor
        row_fields["nodrop_max_load"] = (f"{nodrop['max_load']}/"
                                         f"{nodrop['capacity']}")
        row_fields["nodrop_rows_compared"] = f"{SERVE_BATCH}/{SERVE_BATCH}"
    err = _max_err(served[rows], tf[rows])
    check(_within(served[rows], tf[rows], **tol),
          f"{arch}: served logits within {tol} of the teacher-forced "
          f"forward: max err {err}")
    top2 = tf.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]
                > tol["atol"] + tol["rtol"] * top2[..., 0].abs())[rows]
    same = (served.argmax(-1) == tf.argmax(-1))[rows]
    check(bool(same[decisive].all()),
          f"{arch}: served argmax equals the teacher-forced argmax wherever "
          f"the top-two gap exceeds the tolerance")
    logits_absmax = float(tf.abs().max())
    del tf

    # the named launches of each kernel against its plain version (a
    # launch the capture recorded holds the last replay's tensors)
    rerun = {}
    for k, calls in zip(kernels, launched):
        name = k.wrapper.__name__
        for which, index in k.rerun:
            args, kwargs, out = calls[index]
            out = out if isinstance(out, tuple) else (out,)
            with torch.inference_mode():
                want = k.plain(*args, **kwargs)
            want = want if isinstance(want, tuple) else (want,)
            for got, ref, call_tol in zip(out, want, k.tol):
                check(_within(got, ref, **call_tol),
                      f"{arch}: the {which} {name} launch within "
                      f"{call_tol} of its plain version: max err "
                      f"{_max_err(got, ref)}")
                rerun[f"{name}_rerun_max_err"] = max(
                    rerun.get(f"{name}_rerun_max_err", 0.0),
                    _max_err(got, ref))
            q, k_ = args[0], args[1]
            rerun[f"{name}_rerun_{which}"] = "x".join(
                str(n) for n in q.shape) + (
                f"_kv{k_.shape[1]}" if k_.dim() == 4
                and k_.shape[1] != q.shape[1] else "")
    del launched

    # the same check must fail on each planted fault
    planted = {fault.__name__: (fault(held), None)}
    if cfg.family != "ssm":          # RWKV's step reads no index
        planted["stale_index"] = (held, _stale_index())
    planted_err = {}
    for name, (bad_api, graph) in planted.items():
        bad_toks, bad_served = _serve(bad_api, params, prompts, extras,
                                      graph=graph)[:2]
        bad_tf = _teacher_forced(held, params, prompts, bad_toks, extras)
        planted_err[name] = _max_err(bad_served[rows], bad_tf[rows])
        check(not _within(bad_served[rows], bad_tf[rows], **tol),
              f"{arch}: a planted fault ({name}) fails the served-vs-"
              f"forward check at {tol}: its max err is only "
              f"{planted_err[name]}")
        del bad_api, bad_served, bad_tf
    del planted, held

    decode_ms = statistics.median(ms[2:])      # the replays
    eager_decode_ms = statistics.median(eager_ms[1:])
    # rewrites the last cache slot
    index = _prefix(cfg) + s_text + SERVE_GEN - 1
    last = toks[:, -1:]
    graph_split = _device_split(lambda: DecodeGraph.step(runner, last,
                                                         index))
    eager_split = _device_split(lambda: api.decode_step(params, eager_cache,
                                                        last, index))
    prefill = _device_split(lambda: api.prefill(
        params, dict(extras, tokens=prompts),
        cache_len=_prefix(cfg) + s_text + SERVE_GEN))
    on_path = {k.wrapper.__name__ for k in kernels}
    say(phase, arch=arch, params=n_params, layers=cfg.num_layers,
        d_model=cfg.d_model, batch=SERVE_BATCH, prompt=prompt,
        **({"prompt_text": s_text} if s_text != prompt else {}),
        **{f"{k}_shape": "x".join(str(n) for n in v.shape)
           for k, v in extras.items()},
        gen=SERVE_GEN,
        **{f"{name}_launches": counts[name] for name in sorted(on_path)},
        other_launches=sum(n for name, n in counts.items()
                           if name not in on_path),
        graph_launches_a_replay=",".join(
            f"{n}:{c}" for n, c in sorted(per_replay.items())) or "none",
        wall_s=f"{wall:.3f}", tok_s=f"{SERVE_BATCH * SERVE_GEN / wall:.1f}",
        eager_wall_s=f"{eager_wall:.3f}",
        eager_tok_s=f"{SERVE_BATCH * SERVE_GEN / eager_wall:.1f}",
        prefill_ms=f"{ms[0]:.3f}",
        decode_first_step_ms=f"{ms[1]:.3f}",
        decode_step_ms_median=f"{decode_ms:.3f}",
        decode_eager_ms_median=f"{eager_decode_ms:.3f}",
        decode_step_device_ms=f"{graph_split['all']:.3f}",
        decode_idle_share=f"{1 - graph_split['all'] / decode_ms:.3f}",
        **{f"decode_{k}_ms": f"{v:.3f}" for k, v in graph_split.items()
           if k not in ("all", "warm")},
        decode_eager_device_ms=f"{eager_split['all']:.3f}",
        decode_eager_idle_share=(
            f"{1 - eager_split['all'] / eager_decode_ms:.3f}"),
        **{f"decode_eager_{k}_ms": f"{v:.3f}"
           for k, v in eager_split.items() if k not in ("all", "warm")},
        prefill_device_ms=f"{prefill['all']:.3f}",
        **{f"prefill_{k}_ms": f"{v:.3f}" for k, v in prefill.items()
           if k != "all"},
        peak_gb=f"{peak_gb:.2f}", eager_peak_gb=f"{eager_peak_gb:.2f}",
        graph_tokens_equal_eager=True,
        graph_logits_bitwise_eager=graph_bitwise,
        graph_logits_max_err_vs_eager=f"{graph_err:.3g}",
        logits_absmax=f"{logits_absmax:.3g}",
        tol_atol=tol["atol"], logits_max_err_vs_forward=f"{err:.3g}",
        argmax_decisive=f"{int(decisive.sum())}/{decisive.numel()}",
        argmax_equal=f"{int(same.sum())}/{same.numel()}", **row_fields,
        **{key: (f"{v:.3g}" if isinstance(v, float) else v)
           for key, v in rerun.items()},
        planted_fault=fault.__name__,
        planted_max_err_vs_forward=f"{planted_err[fault.__name__]:.3g}",
        # "n/a": the family's step reads no index
        stale_index_max_err_vs_forward=(
            f"{planted_err['stale_index']:.3g}" if "stale_index"
            in planted_err else "n/a"))
    del params, api, served, runner, eager_cache, extras
    gc.collect()
    torch.cuda.empty_cache()
    return {name: counts[name] for name in on_path}


# --- 9. training qwen1.5-0.5b with the paper's split strategies --------------

TRAIN_ARCH = "qwen1.5-0.5b"
#: phase 9's learning rate (β 1 as the paper's, K 4 and the rest
#: RunConfig's defaults).  With β inside the square root and gradients of
#: ~1e-3 a step moves each parameter by ~lr·g: at RunConfig's 1e-2, and up
#: to 1, 20 steps lowered the loss by no more than the batches' noise
#: (~0.01-0.03); 3 lowered it by 0.22, 10 by 0.43, and 30 diverged
#: (PERF.md)
TRAIN_LR = 3.0
#: a: batch, sequence, split_concurrent steps; the first TRAIN_WARM steps
#: are left out of the step-time medians
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARM = 8, 512, 20, 2
#: b: dp_full and split_sequential steps, each
TRAIN_TIMED_STEPS = 6
#: c: depth cut to 2 layers, batch 2, sequence 64, 3 steps, card vs CPU
TRAIN_CUT_LAYERS, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ, TRAIN_CUT_STEPS = (
    2, 2, 64, 3)
#: the f32 model bar of ROADMAP.md's conventions, card against host CPU
TRAIN_TOL = dict(atol=2e-4, rtol=1e-3)


@contextlib.contextmanager
def _patched(owner, attr: str, wrap):
    """Within the block, ``owner.attr`` is ``wrap(original)``."""
    original = getattr(owner, attr)
    setattr(owner, attr, wrap(original))
    try:
        yield
    finally:
        setattr(owner, attr, original)


def _trees_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y.to(x.device))
                                      for x, y in zip(la, lb))


def _state_gap(got, want) -> tuple:
    """(every leaf of every ``TrainState`` field within ``TRAIN_TOL``, the
    largest absolute gap), leaves compared on the host."""
    from repro_torch.train_fabric import state_to_tree

    gl, wl = (tree_leaves(state_to_tree(s)) for s in (got, want))
    ok, gap = len(gl) == len(wl), 0.0
    for x, y in zip(gl, wl):
        x, y = torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()
        if x.shape != y.shape or x.dtype != y.dtype:
            return False, float("inf")
        ok = ok and _within(x, y, **TRAIN_TOL)
        gap = max(gap, _max_err(x, y))
    return ok, gap


#: a kernel of PyTorch's own (``torch.cuda._sleep``'s) that marks a point
#: of the stream in a trace
MARK_KERNEL = "spin_kernel"


def _marked(server_head_update):
    """``server_head_update`` that first launches the mark kernel: on the
    one stream every kernel of the step before the mark is the clients'
    half, every one after it the server's."""
    def marked(*args, **kwargs):
        torch.cuda._sleep(1)
        return server_head_update(*args, **kwargs)
    return marked


def _kernel_label(name: str) -> str:
    for noise in ("void ", "at::native::", "(anonymous namespace)::", " "):
        name = name.replace(noise, "")
    return re.sub(r"[^A-Za-z0-9_:<>,]", "", name)[:100]


def _traced_halves(fn) -> tuple:
    """One call of ``fn`` traced (after one untraced): the device ms of its
    kernels before and after the first mark kernel (``_marked``), each
    split into the repository's kernels, matrix products and the rest,
    the mark left out; and the ms of each kernel of the rest, by label."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.time_range.start)
    marks = [e for e in kernels if MARK_KERNEL in e.name]
    check(len(marks) == 1, f"one mark kernel in the traced step, found "
          f"{len(marks)} among {len(kernels)} kernels")
    halves = {half: {"repo_kernels": 0.0, "matmul": 0.0, "other": 0.0}
              for half in ("client", "server")}
    others: dict = {}
    for e in kernels:
        if e is marks[0]:
            continue
        half = ("server" if e.time_range.start >= marks[0].time_range.start
                else "client")
        part, ms = _part(e.name), e.time_range.elapsed_us() / 1e3
        halves[half][part] += ms
        if part == "other":
            label = _kernel_label(e.name)
            others[label] = others.get(label, 0.0) + ms
    check(all(sum(h.values()) > 0 for h in halves.values()),
          f"the profiler traced both halves of the step: {halves}")
    return halves, others


def _k2_rerun(call, which: str) -> int:
    """A recorded K2 launch (``adagrad.ops._update``, which the wrapper
    calls positionally) against its plain version, ``adagrad_ref``, on the
    same tensors, bitwise, one leaf at a time (so the re-run holds one
    leaf's outputs, not the whole tree's); returns its leaves."""
    (_, ps, gs, accs, lr, beta, weight_decay), _, (p_out, acc_out) = call
    for p, g, a, got_p, got_acc in zip(ps, gs, accs, p_out, acc_out):
        want = adagrad_ref(p, g, a, lr=lr, beta=beta,
                           weight_decay=weight_decay)
        for got, w in zip((got_p, got_acc), want):
            check(got.dtype == w.dtype and torch.equal(got, w),
                  f"train: the {which} K2 launch bitwise equal to its plain "
                  f"version: max err {_max_err(got, w)}")
        del want
    return len(ps)


def _cuda_batches(rng, n: int, batch: int, seq: int, vocab: int,
                  device="cuda") -> list:
    from repro_torch.data import make_lm_batch
    return [{k: torch.from_numpy(v).to(device) for k, v in
             make_lm_batch(rng, batch, seq, vocab).items()}
            for _ in range(n)]


def _current_features_fault(api, step_fn):
    """A planted fault: the server trains the head on the CURRENT step's
    features (the client's forward through the stale head), not on the
    previous step's."""
    from repro_torch.core.split_parallel import merge_params

    def step(state, batch):
        with torch.no_grad():
            _, _, feats = api.forward_features(
                merge_params(state.params, state.head_stale), batch,
                compute_logits=False, differentiable=True)
        return step_fn(dataclasses.replace(
            state, prev_features=feats, prev_labels=batch["labels"],
            prev_mask=batch["mask"]), batch)
    return step


def _split_concurrent_run(api, run, params, batches, fault=False) -> tuple:
    """``split_concurrent`` steps from ``params`` on their device over
    ``batches``, through a ``StepGraph`` (on the card the first step
    eager, the rest replays of its graph; on the host CPU every step
    eager): (per-step losses, (initial state, final state))."""
    from repro_torch.core.split_parallel import (init_prev_features,
                                                 make_train_step)
    from repro_torch.optim import get_optimizer

    opt = get_optimizer("adagrad", run.learning_rate,
                        adagrad_beta=run.adagrad_beta,
                        weight_decay=run.weight_decay, use_kernel=True)
    init, step = make_train_step(api, opt, strategy="split_concurrent",
                                 head_sync_period=run.head_sync_period)
    if fault:
        step = _current_features_fault(api, step)
    first = init_prev_features(init(params=params), api, batches[0],
                               dtype=torch.float32)
    runner = StepGraph(step, _moved(first, batches[0]["tokens"].device))
    losses = []
    for b in batches:
        state, metrics = runner(b)
        losses.append(metrics["loss"].clone())
    return torch.stack(losses), (first, state)


def _update_gap(got, want, *, zero=(), spacing=False) -> tuple:
    """``got``, ``want``: (initial, final) states.  (Each trained leaf's
    change since the initial state, and each accumulator, within 1e-3 of
    ``want``'s largest magnitude with rtol 1e-3 beside it; the largest
    gap over that magnitude).  An update is far smaller than
    ``TRAIN_TOL``'s atol, which alone would pass one of the wrong size.

    ``spacing``: the bar is at least one f32 spacing at the leaf's largest
    magnitude, the least difference two f32 params can show (a Mamba
    ``dt_b`` sits at -4.6, where the spacing is 4.8e-7, and changes by
    ~1.5e-4 a step).  ``zero``: the last keys of leaves whose gradient is
    zero in exact arithmetic (``ZERO_GRAD``); each must change on both
    sides by less than 1e-6 of the largest change, and is left out of the
    gap."""
    from repro_torch.models.model import _paths

    ok, worst = True, 0.0
    for field in ("params", "head", "opt_state", "head_opt_state"):
        leaves, tdef = tree_flatten(getattr(got[0], field))
        rows = []
        for path, g0, g1, w0, w1 in zip(_paths(tdef), leaves, *(
                tree_leaves(getattr(s, field))
                for s in (got[1], *want))):
            rows.append((path.rsplit("/", 1)[-1] in zero,
                         (g1 - g0).cpu(), (w1 - w0).cpu(),
                         float(w1.abs().max()) if w1.numel() else 0.0))
        top = max((float(dw.abs().max()) for _, _, dw, _ in rows
                   if dw.numel()), default=0.0)
        for is_zero, dg, dw, big in rows:
            scale, gap = float(dw.abs().max()), _max_err(dg, dw)
            if is_zero:
                ok = ok and max(scale, float(dg.abs().max())) < 1e-6 * top
                continue
            atol = 1e-3 * scale
            if spacing:
                atol = max(atol, float(np.spacing(np.float32(big))))
            ok = ok and _within(dg, dw, atol=atol, rtol=1e-3)
            worst = max(worst, gap / scale if scale else
                        (float("inf") if gap else 0.0))
    return ok, worst


def _refresh_frozen_in(make):
    """``make_train_step`` whose step is ``_frozen_refresh``'s planted
    fault."""
    def make_planted(api, opt, **kw):
        init, step_fn = make(api, opt, **kw)
        return init, _frozen_refresh(step_fn, kw["head_sync_period"])
    return make_planted


def _held_train_loop(cfg, run, *, steps: int, on_step=None,
                     recorders=()) -> dict:
    """``train.train_loop`` of ``cfg`` under ``run`` for ``steps`` steps at
    batch TRAIN_BATCH, sequence TRAIN_SEQ on the card, its runner (a
    ``StepGraph``) timed at each call (``on_step(the state the step read
    (step 0's on the host), new state, i, recorded)`` after it), with the
    kernels' counts set to 0 just before
    and read just after, and the ``recorders`` ((module, attr, every)
    of ``_recording``) open around it; then one more replay traced, an
    eager loop of the same step from the same init over the same
    batches, held to the captured run at the measured bar, and the two
    planted graph faults (a stale batch buffer; the refresh frozen at the
    captured step), each over GRAPH_CMP_STEPS steps through
    ``train_loop``, which must fail that check.  Returns the runs'
    numbers and the eager loop (its final state the eager one)."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train

    seen, secs, fed = {}, [], []

    def noting(make):
        def make_noted(api, opt, **kw):
            init, step_fn = make(api, opt, **kw)
            seen.update(api=api, opt=opt, step=step_fn)
            return init, step_fn
        return make_noted

    class Timed(StepGraph):
        def __init__(self, fn, state, **kw):
            seen["init"] = _moved(state, "cpu")
            super().__init__(fn, state, **kw)
            seen["runner"] = self

        def __call__(self, batch):
            i = len(secs)
            if i == TRAIN_WARM:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            (new, metrics), took = _synced(super().__call__, batch)
            secs.append(took)
            if on_step is not None:
                # after the first step the runner's buffers are its new
                # state; after a later one they still hold what it read
                on_step(seen["init"] if i == 0 else self.state, new, i,
                        seen["recorded"])
            fed.append(batch)
            return new, metrics

    gc.collect()
    torch.cuda.empty_cache()
    with contextlib.ExitStack() as stack:
        seen["recorded"] = [stack.enter_context(_recording(*r))
                            for r in recorders]
        stack.enter_context(_patched(steps_mod, "make_train_step", noting))
        stack.enter_context(_patched(train, "StepGraph", lambda _: Timed))
        _zero_counts()
        t0 = time.perf_counter()
        losses, state = train.train_loop(cfg, run, steps=steps,
                                         batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                         device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {w.__name__: w.launches for w in WRAPPERS}
        captured = {"secs": secs,
                    "losses": torch.tensor(losses, dtype=torch.float32),
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
    runner, recorded = seen.pop("runner"), seen.pop("recorded")
    got = _host(state)
    leaves = tree_leaves((state.params, state.head))
    k2_bound, _ = _k2_bound(leaves, leaves)
    del state, leaves
    graph_split, _, n_kernels = _traced_device_split(
        lambda: StepGraph.__call__(runner, fed[-1]))
    numbers = _capture_numbers(runner)
    out = dict(losses=losses, counts=counts, wall=wall, recorded=recorded,
               batch=fed[-1],
               api=seen["api"], opt=seen["opt"], step=seen["step"],
               per_replay=numbers["per_replay"], k2_bound=k2_bound,
               graph_split=graph_split, graph_kernels=n_kernels)
    del runner
    gc.collect()
    torch.cuda.empty_cache()

    init = seen.pop("init")
    twice = _eager_twice(seen["step"], _moved(init, "cuda"), fed[0])
    bar = twice["bar"]
    eager_run = _Eager(seen["step"], _moved(init, "cuda"))
    del init
    eager = _run_steps(eager_run, fed, keep_at=GRAPH_CMP_STEPS, host=True)
    ok, gap = _gap([captured["losses"], *got],
                   [eager["losses"], *_host(eager_run.state)], bar)
    del got
    check(ok, f"train: {cfg.name} ({run.compute_dtype}) through train_loop's "
          f"graph: every loss and state leaf of {steps} steps at {bar} of "
          f"an eager loop of the same step: max gap {gap}")
    planted = {}
    for name, ctx in (
            ("stale_batch", _patched(train, "StepGraph",
                                     lambda _: _StaleBatch)),
            ("frozen_refresh", _patched(steps_mod, "make_train_step",
                                        _refresh_frozen_in))):
        with ctx:
            f_losses, f_state = train.train_loop(
                cfg, run, steps=GRAPH_CMP_STEPS, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, device="cuda")
        planted[name] = _gap(
            [torch.tensor(f_losses, dtype=torch.float32), *_host(f_state)],
            [eager["losses"][:GRAPH_CMP_STEPS], *eager["kept"]], bar)
        del f_state
        check(not planted[name][0], f"train: {cfg.name}'s planted graph "
              f"fault {name} fails the check against the eager loop: max "
              f"gap only {planted[name][1]}")
    seen.clear()
    eager_ms = 1e3 * statistics.median(eager["secs"][TRAIN_WARM:])
    eager_dev = sum(twice["split"].values())
    out.update(eager=eager, eager_run=eager_run, captured=captured,
               fields=dict(_graph_fields(captured, eager, numbers, bar, gap),
                           eager_device_ms=f"{eager_dev:.3f}",
                           eager_idle_share=f"{1 - eager_dev / eager_ms:.3f}"),
               planted={k: v[1] for k, v in planted.items()})
    return out


def phase_train() -> int:
    """Phase 9 (the module docstring): returns K2's launches on the path
    (run a)."""
    from repro_torch.configs import get_arch_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import split_parallel
    from repro_torch.core.split_parallel import (make_train_step,
                                                 merge_params, split_params)
    from repro_torch.kernels.adagrad import ops as k2_ops
    from repro_torch.models.model import build_model, count_params_analytic
    from repro_torch.optim import get_optimizer
    from repro_torch.sharding.spec import values_tree

    run = RunConfig(arch=TRAIN_ARCH, strategy="split_concurrent",
                    learning_rate=TRAIN_LR, compute_dtype="float32", seed=0)
    cfg = get_arch_config(TRAIN_ARCH)
    untied = dataclasses.replace(cfg, tie_embeddings=False)
    k = run.head_sync_period
    tokens = TRAIN_BATCH * TRAIN_SEQ

    # a. the main path: train_loop through its graph, each step checked
    head_moved, stale_moved, stale_is_head, first_leaves = [], [], [], []

    def checking(before, new, i, recorded):
        head_moved.append(not _trees_equal(new.head, before.head))
        stale_moved.append(not _trees_equal(new.head_stale,
                                            before.head_stale))
        stale_is_head.append(_trees_equal(new.head_stale, new.head))
        if i == 0:        # the first launch, checked and let go
            k2_calls = recorded[0]
            first_leaves.append(_k2_rerun(k2_calls[0], "first"))
            k2_calls[0] = None

    held = _held_train_loop(
        cfg, run, steps=TRAIN_STEPS, on_step=checking,
        recorders=[(k2_ops, "_update")] + [
            (module, attr, True) for module, attr in (
                (layers, "flash_attention"), (rwkv, "wkv"),
                (mamba, "mamba_scan"))])
    k2_calls, *stray = held["recorded"]
    last_leaves = _k2_rerun(k2_calls[-1], "last")
    del k2_calls
    losses, counts = held["losses"], held["counts"]
    launches = counts["adagrad_update_leaves"]
    api, opt = held["api"], held["opt"]
    backbone, head = split_params(values_tree(api.init(None)))
    n_leaves = (len(tree_leaves(backbone)), len(tree_leaves(head)))
    state = held["eager_run"].state
    n_params = sum(x.numel() for x in tree_leaves(
        merge_params(state.params, state.head)))
    check(api.cfg == untied and n_params == count_params_analytic(untied),
          f"train: the untied {TRAIN_ARCH} at every width and depth, "
          f"{n_params} params (analytic: {count_params_analytic(untied)})")
    check(all(n <= MAX_LEAVES for n in n_leaves)
          and (first_leaves[0], last_leaves) == n_leaves,
          f"train: backbone and head trees of {n_leaves} f32 leaves, one "
          f"K2 launch each; first and last launches took "
          f"{first_leaves[0]} and {last_leaves}")
    check(launches == 2 * TRAIN_STEPS and counts["adagrad_update"] == 0
          and held["per_replay"] == {adagrad_update_leaves: 2},
          f"train: K2 launched twice a step (backbone, head), both inside "
          f"the graph: {launches} launches in {TRAIN_STEPS} steps, "
          f"{counts}, {held['per_replay']} a replay")
    check(not any(stray) and all(
        counts[w.__name__] == 0 for w in (flash_attention, wkv, mamba_scan,
                                          server_step_update)),
          f"train: no call of K3, K4 or K5 and no other kernel launched: "
          f"{[len(c) for c in stray]} calls, {counts}")
    del stray
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"train: finite losses: {losses}")
    first5, last5 = np.mean(losses[:5]), np.mean(losses[-5:])
    check(last5 < first5, f"train: mean loss of the last 5 steps ({last5}) "
          f"below the first 5 ({first5}): {losses}")
    check(not head_moved[0] and head_moved[1],
          f"train: the head bitwise unchanged by step 0 (no features yet, "
          f"weight decay 0) and changed by step 1: {head_moved[:2]}")
    syncs = [i for i in range(TRAIN_STEPS) if (i + 1) % k == 0]
    check(all(stale_is_head[i] and stale_moved[i] for i in syncs)
          and not any(stale_moved[i] for i in range(TRAIN_STEPS)
                      if i not in syncs),
          f"train: head_stale bitwise equal to the head after steps {syncs} "
          f"and unchanged after the others: moved {stale_moved}, equal to "
          f"head {stale_is_head}")
    step_s = held["captured"]["secs"]
    step_ms = 1e3 * statistics.median(step_s[TRAIN_WARM:])
    graph_dev = sum(held["graph_split"].values())
    say("9a train", arch=TRAIN_ARCH, params=n_params, layers=cfg.num_layers,
        d_model=cfg.d_model, vocab=cfg.padded_vocab, untied="yes",
        strategy=run.strategy, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=TRAIN_STEPS, lr=run.learning_rate, beta=run.adagrad_beta,
        head_sync_period=k, loss_first=f"{losses[0]:.6f}",
        loss_last=f"{losses[-1]:.6f}", loss_first5=f"{first5:.6f}",
        loss_last5=f"{last5:.6f}",
        losses=",".join(f"{x:.4f}" for x in losses),
        adagrad_launches=launches, backbone_leaves=n_leaves[0],
        head_leaves=n_leaves[1], k2_first_last_vs_plain="bitwise",
        k3_k4_k5_calls=0, head_after_step0="unchanged",
        head_after_step1="changed",
        stale_synced_after=",".join(map(str, syncs)),
        step_ms_median=f"{step_ms:.3f}",
        step_ms=",".join(f"{1e3 * x:.3f}" for x in step_s),
        tok_s=f"{tokens / step_ms * 1e3:.1f}",
        captured_device_ms=f"{graph_dev:.3f}",
        captured_idle_share=f"{1 - graph_dev / step_ms:.3f}",
        **held["fields"],
        **{f"planted_{k_}_gap": f"{v:.3g}"
           for k_, v in held["planted"].items()},
        wall_s=f"{held['wall']:.3f}")

    # d. one more step traced, split at a mark where the server's half
    # starts
    # (eager: the mark is a launch of the server's half, in the eager loop
    # of the same step that run a was held to)
    batch, step_fn = held["batch"], held["step"]
    eager_ms = 1e3 * statistics.median(held["eager"]["secs"][TRAIN_WARM:])
    with _patched(split_parallel, "server_head_update", _marked):
        halves, others = _traced_halves(lambda: step_fn(state, batch))
    k2_bound = held["k2_bound"]
    del state, batch, step_fn, held
    device_ms = sum(sum(h.values()) for h in halves.values())
    top = sorted(others.items(), key=lambda kv: -kv[1])[:5]
    say("9d train trace", strategy="split_concurrent", route="eager",
        step_device_ms=f"{device_ms:.3f}", eager_step_ms=f"{eager_ms:.3f}",
        step_idle_share=f"{1 - device_ms / eager_ms:.3f}",
        **{f"step_{part}_ms": f"{sum(h[part] for h in halves.values()):.3f}"
           for part in halves["client"]},
        **{f"{half}_device_ms": f"{sum(h.values()):.3f}"
           for half, h in halves.items()},
        **{f"{half}_{part}_ms": f"{ms:.3f}" for half, h in halves.items()
           for part, ms in h.items()},
        k2_bound_ms_a_step=f"{k2_bound:.3f}", repo_kernels="adagrad (K2)",
        step_other_top5=";".join(f"{name}:{ms:.3f}" for name, ms in top))
    gc.collect()
    torch.cuda.empty_cache()

    # b. dp_full against split_sequential from the same weights and batch,
    # then each timed
    api = build_model(untied, compute_dtype=torch.float32, remat=run.remat)
    opt = get_optimizer("adagrad", run.learning_rate,
                        adagrad_beta=run.adagrad_beta,
                        weight_decay=run.weight_decay, use_kernel=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(run.seed)
    params = values_tree(api.init(gen))
    batches = _cuda_batches(np.random.default_rng(run.seed),
                            TRAIN_TIMED_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                            cfg.vocab_size)
    after_one, times, peaks = {}, {}, {}
    for strategy in ("dp_full", "split_sequential"):
        init, step = make_train_step(api, opt, strategy=strategy)
        timed = _run_steps(
            StepGraph(step, init(params=tree_map(torch.clone, params))),
            batches, first=lambda new, s=strategy: after_one.__setitem__(
                s, merge_params(_moved(new.params, "cuda"),
                                _moved(new.head, "cuda"))))
        times[strategy] = 1e3 * statistics.median(
            timed["secs"][TRAIN_WARM:])
        peaks[strategy] = timed["peak_gb"]
        del timed
    flat_dp, tdef = tree_flatten(after_one["dp_full"])
    flat_sp = tdef.flatten_up_to(after_one["split_sequential"])
    gap = max(_max_err(a, b) for a, b in zip(flat_dp, flat_sp))
    check(gap <= 1e-6, f"train: one adagrad step of dp_full and of "
          f"split_sequential from the same weights and batch give params "
          f"within 1e-6: max gap {gap}")
    del params, batches, after_one, flat_dp, flat_sp, api, opt
    gc.collect()
    torch.cuda.empty_cache()
    say("9b train strategies", arch=TRAIN_ARCH, untied="yes",
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_TIMED_STEPS,
        dp_full_vs_split_sequential_max_gap=f"{gap:.3g}",
        **{f"{name}_step_ms_median": f"{ms:.3f}"
           for name, ms in times.items()},
        **{f"{name}_tok_s": f"{tokens / ms * 1e3:.1f}"
           for name, ms in times.items()},
        **{f"{name}_peak_gb": f"{gb:.2f}" for name, gb in peaks.items()})

    # c. the card against the host CPU at every width, depth cut to 2
    cut = dataclasses.replace(untied, num_layers=TRAIN_CUT_LAYERS)
    api = build_model(cut, compute_dtype=torch.float32, remat=run.remat)
    gen.manual_seed(run.seed)
    params = values_tree(api.init(gen))
    host = tree_map(lambda x: x.cpu(), params)
    on = {dev: _cuda_batches(np.random.default_rng(run.seed),
                             TRAIN_CUT_STEPS, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ,
                             cfg.vocab_size, dev) for dev in ("cuda", "cpu")}
    t0 = time.perf_counter()
    cpu_losses, cpu_states = _split_concurrent_run(api, run, host, on["cpu"])
    cpu_s = time.perf_counter() - t0
    results = {}
    for name, fault in (("card", False), ("planted", True)):
        losses_c, states_c = _split_concurrent_run(api, run, params,
                                                   on["cuda"], fault=fault)
        ok_state, gap_state = _state_gap(states_c[1], cpu_states[1])
        ok_update, gap_update = _update_gap(states_c, cpu_states)
        ok_loss = _within(losses_c.cpu(), cpu_losses, **TRAIN_TOL)
        results[name] = (ok_state and ok_update and ok_loss,
                         max(gap_state, _max_err(losses_c.cpu(), cpu_losses)),
                         gap_update)
        del states_c
    check(results["card"][0], f"train: {TRAIN_CUT_STEPS} split_concurrent "
          f"steps on the card within {TRAIN_TOL} of the host CPU's, every "
          f"loss and state leaf, and every update and accumulator within "
          f"1e-3 of its scale: max gap {results['card'][1]}, update gap "
          f"{results['card'][2]} of its scale")
    check(not results["planted"][0], f"train: a planted fault (the head "
          f"trained on the current step's features) fails the card-vs-CPU "
          f"check: its max gap is only {results['planted'][1]}, its update "
          f"gap {results['planted'][2]} of its scale")
    say("9c train card vs cpu", arch=TRAIN_ARCH, layers=TRAIN_CUT_LAYERS,
        d_model=cut.d_model, params=sum(x.numel()
                                        for x in tree_leaves(params)),
        batch=TRAIN_CUT_BATCH, seq=TRAIN_CUT_SEQ, steps=TRAIN_CUT_STEPS,
        losses_cpu=",".join(f"{float(x):.6f}" for x in cpu_losses),
        max_gap_vs_cpu=f"{results['card'][1]:.3g}",
        update_gap_of_scale=f"{results['card'][2]:.3g}",
        tol=f"atol={TRAIN_TOL['atol']},rtol={TRAIN_TOL['rtol']}",
        planted_fault="head_trained_on_current_features",
        planted_max_gap_vs_cpu=f"{results['planted'][1]:.3g}",
        planted_update_gap_of_scale=f"{results['planted'][2]:.3g}",
        cpu_run_s=f"{cpu_s:.3f}")
    del params, host, on, cpu_states, api
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --- 13. training the other LM families -------------------------------------

#: the families phase 13 trains (one config each) and each one's planted
#: fault in the card-vs-CPU check (13a)
ZOO_FAULTS = {"qwen3-moe-30b-a3b": "aux_loss_dropped",
              "internvl2-26b": "loss_over_the_patch_positions_too",
              "whisper-small": "enc_out_detached_before_cross_attention",
              "rwkv6-1.6b": "scan_carry_reset_at_the_chunk_boundary",
              "jamba-1.5-large-398b":
                  "scan_carry_reset_at_the_chunk_boundary"}
#: a: the smoke configs on the card and on the host CPU: batch, text
#: sequence (two 256-step chunks of the recurrent scans), split_concurrent
#: steps, and the CPU parity tests' lr
ZOO_SMOKE_BATCH, ZOO_SMOKE_SEQ, ZOO_SMOKE_STEPS, ZOO_SMOKE_LR = 2, 512, 3, 0.05
#: leaves whose gradient is zero in exact arithmetic
#: (``tests/test_torch_train_zoo.py::ZERO_GRAD``): without RoPE a key
#: bias shifts every score of a query's row alike
ZERO_GRAD = {"whisper-small": ("bk",)}
#: b: each family at every published width, one at a time: (arch, config
#: changes, the cuts (``reduced``), batch, text sequence, lr, steps).  The
#: depth cuts keep f32 params, gradients and accumulators (12 bytes a
#: param) and the update's new params and accumulators under ~70 GB.  At
#: β 1 a step moves a param by ~lr·g, so each row takes the lr at which
#: its loss fell in the fewest steps without a spike, found by
#: ``tools/torch_train_zoo_lr.py`` (PERF.md): whisper-small 3 (phase 9's
#: ``TRAIN_LR``) in 8 steps; rwkv6-1.6b and the Jamba cut 1 in 6 and 8 (3
#: spiked); qwen3-moe-30b-a3b 1 in 30 (its loss moved within its noise in
#: 8 steps at every lr from 0.1 to 3; 2 and 3 diverged within 30);
#: internvl2-26b 0.2 in 150 (0.5 and above diverged, 0.3 rose over 150
#: steps; at 0.2 its means over 15 steps fell from 11.940 to 11.911).
ZOO_FULL = (
    ("qwen3-moe-30b-a3b", dict(num_layers=4), "depth_48_to_4", 4, 512, 1.0,
     30),
    ("internvl2-26b", dict(num_layers=4),
     "depth_48_to_4,256_patches_and_256_text_tokens", 4, 256, 0.2, 150),
    ("whisper-small", {}, "none:1500_frames,decoder_S_448_its_context", 4,
     448, TRAIN_LR, 8),
    ("rwkv6-1.6b", {}, "none", 4, 512, 1.0, 6),
    ("jamba-1.5-large-398b", dict(JAMBA_CUT, moe_layer_period=4),
     "depth_72_to_2:one_period_Mamba_then_64:8_attention,"
     "moe_layer_period_2_to_4:both_FFNs_dense", 4, 512, 1.0, 8),
)
#: b: the first ZOO_FULL_WARM steps are left out of the step-time median;
#: the loss's mean over the last 3 steps must be below its first 3's
ZOO_FULL_WARM = 2
#: c: the families without a router, card against host CPU at bf16: one
#: dp_full step at the CPU tests' size and lr, held to their bf16 training
#: bars (``tests/test_torch_train_paths.py::BF16_TRAIN_TOL``: twice the
#: largest gap measured between the two packages; loss, and each update
#: and accumulator as a fraction of its leaf's largest magnitude)
ZOO_BF16 = ("qwen3-4b", "rwkv6-1.6b", "whisper-small")
ZOO_BF16_BATCH, ZOO_BF16_SEQ = 4, 32
BF16_TRAIN_TOL = {"loss": 0.0103, "update": 0.103, "accumulator": 0.203}


def _zoo_batches(cfg, n: int, batch: int, seq: int, seed: int = 0) -> list:
    """``n`` numpy batches: ``make_lm_batch`` tokens, and a vlm's patches
    or an encdec's frames from normal(0, 0.02), from one generator."""
    from repro_torch.data import make_lm_batch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = make_lm_batch(rng, batch, seq, cfg.vocab_size)
        if cfg.family == "vlm":
            b["patches"] = rng.normal(0, 0.02, (
                batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            b["frames"] = rng.normal(0, 0.02, (
                batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _on(batches, device) -> list:
    return [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
            for b in batches]


def _reset_carry(chunk):
    """A scan chunk (``rwkv._wkv_chunk``, ``mamba._scan_chunk``: the state
    is the last argument) that starts from a zero state."""
    def run(*args):
        return chunk(*args[:-1], torch.zeros_like(args[-1]))
    return run


def _without_aux(apply_moe):
    def run(*args, **kwargs):
        y, aux = apply_moe(*args, **kwargs)
        return y, aux * 0
    return run


def _over_patches(lm_loss):
    """``lm_loss`` over every position: label 0 and mask 1 at the patch
    positions before the text."""
    def run(logits, labels, mask):
        extra = logits.shape[1] - labels.shape[1]
        pad = torch.nn.functional.pad
        return lm_loss(logits, pad(labels, (extra, 0)),
                       pad(mask, (extra, 0), value=1.0))
    return run


def _detached_encoder(dec_block):
    def run(bp, cfg, x, enc_out, **kwargs):
        return dec_block(bp, cfg, x, enc_out.detach(), **kwargs)
    return run


@contextlib.contextmanager
def _zoo_fault(arch: str):
    """Within the block, the planted fault ``ZOO_FAULTS[arch]``."""
    from repro_torch.core import split_parallel
    from repro_torch.models import encdec

    with contextlib.ExitStack() as stack:
        if arch == "rwkv6-1.6b":
            stack.enter_context(_patched(rwkv, "_wkv_chunk", _reset_carry))
        elif arch == "jamba-1.5-large-398b":
            stack.enter_context(_patched(mamba, "_scan_chunk", _reset_carry))
        elif arch == "qwen3-moe-30b-a3b":
            stack.enter_context(_patched(transformer, "apply_moe",
                                         _without_aux))
        elif arch == "internvl2-26b":
            stack.enter_context(_patched(split_parallel, "_text_logits",
                                         lambda f: lambda api, x: x))
            stack.enter_context(_patched(split_parallel, "lm_loss",
                                         _over_patches))
        else:
            stack.enter_context(_patched(encdec, "_dec_block",
                                         _detached_encoder))
        yield


def _zoo_card_vs_cpu(arch: str) -> None:
    """13a for one family (the module docstring)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.model import build_model
    from repro_torch.sharding.spec import values_tree
    from repro_torch.tree import tree_map

    run = RunConfig(arch=arch, strategy="split_concurrent",
                    learning_rate=ZOO_SMOKE_LR, compute_dtype="float32",
                    seed=0)
    cfg = dataclasses.replace(get_smoke_config(arch), tie_embeddings=False)
    api = build_model(cfg, compute_dtype=torch.float32, remat=run.remat)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(run.seed)
    params = values_tree(api.init(gen))
    host = tree_map(lambda x: x.cpu(), params)
    batches = _zoo_batches(cfg, ZOO_SMOKE_STEPS, ZOO_SMOKE_BATCH,
                           ZOO_SMOKE_SEQ, run.seed)
    t0 = time.perf_counter()
    cpu_losses, cpu_states = _split_concurrent_run(api, run, host,
                                                   _on(batches, "cpu"))
    cpu_s = time.perf_counter() - t0
    results = {}
    for name in ("card", "planted"):
        with (_zoo_fault(arch) if name == "planted"
              else contextlib.nullcontext()):
            losses_c, states_c = _split_concurrent_run(
                api, run, params, _on(batches, "cuda"))
        ok_state, gap_state = _state_gap(states_c[1], cpu_states[1])
        ok_update, gap_update = _update_gap(
            states_c, cpu_states, zero=ZERO_GRAD.get(arch, ()),
            spacing=True)
        ok_loss = _within(losses_c.cpu(), cpu_losses, **TRAIN_TOL)
        results[name] = (ok_state and ok_update and ok_loss,
                         max(gap_state, _max_err(losses_c.cpu(), cpu_losses)),
                         gap_update)
        del states_c
    check(results["card"][0], f"train zoo: {arch} (smoke, S "
          f"{ZOO_SMOKE_SEQ}) {ZOO_SMOKE_STEPS} split_concurrent steps on the "
          f"card within {TRAIN_TOL} of the host CPU's, every loss and state "
          f"leaf, every update within 1e-3 of its scale: max gap "
          f"{results['card'][1]}, update gap {results['card'][2]}")
    check(not results["planted"][0], f"train zoo: {arch}'s planted fault "
          f"({ZOO_FAULTS[arch]}) fails the card-vs-CPU check: max gap only "
          f"{results['planted'][1]}, update gap {results['planted'][2]}")
    say("13a train zoo card vs cpu", arch=arch, family=cfg.family,
        layers=cfg.num_layers, d_model=cfg.d_model, batch=ZOO_SMOKE_BATCH,
        seq=ZOO_SMOKE_SEQ, steps=ZOO_SMOKE_STEPS, lr=ZOO_SMOKE_LR,
        losses_cpu=",".join(f"{float(x):.6f}" for x in cpu_losses),
        max_gap_vs_cpu=f"{results['card'][1]:.3g}",
        update_gap_of_scale=f"{results['card'][2]:.3g}",
        tol=f"atol={TRAIN_TOL['atol']},rtol={TRAIN_TOL['rtol']}",
        planted_fault=ZOO_FAULTS[arch],
        planted_max_gap_vs_cpu=f"{results['planted'][1]:.3g}",
        planted_update_gap_of_scale=f"{results['planted'][2]:.3g}",
        cpu_run_s=f"{cpu_s:.3f}")


def _k2_launches_a_step(*trees) -> int:
    """What ``adagrad_update_leaves`` launches for an update of each tree
    (gradients in the params' dtypes): one launch per (p, g) dtype pair
    per ``MAX_LEAVES`` non-empty leaves."""
    total = 0
    for tree in trees:
        pairs: dict = {}
        for p in tree_leaves(tree):
            if p.numel():
                pairs[p.dtype] = pairs.get(p.dtype, 0) + 1
        total += sum(-(-n // MAX_LEAVES) for n in pairs.values())
    return total


def _traced_device_split(fn, kernels: bool = True) -> tuple:
    """One call of ``fn`` traced (CUDA activity only): the device ms of its
    kernels split into the repository's kernels, matrix products and the
    rest, and the kernels it ran (with ``kernels``, both a product and one
    of the repository's kernels must be among them).  The trace's events are read as the
    profiler keeps them (``kineto_results``), not parsed into its
    ``FunctionEvent`` objects, which for a step of ~10^5 kernels (the
    recurrent families' step loops) would take minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {"repo_kernels": 0.0, "matmul": 0.0, "other": 0.0}
    others: dict = {}
    n = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        name, ms = e.name(), e.duration_ns() / 1e6
        part = _part(name)
        split[part] += ms
        n += 1
        if part == "other":
            label = _kernel_label(name)
            others[label] = others.get(label, 0.0) + ms
    check(split["matmul"] > 0 and (split["repo_kernels"] > 0 or not kernels),
          f"the profiler traced the step's matrix products and K2: {split}")
    return split, others, n


def _zoo_full(arch: str, changes: dict, reduced: str, batch: int, seq: int,
              lr: float, steps: int, beta: float = 1.0) -> int:
    """13b for one family (the module docstring), with AdaGrad's ``lr``
    and ``beta`` for ``steps`` steps; returns K2's launches."""
    from repro_torch.configs import get_arch_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.split_parallel import (init_prev_features,
                                                 make_train_step,
                                                 merge_params, split_params)
    from repro_torch.kernels.adagrad import ops as k2_ops
    from repro_torch.models.model import build_model, count_params_analytic
    from repro_torch.optim import get_optimizer
    from repro_torch.sharding.spec import values_tree

    run = RunConfig(arch=arch, strategy="split_concurrent", learning_rate=lr,
                    adagrad_beta=beta, compute_dtype="float32", seed=0)
    cfg = dataclasses.replace(get_arch_config(arch), tie_embeddings=False,
                              **changes)
    api = build_model(cfg, compute_dtype=torch.float32, remat=run.remat)
    opt = get_optimizer("adagrad", lr, adagrad_beta=run.adagrad_beta,
                        weight_decay=run.weight_decay, use_kernel=True)
    init, step = make_train_step(api, opt, strategy=run.strategy,
                                 head_sync_period=run.head_sync_period)
    batches = _on(_zoo_batches(cfg, steps + 1, batch, seq, run.seed),
                  "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(run.seed)
    gc.collect()
    torch.cuda.empty_cache()
    state = init_prev_features(init(params=values_tree(api.init(gen))), api,
                               batches[0], dtype=torch.float32)
    n_params = sum(x.numel() for x in tree_leaves(
        merge_params(state.params, state.head)))
    check(n_params == count_params_analytic(cfg),
          f"train zoo: {arch} has {n_params} params (analytic: "
          f"{count_params_analytic(cfg)})")
    per_step = _k2_launches_a_step(state.params, state.head)
    del state

    def state0():
        gen.manual_seed(run.seed)
        return init_prev_features(init(params=values_tree(api.init(gen))),
                                  api, batches[0], dtype=torch.float32)

    def first_launch(_):        # the first launch, checked and let go
        first_leaves.append(_k2_rerun(k2_calls[0], "first"))
        k2_calls[0] = None

    # the eager step at the row's config, twice from one state: the bar
    # of the captured-vs-eager check, the eager step's ms and its trace
    cut = GRAPH_CMP_CUT.get(arch)
    twice = None if cut else _eager_twice(step, state0(), batches[0])
    bar = twice["bar"] if twice else None
    first_leaves = []
    with contextlib.ExitStack() as stack:
        k2_calls = stack.enter_context(_recording(k2_ops, "_update"))
        stray = [stack.enter_context(_recording(module, attr, every=True))
                 for module, attr in ((layers, "flash_attention"),
                                      (rwkv, "wkv"), (mamba, "mamba_scan"))]
        gc.collect()
        torch.cuda.empty_cache()
        state = state0()
        _zero_counts()
        t0 = time.perf_counter()
        runner = StepGraph(step, state)
        del state
        captured = _run_steps(runner, batches[:steps], first=first_launch,
                              keep_at=GRAPH_CMP_STEPS,
                              host=bar is not BITWISE and not cut)
        wall = time.perf_counter() - t0
        counts = {w.__name__: w.launches for w in WRAPPERS}
    last_leaves = _k2_rerun(k2_calls[-1], "last")
    del k2_calls
    launches = counts["adagrad_update_leaves"]
    backbone, head = split_params(values_tree(api.init(None)))
    n_leaves = (len(tree_leaves(backbone)), len(tree_leaves(head)))
    check(launches == per_step * steps and counts["adagrad_update"] == 0
          and runner.per_replay == {adagrad_update_leaves: per_step},
          f"train zoo: {arch}: K2 launched {per_step} times a step, all "
          f"inside the graph (backbone and head trees of {n_leaves} f32 "
          f"leaves): {launches} in {steps} steps, {counts}, "
          f"{runner.per_replay} a replay")
    check((first_leaves[0], last_leaves) == n_leaves,
          f"train zoo: {arch}: the first and last K2 launches took "
          f"{first_leaves[0]} and {last_leaves} leaves, the trees "
          f"{n_leaves}")
    check(not any(stray) and all(
        counts[w.__name__] == 0 for w in (flash_attention, wkv, mamba_scan,
                                          server_step_update)),
          f"train zoo: {arch}: no call of K3, K4 or K5: "
          f"{[len(c) for c in stray]} calls, {counts}")
    del stray
    losses = [float(x) for x in captured["losses"]]
    first3, last3 = np.mean(losses[:3]), np.mean(losses[-3:])
    step_ms = 1e3 * statistics.median(captured["secs"][ZOO_FULL_WARM:])
    leaves = tree_leaves(merge_params(runner.new.params, runner.new.head))
    k2_bound, _ = _k2_bound(leaves, leaves)
    del leaves
    b = batches[steps]
    split, others, n_kernels = _traced_device_split(lambda: runner(b))
    device_ms = sum(split.values())
    numbers = _capture_numbers(runner)
    del runner
    gc.collect()
    torch.cuda.empty_cache()

    # the first GRAPH_CMP_STEPS steps held to an eager loop, and the
    # planted graph faults (at the depth GRAPH_CMP_CUT gives, if any)
    cmp_cfg, cmp_step, cmp_state0, cmp_bar = cfg, step, state0, bar
    if cut:      # state0 reads api and init when called: the cut's state
        del api, opt, init, step
        cmp_cfg = dataclasses.replace(cfg, **cut)
        api = build_model(cmp_cfg, compute_dtype=torch.float32,
                          remat=run.remat)
        opt = get_optimizer("adagrad", lr, adagrad_beta=run.adagrad_beta,
                            weight_decay=run.weight_decay, use_kernel=True)
        init, cmp_step = make_train_step(
            api, opt, strategy=run.strategy,
            head_sync_period=run.head_sync_period)
        cmp_bar = _eager_twice(cmp_step, cmp_state0(), batches[0])["bar"]
        twice = dict(ms=1e3 * captured["secs"][0],
                     peak_gb=captured["first_peak_gb"],
                     reserved_gb=captured["first_reserved_gb"], split=split)
    eager_dev = sum(twice["split"].values())
    gap, planted = _graph_held(
        f"train zoo: {arch} at {cmp_cfg.num_layers} layers", cmp_step,
        cmp_state0, batches, cmp_bar, run.head_sync_period,
        None if cut else captured)
    tokens = batch * seq
    top = sorted(others.items(), key=lambda kv: -kv[1])[:5]
    say("13b train zoo", arch=arch, family=cfg.family, params=n_params,
        layers=cfg.num_layers, d_model=cfg.d_model, vocab=cfg.padded_vocab,
        untied="yes", reduced=reduced, strategy=run.strategy, batch=batch,
        seq=seq, positions=seq + (cfg.num_patches if cfg.family == "vlm"
                                  else 0),
        frames=cfg.encoder_seq_len if cfg.family == "encdec" else 0,
        steps=steps, lr=lr, beta=run.adagrad_beta,
        losses=",".join(f"{x:.4f}" for x in losses),
        loss_first3=f"{first3:.6f}", loss_last3=f"{last3:.6f}",
        adagrad_launches=launches, adagrad_launches_a_step=per_step,
        backbone_leaves=n_leaves[0], head_leaves=n_leaves[1],
        k2_first_last_vs_plain="bitwise", k3_k4_k5_calls=0,
        step_ms_median=f"{step_ms:.3f}",
        step_ms=",".join(f"{1e3 * x:.3f}" for x in captured["secs"]),
        tok_s=f"{tokens / step_ms * 1e3:.1f}",
        eager_tok_s=f"{tokens / twice['ms'] * 1e3:.1f}",
        wall_s=f"{wall:.3f}",
        **_graph_fields(captured, twice, numbers, cmp_bar, gap),
        eager_run_to_run_at_row=("not_measured" if bar is None else
                                 "bitwise" if bar is BITWISE
                                 else "not_bitwise"),
        graph_vs_eager_steps=GRAPH_CMP_STEPS,
        graph_vs_eager_layers=cmp_cfg.num_layers,
        traced_kernels=n_kernels, step_device_ms=f"{device_ms:.3f}",
        step_idle_share=f"{1 - device_ms / step_ms:.3f}",
        eager_device_ms=f"{eager_dev:.3f}",
        eager_device_ms_of="the_replay" if cut else "an_eager_step",
        eager_idle_share=f"{1 - eager_dev / twice['ms']:.3f}",
        **{f"step_{part}_ms": f"{ms:.3f}" for part, ms in split.items()},
        k2_bound_ms_a_step=f"{k2_bound:.3f}",
        **{f"planted_{k_}_gap": f"{v:.3g}" for k_, v in planted.items()},
        step_other_top5=";".join(f"{name}:{ms:.3f}" for name, ms in top))
    check(all(np.isfinite(losses)) and last3 < first3,
          f"train zoo: {arch}: finite losses whose mean over the last 3 "
          f"steps ({last3}) is below the first 3's ({first3}): {losses}")
    del batches, b, api, opt, init, cmp_step, cmp_state0
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _bf16_gaps(got, want, zero=()) -> dict:
    """``got``, ``want``: (initial state, state after one step, metrics).
    The gaps ``BF16_TRAIN_TOL`` bounds (the ``zero`` leaves left out)."""
    from repro_torch.models.model import _paths

    gaps = {"loss": abs(float(got[2]["loss"]) - float(want[2]["loss"]))}
    for key, field in (("update", "params"), ("accumulator", "opt_state")):
        leaves, tdef = tree_flatten(getattr(got[0], field))
        worst = 0.0
        for path, g0, g1, w0, w1 in zip(_paths(tdef), leaves, *(
                tree_leaves(getattr(s, field))
                for s in (got[1], want[0], want[1]))):
            if path.rsplit("/", 1)[-1] in zero:
                continue
            dg, dw = (g1 - g0).cpu(), (w1 - w0).cpu()
            if key == "accumulator":
                dg, dw = g1.cpu(), w1.cpu()
            scale = float(dw.abs().max())
            if scale:
                worst = max(worst, _max_err(dg, dw) / scale)
        gaps[key] = worst
    return gaps


def _zoo_bf16_card_vs_cpu(arch: str) -> dict:
    """13c: one bf16 ``dp_full`` step of a smoke config on the card and on
    the host CPU from one init; returns the gaps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.split_parallel import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim import get_optimizer
    from repro_torch.sharding.spec import values_tree
    from repro_torch.tree import tree_map

    cfg = get_smoke_config(arch)
    api = build_model(cfg, compute_dtype=torch.bfloat16)
    init, step = make_train_step(
        api, get_optimizer("adagrad", ZOO_SMOKE_LR, use_kernel=True),
        strategy="dp_full")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = values_tree(api.init(gen))
    batch = _zoo_batches(cfg, 1, ZOO_BF16_BATCH, ZOO_BF16_SEQ)
    out = {}
    for dev, p in (("cpu", tree_map(lambda x: x.cpu(), params)),
                   ("cuda", params)):
        s0 = init(params=p)
        s1, m = step(s0, _on(batch, dev)[0])
        out[dev] = (s0, s1, m)
    gaps = _bf16_gaps(out["cuda"], out["cpu"], ZERO_GRAD.get(arch, ()))
    check(all(gaps[k] <= BF16_TRAIN_TOL[k] for k in gaps),
          f"train zoo bf16: {arch} one dp_full step on the card within "
          f"{BF16_TRAIN_TOL} of the host CPU's: {gaps}")
    return gaps


def phase_train_zoo() -> int:
    """Phase 13 (the module docstring): returns K2's launches on the paths
    (runs b and c)."""
    from repro_torch.configs import get_arch_config
    from repro_torch.configs.base import RunConfig

    # a. the card against the host CPU at smoke widths
    for arch in ZOO_FAULTS:
        _zoo_card_vs_cpu(arch)
        gc.collect()
        torch.cuda.empty_cache()

    # b. every published width, one family at a time
    launches = sum(_zoo_full(*row) for row in ZOO_FULL)

    # c. bf16: qwen1.5-0.5b through train_loop, then the card against the
    # host CPU
    run = RunConfig(arch=TRAIN_ARCH, strategy="split_concurrent",
                    learning_rate=TRAIN_LR, compute_dtype="bfloat16", seed=0)
    held = _held_train_loop(get_arch_config(TRAIN_ARCH), run,
                            steps=TRAIN_STEPS)
    losses, counts = held["losses"], held["counts"]
    state = held["eager_run"].state
    bf16_launches = counts["adagrad_update_leaves"]
    check(bf16_launches == 2 * TRAIN_STEPS and sum(counts.values())
          == bf16_launches and held["per_replay"] == {
              adagrad_update_leaves: 2},
          f"train zoo bf16: K2 launched twice a step, inside the graph, and "
          f"no other kernel: {counts}, {held['per_replay']} a replay")
    check(all(x.dtype == torch.float32 for x in tree_leaves(
        (state.params, state.head, state.opt_state, state.head_opt_state)))
          and state.prev_features.dtype == torch.bfloat16,
          "train zoo bf16: params, head and accumulators f32, the replayed "
          "features bf16")
    first5, last5 = np.mean(losses[:5]), np.mean(losses[-5:])
    check(all(np.isfinite(losses)) and last5 < first5,
          f"train zoo bf16: mean loss of the last 5 steps ({last5}) below "
          f"the first 5 ({first5}): {losses}")
    step_ms = 1e3 * statistics.median(held["captured"]["secs"][TRAIN_WARM:])
    graph_dev = sum(held["graph_split"].values())
    fields = held["fields"]
    planted = held["planted"]
    del state, held
    gc.collect()
    torch.cuda.empty_cache()
    gaps = {arch: _zoo_bf16_card_vs_cpu(arch) for arch in ZOO_BF16}
    say("13c train zoo bf16", arch=TRAIN_ARCH, compute_dtype="bfloat16",
        params_dtype="float32", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=TRAIN_STEPS, lr=TRAIN_LR, loss_first5=f"{first5:.6f}",
        loss_last5=f"{last5:.6f}",
        losses=",".join(f"{x:.4f}" for x in losses),
        adagrad_launches=bf16_launches, step_ms_median=f"{step_ms:.3f}",
        tok_s=f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.1f}",
        captured_device_ms=f"{graph_dev:.3f}",
        captured_idle_share=f"{1 - graph_dev / step_ms:.3f}", **fields,
        **{f"planted_{k}_gap": f"{v:.3g}" for k, v in planted.items()},
        **{f"card_vs_cpu_{arch}_{k}": f"{v:.3g}"
           for arch, g in gaps.items() for k, v in g.items()},
        card_vs_cpu_bars=",".join(f"{k}={v}"
                                  for k, v in BF16_TRAIN_TOL.items()))
    return launches + bf16_launches


# --- 14. the sharded paths on a 1x1 mesh over NCCL ---------------------------

#: 14a: split_concurrent steps of qwen1.5-0.5b, sharded and not: as many as
#: the planted graph faults take to show (the stale-head refresh, K = 4,
#: falls at the fourth)
SHARD_TRAIN_STEPS = GRAPH_CMP_STEPS
#: 14c: the qwen3-moe-30b-a3b cut (every width, 4 layers as in 13b), its
#: prompt and new tokens; 14d serves rwkv6-1.6b whole at the same lengths
SHARD_MOE_CUT = dict(num_layers=4)
SHARD_PROMPT, SHARD_GEN = 64, 4


def _whole_state(state):
    """A TrainState's DTensor leaves gathered whole (plain tensors pass)."""
    from repro_torch.core.split_parallel import TrainState
    from repro_torch.launch.train import _whole
    from repro_torch.tree import tree_map
    return TrainState(**{k: tree_map(_whole, v)
                         for k, v in vars(state).items()})


def _local_state(state):
    """A TrainState's DTensor leaves as their local shards (views)."""
    from repro_torch.core.split_parallel import TrainState
    from repro_torch.tree import tree_map
    return TrainState(**{k: tree_map(graphs.local, v)
                         for k, v in vars(state).items()})


def _greedy(prefill, decode, params, prompts, gen: int, vocab: int):
    """Prefill (cache for prompt + ``gen``) and ``gen`` greedy decode
    steps: (each call's last-position logits (B, V) on the host, the
    tokens fed, each decode call's seconds (``_synced``), the last
    cache)."""
    from repro_torch.launch.train import _whole
    s = prompts.shape[1]
    logits, cache = prefill(params, {"tokens": prompts}, cache_len=s + gen)
    out, toks, secs = [_whole(logits)[:, -1, :vocab].cpu()], [], []
    for i in range(gen):
        tok = out[-1].argmax(-1)[:, None].to(torch.int32).cuda()
        toks.append(tok.cpu())
        (logits, cache), took = _synced(decode, params, cache, tok, s + i)
        secs.append(took)
        out.append(_whole(logits)[:, -1, :vocab].cpu())
    return out, toks, secs, cache


class _CountingCapture(graphs.Capture):
    """``graphs.Capture`` that also counts the collective calls its
    capture records (``launch.hlo_analysis.CollectiveCalls``):
    ``collectives``, by kind.  On one rank a collective may launch no
    kernel to see in a trace, so the calls are counted where they are
    made."""

    collectives = None

    def record(self, body):
        from repro_torch.launch.hlo_analysis import CollectiveCalls
        with CollectiveCalls() as calls:
            captured = super().record(body)
        self.collectives = dict(calls.calls)
        return captured


@contextlib.contextmanager
def _counting_captures():
    """Within the block, both graph runners capture with
    :class:`_CountingCapture`."""
    from repro_torch.launch.serve import DecodeGraph
    with _patched(StepGraph, "capture_type", lambda _: _CountingCapture), \
            _patched(DecodeGraph, "capture_type",
                     lambda _: _CountingCapture):
        yield


def _unsharded_graph_decode(api):
    """``api.decode_step`` through a ``DecodeGraph`` made at the first
    call, called as a decode step is."""
    from repro_torch.launch.serve import DecodeGraph
    held = []

    def decode(params, cache, tok, index):
        if not held:
            held.append(DecodeGraph(api, params, cache, tok.shape[0]))
        return held[0].step(tok, index), cache
    return decode


class _TimedGraphs:
    """Within the block, every ``StepGraph`` that ``owner`` (a module)
    makes keeps each call's seconds (``secs``) and its last inputs, and
    the last one made is ``runner``."""

    def __init__(self, owner):
        self.owner, self.secs, self.runner, self.inputs = owner, [], None, None

    def __enter__(self):
        timed = self
        self.base = self.owner.StepGraph

        class Timed(self.base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                timed.runner = self

            def __call__(self, inputs):
                timed.inputs = inputs
                out, took = _synced(super().__call__, inputs)
                timed.secs.append(took)
                return out

        self.owner.StepGraph = Timed
        return self

    def __exit__(self, *exc):
        self.owner.StepGraph = self.base


class _EagerLowered:
    """``StepBundle.lower`` patched out for the eager mesh loop: the
    bundle's own call, each one timed, the first call's state and batch
    kept."""

    def __init__(self, bundle, secs: list, first: list):
        self.bundle, self.secs, self.first = bundle, secs, first

    def __call__(self, state, batch):
        if not self.first:
            self.first.extend([state, batch])
        out, took = _synced(self.bundle, state, batch)
        self.secs.append(took)
        return out


def _shard_train(mesh) -> int:
    """14a (the module docstring); returns K2's launches."""
    import torch.distributed as dist
    from repro_torch.configs import RunConfig, get_arch_config
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train

    run = RunConfig(arch=TRAIN_ARCH, strategy="split_concurrent",
                    learning_rate=TRAIN_LR, compute_dtype="float32", seed=0)
    cfg = get_arch_config(TRAIN_ARCH)
    kw = dict(steps=SHARD_TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
              device="cuda", log_every=SHARD_TRAIN_STEPS)
    with _TimedGraphs(train) as plain:
        want_losses, want = train.train_loop(cfg, run, **kw)
    plain.runner = plain.inputs = None
    gc.collect()
    torch.cuda.empty_cache()

    # the eager mesh loop of the bundle, then its first step twice from
    # the same init: the bar the captured run is held to, measured first
    secs, first = [], []
    torch.cuda.reset_peak_memory_stats()
    with _patched(steps_mod.StepBundle, "lower",
                  lambda _: lambda self: _EagerLowered(
                      self, secs, first)):
        eager_losses, eager = train.train_loop(cfg, run, mesh=mesh, **kw)
    eager_peaks = (torch.cuda.max_memory_allocated() / 1e9,
                   torch.cuda.max_memory_reserved() / 1e9)
    bundle = steps_mod.build_train_step(cfg, run, _train_shape(), mesh)
    twice = _eager_twice(lambda st, bt: _local_pair(bundle(st, bt)), *first)
    bar = twice["bar"]
    del first[:], bundle
    eager_digest = _digest(_local_state(eager))
    eager_whole = None if bar is BITWISE else _whole_state(eager)
    del eager
    gc.collect()
    torch.cuda.empty_cache()

    def held(losses_, state) -> tuple:
        """(the run's losses and final state at ``bar`` of the eager mesh
        loop's, the largest gap): by digest where the bar is bitwise."""
        l_ok, l_gap = _gap([torch.tensor(losses_)],
                           [torch.tensor(eager_losses)], bar)
        if bar is BITWISE:
            return (l_ok and torch.equal(_digest(_local_state(state)),
                                         eager_digest)), l_gap
        s_ok, s_gap = _state_gap(_whole_state(state), eager_whole)
        return l_ok and s_ok, max(l_gap, s_gap)

    # the captured mesh step: train_loop(mesh=) through bundle.lower()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with _TimedGraphs(steps_mod) as cap, _counting_captures():
        losses, got = train.train_loop(cfg, run, mesh=mesh, **kw)
        torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in WRAPPERS}
    peaks = (torch.cuda.max_memory_allocated() / 1e9,
             torch.cuda.max_memory_reserved() / 1e9)
    graph_ok, graph_gap = held(losses, got)
    ok, gap = _state_gap(_whole_state(got), want)
    loss_gap = max(abs(a - b) for a, b in zip(losses, want_losses))
    del got, want
    runner = cap.runner
    split, _, _ = _traced_device_split(lambda: runner(cap.inputs))
    numbers = _capture_numbers(runner)
    collectives = dict(runner.capture.collectives or {})
    del runner
    cap.runner = cap.inputs = None
    gc.collect()
    torch.cuda.empty_cache()
    check(graph_ok, f"14a: the captured mesh run's losses and state at "
          f"{bar} of the eager mesh loop's: gap {graph_gap}")
    check(ok and loss_gap <= TRAIN_TOL["atol"],
          f"14a: every loss and state leaf of the captured mesh run within "
          f"the f32 model bar of the unsharded one: loss gap {loss_gap}, "
          f"state gap {gap}")
    launches = counts["adagrad_update_leaves"]
    check(launches == 2 * SHARD_TRAIN_STEPS and all(
        counts[w.__name__] == 0 for w in (
            flash_attention, wkv, mamba_scan, server_step_update,
            adagrad_update))
          and numbers["per_replay"].get(adagrad_update_leaves) == 2,
          f"14a: K2 twice a step on the local shards, inside the graph "
          f"(counted a replay: {numbers['per_replay']}), and no other "
          f"kernel: {counts}")
    check(sum(collectives.values()) > 0,
          f"14a: the capture recorded the step's collectives: "
          f"{collectives}")

    planted = {}
    for name, ctx in (
            ("stale_batch", _patched(steps_mod, "StepGraph",
                                     lambda _: _StaleBatch)),
            ("frozen_refresh", _patched(steps_mod, "make_train_step",
                                        _refresh_frozen_in))):
        with ctx:
            f_losses, f_state = train.train_loop(cfg, run, mesh=mesh, **kw)
        f_ok, planted[name] = held(f_losses, f_state)
        del f_state
        gc.collect()
        torch.cuda.empty_cache()
        check(not f_ok, f"14a: the planted graph fault {name} fails the "
              f"check against the eager mesh loop: gap only "
              f"{planted[name]}")
    del eager_whole
    cap_ms = 1e3 * statistics.median(cap.secs[TRAIN_WARM:SHARD_TRAIN_STEPS])
    eager_ms = 1e3 * statistics.median(secs[TRAIN_WARM:])
    dev = sum(split.values())
    eager_dev = sum(twice["split"].values())
    say("14a shard-train", arch=TRAIN_ARCH, mesh="1x1",
        backend=dist.get_backend(), strategy=run.strategy,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=SHARD_TRAIN_STEPS,
        losses=",".join(f"{x:.6f}" for x in losses),
        max_loss_gap=loss_gap, max_state_gap=gap,
        adagrad_launches=launches,
        graph_launches_a_replay=",".join(
            f"{w.__name__}:{n}" for w, n in numbers["per_replay"].items()),
        captured_ms_median=f"{cap_ms:.3f}",
        eager_mesh_ms_median=f"{eager_ms:.3f}",
        unsharded_captured_ms_median=_ms_median(
            plain.secs[TRAIN_WARM:SHARD_TRAIN_STEPS]),
        first_step_ms=f"{1e3 * cap.secs[0]:.3f}",
        second_step_ms=f"{1e3 * cap.secs[1]:.3f}",
        device_ms=f"{dev:.3f}", idle_share=f"{1 - dev / cap_ms:.3f}",
        eager_device_ms=f"{eager_dev:.3f}",
        eager_idle_share=f"{1 - eager_dev / eager_ms:.3f}",
        peak_gb=f"{peaks[0]:.2f}", reserved_gb=f"{peaks[1]:.2f}",
        eager_peak_gb=f"{eager_peaks[0]:.2f}",
        eager_reserved_gb=f"{eager_peaks[1]:.2f}",
        capture_s=f"{numbers['capture_s']:.3f}",
        instantiate_s=f"{numbers['instantiate_s']:.3f}",
        capture_collectives=",".join(f"{k}:{v}" for k, v in
                                     sorted(collectives.items())),
        graph_vs_eager_bar="bitwise" if bar is BITWISE else "TRAIN_TOL",
        graph_vs_eager_max_gap=f"{graph_gap:.3g}",
        **{f"planted_{k}_gap": f"{v:.3g}" for k, v in planted.items()})
    return launches


def _train_shape():
    from repro_torch.configs import InputShape
    return InputShape("custom", TRAIN_SEQ, TRAIN_BATCH, "train")


def _local_pair(out):
    """A mesh step's ``(new state, metrics)`` with every DTensor as its
    local shard."""
    new, metrics = out
    return _local_state(new), {k: graphs.local(v)
                               for k, v in metrics.items()}


def _shard_serve(phase: str, cfg, mesh, *, wrapper, launches: int,
                 stale_index: bool, in_decode: bool,
                 moe: bool = False) -> int:
    """14c/14d (the module docstring) for ``cfg`` under ``fsdp_tp``:
    ``wrapper``, the kernel on the path, must launch ``launches`` times in
    the captured run (prefill and decode), and with ``in_decode`` in each
    traced decode step.  Returns them."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import InputShape, RunConfig
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step)
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import build_model
    from repro_torch.sharding.spec import values_tree

    arch = cfg.name
    tol = SERVE_TOL[arch]
    vocab = cfg.vocab_size
    api = build_model(cfg, compute_dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = values_tree(api.init(gen))
    n_params = sum(x.numel() for x in tree_leaves(params))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, vocab, (SERVE_BATCH, SHARD_PROMPT))).to("cuda", torch.int32)
    # the plain unsharded decode, the reference; then the unsharded
    # DecodeGraph, timed alone (phases 6-12 hold it to the plain decode)
    with torch.inference_mode():
        want_l, want_t, want_secs, _ = _greedy(
            api.prefill, api.decode_step, params, prompts, SHARD_GEN, vocab)
        _, _, plain_graph_secs, _ = _greedy(
            api.prefill, _unsharded_graph_decode(api), params, prompts,
            SHARD_GEN, vocab)
    gc.collect()
    srun = RunConfig(arch=arch, strategy="fsdp_tp", compute_dtype="float32")
    pre = build_prefill_step(cfg, srun, InputShape(
        "p", SHARD_PROMPT, SERVE_BATCH, "prefill"), mesh)
    dec = build_decode_step(cfg, srun, InputShape(
        "d", SHARD_PROMPT + SHARD_GEN, SERVE_BATCH, "decode"), mesh)
    layout = ("replicated_batch" if dec.rules["batch"] is None
              else "batch_sharded")
    pre_p, = pre.place(params)            # placed once for every call
    dec_p, = dec.place(params)
    sharded_moe, made = [], {}

    def counting(orig):
        def run_(*a, **k):
            sharded_moe.append(1)
            return orig(*a, **k)
        return run_

    def prefill(p, b, **k):
        logits, cache = pre(pre_p, b, **k)
        made.update({key: (tuple(v.placements), tuple(v.to_local().shape),
                           tuple(v.shape)) for key, v in cache.items()})
        return logits, cache

    def eager_decode(p, c, t, i):
        return dec(dec_p, c, t, i)

    # the eager mesh loop, twice: its run-to-run bar
    # no_grad: DTensor's ops cannot run on inference-mode tensors
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        with _patched(moe_mod, "_apply_moe_sharded", counting):
            eager_l, eager_t, eager_secs, eager_cache = _greedy(
                prefill, eager_decode, None, prompts, SHARD_GEN, vocab)
        eager_peaks = (torch.cuda.max_memory_allocated() / 1e9,
                       torch.cuda.max_memory_reserved() / 1e9)
        eager_split, _, _ = _traced_device_split(
            lambda: eager_decode(None, eager_cache, eager_t[-1].cuda(),
                                 SHARD_PROMPT + SHARD_GEN - 1),
            kernels=in_decode)
        del eager_cache
        again_l, again_t, _, _ = _greedy(prefill, eager_decode, None,
                                         prompts, SHARD_GEN, vocab)
        bar = (BITWISE if all(torch.equal(a, b) for a, b in
                              zip(eager_l, again_l)) else tol)
        del again_l, again_t

        # the captured mesh decode: the bundles' lower()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pre_run, dec_run = pre.lower(), dec.lower()
        _zero_counts()
        with _counting_captures():
            got_l, got_t, got_secs, got_cache = _greedy(
                lambda p, b, **k: pre_run(pre_p, b, **k),
                lambda p, c, t, i: dec_run(dec_p, c, t, i), None, prompts,
                SHARD_GEN, vocab)
        counts = {w.__name__: w.launches for w in WRAPPERS}
        peaks = (torch.cuda.max_memory_allocated() / 1e9,
                 torch.cuda.max_memory_reserved() / 1e9)
        graph = dec_run.graph
        split, _, _ = _traced_device_split(
            lambda: dec_run(dec_p, got_cache, got_t[-1].cuda(),
                            SHARD_PROMPT + SHARD_GEN - 1), kernels=in_decode)
        per_replay = {w.__name__: n for w, n in graph.per_replay.items()}
        collectives = dict(graph.capture.collectives or {})
        numbers = dict(capture_s=graph.capture.capture_s,
                       instantiate_s=graph.capture.instantiate_s)
        del got_cache, graph, dec_run, pre_run
        gc.collect()
        torch.cuda.empty_cache()

        planted_gap = None
        if stale_index:
            with _patched(steps_mod, "DecodeGraph",
                          lambda _: _stale_index()):
                bad_run = dec.lower()
                bad_l, bad_t, _, _ = _greedy(
                    prefill, lambda p, c, t, i: bad_run(dec_p, c, t, i),
                    None, prompts, SHARD_GEN, vocab)
            bad_ok, planted_gap = _gap(bad_l, eager_l, bar)
            check(not (bad_ok and all(torch.equal(a, b)
                                      for a, b in zip(bad_t, eager_t))),
                  f"{phase}: a runner that never updates its index buffer "
                  f"fails the check against the eager mesh loop: gap only "
                  f"{planted_gap}")
            del bad_run, bad_l, bad_t
            gc.collect()
            torch.cuda.empty_cache()

    check(all(torch.equal(a, b) for a, b in zip(got_t, eager_t)),
          f"{phase}: the captured mesh decode's tokens equal the eager mesh "
          f"loop's")
    graph_ok, graph_gap = _gap(got_l, eager_l, bar)
    check(graph_ok, f"{phase}: the captured mesh decode's logits at {bar} "
          f"of the eager mesh loop's: gap {graph_gap}")
    gap = max(_max_err(a, b) for a, b in zip(got_l, want_l))
    check(all(_within(a, b, **tol) for a, b in zip(got_l, want_l))
          and all(torch.equal(a, b) for a, b in zip(got_t, want_t)),
          f"{phase}: the sharded prefill and captured decode within {tol} "
          f"of the plain unsharded prefill and decode, the same tokens: gap "
          f"{gap}")
    got = counts[wrapper.__name__]
    check(got == launches,
          f"{phase}: {wrapper.__name__} launched {launches} times on the "
          f"local shards (the decode's counted a replay: {per_replay}), got "
          f"{got}")
    check(sum(collectives.values()) > 0,
          f"{phase}: the capture recorded the step's collectives: "
          f"{collectives}")
    fields = {}
    if moe:
        batch_over_data = (Shard(1), Replicate())
        want_pl = {"k": batch_over_data, "v": batch_over_data,
                   "pos": (Replicate(), Replicate())}
        check({k: pl for k, (pl, _, _) in made.items()} == want_pl
              and all(loc == whole for _, loc, whole in made.values()),
              f"{phase}: the prefill's cache placed as the JAX prefill's "
              f"compile places it (k and v: the batch over data; pos "
              f"replicated), each local shard whole on one rank: {made}")
        n_moe = cfg.num_layers * (1 + SHARD_GEN)
        check(len(sharded_moe) == n_moe,
              f"{phase}: the expert-parallel MoE in every layer of every "
              f"eager step ({len(sharded_moe)} of {n_moe})")
        fields = dict(experts=cfg.moe.num_experts,
                      sharded_moe_calls=len(sharded_moe),
                      prefill_cache_placements=";".join(
                          f"{k}={','.join(map(str, pl))}"
                          for k, (pl, _, _) in sorted(made.items())
                      ).replace(" ", ""))
    cap_ms = 1e3 * statistics.median(got_secs[1:])
    eager_ms = 1e3 * statistics.median(eager_secs[1:])
    dev, eager_dev = sum(split.values()), sum(eager_split.values())
    say(phase, arch=arch, layers=cfg.num_layers, d_model=cfg.d_model,
        params=n_params, mesh="1x1", backend=dist.get_backend(),
        rules="fsdp_tp", decode_layout=layout, batch=SERVE_BATCH,
        prompt=SHARD_PROMPT, gen=SHARD_GEN, **fields,
        **{f"{wrapper.__name__}_launches": got},
        graph_launches_a_replay=",".join(
            f"{n}:{c}" for n, c in sorted(per_replay.items())) or "none",
        captured_ms_median=f"{cap_ms:.3f}",
        eager_mesh_ms_median=f"{eager_ms:.3f}",
        unsharded_captured_ms_median=_ms_median(plain_graph_secs[1:]),
        unsharded_eager_ms_median=_ms_median(want_secs[1:]),
        first_step_ms=f"{1e3 * got_secs[0]:.3f}",
        device_ms=f"{dev:.3f}", idle_share=f"{1 - dev / cap_ms:.3f}",
        eager_device_ms=f"{eager_dev:.3f}",
        eager_idle_share=f"{1 - eager_dev / eager_ms:.3f}",
        peak_gb=f"{peaks[0]:.2f}", reserved_gb=f"{peaks[1]:.2f}",
        eager_peak_gb=f"{eager_peaks[0]:.2f}",
        eager_reserved_gb=f"{eager_peaks[1]:.2f}",
        capture_s=f"{numbers['capture_s']:.3f}",
        instantiate_s=f"{numbers['instantiate_s']:.3f}",
        capture_collectives=",".join(f"{k}:{v}" for k, v in
                                     sorted(collectives.items())),
        graph_vs_eager_bar=("bitwise" if bar is BITWISE
                            else f"atol={bar['atol']},rtol={bar['rtol']}"),
        graph_vs_eager_max_gap=f"{graph_gap:.3g}", tokens_equal="yes",
        max_logit_gap_vs_unsharded=f"{gap:.3g}",
        stale_index_gap=("n/a" if planted_gap is None
                         else f"{planted_gap:.3g}"))
    del params, pre_p, dec_p, api
    gc.collect()
    torch.cuda.empty_cache()
    return got


def phase_sharded() -> dict:
    """Phase 14: the sharding layer's paths on a 1x1 mesh (one card holds
    one NCCL rank), each against its unsharded run on the card; the steps
    on the mesh through ``StepBundle.lower()``, replayed as CUDA graphs.
    Returns the launches of K2, K1, K3 and K5 on them."""
    import torch.distributed as dist
    from datetime import timedelta

    from repro_torch.configs import get_arch_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import adagrad
    from repro_torch.tree import tree_map

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, timeout=timedelta(seconds=300))
        try:
            mesh = make_local_mesh(1, 1, device="cuda")

            # a. train_loop on the mesh, captured, against its eager loop
            # and train_loop without a mesh
            out["adagrad"] = _shard_train(mesh)

            # b. FusedServerStep row-sharded over the data axis, at FIG4
            opt = adagrad(FABRIC_LR, beta=1.0)
            params = cnn.init_cnn(torch.Generator().manual_seed(0),
                                  FIG4_CNN)
            rng = np.random.default_rng(0)
            acc = tree_map(lambda v: torch.from_numpy(rng.uniform(
                0, 1, tuple(v.shape)).astype(np.float32)).cuda(), params)
            grads = [tree_map(lambda v: rng.normal(
                0, 1e-2, tuple(v.shape)).astype(np.float32), params)
                for _ in range(FABRIC_SHARDS)]
            works = [float(FABRIC_BATCH)] * FABRIC_SHARDS
            want_p, want_o = step_mod.FusedServerStep(
                opt, lr=FABRIC_LR, beta=1.0).step(grads, works, params,
                                                  {"acc": acc})
            sharded = step_mod.FusedServerStep(opt, lr=FABRIC_LR, beta=1.0,
                                               mesh=mesh)
            _zero_counts()
            (got_p, got_o), took = _synced(sharded.step, grads, works,
                                           params, {"acc": acc})
            k1 = server_step_update.launches
            same = all(_same_bits(a, b) for a, b in zip(
                tree_leaves(got_p) + tree_leaves(got_o["acc"]),
                tree_leaves(want_p) + tree_leaves(want_o["acc"])))
            check(same and k1 == 1,
                  f"14b: the row-sharded server step bitwise the unsharded "
                  f"one, with one K1 launch: bitwise {same}, {k1} launches")
            out["server_step"] = k1
            say("14b shard-server-step", model=FIG4_CNN.name, mesh="1x1",
                members=FABRIC_SHARDS,
                params=sum(v.numel() for v in tree_leaves(params)),
                vs_unsharded="bitwise", server_step_launches=k1,
                step_ms=f"{1e3 * took:.3f}")

            # c. the qwen3-moe cut served under fsdp_tp rules, the decode
            # captured
            mcfg = dataclasses.replace(get_arch_config("qwen3-moe-30b-a3b"),
                                       **SHARD_MOE_CUT)
            out["flash_attention"] = _shard_serve(
                "14c shard-serve", mcfg, mesh, wrapper=flash_attention,
                launches=mcfg.num_layers, stale_index=True, in_decode=False,
                moe=True)

            # d. rwkv6-1.6b whole: the prefill eager, the decode captured
            # with K5 inside
            finch = get_arch_config("rwkv6-1.6b")
            out["rwkv6"] = _shard_serve(
                "14d shard-serve", finch, mesh, wrapper=wkv,
                launches=(1 + SHARD_GEN) * finch.num_layers,
                stale_index=False, in_decode=True)
        finally:
            dist.destroy_process_group()
    return out


# --- 15. the dry-run against real steps --------------------------------------


#: (name, arch, shape, batch, seq, the kernel on its path, its launches):
#: phase 9's split_concurrent step and phase 6's prefill, at f32
DRYRUN_CASES = (
    ("train", TRAIN_ARCH, "train_4k", TRAIN_BATCH, TRAIN_SEQ, "adagrad", 2),
    ("prefill", "qwen3-4b", "prefill_32k", SERVE_BATCH, SERVE_PROMPT,
     "flash_attention", 36))
#: the dry-run's peak bytes against the card's ``max_memory_allocated``,
#: and its product FLOPs against the real step's, relative
DRYRUN_PEAK_TOL = 0.15
DRYRUN_FLOPS_TOL = 0.01


def _start_dryruns(out_dir: str) -> dict:
    """Each ``DRYRUN_CASES`` case through ``python -m
    repro_torch.launch.dryrun`` (full depth, a 1x1 shape-only mesh, f32),
    all at once, each in a process of its own: this process may hold a
    real process group, beside which a fake one cannot live."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {}
    for name, arch, shape, batch, seq, _, _ in DRYRUN_CASES:
        path = os.path.join(out_dir, f"dryrun_{name}.jsonl")
        procs[name] = (path, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "1x1", "--batch", str(batch),
             "--seq", str(seq), "--compute-dtype", "float32",
             "--full-depth", "--out", path], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs: dict, timeout: float = 300.0) -> dict:
    """Wait for the dry-runs; every process is killed at ``timeout``."""
    recs = {}
    try:
        for name, (path, proc) in procs.items():
            log, _ = proc.communicate(timeout=timeout)
            check(proc.returncode == 0,
                  f"15: the dry-run of {name} ran: {log[-3000:]}")
            with open(path) as f:
                recs[name] = json.loads(f.readline())
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return recs


def _real_step(name, arch, shape_name, batch, seq, mesh) -> dict:
    """The case's step on the card through the same bundle as the
    dry-run's (``build_step`` on a real 1x1 mesh), after one step run
    uncounted (the dry-run counts a step after its ``warm`` one): its
    counts under the accounting mode, its peak memory
    (``max_memory_allocated`` from a reset, less what the process held
    before the arguments were made) and one more step timed."""
    from repro_torch.configs import INPUT_SHAPES, get_arch_config
    from repro_torch.data import make_lm_batch
    from repro_torch.launch.dryrun import make_run
    from repro_torch.launch.steps import build_step
    from repro_torch.sharding.spec import values_tree
    from repro_torch.tree import tree_as_tensors

    cfg = get_arch_config(arch)
    shape = dataclasses.replace(INPUT_SHAPES[shape_name],
                                global_batch=batch, seq_len=seq)
    run = make_run(cfg, shape, mesh, compute_dtype="float32")
    bundle = build_step(cfg, run, shape, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    if shape.kind == "train":
        data = tree_as_tensors(make_lm_batch(rng, batch, seq,
                                             bundle.cfg.vocab_size), "cuda")
        args = (bundle.init(gen, batch=data), data)
    else:
        args = (values_tree(bundle.api.init(gen)),
                {"tokens": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (batch, seq)).astype(np.int32)
                    ).cuda()})
    placed = bundle.place(*args)
    del args
    with torch.no_grad() if shape.kind != "train" else \
            contextlib.nullcontext():
        bundle(*placed)            # a first step, as the dry-run's warm()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = bundle.account(*placed)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        t0 = time.perf_counter()
        out = bundle(*placed)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    del out, placed, bundle
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts, peak_measured=peak, seconds=seconds,
                compute_dtype=run.compute_dtype)


def phase_dryrun() -> dict:
    """Each ``DRYRUN_CASES`` case through the dry-run (a subprocess) and
    once for real on the card under the same accounting mode: per-device
    product FLOPs equal (or within ``DRYRUN_FLOPS_TOL``, each op's
    difference printed), the kernel's meta launches equal the card's, the
    dry-run's peak bytes within ``DRYRUN_PEAK_TOL`` of the card's, and the
    step's time at least its roofline bound.  Returns the card's launches
    by kernel."""
    import torch.distributed as dist
    from datetime import timedelta

    from repro_torch.launch.hlo_analysis import roofline_from_counts
    from repro_torch.launch.mesh import make_local_mesh

    launched = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = _start_dryruns(tmp)
        try:
            dist.init_process_group(
                "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                rank=0, world_size=1, timeout=timedelta(seconds=300))
            try:
                mesh = make_local_mesh(1, 1, device="cuda")
                real = {}
                for case in DRYRUN_CASES:
                    _zero_counts()
                    real[case[0]] = _real_step(*case[:5], mesh)
                    for w in WRAPPERS:
                        launched[w.__name__] = (launched.get(w.__name__, 0)
                                                + w.launches)
            finally:
                dist.destroy_process_group()
        finally:
            dry = _finish(procs)
    for name, arch, _, batch, seq, kernel, launches in DRYRUN_CASES:
        d, r = dry[name], real[name]
        dflops, rflops = d["product_flops_per_device"], r["product_flops"]
        ops = sorted(set(d["flops_by_op"]) | set(r["flops_by_op"]))
        by_op = {op: (d["flops_by_op"].get(op, 0),
                      r["flops_by_op"].get(op, 0)) for op in ops}
        gap = abs(dflops - rflops) / max(rflops, 1)
        check(gap <= DRYRUN_FLOPS_TOL,
              f"15 {name}: product FLOPs of the dry-run {dflops} against "
              f"the card's {rflops} (by op {by_op})")
        dl, rl = d["launches"].get(kernel, 0), r["launches"].get(kernel, 0)
        check(dl == rl == launches,
              f"15 {name}: {kernel}'s meta launches {dl} and the card's "
              f"{rl}, {launches} wanted")
        dpeak, rpeak = d["peak_bytes_per_device"], r["peak_measured"]
        peak_gap = abs(dpeak - rpeak) / rpeak
        check(peak_gap <= DRYRUN_PEAK_TOL,
              f"15 {name}: the dry-run's peak {dpeak} bytes against the "
              f"card's max_memory_allocated {rpeak}")
        roof = roofline_from_counts(r, 1, compute_dtype=r["compute_dtype"])
        bound = max(roof.t_compute, roof.t_memory)
        check(r["seconds"] >= bound,
              f"15 {name}: the step's {r['seconds']} s under its roofline "
              f"bound {bound} s: a counting fault")
        say(f"15 dryrun-{name}", arch=arch, batch=batch, seq=seq,
            dtype="float32", product_flops_dry=dflops,
            product_flops_card=rflops, flops_gap=gap,
            flops_by_op_dry_card=json.dumps(by_op).replace(" ", ""),
            kernel=kernel, launches_dry=dl, launches_card=rl,
            arg_bytes_dry=d["arg_bytes_per_device"],
            arg_bytes_card=r["arg_bytes"], peak_bytes_dry=dpeak,
            peak_bytes_card=rpeak, peak_gap=f"{peak_gap:.4f}",
            bytes_dry=int(d["hbm_bytes"]), bytes_card=r["bytes"],
            collectives_dry=json.dumps(d["collective_counts"]).replace(
                " ", ""),
            collectives_card=json.dumps(r["collective_counts"]).replace(
                " ", ""),
            t_compute_s=f"{roof.t_compute:.6f}",
            t_memory_s=f"{roof.t_memory:.6f}",
            step_s=f"{r['seconds']:.6f}",
            roofline_fraction=f"{bound / r['seconds']:.4f}",
            dry_run_s=d["compile_s"])
    return launched


# --- 16. the examples ---------------------------------------------------------


def phase_examples() -> dict:
    """The four torch examples at their smallest flags, all at once, each
    a process of its own on the card: each exits 0 and prints its kernel
    launches, which must be those of its path.  Returns the launches by
    kernel."""
    from repro_torch.configs import get_smoke_config

    serve_gen = 2
    finch = get_smoke_config("rwkv6-1.6b")
    with tempfile.TemporaryDirectory() as tmp:
        cases = {
            "quickstart": (["torch_quickstart.py", "--batches", "2", "--out",
                            os.path.join(tmp, "model.json")],
                           "adagrad", 2),
            "serve": (["torch_serve_llm.py", "--batch", "1", "--prompt-len",
                       "8", "--gen", str(serve_gen)],
                      "rwkv6", (1 + serve_gen) * finch.num_layers),
            "train": (["torch_train_llm.py", "--steps", "10", "--batch", "2",
                       "--seq", "16", "--d-model", "64", "--layers", "1",
                       "--vocab", "256"], "adagrad", 20),
            "sim": (["torch_sashimi_browser_sim.py", "--train"],
                    "server_step", 6),
        }
        procs = {name: subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples", argv[0]),
             *argv[1:]], cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for name, (argv, _, _) in cases.items()}
        logs, t0 = {}, time.perf_counter()
        try:
            for name, proc in procs.items():
                logs[name], _ = proc.communicate(timeout=300)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        seconds = time.perf_counter() - t0
    launched = {}
    for name, (argv, kernel, want) in cases.items():
        log = logs[name]
        check(procs[name].returncode == 0,
              f"16: examples/{argv[0]} exits 0: {log[-3000:]}")
        lines = [ln for ln in log.splitlines()
                 if ln.startswith("kernel launches:")]
        check(len(lines) == 1, f"16: examples/{argv[0]} prints its kernel "
              f"launches: {log[-2000:]}")
        counts = dict(re.findall(r"(\w+)=(\d+)", lines[0]))
        got = int(counts.get(kernel, -1))
        check(got == want, f"16: examples/{argv[0]} launched {kernel} "
              f"{got} times, {want} wanted: {lines[0]}")
        launched[kernel] = launched.get(kernel, 0) + got
        say(f"16 example-{name}", script=f"examples/{argv[0]}",
            flags=repr(" ".join(argv[1:])), exit=0,
            launches=repr(lines[0][len("kernel launches: "):]))
    say("16 examples", seconds=f"{seconds:.3f}")
    return launched


def _ptxas(name: str) -> list:
    """(CUDA function, registers a thread, spill bytes) of each entry
    function of kernel ``name``, from ptxas's ``-v`` lines in its build
    log; a template instance is named as ``flash_kernel<f32,128>``."""
    found, fn, spill = [], None, 0
    for line in build.log_path(name).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), 0
            t = re.search(r"\d([a-z][a-z_]*_kernel)I(f|\w+?bfloat16)"
                          r"Li(\d+)E(?:Lb([01])E)?", fn)
            k1 = re.search(r"\d(server_step_kernel)ILi(\d+)ELi(\d+)E", fn)
            if k1:
                fn = f"{k1.group(1)}<M={k1.group(2)},W={k1.group(3)}>"
            elif t:
                dtype = "f32" if t.group(2) == "f" else "bf16"
                vec = {None: "", "1": ",vec", "0": ",scalar"}[t.group(4)]
                fn = f"{t.group(1)}<{dtype},{t.group(3)}{vec}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            found.append((fn, int(m.group(1)), spill))
            fn = None
    return found


def main() -> int:
    from repro_torch.configs import get_arch_config

    device = phase_environment()
    built = build.build()
    say("2 build", kernels=",".join(build.KERNELS), seconds=f"{built:.3f}",
        **{f"flags_{k}": repr(" ".join(v))
           for k, v in build.NVCC_FLAGS.items()})
    for name in build.KERNELS:
        fns = _ptxas(name)
        say("2 ptxas", kernel=name, functions=",".join(
            f"{fn}:regs={regs}:spill_bytes={spill}"
            for fn, regs, spill in fns))
        check(fns and all(spill == 0 for _, _, spill in fns),
              f"{name}'s kernels spill no registers")
    timer = ColdTimer()
    kernels = phase_kernels(timer, ColdTimer(hold=False))
    kernels.update(phase_lm_kernels(timer))
    kernels["mamba"] = phase_mamba_kernel(timer)
    kernels["server_step"]["launches"] = phase_fabric()
    kernels["adagrad"]["launches"] = phase_quickstart()
    k3 = dict(module=layers, attr="flash_attention",
              plain=_plain_flash_attention, tol=(TOL_F32,))
    qwen = get_arch_config("qwen3-4b")
    k3_launches = phase_serve(
        "6 serve", qwen,
        [OnPath(flash_attention, launches=qwen.num_layers, **k3)],
        fault=_off_by_one_slot)["flash_attention"]
    finch = get_arch_config("rwkv6-1.6b")
    kernels["rwkv6"]["launches"] = phase_serve(
        "7 serve", finch,
        [OnPath(wkv, rwkv, "wkv", wkv_ref, (BITWISE, BITWISE),
                launches=(1 + SERVE_GEN) * finch.num_layers)],
        fault=_state_dropped("wkv"))["wkv"]
    jamba = dataclasses.replace(get_arch_config("jamba-1.5-large-398b"),
                                **JAMBA_CUT)
    n_attn = jamba.num_layers // jamba.attn_layer_period
    served = phase_serve(
        "8 serve", jamba,
        [OnPath(mamba_scan, mamba, "mamba_scan", mamba_scan_ref,
                (BITWISE, BITWISE),
                launches=(1 + SERVE_GEN) * (jamba.num_layers - n_attn)),
         OnPath(flash_attention, launches=n_attn, **k3)],
        fault=_state_dropped("ssm"), moe=hybrid)
    kernels["mamba"]["launches"] = served["mamba_scan"]
    k3_launches += served["flash_attention"]
    kernels["adagrad"]["launches"] += phase_train()
    moe30 = dataclasses.replace(get_arch_config("qwen3-moe-30b-a3b"),
                                **MOE_CUT)
    k3_launches += phase_serve(
        "10 serve", moe30,
        [OnPath(flash_attention, launches=moe30.num_layers, **k3)],
        fault=_off_by_one_slot, moe=transformer)["flash_attention"]
    vlm = dataclasses.replace(get_arch_config("internvl2-26b"), **VLM_CUT)
    k3_launches += phase_serve(
        "11 serve", vlm,
        [OnPath(flash_attention, launches=vlm.num_layers, **k3)],
        fault=_reference_index)["flash_attention"]
    whisper = get_arch_config("whisper-small")
    enc, dec = whisper.encoder_layers, whisper.num_layers
    k3_launches += phase_serve(
        "12 serve", whisper,
        # the first launch is the encoder's first, then each decoder layer
        # launches its self-attention and its cross-attention
        [OnPath(flash_attention, launches=enc + 2 * dec,
                rerun=(("first_encoder", 0), ("first_cross", enc + 1),
                       ("last_cross", -1)), **k3)],
        fault=_state_dropped("cross_k", "cross_v"),
        prompt=WHISPER_PROMPT)["flash_attention"]
    kernels["flash_attention"]["launches"] = k3_launches
    kernels["adagrad"]["launches"] += phase_train_zoo()
    sharded = phase_sharded()
    kernels["adagrad"]["launches"] += sharded["adagrad"]
    kernels["server_step"]["launches"] += sharded["server_step"]
    kernels["flash_attention"]["launches"] += sharded["flash_attention"]
    kernels["rwkv6"]["launches"] += sharded["rwkv6"]
    dryrun = phase_dryrun()
    kernels["adagrad"]["launches"] += (dryrun["adagrad_update_leaves"]
                                       + dryrun["adagrad_update"])
    kernels["flash_attention"]["launches"] += dryrun["flash_attention"]
    for name, n in phase_examples().items():
        kernels[name]["launches"] += n
    print(_smi(), flush=True)          # again beside the numbers it qualifies
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
