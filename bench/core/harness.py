"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), the check against the reference, and the result line.

A rate is the work of the window's whole steps or calls over their own
elapsed time: the window runs them until its seconds have passed, and
the last one is counted whole, so the rate is not quantised by where the
window ends.  ``setup_s`` runs from the process's start to the window's.
"""
from __future__ import annotations

import gc
from dataclasses import dataclass
from time import perf_counter

import torch

from bench.core import manifest
from bench.core.serve import ServeLoop
from bench.core.train import TrainLoop

LOOPS = {"train": TrainLoop, "serve": ServeLoop}

#: The window's clock (a test may put a fake in its place).
clock = perf_counter

#: Steps or calls the traced stretch holds, by the mix's kind.
TRACED = {"train": 2, "serve": 1}


@dataclass
class Run:
    """What a metric's reader (``bench/metrics/<name>.py``) reads:
    the cell, its dimensions and parameter layout, the window's counts and
    times, and the traced stretch (None without ``--trace 1`` or off the
    card)."""

    cell: manifest.Cell
    dims: dict
    layout: list
    window: dict
    trace: object = None


def _device_peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool, *,
        device="cuda", t0: float | None = None, faults=()) -> dict:
    """The result of one run of ``cell`` (without its printing): the keys
    of the result line, ``checks`` last."""
    t0 = clock() if t0 is None else t0
    dev = torch.device(device)
    kind = cell.mix["kind"]
    loop = LOOPS[kind](cell, seed, dev, faults)
    loop.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        setup_peak = _device_peak(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    start = clock()
    done = 0
    while True:
        loop.step()
        done += 1
        elapsed = clock() - start
        if elapsed >= seconds:
            break
    window_peak = _device_peak(dev)
    work = loop.work(done)
    window = dict(work, done=done, seconds=elapsed, setup_s=start - t0,
                  peak_bytes=window_peak,
                  call_ms=list(getattr(loop, "call_ms", [])),
                  prefill_ms=list(getattr(loop, "prefill_ms", [])))
    run_ = Run(cell, loop.dims, loop.layout, window)
    traced = None
    if trace and dev.type == "cuda":
        from bench.core.trace import traced as trace_fn
        traced = trace_fn(lambda i: loop.step(), TRACED[kind], dev)
        run_.trace = traced
    peak = max(setup_peak, _device_peak(dev)) if dev.type == "cuda" else 0
    loop.release()
    numbers = loop.numbers()
    checks = {k: {"value": numbers[k], "limit": v}
              for k, v in cell.limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = manifest.reader(m["name"])(run_)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct and work["failed"] == 0,
              "attempted": work["attempted"], "failed": work["failed"],
              "metrics": metrics, "device": info}
    if traced is not None:
        info["busy_s"] = traced.busy_s
        info["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": traced.top_ops(),
                               "idle_gaps": traced.top_gaps()}
    result["readings"] = {k: v for k, v in numbers.items()
                          if k not in checks}
    result["checks"] = checks
    gc.collect()
    return result

