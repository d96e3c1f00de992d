"""A traced stretch of a run: ``torch.profiler`` over a few whole steps
or calls, read into what the per-layer metrics need.

The events are read as the profiler keeps them (``kineto_results``), not
parsed into ``FunctionEvent`` objects, which for a step of ~10^5 kernels
(a recurrent model's training step) would take minutes: the reading of
``chip_smoke.py::_traced_device_split``, copied here.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Trace:
    """Device operations ``(name, start_ns, dur_ns)``, host events
    ``(name, start_ns, dur_ns)``, the traced window's host seconds and
    the number of steps or calls ``n`` it holds."""

    device_ops: list
    host: list
    window_s: float
    n: int
    _union: list = field(default=None, repr=False)

    def union(self) -> list:
        """The device's busy intervals ``[(start_ns, end_ns)]``, merged."""
        if self._union is None:
            out = []
            for _, s, d in sorted(self.device_ops, key=lambda e: e[1]):
                if out and s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], s + d)
                else:
                    out.append([s, s + d])
            self._union = out
        return self._union

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self.union()) / 1e9

    def kernels(self) -> list:
        """The device operations that are kernels (no copies, no fills)."""
        return [e for e in self.device_ops
                if not e[0].startswith(("Memcpy", "Memset"))]

    def seconds_of(self, patterns) -> tuple:
        """(seconds, launches) of the kernels whose name holds one of
        ``patterns``."""
        hits = [d for n, _, d in self.device_ops
                if any(p in n for p in patterns)]
        return sum(hits) / 1e9, len(hits)

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` operation names that took the most device time:
        ``[[name, seconds]]``."""
        tot: dict = {}
        for n, _, d in self.device_ops:
            tot[n] = tot.get(n, 0) + d
        return [[_short(n), t / 1e9] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def top_gaps(self, k: int = 10) -> list:
        """The ``k`` longest idle gaps between device operations, each
        named by what the host was doing when it began (the innermost
        host event around its start, else the last one before it):
        ``[[name, seconds]]``."""
        u = self.union()
        gaps = sorted(((u[i + 1][0] - u[i][1], u[i][1])
                       for i in range(len(u) - 1)), reverse=True)[:k]
        host = sorted(self.host, key=lambda e: e[1])
        out = []
        for dur, at in gaps:
            around = [e for e in host if e[1] <= at <= e[1] + e[2]]
            if around:
                label = min(around, key=lambda e: e[2])[0]
            else:
                before = [e for e in host if e[1] + e[2] <= at]
                label = ("after " + before[-1][0]) if before else "host"
            out.append([_short(label), dur / 1e9])
        return out


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def traced(fn, n: int, device) -> Trace:
    """``fn(i)`` for i in range(n) under the profiler (CPU and CUDA
    activity), the device synchronised at both ends."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            with record_function(f"bench.{i}"):
                fn(i)
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    ops, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((e.name(), e.start_ns(), e.duration_ns()))
        else:
            host.append((e.name(), e.start_ns(), e.duration_ns()))
    return Trace(ops, host, window, n)
