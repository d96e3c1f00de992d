"""Declarative SLO monitors over the unified metrics registry.

An :class:`Slo` names a metric in a :class:`~repro.obs.metrics.
MetricsRegistry`, a statistic to extract from it, and a threshold; a
:class:`SloMonitor` evaluates a set of them on demand — the
:class:`~repro.train_fabric.round_engine.FederatedTrainer` runs its
monitor at every round close (results land in ``RoundResult.slos``),
and ``benchmarks/run.py --only obs`` uses one as a CI gate (an
injected regression must trip it; the clean run must not).

Statistics:

* ``value`` — gauge value / counter total (summed across label sets).
* ``total`` — alias of ``value`` for counters (reads as intent).
* ``count`` — a histogram's observation count.
* ``p95`` (any ``p``-prefixed quantile, e.g. ``p50``/``p99``) — the
  upper edge of the first cumulative bucket covering that fraction of
  a histogram's observations.  Bucket-quantiles are conservative
  (they round up to a bucket boundary, and a quantile past the last
  finite bucket reads as inf), which is the right bias for a latency
  gate.

A missing metric evaluates the statistic as 0.0 rather than failing —
an SLO list must be safe to attach before the subsystem it watches has
registered anything.  Breaches emit ``slo.breach`` trace instants
(cat ``warning``) when the monitor holds a tracer, so a flight
recorder can trigger on them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from .metrics import Histogram, MetricsRegistry
from .trace import Tracer

__all__ = ["Slo", "SloMonitor", "DEFAULT_ROUND_SLOS"]

_OPS = {
    "<=": lambda v, t: v <= t,
    "<": lambda v, t: v < t,
    ">=": lambda v, t: v >= t,
    ">": lambda v, t: v > t,
    "==": lambda v, t: v == t,
}


@dataclass(frozen=True)
class Slo:
    """One declarative objective: ``stat(metric) op threshold``."""
    name: str           # short id, e.g. "round-p95"
    metric: str         # registry metric name, e.g. "round.duration_seconds"
    op: str             # one of <=, <, >=, >, ==
    threshold: float
    stat: str = "value"  # value | total | count | pNN

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown SLO op {self.op!r}")
        if (self.stat not in ("value", "total", "count")
                and not (self.stat.startswith("p")
                         and self.stat[1:].isdigit())):
            raise ValueError(f"unknown SLO stat {self.stat!r}")


def _histogram_quantile(h: Histogram, q: float) -> float:
    """Upper edge of the first cumulative bucket covering fraction
    ``q`` of observations, summed across label sets.  0.0 when empty.
    A quantile landing in the +inf bucket returns **inf** — "beyond the
    histogram's resolution" must FAIL a ``<= threshold`` latency gate,
    never clamp back under it (clamping to the last finite edge would
    make a gate at that edge untrippable)."""
    counts = [0] * len(h.buckets)
    total = 0
    with h._lock:
        for row in h._hvalues.values():
            for i in range(len(h.buckets)):
                counts[i] += row[i]
            total += row[-2]
    if total == 0:
        return 0.0
    need = q * total
    for b, c in zip(h.buckets, counts):
        if c >= need:
            return b
    return float("inf")     # unreachable: the +inf bucket holds `total`


@dataclass
class SloResult:
    slo: Slo
    value: float
    ok: bool

    def as_dict(self) -> dict:
        return {"name": self.slo.name, "metric": self.slo.metric,
                "stat": self.slo.stat, "op": self.slo.op,
                "threshold": self.slo.threshold,
                "value": self.value, "ok": self.ok}


class SloMonitor:
    """Evaluates a set of :class:`Slo` against one registry."""

    def __init__(self, registry: MetricsRegistry, slos: Sequence[Slo],
                 tracer: Optional[Tracer] = None):
        self.registry = registry
        self.slos = list(slos)
        self.tracer = tracer
        self.breaches_total = 0

    def _stat(self, slo: Slo) -> float:
        m = self.registry.get(slo.metric)
        if m is None:
            return 0.0
        if slo.stat in ("value", "total"):
            if isinstance(m, Histogram):
                return float(m.sum()) if not m.label_names else 0.0
            # counter total / gauge sum, across every label set
            with m._lock:
                return float(sum(m._values.values()))
        if slo.stat == "count":
            if isinstance(m, Histogram) and not m.label_names:
                return float(m.count())
            return 0.0
        # pNN quantile
        if not isinstance(m, Histogram):
            return 0.0
        return float(_histogram_quantile(m, int(slo.stat[1:]) / 100.0))

    def evaluate(self, *, ts: Optional[float] = None) -> List[SloResult]:
        """Evaluate every SLO now; breaches emit ``slo.breach``
        instants on the monitor's tracer (track ``slo``)."""
        out: List[SloResult] = []
        for slo in self.slos:
            v = self._stat(slo)
            ok = _OPS[slo.op](v, slo.threshold)
            out.append(SloResult(slo, v, ok))
            if not ok:
                self.breaches_total += 1
                if self.tracer is not None:
                    self.tracer.instant(
                        "slo.breach", track="slo", cat="warning", ts=ts,
                        args={"slo": slo.name, "metric": slo.metric,
                              "stat": slo.stat, "value": v,
                              "op": slo.op,
                              "threshold": slo.threshold})
        return out

    def ok(self, *, ts: Optional[float] = None) -> bool:
        return all(r.ok for r in self.evaluate(ts=ts))


#: The fabric's stock round-health objectives (ISSUE 10): latency p95,
#: zero stale weight serves, zero lost/duplicated tickets, bounded
#: eviction and busy-refusal pressure.  Callers clone-and-tune.
DEFAULT_ROUND_SLOS = (
    Slo("round-latency-p95", "round.duration_seconds", "<=", 60.0,
        stat="p95"),
    Slo("zero-stale-serves", "round.stale_executions_total", "==", 0.0,
        stat="total"),
    Slo("zero-lost-tickets", "round.lost_tickets_total", "==", 0.0,
        stat="total"),
    Slo("zero-duplicate-results", "queue.duplicate_results_total", "==",
        0.0, stat="total"),
    Slo("eviction-rate", "transport.evictions_total", "<=", 100.0,
        stat="total"),
    Slo("busy-refusal-rate", "transport.busy_refusals_total", "<=",
        1000.0, stat="total"),
)
