"""Unified metrics registry for the Sashimi fabric.

One :class:`MetricsRegistry` holds every labelled counter, gauge, and
histogram the fabric exposes, behind a single :meth:`snapshot` /
:meth:`export` API.  It absorbs the ad-hoc telemetry that grew across
PRs 2-6 (``EdgeCache`` hit counters, origin ``download_count``,
``FederationMember.steals``, transport frame counters, ticket-queue EWMA
rates, barrier wait times) — see ``repro.obs.collect`` for the
collectors that map those legacy counters in.

Naming convention (linted by ``tools/check_metric_names.py``, catalog
in ``docs/ARCHITECTURE.md`` §Observability)::

    subsystem.noun_unit        e.g.  cache.hits_total
                                     round.barrier_wait_seconds

where ``subsystem`` is a single lowercase token, and the final
underscore-separated token of the noun part is one of the allowed units
(:data:`UNITS`).  Invalid names are rejected at registration, so the
lint and the runtime cannot drift.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["UNITS", "METRIC_NAME_RE", "valid_metric_name",
           "Counter", "Gauge", "Histogram", "MetricsRegistry"]

#: allowed unit suffixes — the last ``_``-separated token of every name
UNITS = ("total", "seconds", "bytes", "count", "rate", "ratio")

METRIC_NAME_RE = re.compile(
    r"^[a-z][a-z0-9]*\.[a-z][a-z0-9]*(?:_[a-z0-9]+)*_(%s)$"
    % "|".join(UNITS))


def valid_metric_name(name: str) -> bool:
    return bool(METRIC_NAME_RE.match(name))


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   60.0, float("inf"))


class _Metric:
    kind = "abstract"

    def __init__(self, name: str, help: str, label_names: Tuple[str, ...],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.label_names = label_names
        self._lock = lock
        self._values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: dict) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                "metric %r takes labels %r, got %r"
                % (self.name, self.label_names, tuple(labels)))
        return tuple(str(labels[k]) for k in self.label_names)

    def _value_rows(self) -> List[dict]:
        rows = []
        for key in sorted(self._values):
            rows.append({"labels": dict(zip(self.label_names, key)),
                         "value": self._values[key]})
        return rows


class Counter(_Metric):
    """Monotonic counter.  ``set_total`` exists for snapshot-time
    collectors that absorb an externally-maintained cumulative count."""
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set_total(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus-style ``le`` buckets)."""
    kind = "histogram"

    def __init__(self, name, help, label_names, lock,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, label_names, lock)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or bs[-1] != float("inf"):
            bs = bs + (float("inf"),)
        self.buckets = bs
        # key -> [counts per bucket..., count, sum]
        self._hvalues: Dict[Tuple[str, ...], List[float]] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            row = self._hvalues.get(key)
            if row is None:
                row = self._hvalues[key] = [0.0] * (len(self.buckets) + 2)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    row[i] += 1
            row[-2] += 1
            row[-1] += value

    def count(self, **labels) -> int:
        key = self._key(labels)
        with self._lock:
            row = self._hvalues.get(key)
            return int(row[-2]) if row else 0

    def sum(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            row = self._hvalues.get(key)
            return row[-1] if row else 0.0

    def _value_rows(self) -> List[dict]:
        rows = []
        for key in sorted(self._hvalues):
            row = self._hvalues[key]
            rows.append({
                "labels": dict(zip(self.label_names, key)),
                "count": int(row[-2]),
                "sum": row[-1],
                "buckets": {("inf" if b == float("inf") else repr(b)): int(c)
                            for b, c in zip(self.buckets, row)},
            })
        return rows


class MetricsRegistry:
    """Registry of named metrics; registration is idempotent per name.

    Re-registering a name with the same kind returns the existing
    instrument (so collectors can run repeatedly); a kind clash or a
    name violating the ``subsystem.noun_unit`` convention raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name: str, help: str,
                  labels: Tuple[str, ...], **kw) -> _Metric:
        if not valid_metric_name(name):
            raise ValueError(
                "metric name %r violates the subsystem.noun_unit "
                "convention (unit suffix must be one of %s)"
                % (name, "/".join(UNITS)))
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.kind != cls.kind:
                    raise ValueError(
                        "metric %r already registered as %s, not %s"
                        % (name, existing.kind, cls.kind))
                if tuple(existing.label_names) != tuple(labels):
                    raise ValueError(
                        "metric %r already registered with labels %r"
                        % (name, existing.label_names))
                return existing
            m = cls(name, help, tuple(labels), self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Tuple[str, ...] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Tuple[str, ...] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Tuple[str, ...] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labels,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """JSON-safe dump of every metric: name -> {kind, help, values}."""
        with self._lock:
            metrics = dict(self._metrics)
        return {name: {"kind": m.kind, "help": m.help,
                       "values": m._value_rows()}
                for name, m in sorted(metrics.items())}

    def export(self) -> List[dict]:
        """Flat row-per-series export (for BENCH json and dashboards)."""
        rows = []
        for name, body in self.snapshot().items():
            for v in body["values"]:
                rows.append({"name": name, "kind": body["kind"], **v})
        return rows
