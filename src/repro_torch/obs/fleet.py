"""Fleet telemetry aggregation: the server-side half of the telemetry
plane (docs/PROTOCOL.md §telemetry, docs/ARCHITECTURE.md §Observability).

Remote browsers are the one part of the fabric you can never attach a
profiler to — everything a :class:`~repro.core.transport.
RemoteBrowserClient` measures locally (execute lanes, backoff sleeps,
busy refusals) either crosses the wire or dies with the tab.  A
:class:`FleetAggregator` is handed to the :class:`TransportServer`
(``fleet=``) and receives every tolerantly-parsed ``telemetry`` batch:

* **Metrics** merge into one fleet-wide snapshot with a ``client=``
  label injected into every series row, so ``client.execute_seconds``
  from forty browsers reads as one labelled metric family.  Ingestion
  is last-write-wins per (client, series) — clients ship cumulative
  snapshots, so re-ingestion is idempotent by construction.
* **Spans** buffer per client (bounded, oldest dropped and counted)
  with their timestamps remapped from the client's clock to the
  server's via the per-connection skew estimate, so the merged
  :meth:`chrome_trace` shows server round lanes, wire spans, and
  *remote* client execute lanes on one common timeline.
* **Clock skew** is estimated NTP-style from heartbeat echoes: the
  client reports ``(t0, server_ts, t1)`` — its send time, the server's
  stamp, its receive time — giving ``offset = server_ts - (t0+t1)/2``
  with uncertainty ``rtt = t1 - t0``.  The minimum-RTT sample wins
  (least queueing delay → tightest bound on the true offset).

Everything here is defensive: batches arrive pre-sanitized by
:func:`repro.core.wire.parse_telemetry`, but the aggregator still
bounds every buffer and counts every drop rather than trusting a peer.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .trace import Tracer, render_chrome_trace

__all__ = ["ClockSkew", "FleetAggregator"]

#: async-span ids from remote clients are renumbered into this range so
#: they can never collide with the server tracer's own span ids.
_REMOTE_ID_BASE = 1 << 32


@dataclass
class ClockSkew:
    """Best clock-skew estimate for one client (server − client)."""
    offset: float = 0.0     # add to a client timestamp → server time
    rtt: float = float("inf")  # uncertainty of the winning sample
    samples: int = 0


class FleetAggregator:
    """Merges per-client telemetry into one fleet view.

    ``tracer`` is the *server's* tracer: its events form the local half
    of the merged export.  ``max_spans_per_client`` bounds each span
    buffer (oldest evicted, counted in ``spans_dropped``);
    ``max_clients`` bounds how many distinct clients may hold state
    (batches from the overflow are dropped whole, counted in
    ``batches_dropped``).
    """

    def __init__(self, tracer: Optional[Tracer] = None, *,
                 max_spans_per_client: int = 4096,
                 max_clients: int = 1024):
        self.tracer = tracer
        self.max_spans_per_client = int(max_spans_per_client)
        self.max_clients = int(max_clients)
        self._lock = threading.Lock()
        # client -> latest metrics snapshot (name -> {kind, help, values})
        self._series: Dict[str, Dict[str, dict]] = {}
        # client -> bounded buffer of decoded span events (client clock)
        self._spans: Dict[str, deque] = {}
        self._skew: Dict[str, ClockSkew] = {}
        self.batches_total = 0
        self.batches_dropped = 0
        self.spans_total = 0
        self.spans_dropped = 0       # buffer evictions on this side
        self.series_dropped = 0      # malformed rows discarded here
        self.remote_dropped = 0      # peers' self-reported drop counts
        self.parse_dropped = 0       # entries parse_telemetry discarded

    # -- ingestion ---------------------------------------------------------

    def ingest(self, client: str, parsed: Optional[dict], *,
               recv_ts: Optional[float] = None) -> bool:
        """Absorb one parsed ``telemetry`` batch (the output of
        :func:`repro.core.wire.parse_telemetry`) from ``client``.
        Returns False — never raises — when the batch was dropped
        (unparseable, or a brand-new client past ``max_clients``)."""
        if not isinstance(client, str) or not client or parsed is None:
            with self._lock:
                self.batches_dropped += 1
            return False
        with self._lock:
            if (client not in self._spans
                    and len(self._spans) >= self.max_clients):
                self.batches_dropped += 1
                return False
            self.batches_total += 1
            self.remote_dropped += parsed.get("dropped", 0)
            self.parse_dropped += parsed.get("local_drops", 0)

            snap = self._series.setdefault(client, {})
            for name, body in parsed.get("metrics", {}).items():
                rows = []
                for row in body.get("values", ()):
                    if not isinstance(row, dict):
                        self.series_dropped += 1
                        continue
                    labels = row.get("labels")
                    rows.append({**row,
                                 "labels": {**(labels if isinstance(
                                     labels, dict) else {}),
                                     "client": client}})
                snap[name] = {"kind": body["kind"], "help": body["help"],
                              "values": rows}

            buf = self._spans.setdefault(
                client, deque(maxlen=self.max_spans_per_client))
            for ev in parsed.get("spans", ()):
                if len(buf) == buf.maxlen:
                    self.spans_dropped += 1
                self.spans_total += 1
                buf.append(ev)
        return True

    def clock_sample(self, client: str, *, offset: float,
                     rtt: float) -> None:
        """Feed one skew sample (from a heartbeat echo); the
        minimum-RTT sample seen so far wins."""
        if not isinstance(client, str) or not client or rtt < 0:
            return
        with self._lock:
            sk = self._skew.setdefault(client, ClockSkew())
            sk.samples += 1
            if rtt <= sk.rtt:
                sk.rtt = rtt
                sk.offset = float(offset)

    # -- views -------------------------------------------------------------

    def skew(self, client: str) -> Optional[ClockSkew]:
        with self._lock:
            return self._skew.get(client)

    def offset(self, client: str) -> float:
        """Current best offset to add to ``client``'s timestamps (0.0
        until a skew sample exists)."""
        with self._lock:
            sk = self._skew.get(client)
            return sk.offset if sk is not None and sk.samples else 0.0

    def clients(self) -> List[str]:
        with self._lock:
            return sorted(set(self._series) | set(self._spans))

    def snapshot(self) -> dict:
        """Fleet-wide metrics snapshot: every remote series keyed by
        name, each row carrying its ``client`` label.  Same shape as
        ``MetricsRegistry.snapshot()`` so the two merge trivially."""
        with self._lock:
            names: Dict[str, dict] = {}
            for client in sorted(self._series):
                for name, body in sorted(self._series[client].items()):
                    agg = names.setdefault(
                        name, {"kind": body["kind"], "help": body["help"],
                               "values": []})
                    if agg["kind"] == body["kind"]:
                        agg["values"].extend(body["values"])
                    else:
                        self.series_dropped += len(body["values"])
            return names

    def remote_events(self, *, corrected: bool = True) -> List[dict]:
        """Every buffered remote span, skew-corrected to server time
        (``corrected=False`` returns raw client timestamps), async ids
        renumbered clear of the server tracer's, in deterministic
        (client, arrival) order."""
        with self._lock:
            clients = sorted(self._spans)
            bufs = {c: list(self._spans[c]) for c in clients}
            offs = {c: (self._skew[c].offset
                        if c in self._skew and self._skew[c].samples
                        else 0.0)
                    for c in clients}
        out: List[dict] = []
        id_map: Dict[tuple, int] = {}
        for c in clients:
            off = offs[c] if corrected else 0.0
            for ev in bufs[c]:
                ev = dict(ev)
                ev["ts"] = ev["ts"] + off
                if "id" in ev:
                    key = (c, ev["id"])
                    if key not in id_map:
                        id_map[key] = _REMOTE_ID_BASE + len(id_map)
                    ev["id"] = id_map[key]
                out.append(ev)
        return out

    # -- export ------------------------------------------------------------

    def merged_events(self) -> List[dict]:
        """Server tracer events followed by skew-corrected remote
        events — the one-timeline view of a federated round."""
        local = self.tracer.events() if self.tracer is not None else []
        return local + self.remote_events()

    def chrome_trace(self) -> dict:
        return render_chrome_trace(self.merged_events(),
                                   process_name="sashimi-fleet")

    def to_json(self) -> str:
        """Deterministic serialization (same-seed virtual-clock runs
        compare byte-equal, exactly like ``Tracer.to_json``)."""
        return json.dumps(self.chrome_trace(), sort_keys=True,
                          separators=(",", ":"))

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json())

    def stats(self) -> dict:
        with self._lock:
            return {
                "clients": len(set(self._series) | set(self._spans)),
                "batches_total": self.batches_total,
                "batches_dropped": self.batches_dropped,
                "spans_total": self.spans_total,
                "spans_dropped": self.spans_dropped,
                "series_dropped": self.series_dropped,
                "remote_dropped": self.remote_dropped,
                "parse_dropped": self.parse_dropped,
                "skew_samples": sum(s.samples
                                    for s in self._skew.values()),
            }
