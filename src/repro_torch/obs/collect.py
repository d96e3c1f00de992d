"""Collectors: map the fabric's legacy telemetry into a
:class:`~repro.obs.metrics.MetricsRegistry`.

Every subsystem grown across PRs 2-6 kept its own ad-hoc counters
(``EdgeCache`` hit/miss/eviction counts, the origin's ``download_count``
ledger, ``FederationMember.steals``, the transport's per-message-type
frame accounting, the ticket queue's EWMA client rates).  These
collectors absorb them into one registry at snapshot time — the legacy
counters stay the source of truth (cheap, lock-local, always on), and
the registry is a *view* refreshed by calling a collector.  That keeps
the differential test trivial: registry value == legacy counter, always.

Cumulative legacy counts land via :meth:`Counter.set_total` (idempotent
re-collection — calling a collector twice doesn't double-count);
point-in-time values land in gauges.

Entry point::

    reg = MetricsRegistry()
    collect_fabric(reg, distributor=fed, transport=server)
    print(reg.snapshot())
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["collect_origin", "collect_edge", "collect_queue",
           "collect_federation", "collect_transport", "collect_fleet",
           "collect_fabric"]


def collect_origin(reg: MetricsRegistry, origin) -> None:
    """Absorb an ``HttpServerBase`` origin's download/revalidation/delta
    ledgers (keyed by asset key)."""
    dl = reg.counter("origin.downloads_total",
                     "Full payload transfers served by the origin",
                     labels=("key",))
    rv = reg.counter("origin.revalidations_total",
                     "Conditional fetches answered not-modified",
                     labels=("key",))
    de = reg.counter("origin.deltas_total",
                     "Changed-leaves delta payloads served (protocol v2)",
                     labels=("key",))
    for key, n in origin.download_count.items():
        dl.set_total(n, key=key)
    for key, n in origin.revalidation_count.items():
        rv.set_total(n, key=key)
    for key, n in origin.delta_count.items():
        de.set_total(n, key=key)


def collect_edge(reg: MetricsRegistry, edge) -> None:
    """Absorb one :class:`~repro.core.federation.EdgeCache`'s ``stats()``
    (labelled by the edge's name, so a federation's edges coexist)."""
    s = edge.stats()
    cache = s["name"]
    for field, help_ in (("requests", "Client-facing requests at the edge"),
                         ("hits", "Edge cache hits"),
                         ("misses", "Edge cache misses"),
                         ("evictions", "Edge cache LRU evictions"),
                         ("invalidations", "Origin-pushed invalidations"),
                         ("revalidations",
                          "Conditional origin fetches answered 304"),
                         ("deltas", "Delta payloads passed through")):
        reg.counter(f"cache.{field}_total", help_, labels=("cache",)
                    ).set_total(s[field], cache=cache)
    reg.gauge("cache.hit_ratio", "Edge hits / requests",
              labels=("cache",)).set(s["hit_rate"], cache=cache)


def collect_queue(reg: MetricsRegistry, queue) -> None:
    """Absorb a ticket queue's ``snapshot()``: lifecycle counters plus
    per-client EWMA throughput gauges."""
    snap = queue.snapshot()
    reg.gauge("queue.tickets_count",
              "Tickets currently tracked").set(snap["tickets"])
    reg.gauge("queue.waiting_count",
              "Tickets never yet leased").set(snap["waiting"])
    reg.gauge("queue.inflight_count",
              "Tickets leased and incomplete").set(snap["in_flight"])
    reg.counter("queue.executed_total",
                "Tickets completed").set_total(snap["executed"])
    reg.counter("queue.errors_total",
                "Client error reports").set_total(snap["errors"])
    reg.counter("queue.redistributions_total",
                "Ticket re-leases past the first").set_total(
                    snap["redistributions"])
    reg.counter("queue.releases_total",
                "Lease releases (watchdog + voluntary)").set_total(
                    snap["lease_releases"])
    reg.counter("queue.duplicate_results_total",
                "Duplicate submits dropped by first-result-wins"
                ).set_total(snap.get("duplicates", 0))
    rate = reg.gauge("queue.client_rate",
                     "Per-client EWMA tickets/second", labels=("client",))
    for client, cs in snap["clients"].items():
        # rate is None until the EWMA has its first observation
        rate.set(cs["rate"] or 0.0, client=client)


def collect_federation(reg: MetricsRegistry, fed) -> None:
    """Absorb a :class:`~repro.core.federation.FederatedDistributor`:
    per-member steals + liveness, migrations, and every edge cache."""
    steals = reg.counter("federation.steals_total",
                         "Lease grants that reached outside home shards",
                         labels=("member",))
    alive = reg.gauge("federation.alive_count", "Members currently alive")
    reg.counter("federation.migrations_total",
                "Home-shard migrations applied").set_total(fed.migrations)
    for m in fed.members:
        steals.set_total(m.steals, member=m.index)
        collect_edge(reg, m.edge)
    alive.set(len(fed.alive_members()))


def collect_transport(reg: MetricsRegistry, server) -> None:
    """Absorb a :class:`~repro.core.transport.TransportServer`'s
    ``stats()``: totals plus the per-message-type breakdown."""
    s = server.stats()
    reg.gauge("transport.connections_count",
              "Live client connections").set(s["connections"])
    reg.counter("transport.errors_total",
                "Protocol errors raised").set_total(s["protocol_errors"])
    reg.counter("transport.busy_refusals_total",
                "Hellos refused at admission (busy frames sent)"
                ).set_total(s.get("busy_refusals", 0))
    reg.counter("transport.heartbeats_total",
                "Heartbeat frames answered").set_total(
                    s.get("heartbeats", 0))
    reg.counter("transport.evictions_total",
                "Connections evicted for heartbeat silence").set_total(
                    s.get("evictions", 0))
    reg.counter("transport.evicted_leases_total",
                "Leases force-released by eviction").set_total(
                    s.get("evicted_leases", 0))
    reg.counter("transport.telemetry_frames_total",
                "Telemetry batches accepted into the fleet plane"
                ).set_total(s.get("telemetry_accepted", 0))
    reg.counter("transport.telemetry_drops_total",
                "Telemetry batches dropped (malformed, no fleet "
                "aggregator, or v1 sender)").set_total(
                    s.get("telemetry_dropped", 0))
    frames = reg.counter("transport.frames_total",
                         "Wire frames (chunk frames included)",
                         labels=("direction", "type"))
    nbytes = reg.counter("transport.bytes_total", "Wire payload bytes",
                         labels=("direction", "type"))
    chunks = reg.counter("transport.chunks_total",
                         "Binary chunk frames (protocol v2)",
                         labels=("direction",))
    chunks.set_total(s["chunks_in"], direction="in")
    chunks.set_total(s["chunks_out"], direction="out")
    by = s["by_type"]
    for direction in ("in", "out"):
        for kind, n in by[f"frames_{direction}"].items():
            frames.set_total(n, direction=direction, type=kind)
        for kind, n in by[f"bytes_{direction}"].items():
            nbytes.set_total(n, direction=direction, type=kind)


def collect_fleet(reg: MetricsRegistry, fleet) -> None:
    """Absorb a :class:`~repro.obs.fleet.FleetAggregator`'s ``stats()``:
    population, ingested batch/span volume, and every drop category
    (labelled by where the data was lost)."""
    s = fleet.stats()
    reg.gauge("fleet.clients_count",
              "Distinct clients with telemetry state").set(s["clients"])
    reg.counter("fleet.batches_total",
                "Telemetry batches ingested").set_total(s["batches_total"])
    reg.counter("fleet.spans_total",
                "Remote trace events received").set_total(s["spans_total"])
    reg.counter("fleet.skew_samples_total",
                "Clock-skew samples from heartbeat echoes").set_total(
                    s["skew_samples"])
    drops = reg.counter(
        "fleet.drops_total",
        "Telemetry discarded, by where it was lost: whole batches, "
        "span-buffer evictions, malformed series rows, the peer's own "
        "report, or the wire parser", labels=("reason",))
    drops.set_total(s["batches_dropped"], reason="batch")
    drops.set_total(s["spans_dropped"], reason="span_buffer")
    drops.set_total(s["series_dropped"], reason="series")
    drops.set_total(s["remote_dropped"], reason="remote")
    drops.set_total(s["parse_dropped"], reason="parse")


def collect_fabric(reg: MetricsRegistry, *, distributor=None,
                   transport=None, fleet=None) -> MetricsRegistry:
    """One-call collection over whatever the caller has: an
    ``AsyncDistributor`` or ``FederatedDistributor`` (origin + queue,
    plus federation surfaces when present), a ``TransportServer``,
    and/or its ``FleetAggregator``.  Returns the registry for
    chaining."""
    if distributor is not None:
        if hasattr(distributor, "download_count"):
            collect_origin(reg, distributor)
        if hasattr(distributor, "queue"):
            collect_queue(reg, distributor.queue)
        if hasattr(distributor, "members"):
            collect_federation(reg, distributor)
    if transport is not None:
        collect_transport(reg, transport)
        if fleet is None:
            fleet = getattr(transport, "fleet", None)
    if fleet is not None:
        collect_fleet(reg, fleet)
    return reg
