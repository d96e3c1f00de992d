"""Sharded ticket store: the federation fabric's queue-of-queues.

One ``TicketQueue`` behind one lock is the seed's scaling ceiling — every
producer ``add_many`` and every client ``lease``/``submit_batch`` from any
distributor serialises on the same mutex.  :class:`ShardedTicketQueue`
partitions tickets **by task** into per-shard ``TicketQueue``s, each with
its own lock, so traffic for different tasks never contends and a
federation of distributors can drive the same store concurrently.

The paper's §2.1.2 ordering rule survives sharding via a two-step
**peek/checkout min-VCT merge**:

  1. ``peek_eligible`` each candidate shard for its top-k eligible
     ``(virtual_created_time, ticket_id)`` pairs (per-shard lock, held
     briefly);
  2. merge the candidates globally, keep the k smallest, and check the
     winners out of their shards with ``lease_tickets`` under one shared
     **lease id** — so a single lease batch may interleave tickets from
     several shards in exact global ascending-VCT order.

A ticket completed or re-cooled between peek and checkout is skipped by
``lease_tickets`` (another client won the race); the global order degrades
gracefully under contention and is *exact* when operations are serialised
(property-tested against a single ``TicketQueue`` in
``tests/test_shards.py``).

Global invariants the sharded store maintains on top of its shards:

  * **ticket ids** come from one shared counter, so they are globally
    unique and assigned in arrival order (VCT ties break identically to
    the single-queue case);
  * **lease ids** come from one shared counter; a cross-shard lease uses
    the same id in every member shard, and the store keeps the global
    ``LeaseBatch`` plus the set of shards it touched for routing;
  * **client stats** (EWMA rate, lease/failure counts) are booked exactly
    once at the global level — member shards are told ``observe=False`` so
    a lease spanning three shards still folds ONE (work, duration) sample
    into the client's rate.

Lock order: the store's small ``_meta_lock`` (routing tables) may be held
while taking a shard lock, never the reverse — shards know nothing about
the store, so no cycle is possible.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
import zlib
import collections
from typing import Any, Callable, Optional

from repro_torch.core.tickets import ClientStats, LeaseBatch, Ticket, TicketQueue


def shard_index(task_name: str, n_shards: int) -> int:
    """Stable task → shard mapping (crc32, not ``hash``: Python salts
    string hashes per process, and shard placement must agree between a
    producer and a distributor restarted later)."""
    return zlib.crc32(task_name.encode()) % n_shards


class ShardedTicketQueue:
    """Drop-in ``TicketQueue`` replacement partitioned by task.

    Duck-type compatible with the surface ``AsyncDistributor`` and
    ``SplitConcurrentDispatcher`` use (``add_many`` / ``lease`` /
    ``submit_batch`` / ``release`` / ``results_for`` / ``prune`` /
    ``snapshot`` / ...), plus a ``shards=`` hint on :meth:`lease` so a
    federation member can prefer its *home* shards and steal from the rest
    only when home runs dry.
    """

    def __init__(self, n_shards: int = 4, *, timeout: float = 300.0,
                 redistribute_min: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 tracer=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        self.timeout = timeout
        self.redistribute_min = redistribute_min
        self.clock = clock
        # shards share the store's tracer for per-ticket lifecycle spans;
        # cross-shard leases are traced once here (shards are checked out
        # with observe=False, which also skips their per-shard lease span)
        self.tracer = tracer
        self._lease_spans: dict[int, int] = {}    # guarded by _meta_lock
        self.shards: list[TicketQueue] = [
            TicketQueue(timeout=timeout, redistribute_min=redistribute_min,
                        clock=clock, tracer=tracer)
            for _ in range(n_shards)]
        # one id stream across shards: globally unique, arrival-ordered
        # (itertools.count.__next__ is atomic under the GIL)
        shared_ids = itertools.count()
        for sh in self.shards:
            sh._ids = shared_ids
        self._lease_ids = itertools.count()
        self._meta_lock = threading.Lock()
        self._ticket_shard: dict[int, TicketQueue] = {}
        # global lease routing: lease_id -> (batch, shards it touched)
        self._leases: dict[int, tuple[LeaseBatch, list[TicketQueue]]] = {}
        self._released_leases: "collections.OrderedDict[int, LeaseBatch]" = \
            collections.OrderedDict()
        self._stats_lock = threading.Lock()
        self.stats: dict[str, ClientStats] = {}
        self.releases = 0

    # -- routing --------------------------------------------------------------

    def shard_for(self, task_name: str) -> TicketQueue:
        """The shard that owns ``task_name``'s tickets."""
        return self.shards[shard_index(task_name, self.n_shards)]

    def _route_results(self, results: dict) -> dict:
        """Group a {ticket_id: result} dict by owning shard (unknown ids —
        already pruned — are dropped, matching TicketQueue.submit)."""
        by_shard: dict[int, tuple[TicketQueue, dict]] = {}
        with self._meta_lock:
            for tid, r in results.items():
                sh = self._ticket_shard.get(tid)
                if sh is not None:
                    by_shard.setdefault(id(sh), (sh, {}))[1][tid] = r
        return by_shard

    # -- producer side --------------------------------------------------------

    def add(self, task_name: str, args: Any, *, work: float = 1.0,
            task_version: int = 0, shard: Optional[int] = None) -> int:
        """Enqueue one ticket on its task's shard (or an explicit
        ``shard`` index — see :meth:`add_many`); returns its id."""
        sh = (self.shard_for(task_name) if shard is None
              else self.shards[shard])
        tid = sh.add(task_name, args, work=work, task_version=task_version)
        with self._meta_lock:
            self._ticket_shard[tid] = sh
        if self.tracer is not None:
            self.tracer.instant(
                "ticket.route", track="queue", cat="ticket",
                ts=self.clock(),
                args={"shard": self.shards.index(sh), "tickets": 1,
                      "task": task_name})
        return tid

    def add_many(self, task_name: str, args_list, *, work=1.0,
                 task_version: int = 0,
                 shard: Optional[int] = None) -> list[int]:
        """Bulk-enqueue on the owning shard (one shard lock acquisition;
        producers for different tasks don't contend at all).

        ``shard`` overrides the task-name hash with an explicit shard
        index — the training fabric uses it to spread one task's round of
        tickets across the federation members' *home* shards (per-member
        shard affinity), so each member serves its slice from its own
        locks instead of stealing everything from one hot shard.  All
        downstream routing (submit / results / prune) follows the
        per-ticket table, so placement is free to differ per round."""
        sh = (self.shard_for(task_name) if shard is None
              else self.shards[shard])
        tids = sh.add_many(task_name, args_list, work=work,
                           task_version=task_version)
        with self._meta_lock:
            for tid in tids:
                self._ticket_shard[tid] = sh
        if self.tracer is not None and tids:
            self.tracer.instant(
                "ticket.route", track="queue", cat="ticket",
                ts=self.clock(),
                args={"shard": self.shards.index(sh), "tickets": len(tids),
                      "task": task_name})
        return tids

    # -- client side: batched leases ------------------------------------------

    def lease(self, client: str, max_tickets: int = 1,
              *, expected_duration: Optional[float] = None,
              shards: Optional[list[TicketQueue]] = None
              ) -> Optional[LeaseBatch]:
        """Check out up to ``max_tickets`` tickets in global ascending-VCT
        order, merged across ``shards`` (default: all of them).

        A federation member passes its home shards here and falls back to
        the full set to steal (see ``federation.FederationMember``)."""
        now = self.clock()
        pool = self.shards if shards is None else shards
        # step 1: peek each shard's top-k (brief per-shard locks)
        candidates: list[tuple[float, int, TicketQueue]] = []
        for sh in pool:
            candidates.extend(
                (vct, tid, sh)
                for vct, tid in sh.peek_eligible(max_tickets, now=now))
        if not candidates:
            return None
        picked = heapq.nsmallest(max_tickets, candidates,
                                 key=lambda c: c[:2])
        # step 2: check the winners out shard by shard under ONE lease id
        lease_id = next(self._lease_ids)
        per_shard: dict[int, tuple[TicketQueue, list[int]]] = {}
        for _, tid, sh in picked:
            per_shard.setdefault(id(sh), (sh, []))[1].append(tid)
        granted: dict[int, Ticket] = {}
        touched: list[TicketQueue] = []
        for sh, tids in per_shard.values():
            sub = sh.lease_tickets(client, tids, lease_id=lease_id, now=now,
                                   observe=False)
            if sub is not None:
                touched.append(sh)
                granted.update((t.ticket_id, t) for t in sub.tickets)
        if not granted:
            return None          # lost every race between peek and checkout
        # assemble client-side copies in the merged global order
        copies = [granted[tid] for _, tid, _ in picked if tid in granted]
        batch = LeaseBatch(lease_id, client, copies, now,
                           expected_duration=expected_duration,
                           shards=touched)
        with self._meta_lock:
            self._leases[lease_id] = (batch, touched)
            if self.tracer is not None:
                self._lease_spans[lease_id] = self.tracer.begin(
                    "lease", track="queue", cat="lease", ts=now,
                    args={"lease": lease_id, "client": client,
                          "tickets": len(copies), "shards": len(touched)})
        with self._stats_lock:
            self.stats.setdefault(client, ClientStats(client)).leases += 1
        return batch

    def submit_batch(self, lease_id: int, results: dict,
                     client: str = "?") -> int:
        """Record a lease's results, routing each ticket to its shard;
        folds ONE EWMA sample (total accepted work over the lease's full
        duration) into the client's global stats."""
        now = self.clock()
        with self._meta_lock:
            entry = self._leases.get(lease_id)
            batch = (entry[0] if entry is not None
                     else self._released_leases.pop(lease_id, None))
        accepted = 0
        accepted_work = 0.0
        for sh, sub in self._route_results(results).values():
            a, w = sh.submit_batch_ex(lease_id, sub, client, observe=False)
            accepted += a
            accepted_work += w
        if accepted and batch is not None:
            with self._stats_lock:
                self.stats.setdefault(client, ClientStats(client)).observe(
                    accepted_work, now - batch.issued_at, tickets=accepted)
        self._gc_lease(lease_id)
        # a redistributed ticket can sit in several leases: this submit
        # may have drained OTHER leases' last outstanding tickets at the
        # shard level — sweep them too, so their store records don't
        # linger for the watchdog (the per-shard GC already ran)
        with self._meta_lock:
            others = [lid for lid in self._leases if lid != lease_id]
        for lid in others:
            self._gc_lease(lid)
        return accepted

    def _gc_lease(self, lease_id: int):
        """Drop the global lease record once no member shard still holds
        outstanding tickets for it (mirrors TicketQueue's per-shard GC,
        so the watchdog never sees a fully-drained lease)."""
        with self._meta_lock:
            entry = self._leases.get(lease_id)
            if entry is None:
                return
            batch, touched = entry
            if not any(sh.lease_is_outstanding(lease_id) for sh in touched):
                del self._leases[lease_id]
                if self.tracer is not None:
                    self.tracer.end(self._lease_spans.pop(lease_id, None),
                                    ts=self.clock(),
                                    args={"status": "drained"})

    def release(self, lease_id: int, *, client_failed: bool = False,
                reset_vct: bool = True) -> int:
        """Return a lease's unfinished tickets across every shard it
        touched (member died / watchdog overrun); global failure and
        release counters are booked once, not once per shard."""
        with self._meta_lock:
            entry = self._leases.pop(lease_id, None)
            if entry is not None:
                # park the batch for late submits IN the same critical
                # section as the pop — a concurrent submit_batch must
                # always find the batch in one of the two tables, or its
                # EWMA observation would be silently skipped
                self._released_leases[lease_id] = entry[0]
                while len(self._released_leases) > 256:
                    self._released_leases.popitem(last=False)
                if self.tracer is not None:
                    self.tracer.end(self._lease_spans.pop(lease_id, None),
                                    ts=self.clock(),
                                    args={"status": "released",
                                          "client_failed": client_failed,
                                          "reset_vct": reset_vct})
        if entry is None:
            return 0
        batch, touched = entry
        released = sum(
            sh.release(lease_id, client_failed=False, reset_vct=reset_vct)
            for sh in touched)
        with self._stats_lock:
            if released:
                self.releases += 1
            if client_failed:
                self.stats.setdefault(
                    batch.client, ClientStats(batch.client)).failures += 1
        return released

    # -- client side: v1 single-ticket API ------------------------------------

    def request(self) -> Optional[Ticket]:
        """v1 compat: hand out the single globally-min-VCT ticket."""
        now = self.clock()
        best = min((c for sh in self.shards
                    for c in ((vct, tid, sh) for vct, tid
                              in sh.peek_eligible(1, now=now))),
                   default=None, key=lambda c: c[:2])
        if best is None:
            return None
        return best[2].request()

    def submit(self, ticket_id: int, result: Any, client: str = "?") -> bool:
        """v1 compat: route a single result to its shard."""
        with self._meta_lock:
            sh = self._ticket_shard.get(ticket_id)
        return sh.submit(ticket_id, result, client) if sh else False

    # -- scheduler support -----------------------------------------------------

    def seconds_until_eligible(self) -> Optional[float]:
        """Minimum over shards: time until ANY cool-down expires."""
        best = None
        for sh in self.shards:
            r = sh.seconds_until_eligible()
            if r is None:
                continue
            if r <= 0:
                return 0.0
            if best is None or r < best:
                best = r
        return best

    def outstanding_leases(self) -> list[LeaseBatch]:
        """Global leases with at least one unfinished ticket in some shard
        (the federation members' shared watchdog input)."""
        with self._meta_lock:
            entries = list(self._leases.values())
        return [batch for batch, touched in entries
                if any(sh.lease_is_outstanding(batch.lease_id)
                       for sh in touched)]

    def results_for(self, ticket_ids) -> Optional[list]:
        """Results for exactly ``ticket_ids`` in order, or None if any is
        unfinished (routes each id to its shard)."""
        out = []
        with self._meta_lock:
            shards = [self._ticket_shard.get(tid) for tid in ticket_ids]
        for tid, sh in zip(ticket_ids, shards):
            if sh is None:
                return None
            got = sh.results_for([tid])
            if got is None:
                return None
            out.append(got[0])
        return out

    def prune(self, ticket_ids) -> int:
        """Forget completed tickets and their shard-routing entries.

        Three lock acquisitions total (route, per-shard prune, routing
        cleanup) — NOT one ``_meta_lock`` round per ticket, which made
        pruning a long round O(n) lock traffic."""
        pruned: list = []
        for sh, tids in self._route_ids(ticket_ids):
            pruned.extend(sh.prune_ex(tids))
        if pruned:
            with self._meta_lock:
                for tid in pruned:
                    self._ticket_shard.pop(tid, None)
        return len(pruned)

    def _route_ids(self, ticket_ids) -> list[tuple[TicketQueue, list]]:
        """Group ticket ids by owning shard (one ``_meta_lock``
        acquisition; unknown — already pruned — ids are dropped)."""
        with self._meta_lock:
            routed = [(tid, self._ticket_shard.get(tid))
                      for tid in ticket_ids]
        by_shard: dict[int, tuple[TicketQueue, list]] = {}
        for tid, sh in routed:
            if sh is not None:
                by_shard.setdefault(id(sh), (sh, []))[1].append(tid)
        return list(by_shard.values())

    def cancel(self, ticket_ids) -> int:
        """Force-complete tickets with the CANCELLED sentinel, routed to
        their owning shards (the K-of-N barrier's fold path)."""
        n = sum(sh.cancel(tids) for sh, tids in self._route_ids(ticket_ids))
        if n:
            # GC global lease records fully drained by the cancellations:
            # a dead client's never-submitted lease would otherwise leak
            # its _leases entry forever (no watchdog patrols a lease with
            # no outstanding tickets, and no submit runs _gc_lease)
            with self._meta_lock:
                drained = [
                    lid for lid, (_, touched) in self._leases.items()
                    if not any(sh.lease_is_outstanding(lid)
                               for sh in touched)]
                for lid in drained:
                    del self._leases[lid]
                    if self.tracer is not None:
                        self.tracer.end(self._lease_spans.pop(lid, None),
                                        ts=self.clock(),
                                        args={"status": "drained"})
        return n

    def completed_results(self, ticket_ids) -> dict:
        """{ticket_id: result} for the already-completed subset (partial-
        progress probe for round barriers; routes each id to its shard)."""
        out: dict = {}
        for sh, tids in self._route_ids(ticket_ids):
            out.update(sh.completed_results(tids))
        return out

    def report_error(self, ticket_id: int, error: str, client: str = "?"):
        """Route an error report to the owning shard."""
        with self._meta_lock:
            sh = self._ticket_shard.get(ticket_id)
        if sh is not None:
            sh.report_error(ticket_id, error, client)

    # -- introspection ---------------------------------------------------------

    def all_done(self) -> bool:
        """True when every shard's every ticket has a result."""
        return all(sh.all_done() for sh in self.shards)

    def wait_all(self, timeout: Optional[float] = None) -> bool:
        """Block until every shard drains (or ``timeout`` elapses)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for sh in self.shards:
            remaining = (None if deadline is None
                         else max(deadline - time.monotonic(), 0.0))
            if not sh.wait_all(remaining):
                return False
        return True

    def results(self) -> dict[int, Any]:
        """{ticket_id: result} merged across shards."""
        out: dict[int, Any] = {}
        for sh in self.shards:
            out.update(sh.results())
        return out

    def snapshot(self) -> dict:
        """Control-console counters summed over shards, with global client
        stats and a per-shard breakdown."""
        shard_snaps = [sh.snapshot() for sh in self.shards]
        summed = {k: sum(s[k] for s in shard_snaps)
                  for k in ("tickets", "waiting", "in_flight", "executed",
                            "errors", "redistributions", "duplicates")}
        with self._stats_lock:
            summed["lease_releases"] = self.releases
            summed["clients"] = {
                name: {"rate": s.rate, "leases": s.leases,
                       "completed": s.completed_tickets,
                       "failures": s.failures}
                for name, s in self.stats.items()}
        summed["shards"] = [
            {"tickets": s["tickets"], "waiting": s["waiting"],
             "in_flight": s["in_flight"], "executed": s["executed"]}
            for s in shard_snaps]
        return summed
