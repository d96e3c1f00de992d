"""The Sashimi ticket queue — the paper's §2.1.2 algorithm, extended.

Tickets are served in ascending **virtual created time** (VCT):

  * an undistributed ticket's VCT is its creation time;
  * once distributed, its VCT becomes ``last_distributed_at + timeout``
    (paper: five minutes) — i.e. if no result arrives within the timeout the
    ticket sorts as if re-created and another client picks it up;
  * when no fresh tickets remain, distributed-but-unfinished tickets are
    *redistributed* in ascending last-distribution order, but never more
    often than ``redistribute_min`` (paper: ten seconds) per ticket — this
    prevents the last ticket from stampeding to every idle client.

The first result submitted for a ticket wins; duplicates are dropped.

Beyond the paper (Distributor v2 substrate), the queue also supports:

  * **lease batches** (`lease` / `submit_batch` / `release`): a client
    checks out up to N tickets in one round-trip.  Each batch gets a lease
    id; releasing a lease (client died, watchdog fired) resets its
    unfinished tickets so they sort as freshly created — *proactive*
    redistribution instead of waiting out the full timeout.
  * **client-speed metadata** (`ClientStats`): an EWMA of completed work
    per second per client, updated on every batch submit.  The scheduler
    uses it to size the next lease (slow clients get smaller shards).

Thread-safe; the clock is injectable so tests can run timeouts in
milliseconds (see ``docs/ARCHITECTURE.md`` §Injectable clock).
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
import collections
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.core.wire import ProtocolError


class _Cancelled:
    """Sentinel result for tickets force-completed by a barrier fold (the
    K-of-N straggler path): the round closed without them, so they must
    drain from the queue's bookkeeping without a real result."""

    def __repr__(self):
        return "<cancelled>"


#: The result recorded for a cancelled ticket (see TicketQueue.cancel).
CANCELLED = _Cancelled()


@dataclass
class Ticket:
    """One unit of distributable work (paper §2.1.1: a slice of a Task's
    arguments).  ``work`` is the nominal size of the slice in abstract work
    units; the adaptive scheduler uses it to meter client throughput."""

    ticket_id: int
    task_name: str
    args: Any
    created_at: float
    work: float = 1.0
    distribute_count: int = 0
    last_distributed_at: float = -float("inf")
    completed: bool = False
    result: Any = None
    completed_by: Optional[str] = None
    error_reports: list = field(default_factory=list)
    lease_id: Optional[int] = None
    # registry coherence version pinned at creation (see
    # HttpServerBase.task_version): a client executing this ticket must
    # hold task code + statics validated at >= this version, or
    # revalidate its cache first.  0 = unversioned (queue used directly,
    # without a registry — the seed behaviour).
    task_version: int = 0

    def virtual_created_time(self, timeout: float) -> float:
        """The paper's ordering key: creation time while fresh, then
        ``last_distributed_at + timeout`` once handed out."""
        if self.distribute_count == 0:
            return self.created_at
        return self.last_distributed_at + timeout

    def _copy_for_client(self) -> "Ticket":
        return Ticket(self.ticket_id, self.task_name, self.args,
                      self.created_at, self.work, self.distribute_count,
                      self.last_distributed_at, lease_id=self.lease_id,
                      task_version=self.task_version)

    # -- wire codec (docs/PROTOCOL.md) ---------------------------------------
    # Scheduling state (created_at / last_distributed_at / distribute_count)
    # is meaningful only on the distributor's clock and never crosses the
    # wire; a remote client needs exactly what it takes to execute the
    # ticket and submit its result.

    def to_wire(self, encode_args: Callable[[Any], Any]) -> dict:
        """The ticket as a JSON-safe dict for the transport layer.
        ``encode_args`` serialises ``args`` (opaque payload codec)."""
        return {"ticket_id": self.ticket_id, "task_name": self.task_name,
                "args": encode_args(self.args), "work": self.work,
                "task_version": self.task_version,
                "lease_id": self.lease_id}

    @classmethod
    def from_wire(cls, d: dict,
                  decode_args: Callable[[Any], Any]) -> "Ticket":
        """Rebuild a client-side ticket from its wire dict (inverse of
        :meth:`to_wire`; server-only scheduling fields default to zero).

        Wire dicts come from an untrusted peer: missing or mistyped
        fields raise ``ProtocolError("bad-message")`` instead of leaking
        KeyError/TypeError into the request loop."""
        if not isinstance(d, dict):
            raise ProtocolError("bad-message", "ticket must be an object")
        ticket_id = d.get("ticket_id")
        task_name = d.get("task_name")
        work = d.get("work")
        task_version = d.get("task_version", 0)
        if (not isinstance(ticket_id, int) or isinstance(ticket_id, bool)
                or not isinstance(task_name, str)
                or not isinstance(work, (int, float))
                or isinstance(work, bool)
                or not isinstance(task_version, int)
                or isinstance(task_version, bool)
                or "args" not in d):
            raise ProtocolError("bad-message",
                                f"malformed ticket fields: "
                                f"{sorted(d.keys())}")
        return cls(ticket_id, task_name, decode_args(d["args"]),
                   created_at=0.0, work=float(work),
                   lease_id=d.get("lease_id"),
                   task_version=task_version)


@dataclass
class ClientStats:
    """Per-client throughput metadata (Distributor v2).

    ``rate`` is an exponentially-weighted moving average of completed work
    units per second.  ``rate is None`` until the first observation — the
    scheduler treats unknown clients conservatively (probe lease).
    """

    name: str
    rate: Optional[float] = None      # EWMA work units / second
    alpha: float = 0.3                # EWMA smoothing factor
    completed_work: float = 0.0
    completed_tickets: int = 0
    leases: int = 0
    failures: int = 0

    def observe(self, work: float, duration: float, tickets: int = 1):
        """Fold one completed lease (``tickets`` tickets totalling ``work``
        units, finished in ``duration`` s) into the EWMA."""
        duration = max(duration, 1e-9)
        sample = work / duration
        self.rate = (sample if self.rate is None
                     else self.alpha * sample + (1 - self.alpha) * self.rate)
        self.completed_work += work
        self.completed_tickets += tickets

    @property
    def mean_ticket_work(self) -> float:
        """Average work units per completed ticket (1.0 until measured);
        converts the work-rate EWMA into ticket counts and back."""
        if self.completed_tickets <= 0:
            return 1.0
        return self.completed_work / self.completed_tickets


@dataclass
class LeaseBatch:
    """A batch of tickets checked out by one client in one round-trip."""

    lease_id: int
    client: str
    tickets: list                     # list[Ticket] (client-side copies)
    issued_at: float
    expected_duration: Optional[float] = None   # scheduler's ETA (watchdog)
    # shards the grant actually touched (set by ShardedTicketQueue.lease;
    # None for a plain TicketQueue).  A federation member uses it to count
    # a steal only when the batch really contains foreign-shard tickets.
    shards: Optional[list] = None

    @property
    def work(self) -> float:
        """Total work units in the batch (EWMA denominator)."""
        return sum(t.work for t in self.tickets)

    @property
    def ticket_ids(self) -> list:
        """Ids of the batched tickets, in lease order."""
        return [t.ticket_id for t in self.tickets]

    # -- wire codec (docs/PROTOCOL.md) ---------------------------------------

    def to_wire(self, encode_args) -> dict:
        """The lease as a JSON-safe ``lease_grant`` body: lease id, client,
        and the tickets' wire dicts.  ``issued_at``, ``expected_duration``
        and ``shards`` are distributor-side scheduling state and stay off
        the wire."""
        return {"lease_id": self.lease_id, "client": self.client,
                "tickets": [t.to_wire(encode_args) for t in self.tickets]}

    @classmethod
    def from_wire(cls, d: dict, decode_args) -> "LeaseBatch":
        """Rebuild a client-side lease from its wire dict (inverse of
        :meth:`to_wire`).  Malformed grants from an untrusted peer raise
        ``ProtocolError("bad-message")``, not bare KeyError/TypeError."""
        if not isinstance(d, dict):
            raise ProtocolError("bad-message",
                                "lease grant must be an object")
        lease_id = d.get("lease_id")
        client = d.get("client")
        tickets = d.get("tickets")
        if (not isinstance(lease_id, int) or isinstance(lease_id, bool)
                or not isinstance(client, str)
                or not isinstance(tickets, list)):
            raise ProtocolError("bad-message",
                                f"malformed lease grant fields: "
                                f"{sorted(d.keys())}")
        return cls(lease_id, client,
                   [Ticket.from_wire(t, decode_args) for t in tickets],
                   issued_at=0.0)


class TicketQueue:
    """Thread-safe VCT-ordered ticket store shared by Distributor v1/v2.

    Producer side: :meth:`add` / :meth:`add_many`.
    Client side (v1): :meth:`request` / :meth:`submit`.
    Client side (v2): :meth:`lease` / :meth:`submit_batch` / :meth:`release`.
    """

    def __init__(self, *, timeout: float = 300.0,
                 redistribute_min: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 tracer=None):
        self.timeout = timeout
        self.redistribute_min = redistribute_min
        self.clock = clock
        # optional repro.obs Tracer; every site below guards on
        # ``is not None`` so the disabled path costs one attribute check
        self.tracer = tracer
        self._ticket_spans: dict[int, int] = {}   # ticket_id -> span id
        self._lease_spans: dict[int, int] = {}    # lease_id -> span id
        self._lock = threading.Lock()
        self._tickets: dict[int, Ticket] = {}
        self._ids = itertools.count()
        self._lease_ids = itertools.count()
        self._leases: dict[int, LeaseBatch] = {}
        self._lease_outstanding: dict[int, set] = {}
        self._ticket_leases: dict[int, set] = {}   # reverse index
        # released leases kept (bounded) so a LATE submit from a
        # slower-than-expected client still calibrates its EWMA
        self._released_leases: "collections.OrderedDict[int, LeaseBatch]" = \
            collections.OrderedDict()
        self.stats: dict[str, ClientStats] = {}
        self.releases = 0
        # submits for an already-completed ticket (racing redistributed
        # leases; first result won) — dropped, but counted so the SLO
        # "zero duplicated results reach training math" is checkable
        self.duplicates = 0
        self._incomplete = 0      # live not-yet-completed ticket count
        self._done = threading.Event()
        self._done.set()

    # -- producer side ------------------------------------------------------

    def add(self, task_name: str, args: Any, *, work: float = 1.0,
            task_version: int = 0) -> int:
        """Enqueue one ticket; returns its id.  ``task_version`` pins the
        registry coherence version the ticket was created against (0 when
        the queue is used without a registry)."""
        with self._lock:
            now = self.clock()
            tid = next(self._ids)
            self._tickets[tid] = Ticket(tid, task_name, args, now,
                                        work=work, task_version=task_version)
            self._incomplete += 1
            self._done.clear()
            if self.tracer is not None:
                self._ticket_spans[tid] = self.tracer.begin(
                    "ticket", track="queue", cat="ticket", ts=now,
                    args={"ticket": tid, "task": task_name})
            return tid

    def add_many(self, task_name: str, args_list, *,
                 work=1.0, task_version: int = 0) -> list[int]:
        """Enqueue one ticket per element of ``args_list``; ``work`` is a
        scalar applied to all, or a per-ticket sequence.

        One locked bulk insert — the whole batch lands atomically, so a
        consumer can never lease the front of a batch while a producer is
        still appending its tail."""
        args_list = list(args_list)
        works = (list(work) if isinstance(work, (list, tuple))
                 else [work] * len(args_list))
        if not args_list:
            return []
        with self._lock:
            now = self.clock()
            tids = []
            for a, w in zip(args_list, works):
                tid = next(self._ids)
                self._tickets[tid] = Ticket(tid, task_name, a, now, work=w,
                                            task_version=task_version)
                tids.append(tid)
            if self.tracer is not None:
                self._ticket_spans.update(zip(tids, self.tracer.begin_many(
                    "ticket", [{"ticket": t, "task": task_name}
                               for t in tids],
                    track="queue", cat="ticket", ts=now)))
            self._incomplete += len(tids)
            self._done.clear()
            return tids

    # -- selection core ------------------------------------------------------

    def _eligible_sorted(self, now: float, limit: int) -> list[Ticket]:
        """Up to ``limit`` eligible tickets in ascending-VCT order.

        Caller must hold the lock.  Eligibility follows the paper: not
        completed, and either never distributed or last distributed at least
        ``redistribute_min`` seconds ago."""
        eligible = (
            (t.virtual_created_time(self.timeout), t.ticket_id, t)
            for t in self._tickets.values()
            if not t.completed
            and (t.distribute_count == 0
                 or now - t.last_distributed_at >= self.redistribute_min))
        if limit == 1:                       # v1 hot path: single min scan
            best = min(eligible, default=None)
            return [best[2]] if best is not None else []
        return [t for _, _, t in heapq.nsmallest(limit, eligible)]

    def peek_eligible(self, limit: int,
                      now: Optional[float] = None) -> list[tuple]:
        """Up to ``limit`` eligible tickets as ``(vct, ticket_id)`` pairs in
        ascending-VCT order, *without* checking anything out.

        The queue-of-queues merge (``ShardedTicketQueue``) peeks every
        shard's head, merges globally, and then checks out the winners with
        :meth:`lease_tickets` — the two-step protocol that preserves the
        paper's global ascending-VCT rule across shards."""
        if now is None:
            now = self.clock()
        with self._lock:
            return [(t.virtual_created_time(self.timeout), t.ticket_id)
                    for t in self._eligible_sorted(now, limit)]

    # -- distributor side, v1 single-ticket API ------------------------------

    def request(self) -> Optional[Ticket]:
        """Hand out the next ticket by ascending VCT (the paper's SQL
        query).  Returns a client-side copy, or None if nothing is
        currently eligible."""
        now = self.clock()
        with self._lock:
            best = next(iter(self._eligible_sorted(now, 1)), None)
            if best is None:
                return None
            best.distribute_count += 1
            best.last_distributed_at = now
            return best._copy_for_client()

    def submit(self, ticket_id: int, result: Any, client: str = "?") -> bool:
        """Record a result; returns False for duplicates/unknown tickets."""
        with self._lock:
            return self._submit_locked(ticket_id, result, client)

    def _submit_locked(self, ticket_id: int, result: Any,
                       client: str) -> bool:
        t = self._tickets.get(ticket_id)
        if t is None or t.completed:
            if t is not None:
                self.duplicates += 1
            return False
        t.completed = True
        t.result = result
        t.completed_by = client
        # Drop the ticket from every lease still tracking it (a ticket can
        # sit in several leases after redistribution; the reverse index
        # makes this O(leases holding THIS ticket), almost always 1); GC
        # drained leases so the watchdog never "releases" a lease of
        # completed tickets.
        drained = []
        for lid in self._ticket_leases.pop(ticket_id, ()):
            outstanding = self._lease_outstanding.get(lid)
            if outstanding is None:
                continue
            outstanding.discard(ticket_id)
            if not outstanding:
                self._lease_outstanding.pop(lid, None)
                self._leases.pop(lid, None)
                drained.append(lid)
        self._incomplete -= 1      # O(1) done check (no full-queue scan)
        if self._incomplete == 0:
            self._done.set()
        if self.tracer is not None:
            now = self.clock()
            self.tracer.end(
                self._ticket_spans.pop(ticket_id, None), ts=now,
                args={"status": ("cancelled" if result is CANCELLED
                                 else "ok"),
                      "client": client})
            for lid in drained:
                self.tracer.end(self._lease_spans.pop(lid, None), ts=now,
                                args={"status": "drained"})
        return True

    # -- distributor side, v2 batched-lease API ------------------------------

    def lease(self, client: str, max_tickets: int = 1,
              *, expected_duration: Optional[float] = None
              ) -> Optional[LeaseBatch]:
        """Check out up to ``max_tickets`` tickets (ascending VCT) as one
        lease.  Returns None when nothing is eligible right now."""
        now = self.clock()
        with self._lock:
            picked = self._eligible_sorted(now, max_tickets)
            if not picked:
                return None
            return self._checkout_locked(picked, client,
                                         next(self._lease_ids), now,
                                         expected_duration, observe=True)

    def _checkout_locked(self, picked: list[Ticket], client: str,
                         lease_id: int, now: float,
                         expected_duration: Optional[float],
                         observe: bool) -> LeaseBatch:
        """Hand out ``picked`` tickets as one lease (caller holds the lock).
        ``observe=False`` skips the per-client lease counter — the sharded
        queue books stats once globally, not once per member shard."""
        copies = []
        for t in picked:
            t.distribute_count += 1
            t.last_distributed_at = now
            t.lease_id = lease_id
            self._ticket_leases.setdefault(t.ticket_id, set()).add(lease_id)
            copies.append(t._copy_for_client())
        batch = LeaseBatch(lease_id, client, copies, now,
                           expected_duration=expected_duration)
        self._leases[lease_id] = batch
        self._lease_outstanding[lease_id] = {t.ticket_id for t in picked}
        if observe:
            self.stats.setdefault(client, ClientStats(client)).leases += 1
            # the sharded store (observe=False per member shard) traces
            # its cross-shard lease once at store level instead
            if self.tracer is not None:
                self._lease_spans[lease_id] = self.tracer.begin(
                    "lease", track="queue", cat="lease", ts=now,
                    args={"lease": lease_id, "client": client,
                          "tickets": len(picked)})
        return batch

    def lease_tickets(self, client: str, ticket_ids, *, lease_id: int,
                      now: Optional[float] = None,
                      expected_duration: Optional[float] = None,
                      observe: bool = True) -> Optional[LeaseBatch]:
        """Check out *specific* tickets (by id) under an externally supplied
        ``lease_id`` — the sharded queue's half of the peek/checkout
        protocol.  Tickets that have meanwhile completed or slipped back
        into their cool-down are silently skipped (another client raced us
        between peek and checkout); returns None when nothing survives."""
        if now is None:
            now = self.clock()
        with self._lock:
            picked = []
            for tid in ticket_ids:
                t = self._tickets.get(tid)
                if (t is not None and not t.completed
                        and (t.distribute_count == 0
                             or now - t.last_distributed_at
                             >= self.redistribute_min)):
                    picked.append(t)
            if not picked:
                return None
            return self._checkout_locked(picked, client, lease_id, now,
                                         expected_duration, observe)

    def submit_batch(self, lease_id: int, results: dict,
                     client: str = "?") -> int:
        """Record results for a lease ({ticket_id: result}); updates the
        client's EWMA throughput.  Returns how many results were accepted
        (duplicates from racing redistributed leases are dropped)."""
        return self.submit_batch_ex(lease_id, results, client)[0]

    def submit_batch_ex(self, lease_id: int, results: dict,
                        client: str = "?", *,
                        observe: bool = True) -> tuple[int, float]:
        """:meth:`submit_batch` returning ``(accepted, accepted_work)``.
        ``observe=False`` skips the EWMA update — the sharded queue submits
        a lease's results shard by shard but must fold exactly ONE
        (full-work, full-duration) sample into the client's rate."""
        now = self.clock()
        with self._lock:
            # grab the batch first: _submit_locked GCs drained leases; a
            # watchdog-released lease is still good for the EWMA sample
            batch = (self._leases.get(lease_id)
                     or self._released_leases.pop(lease_id, None))
            accepted_work = 0.0
            accepted = 0
            for tid, result in results.items():
                t = self._tickets.get(tid)
                if t is not None and not t.completed:
                    accepted_work += t.work
                    accepted += self._submit_locked(tid, result, client)
            if observe:
                stats = self.stats.setdefault(client, ClientStats(client))
                if batch is not None and accepted:
                    stats.observe(accepted_work, now - batch.issued_at,
                                  tickets=accepted)
            return accepted, accepted_work

    def release(self, lease_id: int, *, client_failed: bool = False,
                reset_vct: bool = True) -> int:
        """Return a lease's unfinished tickets to the queue *now*.

        Used when a client dies mid-lease or the watchdog deems the lease
        overdue (proactive redistribution).  With ``reset_vct`` (default)
        the tickets sort as freshly created rather than waiting out the
        full timeout; pass ``reset_vct=False`` to drop only the lease
        bookkeeping and keep the paper's redistribute_min cool-down (the
        error-retry path, so a deterministically failing task can't hot-
        loop).  Tickets meanwhile re-leased to ANOTHER client are left
        untouched.  Returns the number of tickets returned to the queue."""
        with self._lock:
            outstanding = self._lease_outstanding.pop(lease_id, set())
            batch = self._leases.pop(lease_id, None)
            released = 0
            for tid in outstanding:
                held_by = self._ticket_leases.get(tid)
                if held_by is not None:
                    held_by.discard(lease_id)
                    if not held_by:
                        self._ticket_leases.pop(tid, None)
                t = self._tickets.get(tid)
                if t is None or t.completed:
                    continue
                if t.lease_id is not None and t.lease_id != lease_id:
                    continue  # an active newer lease owns it now
                if reset_vct:
                    # VCT = last_distributed_at + timeout == created_at
                    t.last_distributed_at = t.created_at - self.timeout
                t.lease_id = None
                released += 1
            if released:
                self.releases += 1
            if self.tracer is not None and batch is not None:
                self.tracer.end(
                    self._lease_spans.pop(lease_id, None), ts=self.clock(),
                    args={"status": "released", "released": released,
                          "client_failed": client_failed,
                          "reset_vct": reset_vct})
            if batch is not None:
                self._released_leases[lease_id] = batch
                while len(self._released_leases) > 256:
                    self._released_leases.popitem(last=False)
                if client_failed:
                    self.stats.setdefault(
                        batch.client, ClientStats(batch.client)).failures += 1
            return released

    def cancel(self, ticket_ids) -> int:
        """Force-complete tickets with the :data:`CANCELLED` sentinel (the
        K-of-N barrier's fold path: a round closed without its stragglers).

        The tickets drain from every lease and from the done-accounting
        exactly as a real submit would, so watchdogs stop patrolling them
        and ``all_done`` can flip; a straggler's own submit arriving later
        is dropped as a duplicate.  Already-completed or unknown ids are
        skipped.  Returns how many tickets were cancelled."""
        with self._lock:
            return sum(self._submit_locked(tid, CANCELLED, "cancelled")
                       for tid in ticket_ids)

    def completed_results(self, ticket_ids) -> dict:
        """{ticket_id: result} for the subset of ``ticket_ids`` already
        completed — the partial-progress probe a K-of-N round barrier
        polls (contrast :meth:`results_for`, which is all-or-nothing)."""
        with self._lock:
            out = {}
            for tid in ticket_ids:
                t = self._tickets.get(tid)
                if t is not None and t.completed:
                    out[tid] = t.result
            return out

    def seconds_until_eligible(self) -> Optional[float]:
        """Time until the next in-cool-down ticket becomes leasable, or
        None when no unfinished distributed ticket is cooling down.  Lets
        an idle client park for exactly the remaining cool-down instead of
        a full redistribute_min."""
        now = self.clock()
        with self._lock:
            best = None
            for t in self._tickets.values():
                if t.completed or t.distribute_count == 0:
                    continue
                remaining = self.redistribute_min - (
                    now - t.last_distributed_at)
                if remaining <= 0:
                    return 0.0
                if best is None or remaining < best:
                    best = remaining
            return best

    def outstanding_leases(self) -> list[LeaseBatch]:
        """Leases with at least one unfinished ticket (watchdog input)."""
        with self._lock:
            return [b for lid, b in self._leases.items()
                    if self._lease_outstanding.get(lid)]

    def lease_is_outstanding(self, lease_id: int) -> bool:
        """True while the lease still has unfinished, unreleased tickets
        in THIS queue (the sharded queue polls its member shards to decide
        when a cross-shard lease has fully drained)."""
        with self._lock:
            return bool(self._lease_outstanding.get(lease_id))

    def results_for(self, ticket_ids) -> Optional[list]:
        """Results for exactly ``ticket_ids`` (in order), or None if any is
        still unfinished.  O(len(ticket_ids)) — use instead of copying the
        whole :meth:`results` dict when polling a round."""
        with self._lock:
            out = []
            for tid in ticket_ids:
                t = self._tickets.get(tid)
                if t is None or not t.completed:
                    return None
                out.append(t.result)
            return out

    def prune(self, ticket_ids) -> int:
        """Forget completed tickets (long-running producers: drop finished
        rounds so lease scans and memory don't grow with history).
        Unfinished tickets are left alone; returns how many were pruned."""
        return len(self.prune_ex(ticket_ids))

    def prune_ex(self, ticket_ids) -> list:
        """:meth:`prune` returning the ids actually pruned — the sharded
        store needs them to batch its routing-table cleanup into one
        ``_meta_lock`` acquisition instead of one per ticket."""
        with self._lock:
            pruned = []
            for tid in ticket_ids:
                t = self._tickets.get(tid)
                if t is not None and t.completed:
                    del self._tickets[tid]
                    self._ticket_leases.pop(tid, None)
                    pruned.append(tid)
            return pruned

    def report_error(self, ticket_id: int, error: str, client: str = "?"):
        """Paper: error report incl. stack trace is sent, browser reloads."""
        with self._lock:
            t = self._tickets.get(ticket_id)
            if t is not None:
                t.error_reports.append((client, error))

    # -- introspection -------------------------------------------------------

    def wait_all(self, timeout: Optional[float] = None) -> bool:
        """Block until every ticket has a result (or ``timeout`` elapses)."""
        return self._done.wait(timeout)

    def results(self) -> dict[int, Any]:
        """{ticket_id: result} for every completed ticket."""
        with self._lock:
            return {tid: t.result for tid, t in self._tickets.items()
                    if t.completed}

    def snapshot(self) -> dict:
        """The paper's control-console counters."""
        with self._lock:
            ts = list(self._tickets.values())
            return {
                "tickets": len(ts),
                "waiting": sum(1 for t in ts if not t.completed
                               and t.distribute_count == 0),
                "in_flight": sum(1 for t in ts if not t.completed
                                 and t.distribute_count > 0),
                "executed": sum(1 for t in ts if t.completed),
                "errors": sum(len(t.error_reports) for t in ts),
                "redistributions": sum(max(t.distribute_count - 1, 0)
                                       for t in ts),
                "lease_releases": self.releases,
                "duplicates": self.duplicates,
                "clients": {
                    name: {"rate": s.rate, "leases": s.leases,
                           "completed": s.completed_tickets,
                           "failures": s.failures}
                    for name, s in self.stats.items()},
            }

    def all_done(self) -> bool:
        """True when every ticket has a result."""
        return self._done.is_set()
