"""Multi-distributor federation over the sharded ticket store.

The paper runs ONE TicketDistributor; follow-up work from the same group
(Hidaka et al., arXiv:1702.01846; DistML.js, arXiv:2407.01023) scales the
server side with multiple coordinating hosts and a dedicated asset-serving
tier.  This module is that fabric for our reproduction:

  * :class:`FederationMember` — an ``AsyncDistributor`` that shares one
    :class:`~repro.core.shards.ShardedTicketQueue` with its peers.  Each
    member owns a set of **home shards** it serves by preference (so the
    common case touches only its own locks) and **steals** from the rest of
    the fabric the moment its home shards run dry — idle capacity anywhere
    drains backlog everywhere.  Every member's watchdog patrols the
    *shared* store, so when a member dies mid-lease its stranded tickets
    are released by a survivor's watchdog and stolen within seconds.
  * :class:`EdgeCache` — a read-through cache node in front of the origin
    ``HttpServerBase``.  Clients fetch task code and static assets from
    their member's edge; only misses reach the origin, whose existing
    ``download_count`` ledger therefore measures exactly the miss traffic
    (hit rate = 1 - origin fetches / edge requests).
  * :class:`FederatedDistributor` — the façade: origin HTTP store +
    sharded queue + N members + per-member edges, with least-loaded client
    routing, member kill/failover for fault-injection, and a merged
    console.

``benchmarks/federation_throughput.py`` measures the payoff under a
bimodal client mix and member failure; ``docs/ARCHITECTURE.md``
§Federation fabric has the shard → member → origin diagram.
"""
from __future__ import annotations

import asyncio
import collections
import threading
import time
from typing import Any, Callable, Optional

from repro_torch.core.distributor import (AdaptiveSizer, AsyncDistributor,
                                    Fetched, HttpServerBase, LRUCache,
                                    TaskDef, build_delta_fetched)
from repro_torch.core.shards import ShardedTicketQueue


class EdgeCache:
    """Read-through cache tier for task code and static assets.

    Sits between a member's browser clients and the origin
    ``HttpServerBase``.  Serves from an LRU store; misses fall through to
    the origin (bumping its ``download_count`` ledger, which thereby
    counts *origin egress*, i.e. cache misses).  The edge keeps its own
    ``download_count`` of client-facing requests plus a
    ``revalidation_count`` of conditional requests it answered
    "not modified", so hit rates and revalidation traffic are directly
    measurable from the ledgers.

    The edge is **coherent**: it subscribes to the origin's invalidation
    feed, so re-registering a task or static drops exactly that key from
    the edge store (next request re-warms read-through) — no full
    ``clear()``.  Entries are stored with their origin version, and
    client-side conditional fetches (``if_version``) are answered locally
    when current.

    All cache + counter mutations are guarded by one lock: v1 thread
    clients routed through an edge would otherwise corrupt the LRU's
    OrderedDict.  The lock is NOT held across origin round-trips, so an
    invalidation can race an in-flight miss fill; a per-key **version
    floor** (the invalidation's tombstone) makes that safe — a fill
    below the floor is never cached and never answered "not modified",
    so a raced fill costs one extra origin round-trip instead of
    freezing stale data in."""

    def __init__(self, origin: HttpServerBase, name: str = "edge0",
                 capacity: int = 64, subscribe: bool = True):
        self.origin = origin
        self.name = name
        self.cache = LRUCache(capacity)   # key -> (value, version, dstate)
        self.download_count: collections.Counter = collections.Counter()
        self.revalidation_count: collections.Counter = collections.Counter()
        #: client-facing partial transfers (protocol v2 deltas served
        #: locally from the cached leaf-stamp snapshot)
        self.delta_count: collections.Counter = collections.Counter()
        self.invalidations = 0
        self._floor: dict[str, int] = {}  # key -> minimum current version
        self._lock = threading.Lock()
        # subscribe=False opts out of coherence (benchmark baseline for
        # the pre-invalidation behaviour); production edges stay coherent
        if subscribe and hasattr(origin, "subscribe_invalidation"):
            origin.subscribe_invalidation(self.invalidate)

    def invalidate(self, cache_key: str, version: int):
        """Origin push: a key was re-published at ``version`` — drop our
        copy (if any) and raise the key's floor, so a concurrent miss
        fill carrying the OLD version can't be cached or served as
        current after this returns."""
        with self._lock:
            self._floor[cache_key] = max(self._floor.get(cache_key, 0),
                                         version)
            if self.cache.pop(cache_key) is not None:
                self.invalidations += 1

    def _read_through(self, cache_key: str, ledger_key: str,
                      fetch, if_version: Optional[int], *,
                      delta: bool = False,
                      delta_state_fetch=None) -> Fetched:
        """Shared fetch path: LRU probe under the lock, origin fetch
        outside it, conditional short-circuit when the client's version
        matches our entry AND the entry is at or above the invalidation
        floor (i.e. provably current).

        Statics additionally read the origin's leaf-stamp snapshot on a
        miss fill (``delta_state_fetch``), kept only when its version
        matches the payload fetched (a mismatch means the fill raced a
        re-publish).  With it cached, a v2 client's ``delta=True``
        conditional fetch is answered locally with just the changed
        leaves — same :func:`build_delta_fetched` decision as the origin,
        and only when the entry is provably current (a sub-floor entry
        already forces the client to refetch a full payload)."""
        with self._lock:
            self.download_count[ledger_key] += 1
            entry = self.cache.get(cache_key)
            if (entry is not None
                    and entry[1] < self._floor.get(cache_key, 0)):
                self.cache.pop(cache_key)   # a raced fill slipped in
                entry = None
        if entry is None:
            got = fetch()                      # origin round-trip, unlocked
            dstate = None
            if delta_state_fetch is not None:
                snap = delta_state_fetch()     # second trip, still unlocked
                if snap is not None and snap[0] == got.version:
                    dstate = snap[1]
            entry = (got.value, got.version, dstate)
            with self._lock:
                if got.version >= self._floor.get(cache_key, 0):
                    self.cache.put(cache_key, entry)
        value, version = entry[0], entry[1]
        dstate = entry[2] if len(entry) > 2 else None
        with self._lock:
            current = version >= self._floor.get(cache_key, 0)
            if if_version is not None and if_version == version and current:
                self.revalidation_count[ledger_key] += 1
                return Fetched(None, version, not_modified=True)
            if delta and current and dstate is not None:
                got_d = build_delta_fetched(dstate, version, if_version)
                if got_d is not None:
                    self.delta_count[ledger_key] += 1
                    return got_d
        # current=False tells the client this payload raced an
        # invalidation — serve it, but don't let it validate a pin
        return Fetched(value, version, current=current)

    def fetch_task_versioned(self, name: str,
                             if_version: Optional[int] = None) -> Fetched:
        """Serve task code, read-through to the origin on a miss."""
        key = f"task:{name}"
        return self._read_through(
            key, key, lambda: self.origin.fetch_task_versioned(name),
            if_version)

    def serve_static_versioned(self, key: str,
                               if_version: Optional[int] = None, *,
                               delta: bool = False) -> Fetched:
        """Serve a static asset, read-through to the origin on a miss.
        ``delta=True`` (protocol v2) serves changed-leaves deltas from the
        cached leaf-stamp snapshot when the client's base is in window."""
        # "static:" namespace so an asset literally named "task:<x>" can't
        # collide with task <x>'s code (same split BrowserNodeBase uses)
        delta_state_fetch = getattr(self.origin, "static_delta_state", None)
        return self._read_through(
            f"static:{key}", key,
            lambda: self.origin.serve_static_versioned(key), if_version,
            delta=delta,
            delta_state_fetch=(None if delta_state_fetch is None
                               else (lambda: delta_state_fetch(key))))

    def fetch_task(self, name: str) -> TaskDef:
        """Unconditional task fetch (v1 compat surface)."""
        return self.fetch_task_versioned(name).value

    def serve_static(self, key: str):
        """Unconditional static fetch (v1 compat surface)."""
        return self.serve_static_versioned(key).value

    def clear(self):
        """Drop the edge's store (node restart); next requests re-warm
        from the origin."""
        with self._lock:
            self.cache.clear()

    def stats(self) -> dict:
        """Requests/hits/misses/hit-rate counters for the console."""
        with self._lock:
            requests = sum(self.download_count.values())
            return {
                "name": self.name,
                "requests": requests,
                "hits": self.cache.hits,
                "misses": self.cache.misses,
                "evictions": self.cache.evictions,
                "invalidations": self.invalidations,
                "revalidations": sum(self.revalidation_count.values()),
                "deltas": sum(self.delta_count.values()),
                "hit_rate": (self.cache.hits / requests) if requests else 0.0,
            }


def grant_has_foreign_tickets(batch, home_shards) -> bool:
    """True when a lease grant contains tickets from shards outside
    ``home_shards`` — the definition of a steal.  A fabric-wide retry
    whose grant turns out to be purely home tickets (a home cool-down
    expired between the two lease calls) is NOT a steal, just home work
    arriving late.  Shared by :class:`FederationMember` and the
    federation benchmark so the two counters can't diverge."""
    home = {id(sh) for sh in home_shards}
    return any(id(sh) not in home for sh in (batch.shards or ()))


class FederationMember(AsyncDistributor):
    """One distributor in the federation: home-shard affinity, work
    stealing, and edge-cached asset serving.

    The member leases from its ``home_shards`` first (touching only those
    shards' locks — the common, contention-free case).  When home is dry
    it re-merges across the WHOLE fabric, stealing whatever ticket is
    globally next by VCT; ``steals`` counts those rescues."""

    def __init__(self, federation: "FederatedDistributor", index: int,
                 home_shards, edge: EdgeCache, **kw):
        super().__init__(queue=federation.queue, **kw)
        self.federation = federation
        self.index = index
        self.home_shards = list(home_shards)
        self.edge = edge
        self.alive = True
        self.steals = 0

    def _queue_lease(self, client_name: str, n: int):
        """Home shards first; steal across the fabric when home is dry."""
        batch = None
        if self.home_shards:
            batch = self.queue.lease(client_name, n,
                                     shards=self.home_shards)
        if batch is None and len(self.home_shards) < self.queue.n_shards:
            batch = self.queue.lease(client_name, n)
            if batch is not None and grant_has_foreign_tickets(
                    batch, self.home_shards):
                self.steals += 1
                if self.tracer is not None:
                    self.tracer.instant(
                        "federation.steal", track=f"member{self.index}",
                        cat="federation", ts=self.queue.clock(),
                        args={"member": self.index, "lease": batch.lease_id,
                              "client": client_name})
        return batch

    def task_version(self, name: str) -> int:
        """Coherence versions live in the ORIGIN registry (the façade) —
        a member enqueueing work directly still pins correctly."""
        return self.federation.task_version(name)

    # clients of this member fetch assets through its edge, not the origin
    def fetch_task_versioned(self, name: str, if_version=None):
        """Serve task code from this member's edge (conditional fetch:
        ``if_version`` matching costs a counter bump, not a payload)."""
        return self.edge.fetch_task_versioned(name, if_version)

    def serve_static_versioned(self, key: str, if_version=None, *,
                               delta: bool = False):
        """Serve a static asset from this member's edge (conditional;
        ``delta=True`` ships changed leaves only, protocol v2)."""
        return self.edge.serve_static_versioned(key, if_version, delta=delta)

    def fetch_task(self, name: str) -> TaskDef:
        """Unconditional task fetch through the edge (v1 compat)."""
        return self.edge.fetch_task(name)

    def serve_static(self, key: str):
        """Unconditional static fetch through the edge (v1 compat)."""
        return self.edge.serve_static(key)

    def _notify_waiters(self):
        """A submit/release/add anywhere may unblock a peer's parked
        clients (stealing) — broadcast through the federation."""
        self.federation._notify_all()


class FederatedDistributor(HttpServerBase):
    """N federated distributors + sharded queue + edge tier, one façade.

    Duck-type compatible with ``AsyncDistributor`` where it matters
    (``add_work`` / ``spawn_clients`` / ``run_until_done`` / ``shutdown``
    / ``console`` / ``queue``), so ``SplitConcurrentDispatcher`` and the
    examples can swap it in.  Itself the *origin* HTTP store: tasks and
    static assets registered here are served to clients through each
    member's :class:`EdgeCache`.
    """

    def __init__(self, n_members: int = 2, *, n_shards: Optional[int] = None,
                 timeout: float = 300.0, redistribute_min: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 sizer=None, grace: float = 3.0,
                 watchdog_interval: float = 0.05,
                 edge_capacity: int = 64,
                 keep_alive: bool = False,
                 project_name: str = "federation",
                 tracer=None):
        super().__init__()
        if n_members < 1:
            raise ValueError(f"n_members must be >= 1, got {n_members}")
        if n_shards is not None and n_shards < n_members:
            # fewer shards than members would leave some members with no
            # home shards — every one of their leases would count as a
            # "steal" and home affinity would silently vanish
            raise ValueError(
                f"n_shards ({n_shards}) must be >= n_members ({n_members})")
        self.project_name = project_name
        self.queue = ShardedTicketQueue(
            n_shards if n_shards is not None else max(n_members, 2),
            timeout=timeout, redistribute_min=redistribute_min, clock=clock,
            tracer=tracer)
        # members inherit the tracer through the shared queue (see
        # AsyncDistributor.__init__); the façade keeps it for its own
        # run_until_done stall events and federation-level instants
        self.tracer = tracer
        self.last_stall_report: Optional[dict] = None
        sizer = sizer if sizer is not None else AdaptiveSizer()
        self.members: list[FederationMember] = []
        for i in range(n_members):
            home = [self.queue.shards[j]
                    for j in range(self.queue.n_shards)
                    if j % n_members == i]
            edge = EdgeCache(self, name=f"edge{i}", capacity=edge_capacity)
            self.members.append(FederationMember(
                self, i, home, edge,
                timeout=timeout, redistribute_min=redistribute_min,
                clock=clock, sizer=sizer, grace=grace,
                watchdog_interval=watchdog_interval,
                keep_alive=keep_alive,
                project_name=f"{project_name}/member{i}"))
        self.migrations = 0           # home-shard moves (rebalancer)
        self._wake: Optional[asyncio.Event] = None

    # -- keep_alive fans out (SplitConcurrentDispatcher sets it) -------------

    @property
    def keep_alive(self) -> bool:
        """True when every member survives drained rounds (the
        ``SplitConcurrentDispatcher`` mode); setting it fans out."""
        return all(m.keep_alive for m in self.members)

    @keep_alive.setter
    def keep_alive(self, value: bool):
        for m in self.members:
            m.keep_alive = value

    # -- wake-event fabric ----------------------------------------------------

    _wait_on = staticmethod(AsyncDistributor._wait_on)

    def _wake_event(self) -> asyncio.Event:
        if self._wake is None:
            self._wake = asyncio.Event()
        return self._wake

    def _notify_all(self):
        """Wake every member's parked clients and the federation's own
        waiters (run_until_done / dispatcher rounds)."""
        for m in self.members:
            AsyncDistributor._notify_waiters(m)   # base impl, no re-entry
        ev = self._wake
        self._wake = asyncio.Event()
        if ev is not None:
            ev.set()

    # -- producer / client management -----------------------------------------

    def add_work(self, task_name: str, args_list, *,
                 work: float = 1.0,
                 shard: Optional[int] = None) -> list[int]:
        """Enqueue version-pinned tickets on the owning shard (or an
        explicit ``shard`` index — the training fabric's per-member
        affinity placement); wakes the whole fabric."""
        tids = self.queue.add_many(task_name, args_list, work=work,
                                   task_version=self.task_version(task_name),
                                   shard=shard)
        for m in self.members:
            m._work_added = True
        self._notify_all()
        return tids

    def alive_members(self) -> list[FederationMember]:
        """Members still serving clients."""
        return [m for m in self.members if m.alive]

    def transport_endpoints(self) -> list[FederationMember]:
        """Endpoints a ``TransportServer`` binds remote connections to: the
        alive members.  Each remote client is pinned to one member for its
        connection's lifetime, so its leases take the member's home-shard /
        steal path and its asset fetches go through that member's edge —
        exactly like an in-process client of that member."""
        return self.alive_members()

    def spawn_clients(self, profiles, *, member: Optional[int] = None):
        """Attach clients to members.  Default policy is least-loaded:
        each profile goes to the alive member currently serving the fewest
        clients.  ``member=`` pins the whole batch to one member."""
        spawned = []
        for p in profiles:
            if member is not None:
                target = self.members[member]
                if not target.alive:
                    raise RuntimeError(f"member{member} is dead")
            else:
                target = min(
                    self.alive_members(),
                    key=lambda m: (sum(1 for c in m.clients if not c.done),
                                   m.index))
            spawned.extend(target.spawn_clients([p]))
        return spawned

    def home_shard_indices(self, member: int) -> list[int]:
        """Queue-shard indices in ``member``'s home set — the producer-side
        view a trainer needs to place a round's tickets with per-member
        affinity (``add_work(shard=...)``)."""
        owned = {id(sh) for sh in self.members[member].home_shards}
        return [j for j, sh in enumerate(self.queue.shards)
                if id(sh) in owned]

    def migrate_shard(self, shard_index: int, to_member: int) -> bool:
        """Move queue shard ``shard_index`` from its current owner's home
        set to ``to_member``'s — the rebalancing primitive.

        Mid-run safe: home sets are consulted per lease, in-flight leases
        against the old owner drain normally, and the shared store means
        no tickets move — only the *affinity* (which member serves the
        shard from its own locks) changes.  Returns False when the target
        already owns the shard (or no member does); raises on a dead
        target."""
        target = self.members[to_member]
        if not target.alive:
            raise RuntimeError(f"member{to_member} is dead")
        sh = self.queue.shards[shard_index]
        donor = next((m for m in self.members
                      if any(h is sh for h in m.home_shards)), None)
        if donor is None or donor is target:
            return False
        donor.home_shards.remove(sh)
        target.home_shards.append(sh)
        self.migrations += 1
        if self.tracer is not None:
            self.tracer.instant(
                "federation.migrate", track="federation", cat="federation",
                ts=self.queue.clock(),
                args={"shard": shard_index, "from": donor.index,
                      "to": to_member})
        self._notify_all()          # the new owner's idle clients wake up
        return True

    async def evict_client_leases(self, client: str) -> int:
        """Force-release every lease ``client`` holds anywhere in the
        shared store — the federation-wide half of heartbeat eviction
        (the transport's per-connection path covers only one member; a
        client that reconnected across members may have stranded leases
        on several).  Returns the number of tickets released."""
        n = 0
        for batch in self.queue.outstanding_leases():
            if batch.client == client:
                n += self.queue.release(batch.lease_id, client_failed=True)
        if n:
            if self.tracer is not None:
                self.tracer.instant(
                    "federation.evict", track="federation",
                    cat="federation", ts=self.queue.clock(),
                    args={"client": client, "released": n})
            self._notify_all()
        return n

    async def kill_member(self, index: int) -> int:
        """Fault injection: member ``index`` dies — its clients and
        watchdog are cancelled mid-flight, WITHOUT releasing its leases.
        Survivors' watchdogs patrol the shared store, so the dead member's
        stranded tickets come back at ``grace × ETA`` and get stolen.
        Returns how many clients went down with it."""
        m = self.members[index]
        m.alive = False
        n = len(m._client_tasks)
        await m.shutdown()
        if self.tracer is not None:
            self.tracer.instant(
                "federation.kill", track="federation", cat="federation",
                ts=self.queue.clock(), args={"member": index, "clients": n})
        self._notify_all()
        return n

    # drive-until-drained loop (and its stall-report diagnosis) reused
    # verbatim: the façade exposes the same _wake_event/_wait_on/queue/
    # shutdown/client_rates surface the loop needs, and one copy means a
    # fix to its lost-wakeup or silent-expiry handling reaches both classes
    run_until_done = AsyncDistributor.run_until_done
    _stall_report = AsyncDistributor._stall_report

    async def shutdown(self):
        """Shut down every member (dead ones are a no-op)."""
        for m in self.members:
            await m.shutdown()

    # -- introspection ---------------------------------------------------------

    def client_rates(self) -> dict:
        """{client: EWMA work-units/s} across the whole fabric — feed for
        ``split_parallel.adaptive_shard_sizes``."""
        return {name: s.rate for name, s in self.queue.stats.items()}

    def console(self) -> dict:
        """Merged control console: global queue counters plus per-member
        client/steal/edge views."""
        snap = self.queue.snapshot()
        snap["project"] = self.project_name
        snap["migrations"] = self.migrations
        snap["members"] = [
            {"name": f"member{m.index}", "alive": m.alive,
             "steals": m.steals, "home_shards": len(m.home_shards),
             "clients": [{"name": c.profile.name, "executed": c.executed,
                          "errors": c.errors, "alive": not c.done}
                         for c in m.clients],
             "edge": m.edge.stats()}
            for m in self.members]
        return snap
