"""The Sashimi Distributor: HTTPServer + TicketDistributor analogue.

Two generations live here:

**Distributor v2** (``AsyncDistributor``) — the asyncio event-driven
scheduler this repo's scaling work builds on.  Clients check out *lease
batches* of tickets sized to their measured throughput (EWMA of completed
work units per second, kept in ``TicketQueue.stats``):

  * unknown clients get a small probe lease;
  * a fast client's next lease grows toward ``rate * target_lease_time``;
  * a slow client's shrinks — the paper's redistribution policy preserved,
    but *proactive*: a watchdog releases leases that overrun their ETA by
    ``grace``x instead of waiting out the full five-minute timeout.

Idle clients park on a wake event and are woken when tickets arrive or a
lease is released — no polling loops.

**Distributor v1** (``Distributor`` + ``BrowserClient`` threads) — the
original thread-per-client simulator, kept as the fixed-size baseline that
``benchmarks/scheduler_throughput.py`` compares against.  Each client:
  1. connects to the distributor (WebSocket analogue: method calls),
  2. requests a ticket,
  3. downloads the task code if not cached (LRU-GC'd cache, as in §2.1.2),
  4. downloads required datasets/static files from the "HTTPServer",
  5. executes the task, 6. returns the result, 7. loops.
On an execution error the client files an error report (with traceback) and
*reloads itself* (cache cleared), exactly as the paper describes.  Clients
can be configured to be slow or to die mid-task, which exercises the
ticket-redistribution fault tolerance.
"""
from __future__ import annotations

import asyncio
import collections
import threading
import time
import traceback
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.core.tickets import ClientStats, LeaseBatch, TicketQueue
from repro_torch.core.wire import (DeltaApplyError, apply_delta, flatten_tree,
                             leaf_equal)

#: Delta staleness horizon: a client whose cached copy is more than this
#: many re-publishes behind gets a full payload instead of a delta (the
#: registry only keeps leaf stamps for the last DELTA_HISTORY versions).
DELTA_HISTORY = 8


class LRUCache:
    """Least-recently-used cache (the paper's in-browser GC).

    Tracks ``hits`` / ``misses`` / ``evictions`` counters so tests and the
    console can verify caching behaviour."""

    def __init__(self, capacity: int = 16):
        self.capacity = capacity
        self._d: "collections.OrderedDict[str, Any]" = collections.OrderedDict()
        self.evictions = 0
        self.hits = 0
        self.misses = 0

    def get(self, key: str):
        """Return the cached value (marking it most-recent) or None."""
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key: str, value: Any):
        """Insert/refresh ``key``, evicting least-recently-used overflow."""
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def pop(self, key: str):
        """Remove and return ``key``'s value (None if absent) without
        touching the hit/miss counters — the targeted-invalidation path."""
        return self._d.pop(key, None)

    def clear(self):
        """Drop everything (the paper's browser reload)."""
        self._d.clear()


@dataclass
class TaskDef:
    """A distributable task: code + the static files/datasets it needs."""

    name: str
    run: Callable[[Any, dict], Any]          # (args, static_data) -> result
    static_files: tuple = ()                 # dataset keys served over "HTTP"
    # monotonic code version, stamped by HttpServerBase.register_task from
    # the registry clock; 0 = never registered.  Re-registering the same
    # name always gets a LARGER version, so caches can tell stale from
    # fresh without comparing payloads.
    version: int = 0


#: Sentinel returned by a conditional fetch whose ``if_version`` matched:
#: the client's copy is current, no payload moved (the HTTP 304 analogue).
NOT_MODIFIED = object()


@dataclass
class Fetched:
    """Result of a versioned registry fetch: the payload (or None when
    ``not_modified``), the server-side version it corresponds to, and
    whether the conditional check short-circuited the transfer.

    ``current`` is the transport's currency claim: the origin always
    serves current data; an edge clears it when its reply raced an
    invalidation (sub-floor fill), telling the browser not to trust the
    payload beyond its own version."""

    value: Any
    version: int
    not_modified: bool = False
    current: bool = True
    #: protocol v2 delta reply: the version the changed-leaf dict in
    #: ``value`` patches (None = ``value`` is a full payload).  Set only
    #: when the client asked for a delta and its base is inside the
    #: registry's DELTA_HISTORY window.
    delta_base: Optional[int] = None

    # -- wire codec (docs/PROTOCOL.md) ---------------------------------------

    def to_wire(self, encode_value) -> dict:
        """JSON-safe dict for the transport layer: a not-modified reply is
        version metadata only; otherwise ``payload`` carries the encoded
        value (``encode_value`` is the opaque payload codec)."""
        d = {"version": self.version, "not_modified": self.not_modified,
             "current": self.current}
        if not self.not_modified:
            d["payload"] = encode_value(self.value)
            if self.delta_base is not None:
                d["delta_base"] = self.delta_base
        return d

    @classmethod
    def from_wire(cls, d: dict, decode_value) -> "Fetched":
        """Rebuild a fetch reply from its wire dict (inverse of
        :meth:`to_wire`)."""
        if d["not_modified"]:
            return cls(None, d["version"], not_modified=True,
                       current=d.get("current", True))
        return cls(decode_value(d["payload"]), d["version"],
                   current=d.get("current", True),
                   delta_base=d.get("delta_base"))


@dataclass
class ClientProfile:
    """Simulated browser behaviour (shared by v1 threads and v2 tasks)."""

    name: str = "client"
    speed: float = 1.0            # work units executed per second (v2) /
    #                               multiplier on task duration (v1)
    fail_prob: float = 0.0        # probability a task raises
    die_after: Optional[int] = None   # abandon after N tickets (v1) or
    #                                   N leases (v2)
    latency: float = 0.0          # network latency per round-trip (s)
    cache_capacity: int = 16


# ---------------------------------------------------------------------------
# Ticket sizing policies (Distributor v2)
# ---------------------------------------------------------------------------


@dataclass
class FixedSizer:
    """v1 policy: every lease is ``size`` tickets, regardless of client."""

    size: int = 1

    def lease_size(self, stats: Optional[ClientStats]) -> int:
        """Constant batch size; client stats are ignored."""
        return self.size

    def expected_duration(self, stats, n_tickets: int) -> Optional[float]:
        """ETA from the client's EWMA rate, or None before any
        observation (the watchdog skips ETA-less leases)."""
        if stats is None or not stats.rate:
            return None
        return n_tickets * stats.mean_ticket_work / stats.rate


@dataclass
class AdaptiveSizer:
    """v2 policy: size each lease so it takes ~``target_lease_time`` seconds
    on *that* client, based on its EWMA throughput.

    ``lease_size = clamp(rate * target_lease_time, min_size, max_size)``.
    Unknown clients get ``probe_size`` so one cheap lease calibrates the
    EWMA before committing real volume."""

    target_lease_time: float = 0.25
    min_size: int = 1
    max_size: int = 64
    probe_size: int = 2

    def lease_size(self, stats: Optional[ClientStats]) -> int:
        """Tickets per lease for this client: rate-proportional, clamped
        to [min_size, max_size]; probe_size until the rate is known.
        ``rate`` is in work units/s, so convert through the client's mean
        ticket work to get a ticket count."""
        if (stats is None or not stats.rate
                or not stats.mean_ticket_work):
            return self.probe_size   # no (usable) measurement yet
        n = int(round(stats.rate * self.target_lease_time
                      / stats.mean_ticket_work))
        return max(self.min_size, min(self.max_size, n))

    def expected_duration(self, stats, n_tickets: int) -> Optional[float]:
        """ETA for a lease of ``n_tickets`` on this client (watchdog
        deadline input)."""
        if stats is None or not stats.rate:
            # No measurement yet: arm the watchdog with a generous multiple
            # of the design target so a dead client's probe lease still
            # comes back, while a merely-slow client gets to finish its
            # probe and report a rate (a released lease's late submit
            # still calibrates the EWMA via the queue's side-table).
            return 4.0 * self.target_lease_time
        return n_tickets * stats.mean_ticket_work / stats.rate


@dataclass
class _DeltaState:
    """Per-static leaf-stamp bookkeeping for delta serving.

    ``flat`` maps each leaf path (see :func:`repro.core.wire.flatten_tree`)
    to the *current* leaf object; ``stamps`` maps the same paths to the
    registry version at which each leaf last changed; ``history`` is the
    ordered list of the last DELTA_HISTORY publish versions over which the
    path set was stable.  A structure change (paths added/removed) resets
    both, so a delta never has to express leaf removal."""

    flat: dict
    stamps: dict
    history: list


def build_delta_fetched(state: Optional[_DeltaState], version: int,
                        if_version: Optional[int], *,
                        current: bool = True) -> Optional[Fetched]:
    """The pure delta-serving decision, shared by the origin registry and
    the federation edge caches so their semantics cannot diverge.

    Returns a delta :class:`Fetched` (``value`` = changed-leaves dict,
    ``delta_base`` = ``if_version``) when the client's base version is
    inside the stamp window and strictly behind ``version``; otherwise
    None (caller falls back to a full payload)."""
    if (state is None or if_version is None or if_version == version
            or if_version not in state.history):
        return None
    changed = {p: leaf for p, leaf in state.flat.items()
               if state.stamps[p] > if_version}
    return Fetched(changed, version, current=current, delta_base=if_version)


class HttpServerBase:
    """The paper's HTTPServer half, shared by Distributor v1 and v2: a
    **versioned registry** of task code + static assets published to
    clients, with a split download ledger.

    Every ``register_task`` / ``add_static`` stamps the key with a fresh
    value of one registry-wide monotonic clock, so versions are totally
    ordered across keys.  Fetches can be **conditional** (ETag analogue):
    pass ``if_version`` and a current copy costs a counter bump
    (``revalidation_count``) instead of a payload copy
    (``download_count``).  Re-registering a key notifies invalidation
    subscribers (edge caches) with the new version, so exactly that key is
    busted fabric-wide — no full ``clear()``.

      * ``download_count[key]``      — full payload transfers (cold misses
                                       and version-mismatch refetches);
      * ``revalidation_count[key]``  — conditional fetches answered
                                       "not modified" (a counter bump)."""

    def __init__(self):
        self.tasks: dict[str, TaskDef] = {}
        self.static_store: dict[str, Any] = {}
        self.download_count: collections.Counter = collections.Counter()
        self.revalidation_count: collections.Counter = collections.Counter()
        #: partial (changed-leaves-only) transfers, keyed like
        #: download_count — a delta is neither a full download nor a 304
        self.delta_count: collections.Counter = collections.Counter()
        self._count_lock = threading.Lock()
        self._registry_clock = 0                 # shared monotonic versions
        self._static_versions: dict[str, int] = {}
        self._static_delta: dict[str, _DeltaState] = {}
        self._invalidation_listeners: list[Callable[[str, int], None]] = []

    # -- publishing (producer side) ------------------------------------------

    def subscribe_invalidation(self, listener: Callable[[str, int], None]):
        """Register ``listener(cache_key, new_version)`` to be called when
        a task ("task:<name>") or static ("static:<key>") is re-published.
        Edge caches subscribe so a re-register invalidates exactly that
        key everywhere instead of nuking whole stores."""
        with self._count_lock:
            self._invalidation_listeners.append(listener)

    def _notify_invalidation(self, cache_key: str, version: int):
        # called OUTSIDE _count_lock: a listener (edge) may take its own
        # lock and a concurrent edge miss holds that lock while fetching
        # from us — holding ours here would deadlock
        for fn in list(self._invalidation_listeners):
            fn(cache_key, version)

    def register_task(self, task: TaskDef):
        """Publish (or re-publish) a task's code.  Stamps ``task.version``
        from the registry clock and fans out an invalidation for the key."""
        with self._count_lock:
            self._registry_clock += 1
            task.version = self._registry_clock
            self.tasks[task.name] = task
        self._notify_invalidation(f"task:{task.name}", task.version)

    def add_static(self, key: str, value: Any):
        """Publish (or re-publish) a dataset/helper; bumps its version and
        fans out an invalidation for the key.

        Also stamps each leaf of the value with the version at which it
        last changed (protocol v2 delta encoding): a re-publish that keeps
        the tree structure compares leaves bit-exactly against the previous
        payload, so a later ``serve_static_versioned(..., delta=True)`` can
        ship only the changed leaves.  A structure change resets the stamp
        window — the next conditional fetch gets a full payload."""
        with self._count_lock:
            self._registry_clock += 1
            version = self._registry_clock
            self._static_versions[key] = version
            self.static_store[key] = value
            new_flat = flatten_tree(value)
            prev = self._static_delta.get(key)
            if prev is not None and prev.flat.keys() == new_flat.keys():
                stamps = {p: (prev.stamps[p]
                              if leaf_equal(prev.flat[p], leaf) else version)
                          for p, leaf in new_flat.items()}
                history = (prev.history + [version])[-DELTA_HISTORY:]
            else:
                stamps = {p: version for p in new_flat}
                history = [version]
            self._static_delta[key] = _DeltaState(new_flat, stamps, history)
        self._notify_invalidation(f"static:{key}", version)

    # -- versions -------------------------------------------------------------

    def static_version(self, key: str) -> int:
        """Current version of a static asset (0 = unversioned, e.g. the
        store was written to directly)."""
        return self._static_versions.get(key, 0)

    def task_version(self, name: str) -> int:
        """The task's **coherence version**: max over its code version and
        its declared statics' versions.  This is what tickets pin — a
        client validated at this version is guaranteed fresh code AND
        fresh data for the task, while unchanged assets still revalidate
        as counter bumps."""
        task = self.tasks.get(name)
        if task is None:
            return 0
        return max([task.version]
                   + [self._static_versions.get(k, 0)
                      for k in task.static_files])

    # -- serving (client side) ------------------------------------------------

    def fetch_task_versioned(self, name: str,
                             if_version: Optional[int] = None) -> Fetched:
        """Download task code, conditionally: when ``if_version`` matches
        the current code version the reply is a not-modified stub
        (revalidation ledger), else the full payload (download ledger)."""
        with self._count_lock:
            task = self.tasks[name]
            if if_version is not None and task.version == if_version:
                self.revalidation_count[f"task:{name}"] += 1
                return Fetched(None, task.version, not_modified=True)
            self.download_count[f"task:{name}"] += 1
            return Fetched(task, task.version)

    def serve_static_versioned(self, key: str,
                               if_version: Optional[int] = None, *,
                               delta: bool = False) -> Fetched:
        """Download a static asset, conditionally (see
        :meth:`fetch_task_versioned`).

        With ``delta=True`` (protocol v2) a client whose ``if_version`` is
        inside the DELTA_HISTORY stamp window gets only the leaves that
        changed since (``delta_count`` ledger); past the horizon — or
        across a structure change — it falls back to the full payload."""
        with self._count_lock:
            value = self.static_store[key]
            version = self._static_versions.get(key, 0)
            if if_version is not None and version == if_version:
                self.revalidation_count[key] += 1
                return Fetched(None, version, not_modified=True)
            if delta:
                got = build_delta_fetched(self._static_delta.get(key),
                                          version, if_version)
                if got is not None:
                    self.delta_count[key] += 1
                    return got
            self.download_count[key] += 1
            return Fetched(value, version)

    def static_delta_state(self, key: str
                           ) -> Optional[tuple[int, _DeltaState]]:
        """Snapshot ``(version, delta_state)`` for a static, taken
        atomically — an edge cache stores it alongside the payload it just
        fetched (discarding it if the versions disagree, i.e. the fetch
        raced a re-publish) so it can serve deltas without an origin
        round-trip."""
        with self._count_lock:
            state = self._static_delta.get(key)
            if state is None:
                return None
            return (self._static_versions.get(key, 0),
                    _DeltaState(dict(state.flat), dict(state.stamps),
                                list(state.history)))

    def static_delta_stats(self, key: str) -> dict:
        """Observability for the training loop: how much of the last
        publish of ``key`` actually changed (what a v2 delta fetch ships)
        versus the total leaf count."""
        with self._count_lock:
            state = self._static_delta.get(key)
            version = self._static_versions.get(key, 0)
            if state is None:
                return {"version": version, "leaves": 0, "changed": 0,
                        "window": 0}
            return {
                "version": version,
                "leaves": len(state.flat),
                "changed": sum(1 for p in state.flat
                               if state.stamps[p] == version),
                "window": len(state.history),
            }

    def serve_static(self, key: str):
        """Unconditional static download (v1 compat surface)."""
        return self.serve_static_versioned(key).value

    def fetch_task(self, name: str) -> TaskDef:
        """Unconditional task-code download (v1 compat surface)."""
        return self.fetch_task_versioned(name).value


@dataclass
class _CacheEntry:
    """A browser-cache slot: payload + the server version it carries +
    the highest ticket pin it has been validated against (``validated >=
    pin`` means no round-trip is needed for that pin)."""

    value: Any
    version: int
    validated: int


def merge_versioned_fetch(entry: Optional[_CacheEntry], got: Fetched,
                          min_version: int
                          ) -> tuple[Optional[_CacheEntry], bool, bool]:
    """The pure cache-merge decision for the download-through-cache rule,
    shared by the sync in-process path (``BrowserNodeBase``) and the
    async wire path (``transport.RemoteBrowserClient``) so the two
    staleness guarantees can never diverge.

    ``entry`` is the current cache slot (or None), ``got`` the reply to a
    conditional fetch, ``min_version`` the ticket's pin.  Returns
    ``(new_entry, revalidated, needs_refetch)``:

      * ``revalidated`` — the reply was an authoritative "not modified";
        the entry is re-validated at the pin (counter-bump accounting);
      * ``needs_refetch`` — the payload was served by an edge whose fill
        raced an invalidation (``current=False``): retry once
        unconditionally and fold the retry with
        :func:`merge_unconditional_fetch`;
      * otherwise ``new_entry`` carries the fresh payload, validated at
        the pin.

    A **delta** reply (``got.delta_base`` set, protocol v2) is spliced
    into the cached entry with :func:`repro.core.wire.apply_delta`; if the
    entry does not match the delta's base version — or the patch does not
    fit — the delta is discarded and ``needs_refetch`` asks for a full
    payload instead, so a bad delta can degrade to an extra round-trip but
    never to a wrong value."""
    if got.not_modified:
        # authoritative "your copy is current": validate at the pin
        return (_CacheEntry(entry.value, entry.version,
                            max(min_version, entry.version)), True, False)
    if not got.current:
        return None, False, True           # heal through a raced edge fill
    if got.delta_base is not None:
        if entry is None or entry.version != got.delta_base:
            return None, False, True       # base moved: take a full payload
        try:
            merged = apply_delta(entry.value, got.value)
        except DeltaApplyError:
            return None, False, True       # corrupt delta: full payload
        return (_CacheEntry(merged, got.version,
                            max(min_version, got.version)), False, False)
    return (_CacheEntry(got.value, got.version,
                        max(min_version, got.version)), False, False)


def merge_unconditional_fetch(got: Fetched, min_version: int) -> _CacheEntry:
    """Fold the retry after a raced edge fill: validate at the pin only
    if the transport now claims currency, else only at the payload's own
    version — so the next pinned ticket revalidates instead of freezing
    the staleness in."""
    validated = (max(min_version, got.version) if got.current
                 else got.version)
    return _CacheEntry(got.value, got.version, validated)


class BrowserNodeBase:
    """Per-client state and helpers shared by the v1 thread client and the
    v2 asyncio client: LRU cache, counters, deterministic failure RNG, and
    the paper's download-through-cache / reload-on-error behaviours.

    The cache is **version-aware**: each entry remembers the registry
    version it was downloaded at.  A ticket pinned at ``task_version`` >
    the entry's validated mark forces a *conditional* refetch — unchanged
    assets come back "not modified" (a counter bump on the server), stale
    ones are re-downloaded.  A ticket pinned at or below the validated
    mark runs straight from cache, which is exactly the pinned-version
    guarantee for leases taken before a re-register."""

    def _init_browser(self, distributor, profile: ClientProfile):
        self.dist = distributor
        self.profile = profile
        self.cache = LRUCache(profile.cache_capacity)
        self.executed = 0
        self.errors = 0
        self.reloads = 0
        self.revalidations = 0       # conditional fetches answered 304
        self._rng_state = hash(profile.name) & 0xFFFFFFFF

    def _rand(self) -> float:
        # tiny deterministic LCG so failures are reproducible
        self._rng_state = (1103515245 * self._rng_state + 12345) & 0x7FFFFFFF
        return self._rng_state / 0x7FFFFFFF

    def _get_versioned(self, cache_key: str, fetch, min_version: int):
        """The shared download-through-cache rule for task code AND
        statics.  ``fetch(if_version)`` is the transport (origin or
        edge); ``min_version`` is the ticket's pin.

          * entry validated at >= the pin: serve from cache, no trip;
          * otherwise fetch conditionally and fold the reply with
            :func:`merge_versioned_fetch` — "not modified" bumps the
            validated mark, a payload replaces the entry, and a payload
            the transport does NOT claim current (an edge whose fill
            raced an invalidation) is retried once unconditionally."""
        entry = self.cache.get(cache_key)
        if entry is not None and entry.validated >= min_version:
            return entry.value
        got = fetch(entry.version if entry is not None else None)
        new, revalidated, refetch = merge_versioned_fetch(entry, got,
                                                          min_version)
        if refetch:
            new = merge_unconditional_fetch(fetch(None), min_version)
        if revalidated:
            self.revalidations += 1
        self.cache.put(cache_key, new)
        return new.value

    def _get_task(self, name: str, min_version: int = 0) -> TaskDef:
        """Step 3: task code through the cache, revalidating when the
        ticket's pin (``min_version``) outruns the cached entry."""
        return self._get_versioned(
            f"task:{name}",
            lambda v: self.dist.fetch_task_versioned(name, if_version=v),
            min_version)

    def _get_static(self, task: TaskDef, min_version: int = 0) -> dict:
        """Step 4: the task's datasets through the cache, same
        revalidation rule as :meth:`_get_task`."""
        return {
            key: self._get_versioned(
                f"static:{key}",
                lambda v, k=key: self.dist.serve_static_versioned(
                    k, if_version=v),
                min_version)
            for key in task.static_files}

    def _reload(self):
        """Paper: on error the browser reloads itself."""
        self.cache.clear()
        self.reloads += 1


# ---------------------------------------------------------------------------
# Distributor v2: asyncio event-driven scheduler
# ---------------------------------------------------------------------------


class AsyncDistributor(HttpServerBase):
    """TicketDistributor + HTTPServer, asyncio edition (Distributor v2).

    Serves batched ticket leases sized by ``sizer`` (default
    :class:`AdaptiveSizer`).  A watchdog proactively releases leases that
    overrun their throughput-based ETA by ``grace``x, so work stranded on a
    stalled client is redistributed in seconds rather than after the
    paper's five-minute timeout.

    The clock is injectable for deterministic tests (see
    ``docs/ARCHITECTURE.md`` §Injectable clock); it must agree with the
    event loop's notion of elapsed time when simulated clients sleep.
    """

    def __init__(self, *, timeout: float = 300.0,
                 redistribute_min: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 sizer=None, grace: float = 3.0,
                 watchdog_interval: float = 0.05,
                 keep_alive: bool = False,
                 project_name: str = "project",
                 queue=None, tracer=None):
        super().__init__()
        # queue may be shared: a federation passes one ShardedTicketQueue
        # (duck-type compatible) to every member distributor
        self.queue = queue if queue is not None else TicketQueue(
            timeout=timeout, redistribute_min=redistribute_min, clock=clock,
            tracer=tracer)
        # a shared queue brings its own tracer; in-process clients, the
        # transport server and the round engine all look it up here
        self.tracer = (tracer if tracer is not None
                       else getattr(self.queue, "tracer", None))
        #: structured diagnosis of the last run_until_done give-up (the
        #: queue snapshot + outstanding leases at expiry), None if none
        self.last_stall_report: Optional[dict] = None
        self.sizer = sizer if sizer is not None else AdaptiveSizer()
        self.grace = grace
        # keep_alive: clients/watchdog survive a drained queue and wait for
        # the next add_work round (used by SplitConcurrentDispatcher, which
        # runs one ticket round per training step); shutdown() ends them.
        self.keep_alive = keep_alive
        self.watchdog_interval = watchdog_interval
        self.project_name = project_name
        self.clients: list["AsyncBrowserClient"] = []
        self._work_added = False
        self._wake: Optional[asyncio.Event] = None
        self._client_tasks: list[asyncio.Task] = []
        self._watchdog_task: Optional[asyncio.Task] = None

    # -- scheduler core (HTTPServer API inherited from HttpServerBase) -------

    def _wake_event(self) -> asyncio.Event:
        """Current wake epoch.  Waiters capture it BEFORE probing the queue
        (so a concurrent notify can't be lost), then await it; every notify
        sets the old epoch and installs a fresh one.  Plain Events have
        clean cancellation semantics, unlike asyncio.Condition on 3.10."""
        if self._wake is None:
            self._wake = asyncio.Event()
        return self._wake

    def _notify_waiters(self):
        ev = self._wake
        self._wake = asyncio.Event()
        if ev is not None:
            ev.set()

    @staticmethod
    async def _wait_on(wake: asyncio.Event, timeout: float):
        """Park on a captured wake epoch for at most ``timeout`` seconds.
        Uses asyncio.wait — NOT wait_for — because wait_for can swallow an
        outer cancel arriving during its own timeout (bpo-42130), which
        would leak the parked task past shutdown()."""
        waiter = asyncio.ensure_future(wake.wait())
        try:
            await asyncio.wait({waiter}, timeout=timeout)
        finally:
            if not waiter.done():
                waiter.cancel()

    def _terminal(self) -> bool:
        return (not self.keep_alive and self._work_added
                and self.queue.all_done())

    def add_work(self, task_name: str, args_list, *,
                 work: float = 1.0,
                 shard: Optional[int] = None) -> list[int]:
        """Enqueue tickets (non-async producer API); wakes idle clients.
        Tickets pin the task's current registry coherence version, so a
        later re-register can't make them execute stale assets.
        ``shard`` places the batch on an explicit queue shard (sharded
        stores only — the training fabric's per-member affinity)."""
        kw = {} if shard is None else {"shard": shard}
        tids = self.queue.add_many(task_name, args_list, work=work,
                                   task_version=self.task_version(task_name),
                                   **kw)
        self._work_added = True
        self._notify_waiters()
        return tids

    def client_rates(self) -> dict:
        """{client: EWMA work-units/s} (None until first measured) — the
        feed for ``split_parallel.adaptive_shard_sizes``, so producers can
        size shards to measured throughput.  Same surface as
        ``FederatedDistributor.client_rates``."""
        return {name: s.rate for name, s in self.queue.stats.items()}

    def _queue_lease(self, client_name: str, n: int):
        """Queue checkout hook: a federation member overrides this to
        prefer its home shards and steal from the rest when home drains."""
        return self.queue.lease(client_name, n)

    async def lease(self, client_name: str) -> Optional[LeaseBatch]:
        """Check out the next lease for ``client_name``, sized by the
        policy.  Parks on the condition until tickets are eligible; returns
        None once every ticket is complete."""
        while True:
            # An empty queue starts out "done"; only treat done as terminal
            # once a producer has actually enqueued work (clients may be
            # spawned before the first add_work call).  In keep_alive mode
            # clients park instead, awaiting the next round's add_work.
            if self._terminal():
                return None
            # capture the wake epoch BEFORE probing, so an add_work /
            # submit / release landing in between still wakes us
            wake = self._wake_event()
            stats = self.queue.stats.get(client_name)
            n = self.sizer.lease_size(stats)
            batch = self._queue_lease(client_name, n)
            if batch is not None:
                # ETA from the tickets actually GRANTED (the queue may hand
                # out fewer than requested near the end of a round)
                batch.expected_duration = self.sizer.expected_duration(
                    stats, len(batch.tickets))
                return batch
            # park until notified, or until the earliest cool-down expiry
            # (no event announces those; fall back to redistribute_min)
            hint = self.queue.seconds_until_eligible()
            pause = (self.queue.redistribute_min if hint is None
                     else max(min(hint, self.queue.redistribute_min), 1e-4))
            await self._wait_on(wake, pause)

    async def submit_batch(self, batch: LeaseBatch, results: dict) -> int:
        """Turn in a lease's results; wakes waiters (done or new
        redistribution candidates)."""
        accepted = self.queue.submit_batch(batch.lease_id, results,
                                           batch.client)
        self._notify_waiters()
        return accepted

    async def release_lease(self, batch: LeaseBatch, *,
                            client_failed: bool = False,
                            reset_vct: bool = True) -> int:
        """Give a lease's unfinished tickets back (client death path);
        ``reset_vct=False`` keeps the cool-down (error-retry path)."""
        n = self.queue.release(batch.lease_id, client_failed=client_failed,
                               reset_vct=reset_vct)
        if n:
            self._notify_waiters()
        return n

    async def evict_client_leases(self, client: str) -> int:
        """Force-release EVERY outstanding lease checked out by
        ``client`` — the distributor half of heartbeat eviction (see
        ``core/transport.py``): when a browser tab is declared gone, its
        stranded work goes back into circulation immediately instead of
        waiting out the watchdog's ``grace x ETA`` deadline.  Also the
        chaos harness's server-side tab-close lever.  Returns the number
        of tickets released."""
        n = 0
        for batch in self.queue.outstanding_leases():
            if batch.client == client:
                n += self.queue.release(batch.lease_id, client_failed=True)
        if n:
            self._notify_waiters()
        return n

    async def _watchdog(self):
        """Proactive redistribution: release leases overrunning their ETA."""
        while not self._terminal():
            now = self.queue.clock()
            for batch in self.queue.outstanding_leases():
                eta = batch.expected_duration
                if eta is None:
                    continue
                if now - batch.issued_at > self.grace * max(eta, 1e-3):
                    await self.release_lease(batch, client_failed=True)
            await asyncio.sleep(self.watchdog_interval)

    # -- client/session management ------------------------------------------

    def transport_endpoints(self) -> list["AsyncDistributor"]:
        """The lease/fetch endpoints a ``TransportServer`` may bind remote
        connections to — for a single distributor, itself.  A federation
        returns its alive members, so each remote client lands on one
        member's scheduler + edge cache (see ``core/transport.py``)."""
        return [self]

    def ensure_watchdog(self):
        """Arm the lease watchdog if it isn't running (must be called with
        an event loop running).  Spawning in-process clients does this
        automatically; a ``TransportServer`` serving only remote clients
        calls it explicitly.  The ``.done()`` check matters: a
        non-keep_alive watchdog self-terminates when a round drains, and a
        later spawn/connection must arm a fresh one."""
        if self._watchdog_task is None or self._watchdog_task.done():
            loop = asyncio.get_running_loop()
            self._watchdog_task = loop.create_task(self._watchdog())

    def spawn_clients(self, profiles) -> list["AsyncBrowserClient"]:
        """Create one :class:`AsyncBrowserClient` task per profile (must be
        called with an event loop running)."""
        loop = asyncio.get_running_loop()
        cs = [AsyncBrowserClient(self, p) for p in profiles]
        self.clients.extend(cs)
        self._client_tasks.extend(loop.create_task(c.run()) for c in cs)
        self.ensure_watchdog()
        return cs

    async def run_until_done(self, timeout: float = 60.0, *,
                             wall_cap: Optional[float] = None) -> bool:
        """Drive the loop until every ticket completes, then shut down the
        clients/watchdog; returns False on timeout (also shut down).

        ``timeout`` is measured on the queue's injectable clock — a
        virtual-clock sim times out in *virtual* seconds instead of racing
        wall time.  ``wall_cap`` (wall seconds, default
        ``max(timeout, 60)``) is the safety net for a virtual clock that
        never advances; virtual-clock tests exercising wedge scenarios
        should pass a small cap so a regression fails in seconds."""
        deadline = self.queue.clock() + timeout
        if wall_cap is None:
            wall_cap = max(timeout, 60.0)
        wall_deadline = time.monotonic() + wall_cap
        while not self.queue.all_done():
            vnow = self.queue.clock()
            if vnow > deadline or time.monotonic() > wall_deadline:
                # never silently: a stall here is a scheduling bug or a
                # wedged virtual clock, and the state that explains it is
                # about to be torn down — snapshot it first
                reason = ("timeout" if vnow > deadline else "wall_cap")
                report = self._stall_report(reason, vnow)
                self.last_stall_report = report
                if self.tracer is not None:
                    self.tracer.instant("distributor.stall", track="queue",
                                        cat="warning", ts=vnow, args=report)
                warnings.warn(
                    "run_until_done gave up (%s expired): %d ticket(s) "
                    "incomplete, %d outstanding lease(s); full queue "
                    "snapshot in .last_stall_report" % (
                        reason,
                        report["snapshot"]["tickets"]
                        - report["snapshot"]["executed"],
                        len(report["outstanding_leases"])),
                    RuntimeWarning, stacklevel=2)
                await self.shutdown()
                return False
            # event-driven: every submit/release notifies; the timeout is
            # only a fallback heartbeat
            wake = self._wake_event()
            if self.queue.all_done():
                break
            await self._wait_on(wake, 0.05)
        await self.shutdown()
        return True

    def _stall_report(self, reason: str, vnow: float) -> dict:
        """JSON-safe diagnosis of a wedged run: the control-console
        snapshot (which carries every client's EWMA rate), plus each
        outstanding lease with its age against its ETA — the two things
        needed to tell a straggler from a lost wake-up."""
        return {
            "reason": reason,
            "virtual_clock": vnow,
            "snapshot": self.queue.snapshot(),
            "client_rates": self.client_rates(),
            "outstanding_leases": [
                {"lease": b.lease_id, "client": b.client,
                 "tickets": [t.ticket_id for t in b.tickets],
                 "issued_at": b.issued_at,
                 "age_s": vnow - b.issued_at,
                 "expected_duration": b.expected_duration}
                for b in self.queue.outstanding_leases()],
        }

    async def shutdown(self):
        """Cancel client + watchdog tasks and wait for them to unwind."""
        self._notify_waiters()
        tasks = list(self._client_tasks)
        if self._watchdog_task is not None:
            tasks.append(self._watchdog_task)
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        self._client_tasks.clear()
        self._watchdog_task = None

    def console(self) -> dict:
        """The paper's control console view (v2 edition)."""
        snap = self.queue.snapshot()
        snap["project"] = self.project_name
        snap["client_views"] = [
            {"name": c.profile.name, "executed": c.executed,
             "errors": c.errors, "alive": not c.done}
            for c in self.clients
        ]
        return snap


class AsyncBrowserClient(BrowserNodeBase):
    """A simulated browser node as an asyncio task (Distributor v2).

    Runs the paper's basic-program loop over the batched-lease API: lease →
    download code/data (LRU-cached) → execute each ticket → submit the
    batch.  ``profile.speed`` is the client's work-units-per-second; task
    execution is simulated with ``asyncio.sleep(work / speed)`` so
    heterogeneous clients genuinely take different wall-clock time."""

    def __init__(self, distributor: AsyncDistributor, profile: ClientProfile):
        self._init_browser(distributor, profile)
        self.leases_taken = 0
        self.done = False

    async def run(self):
        """Lease → download → execute → submit, until the queue drains
        (or the profile says the tab closes)."""
        try:
            while True:
                batch = await self.dist.lease(self.profile.name)
                if batch is None:
                    break
                self.leases_taken += 1
                if self.profile.latency:
                    await asyncio.sleep(self.profile.latency)
                if (self.profile.die_after is not None
                        and self.leases_taken > self.profile.die_after):
                    # tab closed mid-lease: tickets go straight back
                    await self.dist.release_lease(batch, client_failed=True)
                    break
                results: dict[int, Any] = {}
                failed = False
                tr = self.dist.tracer
                exec_span = None
                if tr is not None:
                    exec_span = tr.begin(
                        "client.execute", lane=True, cat="client",
                        track=f"client:{self.profile.name}",
                        ts=self.dist.queue.clock(),
                        args={"lease": batch.lease_id,
                              "tickets": len(batch.tickets)})
                try:
                    await self._run_tickets(batch, results)
                except Exception:
                    failed = True
                finally:
                    if tr is not None:
                        tr.end(exec_span, ts=self.dist.queue.clock(),
                               args={"executed": len(results),
                                     "failed": failed})
                await self.dist.submit_batch(batch, results)
                if failed:
                    # drop the lease bookkeeping for the errored tickets
                    # but keep their redistribute_min cool-down (paper
                    # behaviour) — a deterministically failing task must
                    # not hot-loop at event-loop speed
                    await self.dist.release_lease(batch, reset_vct=False)
        finally:
            self.done = True

    async def _run_tickets(self, batch: LeaseBatch, results: dict):
        """Execute a lease's tickets into ``results``; raises after the
        loop if any ticket errored (the caller releases the lease with the
        cool-down kept)."""
        failed = False
        for ticket in batch.tickets:
            try:
                # the ticket's pinned version drives revalidation:
                # a pin newer than the cached entry forces a
                # conditional refetch, so post-re-register tickets
                # can never execute stale code or data
                task = self._get_task(ticket.task_name,
                                      ticket.task_version)
                static = self._get_static(task, ticket.task_version)
                if (self.profile.fail_prob
                        and self._rand() < self.profile.fail_prob):
                    raise RuntimeError(
                        "simulated browser crash in "
                        f"{ticket.task_name}")
                if self.profile.speed > 0:
                    await asyncio.sleep(
                        ticket.work / self.profile.speed)
                results[ticket.ticket_id] = task.run(ticket.args,
                                                     static)
                self.executed += 1
            except Exception:
                self.errors += 1
                self.dist.queue.report_error(
                    ticket.ticket_id, traceback.format_exc(),
                    self.profile.name)
                self._reload()
                failed = True
        if failed:
            raise RuntimeError("ticket(s) errored in lease "
                               f"{batch.lease_id}")


# ---------------------------------------------------------------------------
# Distributor v1: thread-per-client baseline (fixed-size tickets)
# ---------------------------------------------------------------------------


class Distributor(HttpServerBase):
    """TicketDistributor + HTTPServer in one object (v1 baseline)."""

    def __init__(self, *, timeout: float = 300.0,
                 redistribute_min: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 project_name: str = "project"):
        super().__init__()
        self.queue = TicketQueue(timeout=timeout,
                                 redistribute_min=redistribute_min,
                                 clock=clock)
        self.project_name = project_name
        self.clients: list["BrowserClient"] = []

    # client management (HTTPServer API inherited from HttpServerBase) -------

    def add_work(self, task_name: str, args_list, *,
                 work: float = 1.0) -> list[int]:
        """Enqueue version-pinned tickets (v1 mirror of the v2 producer
        API); the thread clients poll, so no wake-up is needed."""
        return self.queue.add_many(task_name, args_list, work=work,
                                   task_version=self.task_version(task_name))

    def spawn_clients(self, profiles) -> list["BrowserClient"]:
        """Start one daemon thread per profile."""
        cs = [BrowserClient(self, p) for p in profiles]
        self.clients.extend(cs)
        for c in cs:
            c.start()
        return cs

    def shutdown(self):
        """Stop and join all client threads."""
        for c in self.clients:
            c.stop()
        for c in self.clients:
            c.join(timeout=5)
        self.clients.clear()

    def console(self) -> dict:
        """The paper's control console view."""
        snap = self.queue.snapshot()
        snap["project"] = self.project_name
        snap["clients"] = [
            {"name": c.profile.name, "executed": c.executed,
             "errors": c.errors, "alive": c.is_alive()}
            for c in self.clients
        ]
        return snap


class BrowserClient(threading.Thread, BrowserNodeBase):
    """A simulated browser node running the paper's basic-program loop."""

    def __init__(self, distributor: Distributor, profile: ClientProfile):
        super().__init__(daemon=True)
        self._init_browser(distributor, profile)
        # NB: named _stop_requested because threading.Thread owns a private
        # _stop() method; shadowing it breaks Thread.join().
        self._stop_requested = threading.Event()

    def stop(self):
        """Ask the client thread to exit after its current ticket."""
        self._stop_requested.set()

    def run(self):
        """The paper's steps 2-7: request → download → execute → submit."""
        while not self._stop_requested.is_set():
            ticket = self.dist.queue.request()       # step 2: ticket request
            if ticket is None:
                if self.dist.queue.all_done():
                    time.sleep(0.001)
                else:
                    time.sleep(0.002)
                continue
            if self.profile.latency:
                time.sleep(self.profile.latency)
            try:
                task = self._get_task(ticket.task_name, ticket.task_version)
                static = self._get_static(task, ticket.task_version)
                if self.profile.fail_prob and self._rand() < self.profile.fail_prob:
                    raise RuntimeError(
                        f"simulated browser crash in {ticket.task_name}")
                t0 = time.perf_counter()
                result = task.run(ticket.args, static)
                if 0 < self.profile.speed < 1.0:
                    # profile.speed is a duration multiplier in v1: a 0.2x
                    # client takes 5x the real execution time.  Sleep the
                    # difference so slow clients genuinely hold tickets
                    # longer (speeds >= 1 can't shrink real compute).
                    elapsed = time.perf_counter() - t0
                    time.sleep(elapsed * (1.0 / self.profile.speed - 1.0))
                self.dist.queue.submit(ticket.ticket_id, result,
                                       self.profile.name)
                self.executed += 1
            except Exception:
                self.errors += 1
                self.dist.queue.report_error(
                    ticket.ticket_id, traceback.format_exc(),
                    self.profile.name)
                self._reload()                        # paper: reload browser
            if (self.profile.die_after is not None
                    and self.executed + self.errors
                    >= self.profile.die_after):
                return                                # browser tab closed
