"""The framework-free pieces of ``repro.core.split_parallel`` that the
training fabric needs: the train-state record, the round drivers' shared
client-lifetime ownership, and throughput-proportional shard sizing.

The §4.1 split-training strategies themselves are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class TrainState:
    """Train state with the JAX package's field list
    (``core/split_parallel.py:54-66``), so round checkpoints move between
    the packages; split_concurrent uses the head/stale-head/prev-feature
    slots, the others leave them empty."""

    params: Any                 # backbone params (clients)
    head: Any                   # server head params
    head_stale: Any             # client-side stale head copy (split_concurrent)
    opt_state: Any              # backbone optimizer state
    head_opt_state: Any         # head optimizer state
    prev_features: Any          # features from step t-1 (split_concurrent)
    prev_labels: Any
    prev_mask: Any
    step: Any                   # scalar int32


def adaptive_shard_sizes(rates: dict, global_batch: int, *,
                         min_shard: int = 1) -> dict:
    """Split ``global_batch`` rows across clients proportional to measured
    throughput (EWMA work-units/s from ``TicketQueue.stats``).

    Clients with ``None`` rate (never observed) share the mean of the known
    rates so newcomers aren't starved.  Integer apportionment uses the
    largest-remainder method; every client gets at least ``min_shard`` rows
    (dropping to 0 would stop us ever re-measuring a slow client).

    >>> adaptive_shard_sizes({"fast": 30.0, "slow": 10.0}, 8)
    {'fast': 6, 'slow': 2}
    """
    if not rates:
        return {}
    known = [r for r in rates.values() if r]
    fallback = (sum(known) / len(known)) if known else 1.0
    eff = {c: (r if r else fallback) for c, r in rates.items()}
    total = sum(eff.values())
    raw = {c: global_batch * r / total for c, r in eff.items()}
    # largest-remainder apportionment (sums to global_batch exactly)
    sizes = {c: int(raw[c]) for c in raw}
    by_remainder = sorted(raw, key=lambda c: raw[c] - int(raw[c]),
                          reverse=True)
    i = 0
    while sum(sizes.values()) < global_batch:
        sizes[by_remainder[i % len(by_remainder)]] += 1
        i += 1
    # enforce the floor only when it's satisfiable (global_batch may be
    # smaller than len(rates) * min_shard), stealing from the largest
    if min_shard * len(sizes) <= global_batch:
        for c in sizes:
            while sizes[c] < min_shard:
                donor = max(sizes, key=lambda d: (sizes[d], eff[d]))
                if sizes[donor] <= min_shard:
                    break
                sizes[donor] -= 1
                sizes[c] += 1
    return sizes


class RoundDriverLifetime:
    """Explicit client-lifetime ownership shared by the round drivers.

    A round driver needs the distributor's clients to survive drained
    queues between rounds, so constructing one flips ``keep_alive`` on —
    but the caller's original mode must come back when the driver is
    done, or a discarded driver leaves the distributor permanently
    changed.  :meth:`aclose` (or the async context manager) restores it."""

    def _own_clients(self, distributor):
        self.dist = distributor
        self._prev_keep_alive = distributor.keep_alive
        distributor.keep_alive = True
        self._closed = False

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    def _notify(self):
        """Wake the whole fabric (federation) or this distributor's
        parked waiters."""
        notify = getattr(self.dist, "_notify_all", None)
        (notify or self.dist._notify_waiters)()

    async def aclose(self, *, shutdown: bool = False):
        """End this driver's ownership of the client lifetime: restore
        the distributor's original ``keep_alive`` (parked clients wake,
        re-check the now-restored terminal condition, and exit once the
        queue drains), optionally shutting the distributor down outright.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.dist.keep_alive = self._prev_keep_alive
        if shutdown:
            await self.dist.shutdown()
        else:
            self._notify()


__all__ = ["RoundDriverLifetime", "TrainState", "adaptive_shard_sizes"]
