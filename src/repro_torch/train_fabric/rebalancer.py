"""Shard rebalancing: move a hot task's shard between federation members
when load skews.

The signal was already there — each :class:`~repro.core.federation.
FederationMember` counts ``steals`` (lease grants that had to reach
outside its home shards).  A member that steals round after round is
telling us its home set is chronically dry while some other member's
home shards carry the backlog; every one of those steals pays the
full-fabric merge (all shard locks peeked) instead of the home fast
path.  The :class:`Rebalancer` turns the counter into action: when a
member's steal *delta* over an observation window crosses the threshold,
the donor member whose home shards hold the most waiting tickets gives
its busiest shard to the thief (``FederatedDistributor.migrate_shard``).

Two extra rules keep it stable and fault-aware:

  * **cool-down** — at most one migration per ``cooldown`` observation
    windows, so a transient imbalance can't make shards ping-pong;
  * **failover** — a dead member's home shards are orphaned (nobody
    serves them from the fast path; every grant against them is a
    steal), so they are migrated to survivors first, round-robin,
    regardless of counters.

The trainer calls :meth:`Rebalancer.observe_round` at round boundaries;
any long-running producer can do the same on its own cadence.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class Migration:
    """One home-shard move, for consoles and tests."""

    shard_index: int
    from_member: int
    to_member: int
    reason: str                  # "steals" | "failover"


class Rebalancer:
    """Watch per-member steal counters; migrate home shards to the
    members that keep having to steal (and off dead members)."""

    def __init__(self, federation, *, steal_threshold: int = 4,
                 cooldown: int = 2, metrics=None):
        self.fed = federation
        self.steal_threshold = steal_threshold
        self.cooldown = cooldown
        self._last_steals = {m.index: m.steals for m in federation.members}
        self._since_migration = cooldown       # first window may migrate
        self.history: list[Migration] = []
        self.metrics = metrics
        if metrics is not None:
            self._m_migrations = metrics.counter(
                "rebalancer.migrations_total",
                "Home-shard migrations performed by the rebalancer",
                labels=("reason",))

    # -- helpers --------------------------------------------------------------

    def _waiting_by_member(self) -> dict[int, int]:
        """Waiting-ticket backlog summed over each member's home shards."""
        return {m.index: sum(sh.snapshot()["waiting"]
                             for sh in m.home_shards)
                for m in self.fed.members}

    def _busiest_home_shard(self, member) -> Optional[int]:
        """The member's home shard with the most waiting tickets."""
        best: tuple[int, Optional[int]] = (-1, None)
        for sh in member.home_shards:
            w = sh.snapshot()["waiting"]
            idx = next(j for j, q in enumerate(self.fed.queue.shards)
                       if q is sh)
            if w > best[0]:
                best = (w, idx)
        return best[1]

    def _migrate(self, shard_index: int, donor: int, to_member: int,
                 reason: str) -> Optional[Migration]:
        if not self.fed.migrate_shard(shard_index, to_member):
            return None
        mig = Migration(shard_index, donor, to_member, reason)
        self.history.append(mig)
        if self.metrics is not None:
            self._m_migrations.inc(reason=reason)
        return mig

    # -- the per-round hook ----------------------------------------------------

    def observe_round(self) -> list[Migration]:
        """One observation window: fail over dead members' shards, then
        (at most once per cool-down) move the busiest backlogged shard to
        the member with the largest steal delta.  Returns the migrations
        performed this window (usually empty)."""
        out: list[Migration] = []
        alive = self.fed.alive_members()
        if not alive:
            return out

        # failover first: orphaned home shards to survivors, round-robin
        rr = 0
        for m in self.fed.members:
            if m.alive:
                continue
            for sh in list(m.home_shards):
                idx = next(j for j, q in enumerate(self.fed.queue.shards)
                           if q is sh)
                target = alive[rr % len(alive)].index
                mig = self._migrate(idx, m.index, target, "failover")
                if mig is not None:
                    out.append(mig)
                    rr += 1

        # steal-driven migration, throttled by the cool-down
        deltas = {}
        for m in self.fed.members:
            deltas[m.index] = m.steals - self._last_steals.get(m.index, 0)
            self._last_steals[m.index] = m.steals
        self._since_migration += 1
        if self._since_migration <= self.cooldown:
            return out
        thief_idx = max((i for i in deltas if self.fed.members[i].alive),
                        key=lambda i: deltas[i], default=None)
        if thief_idx is None or deltas[thief_idx] < self.steal_threshold:
            return out
        waiting = self._waiting_by_member()
        donor_idx = max((i for i in waiting if i != thief_idx
                         and self.fed.members[i].alive
                         and len(self.fed.members[i].home_shards) > 1),
                        key=lambda i: waiting[i], default=None)
        if donor_idx is None or waiting[donor_idx] == 0:
            return out
        shard_idx = self._busiest_home_shard(self.fed.members[donor_idx])
        if shard_idx is None:
            return out
        mig = self._migrate(shard_idx, donor_idx, thief_idx, "steals")
        if mig is not None:
            out.append(mig)
            self._since_migration = 0
        return out


__all__ = ["Migration", "Rebalancer"]
