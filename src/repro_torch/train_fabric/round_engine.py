"""The federation-scale round engine for §4.1 training (port of
``repro.train_fabric.round_engine``).

The barrier logic is framework-free and is the JAX package's; what the
port changes is where the arrays live.  The loop's ``TrainState`` lives on
one device (``cuda`` unless the caller asks for ``cpu``); each round's
weights are published to the fabric as a host numpy tree, because the
fabric's delta registry and wire codec read leaves with ``np.asarray``;
gradients come back as numpy and the server step uploads them.  The
round SLOs (``slos=``) are evaluated by the port's copy of ``repro.obs``
(``repro_torch.obs.slo``) against the trainer's ``metrics=`` registry;
``rebalancer=`` (``repro_torch.train_fabric.rebalancer``) is duck-typed
as in the JAX package.

The training fabric workload runs over the whole stack — sharded store,
federation members, edge caches, cross-host transport:

  * :class:`FederatedTrainer` — the round engine.  Each round's shards
    are enqueued with **per-member shard affinity** (spread across the
    alive members' home shards via ``add_work(shard=...)``, so each
    member serves its slice from its own locks), per-round weights are
    published through the versioned-statics path BEFORE the tickets
    pin their coherence version (a client can never compute round *t*
    against round *t−1* weights, no matter how its cache is warmed), and
    the round closes through a **straggler-aware K-of-N barrier**.
  * :class:`FederatedTrainingLoop` — round-based data-parallel SGD on
    top of the engine: publish weights → fan gradient shards → work-
    weighted aggregate → server-side optimizer step, with full
    ``TrainState`` checkpoints at round boundaries (resumable — see
    ``checkpointing.py``).

Straggler policies (paper §4: heterogeneous devices — one slow browser
must not stall the fleet):

  * ``"wait"``     — classic full barrier: the round closes only when
                     all N shard gradients arrive.
  * ``"reticket"`` — when K of N have arrived, the laggards' leases are
                     force-released (VCT reset), so idle fast clients
                     redo them immediately; the round still closes with
                     all N gradients — **exact** math, bounded tail.
  * ``"fold"``     — when K of N have arrived, the laggard tickets are
                     cancelled and the round closes with the K arrived
                     gradients; the work-weighted ``aggregate`` then
                     normalises over the arrived work only (approximate
                     math, hard latency bound).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Optional

from repro_torch.core.split_parallel import (RoundDriverLifetime, TrainState,
                                             adaptive_shard_sizes)
from repro_torch.core.tickets import CANCELLED
from repro_torch.device import resolve_device
from repro_torch.train_fabric.checkpointing import (checkpoint_path,
                                                    save_round_checkpoint)
from repro_torch.train_fabric.server_step import (ServerStep, TreeServerStep,
                                                  param_count)
from repro_torch.tree import tree_as_tensors, tree_to_numpy

STRAGGLER_POLICIES = ("wait", "reticket", "fold")


class EmptyRoundError(RuntimeError):
    """A round closed with ZERO arrived gradients (every shard folded or
    timed out), so there is nothing to aggregate: applying an optimizer
    step here would silently train on garbage (a 0/0 weighted mean).
    Carries the offending :class:`RoundResult` so callers can inspect
    which shards straggled and decide whether to retry the round or
    abort; the loop leaves its state untouched (same ``round_index``,
    same params), so a retry is just calling ``run_round`` again."""

    def __init__(self, round_index: int, result: "RoundResult"):
        super().__init__(
            f"training round {round_index} closed with 0 of "
            f"{len(result.ticket_ids)} shard gradients arrived "
            f"({len(result.stragglers)} straggler(s) folded) — nothing "
            f"to aggregate")
        self.round_index = round_index
        self.result = result


def resolve_barrier_k(n: int, barrier_k) -> int:
    """Concrete K for an N-shard round: ``None`` → N (full barrier), a
    float in (0, 1] → ``ceil(frac * N)``, an int → clamped to [1, N]."""
    if barrier_k is None:
        return n
    if isinstance(barrier_k, float):
        if not 0.0 < barrier_k <= 1.0:
            raise ValueError(f"fractional barrier_k must be in (0, 1], "
                             f"got {barrier_k}")
        return max(1, min(n, math.ceil(barrier_k * n)))
    return max(1, min(n, int(barrier_k)))


def affinity_placement(distributor, n: int
                       ) -> Optional[dict[int, list[int]]]:
    """{queue-shard index: [round-shard positions]} spreading an N-shard
    round across the alive members' home shards (None when the
    distributor has no federation surface — plain single ``add_work``).
    Standalone so planners (benchmark sims, dashboards) can use it
    without constructing a trainer and taking client-lifetime
    ownership."""
    if not hasattr(distributor, "alive_members"):
        return None
    homes = [(m.index, distributor.home_shard_indices(m.index))
             for m in distributor.alive_members()]
    homes = [(i, hs) for i, hs in homes if hs]
    if not homes:
        return None
    groups: dict[int, list[int]] = {}
    for pos in range(n):
        _, hs = homes[pos % len(homes)]
        shard = hs[(pos // len(homes)) % len(hs)]
        groups.setdefault(shard, []).append(pos)
    return groups


@dataclass
class RoundResult:
    """One closed training round."""

    index: int                      # round number (zero-based)
    results: list                   # per-shard results; None where folded
    ticket_ids: list
    arrived: list                   # shard positions that arrived
    stragglers: list = field(default_factory=list)   # positions folded
    reticketed: int = 0             # laggard tickets force-released
    work_arrived: float = 0.0
    work_total: float = 0.0
    duration: float = 0.0           # on the queue's (injectable) clock
    barrier_wait: float = 0.0       # clock time between K-of-N and close
    migrations: int = 0             # rebalancer moves at this boundary
    metrics: Optional[dict] = None  # registry snapshot, when trainer has one
    slos: Optional[list] = None     # SLO evaluations at round close, when
    #                                 the trainer holds an SloMonitor
    publish_deltas: dict = field(default_factory=dict)
    # per published static: the origin registry's delta view at publish
    # time ({"version", "leaves", "changed", "window"}) — ``changed``
    # counts the leaf arrays a v2 client actually downloads this round
    # (the wire-protocol delta payload); ``leaves`` is what a v1 client
    # or cold cache pulls.  Empty when the distributor predates the v2
    # delta registry.

    @property
    def complete(self) -> bool:
        """True when every shard's gradient arrived (nothing folded)."""
        return not self.stragglers

    @property
    def slo_ok(self) -> bool:
        """True when no SLO breached at round close (vacuously true
        when the trainer evaluates none)."""
        return all(r["ok"] for r in self.slos) if self.slos else True


class FederatedTrainer(RoundDriverLifetime):
    """Round engine over any distributor duck-typing the v2 surface
    (``AsyncDistributor``, ``FederatedDistributor`` — in-process clients
    or remote ones behind a ``TransportServer`` alike).

    Owns the client lifetime explicitly (``RoundDriverLifetime``):
    constructing the trainer flips the distributor to ``keep_alive``
    (clients must survive drained queues between rounds) and
    :meth:`aclose` — or the async context manager — restores the
    caller's original mode, so a discarded trainer can't leave the
    distributor in a changed state."""

    def __init__(self, distributor, *, task_name: str = "backbone_shard",
                 barrier_k=None, straggler_policy: str = "wait",
                 timeout: float = 60.0, stall_after: Optional[float] = None,
                 rebalancer=None, metrics=None, slos=None):
        if straggler_policy not in STRAGGLER_POLICIES:
            raise KeyError(f"straggler_policy must be one of "
                           f"{STRAGGLER_POLICIES}, got {straggler_policy!r}")
        self._own_clients(distributor)
        self.task_name = task_name
        self.barrier_k = barrier_k
        self.straggler_policy = straggler_policy
        self.timeout = timeout
        # a round STALLS when no new shard arrives for ``stall_after``
        # clock seconds while it is still open — the symptom of a churned
        # fleet whose stranded leases are not coming back.  Stalls are
        # counted (and traced) without aborting the round: eviction or
        # the watchdog may still rescue it before ``timeout``.  The chaos
        # harness asserts this counter stays 0 under 20%/round churn.
        self.stall_after = stall_after
        self.rebalancer = rebalancer
        self.rounds = 0
        self.stalls = 0
        self.reticketed_total = 0
        self.folded_total = 0
        self.tracer = getattr(distributor, "tracer", None)
        self.metrics = metrics
        if metrics is not None:
            self._m_duration = metrics.histogram(
                "round.duration_seconds",
                "Virtual-clock duration of each closed training round")
            self._m_barrier = metrics.histogram(
                "round.barrier_wait_seconds",
                "Clock time spent waiting between K-of-N and round close")
            self._m_reticketed = metrics.counter(
                "round.reticketed_total",
                "Laggard leases force-released by the reticket policy")
            self._m_folded = metrics.counter(
                "round.folded_total",
                "Straggler shards folded (cancelled) at round close")
            self._m_timeouts = metrics.counter(
                "round.timeouts_total", "Training rounds abandoned on timeout")
            self._m_stalls = metrics.counter(
                "round.stalls_total",
                "Open rounds that made no progress for stall_after seconds")
            self._m_lost = metrics.counter(
                "round.lost_tickets_total",
                "Shard tickets abandoned un-arrived at a round timeout")
        # declarative round-health objectives (repro_torch.obs.slo),
        # evaluated at every round close against the trainer's registry;
        # results land in RoundResult.slos and breaches emit slo.breach
        # instants
        self.slo_monitor = None
        if slos:
            if metrics is None:
                raise ValueError("slos= requires metrics= (the monitor "
                                 "evaluates against the registry)")
            from repro_torch.obs.slo import SloMonitor
            self.slo_monitor = SloMonitor(metrics, slos, tracer=self.tracer)

    # -- shard planning --------------------------------------------------------

    def _live_rates(self) -> dict:
        """Measured per-client rates, minus clients known to be gone
        (dead members' clients, finished in-process clients) — their
        EWMA entries outlive them in ``queue.stats``, and a phantom
        client must not be apportioned a shard nobody will execute.
        Remote clients can't be enumerated and stay in (their rates age
        out of relevance only by not being refreshed)."""
        if not hasattr(self.dist, "client_rates"):
            return {}
        rates = {c: r for c, r in self.dist.client_rates().items() if r}
        gone: set = set()
        for m in getattr(self.dist, "members", [self.dist]):
            gone.update(c.profile.name for c in getattr(m, "clients", ())
                        if c.done or not getattr(m, "alive", True))
        return {c: r for c, r in rates.items() if c not in gone}

    def plan_shards(self, global_batch: int, *, default_shards: int = 4,
                    min_shard: int = 1) -> list[int]:
        """Row counts per shard for the next round, sized to **measured**
        per-client EWMA throughput (``client_rates``) so every client's
        slice takes about the same wall time — the barrier closes as one.
        Before any measurement (or without rates) the batch splits into
        ``default_shards`` near-equal slices."""
        rates = self._live_rates()
        if not rates:
            k = min(default_shards, global_batch)
            base, rem = divmod(global_batch, k)
            return [base + (1 if i < rem else 0) for i in range(k)]
        sizes = adaptive_shard_sizes(rates, global_batch,
                                     min_shard=min_shard)
        return [s for s in sizes.values() if s > 0]

    # -- affinity placement ----------------------------------------------------

    def placement(self, n: int) -> Optional[dict[int, list[int]]]:
        """Per-member affinity map for an N-shard round (see
        :func:`affinity_placement`)."""
        return affinity_placement(self.dist, n)

    # -- the round -------------------------------------------------------------

    def _reticket_stragglers(self, laggard_tids) -> int:
        """Force-release every outstanding lease holding a laggard ticket
        (VCT reset → immediately eligible), so idle fast clients redo the
        stragglers' work; the slow client's own late submit is folded by
        the queue's first-result-wins rule."""
        lagset = set(laggard_tids)
        released = 0
        for batch in self.dist.queue.outstanding_leases():
            if lagset & set(batch.ticket_ids):
                released += self.dist.queue.release(batch.lease_id,
                                                    client_failed=False)
        if released:
            self._notify()
        return released

    async def run_round(self, shard_args, *, shard_work=None,
                        statics=None, timeout: Optional[float] = None
                        ) -> RoundResult:
        """Execute one training round through the fabric.

        ``statics`` (e.g. this round's weights) are re-registered on the
        origin BEFORE the tickets are enqueued, so the tickets pin the
        new coherence version and every client revalidates before
        executing.  Re-registering through the v2 delta registry stamps
        each leaf array with the version it last changed, so remote v2
        clients revalidating against a warm cache download only the
        changed leaves (``RoundResult.publish_deltas`` records the
        per-key delta view).  Returns a :class:`RoundResult` with
        per-shard results ordered like ``shard_args`` (None where the
        barrier folded a straggler)."""
        if self._closed:
            raise RuntimeError("trainer is closed")
        n = len(shard_args)
        if shard_work is None:
            shard_work = [1.0] * n
        publish_deltas: dict = {}
        if statics:
            stats_fn = getattr(self.dist, "static_delta_stats", None)
            for key, value in statics.items():
                self.dist.add_static(key, value)
                if stats_fn is not None:
                    publish_deltas[key] = stats_fn(key)
        t0 = self.dist.queue.clock()
        groups = self.placement(n)
        if groups is None:
            tids = list(self.dist.add_work(self.task_name, list(shard_args),
                                           work=list(shard_work)))
        else:
            tids: list = [None] * n
            for shard, positions in groups.items():
                got = self.dist.add_work(
                    self.task_name, [shard_args[p] for p in positions],
                    work=[shard_work[p] for p in positions], shard=shard)
                for p, tid in zip(positions, got):
                    tids[p] = tid
        k = resolve_barrier_k(n, self.barrier_k)
        timeout = self.timeout if timeout is None else timeout
        deadline = t0 + timeout
        wall_deadline = time.monotonic() + max(timeout, 60.0)
        reticketed = 0
        did_reticket = False
        folded: list[int] = []
        tr = self.tracer
        round_span = None
        span_status = "ok"
        if tr is not None:
            round_span = tr.begin(
                "round", track="trainer", cat="round", lane=True, ts=t0,
                args={"round": self.rounds, "shards": n, "barrier_k": k,
                      "policy": self.straggler_policy})
        barrier_open: Optional[float] = None   # clock when K-of-N reached
        progress_count = -1                # arrivals at last progress mark
        progress_at = t0
        stalled = False                    # at most one stall per round
        try:
            while True:
                # capture the wake epoch before probing: a submit can only
                # land at an await point, so a notification can't be missed
                wake = self.dist._wake_event()
                done = self.dist.queue.completed_results(tids)
                if len(done) > progress_count:
                    progress_count = len(done)
                    progress_at = self.dist.queue.clock()
                elif (self.stall_after is not None and not stalled
                        and self.dist.queue.clock() - progress_at
                        > self.stall_after):
                    stalled = True
                    self.stalls += 1
                    if self.metrics is not None:
                        self._m_stalls.inc()
                    if tr is not None:
                        tr.instant("round.stall", track="trainer",
                                   cat="warning",
                                   ts=self.dist.queue.clock(),
                                   args={"round": self.rounds,
                                         "arrived": len(done), "n": n,
                                         "stalled_for": self.stall_after})
                if len(done) >= k and barrier_open is None:
                    barrier_open = self.dist.queue.clock()
                    if tr is not None:
                        tr.instant("round.barrier_open", track="trainer",
                                   cat="round", ts=barrier_open,
                                   args={"round": self.rounds,
                                         "arrived": len(done), "k": k})
                if len(done) >= n:
                    break
                if len(done) >= k and self.straggler_policy != "wait":
                    laggards = [tid for tid in tids if tid not in done]
                    if self.straggler_policy == "fold":
                        self.dist.queue.cancel(laggards)
                        self._notify()
                        done = self.dist.queue.completed_results(tids)
                        if tr is not None:
                            tr.instant(
                                "round.fold", track="trainer", cat="round",
                                ts=self.dist.queue.clock(),
                                args={"round": self.rounds,
                                      "folded": len(laggards)})
                        break
                    if not did_reticket:      # once per round: no thrash
                        did_reticket = True
                        reticketed = self._reticket_stragglers(laggards)
                        if tr is not None:
                            tr.instant(
                                "round.reticket", track="trainer",
                                cat="round", ts=self.dist.queue.clock(),
                                args={"round": self.rounds,
                                      "laggards": len(laggards),
                                      "released": reticketed})
                if (self.dist.queue.clock() > deadline
                        or time.monotonic() > wall_deadline):
                    # abandon the round cleanly: cancel the stragglers and
                    # prune everything so the queue doesn't keep zombie
                    # tickets leasable (and all_done() poisoned) after the
                    # caller handles the timeout
                    span_status = "timeout"
                    if self.metrics is not None:
                        self._m_timeouts.inc()
                        self._m_lost.inc(n - len(done))
                    if tr is not None:
                        tr.instant("round.timeout", track="trainer",
                                   cat="round", ts=self.dist.queue.clock(),
                                   args={"round": self.rounds,
                                         "arrived": len(done), "n": n})
                    self.dist.queue.cancel(
                        [tid for tid in tids if tid not in done])
                    self._notify()
                    self.dist.queue.prune(tids)
                    raise TimeoutError(
                        f"training round {self.rounds} unfinished: "
                        f"{self.dist.console()}")
                await self.dist._wait_on(wake, 0.05)
        finally:
            if tr is not None:
                tr.end(round_span, ts=self.dist.queue.clock(),
                       args={"status": span_status})
        # forget the finished round so queue scans stay O(one round)
        self.dist.queue.prune(tids)
        results, arrived, stragglers = [], [], []
        for pos, tid in enumerate(tids):
            r = done.get(tid)
            if r is CANCELLED or tid not in done:
                results.append(None)
                stragglers.append(pos)
            else:
                results.append(r)
                arrived.append(pos)
        migrations = 0
        if self.rebalancer is not None:
            migrations = len(self.rebalancer.observe_round())
        t_close = self.dist.queue.clock()
        barrier_wait = (t_close - barrier_open
                        if barrier_open is not None else 0.0)
        out = RoundResult(
            index=self.rounds, results=results, ticket_ids=tids,
            arrived=arrived, stragglers=stragglers, reticketed=reticketed,
            work_arrived=sum(shard_work[p] for p in arrived),
            work_total=float(sum(shard_work)),
            duration=t_close - t0, barrier_wait=barrier_wait,
            migrations=migrations, publish_deltas=publish_deltas)
        self.rounds += 1
        self.reticketed_total += reticketed
        self.folded_total += len(stragglers)
        if self.metrics is not None:
            self._m_duration.observe(out.duration)
            self._m_barrier.observe(barrier_wait)
            if reticketed:
                self._m_reticketed.inc(reticketed)
            if stragglers:
                self._m_folded.inc(len(stragglers))
            if self.slo_monitor is not None:
                out.slos = [r.as_dict() for r in
                            self.slo_monitor.evaluate(ts=t_close)]
            out.metrics = self.metrics.snapshot()
        return out


class FederatedTrainingLoop:
    """Round-based data-parallel SGD over a :class:`FederatedTrainer`.

    Server side (this object): holds the full
    :class:`~repro_torch.core.split_parallel.TrainState` on ``device``
    (every array leaf of the given state is moved there as a tensor),
    publishes the current params each round as the versioned
    ``weights_key`` static — a host numpy tree tagged with the round
    number; over the v2 wire protocol a warm remote client then downloads
    only the param leaves that changed since its cached round — aggregates
    the arrived shard gradients with the work-weighted mean, applies the
    optimizer, and checkpoints at round boundaries.  Client side: the task
    registered under the trainer's ``task_name`` receives
    ``static[weights_key] = {"round": t, "params": ...}`` and must return
    ``{grad_key: grad_pytree, loss_key: float, "round": t_seen}`` per
    shard — the echoed round tag lets the loop count stale-weight
    executions (zero by construction; asserted by ``chip_smoke.py``)."""

    def __init__(self, trainer: FederatedTrainer, opt, state: TrainState, *,
                 weights_key: str = "weights", grad_key: str = "grad",
                 loss_key: str = "loss", round_index: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1,
                 extra: Optional[dict] = None,
                 server_step: Optional[ServerStep] = None,
                 device="cuda"):
        self.trainer = trainer
        self.opt = opt
        dev = resolve_device(device)
        self.state = TrainState(**{
            k: tree_as_tensors(v, dev) for k, v in vars(state).items()})
        self.weights_key = weights_key
        self.grad_key = grad_key
        self.loss_key = loss_key
        self.round_index = round_index
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.extra = dict(extra or {})
        self.losses: list[float] = []
        self.stale_executions = 0
        self.server_step = (server_step if server_step is not None
                            else TreeServerStep(opt))
        self._m_step_s = self._m_params = self._m_stale = None
        if trainer.metrics is not None:
            self._m_step_s = trainer.metrics.histogram(
                "round.server_step_seconds",
                "Wall time of the server-side aggregate+update step")
            self._m_params = trainer.metrics.gauge(
                "round.model_params_count",
                "Scalar parameters in the model being trained")
            self._m_params.set(param_count(state.params))
            self._m_stale = trainer.metrics.counter(
                "round.stale_executions_total",
                "Arrived gradients computed against a previous round's "
                "weights (zero by construction; SLO-gated)")

    async def run_round(self, shard_args, shard_work) -> RoundResult:
        """One SGD round: publish → fan out → aggregate → update →
        checkpoint.  Records the round's work-weighted training loss."""
        t = self.round_index
        res = await self.trainer.run_round(
            shard_args, shard_work=shard_work,
            statics={self.weights_key: {
                "round": t, "params": tree_to_numpy(self.state.params)}})
        got = [res.results[p] for p in res.arrived]
        if not got:
            tr = self.trainer.tracer
            if tr is not None:
                tr.instant("round.empty_fold", track="trainer", cat="round",
                           ts=self.trainer.dist.queue.clock(),
                           args={"round": t,
                                 "stragglers": len(res.stragglers)})
            raise EmptyRoundError(t, res)
        for g in got:
            if isinstance(g, dict) and g.get("round", t) != t:
                self.stale_executions += 1
                if self._m_stale is not None:
                    self._m_stale.inc()
        works = [shard_work[p] for p in res.arrived]
        t_step = time.perf_counter()
        new_params, new_opt = self.server_step.step(
            [g[self.grad_key] for g in got], works,
            self.state.params, self.state.opt_state)
        if self._m_step_s is not None:
            self._m_step_s.observe(time.perf_counter() - t_step)
        self.state = replace(
            self.state, params=new_params, opt_state=new_opt,
            step=self.state.step + 1)
        loss = float(sum(g[self.loss_key] * w for g, w in zip(got, works))
                     / sum(works))
        self.losses.append(loss)
        self.round_index = t + 1
        if (self.checkpoint_dir is not None and self.checkpoint_every
                and self.round_index % self.checkpoint_every == 0):
            self.checkpoint()
        return res

    def checkpoint(self) -> str:
        """Write the round-boundary checkpoint (atomic; resumable with
        :func:`~repro_torch.train_fabric.checkpointing.load_round_checkpoint`
        in either package)."""
        extra = {"task_name": self.trainer.task_name,
                 "straggler_policy": self.trainer.straggler_policy,
                 "losses": list(self.losses), **self.extra}
        return save_round_checkpoint(
            checkpoint_path(self.checkpoint_dir, self.round_index),
            self.state, round_index=self.round_index, extra=extra)


__all__ = ["EmptyRoundError", "FederatedTrainer", "FederatedTrainingLoop",
           "RoundResult", "STRAGGLER_POLICIES", "affinity_placement",
           "resolve_barrier_k"]
