"""Sashimi demo on the PyTorch port (``repro_torch``; the JAX package's
twin is ``examples/torch_sashimi_browser_sim.py``): the paper's
PrimeListMakerProject (Appendix) plus a
distributed kNN job and a §4.1 split-training round, with simulated
browsers — including a flaky one that crashes and a tab that closes
mid-job, to show ticket redistribution.

Demo 1 runs on the v1 thread-per-client Distributor exactly as in the
paper; demos 2 and 3 run on Distributor v2 (asyncio, adaptively sized
lease batches) with a bimodal fast/slow client mix.

  PYTHONPATH=src python examples/torch_sashimi_browser_sim.py

``--federation`` runs the federation-fabric demo instead: a 3-member
federation over the sharded ticket store serves two task families at
once through per-member edge caches, member 0 is killed mid-run, and
the survivors steal its stranded work (``--all`` runs everything).

  PYTHONPATH=src python examples/torch_sashimi_browser_sim.py --federation

``--transport`` runs the cross-host transport demo: a 2-member
federation behind a ``TransportServer`` loopback socket, every client a
``RemoteBrowserClient`` speaking only the length-prefixed JSON protocol
(docs/PROTOCOL.md) — zero direct object references.  Mid-run every
connection is hard-dropped; the clients reconnect, resume their
unsubmitted results, and the round still completes exactly.

  PYTHONPATH=src python examples/torch_sashimi_browser_sim.py --transport

``--train`` runs the training-fabric demo: round-based data-parallel
SGD over a 3-member federation (``FederatedTrainer`` +
``FederatedTrainingLoop``), shard sizes fed by the fabric's measured
per-client rates (``client_rates`` → ``adaptive_shard_sizes``), a
straggler re-ticketed at the K-of-N barrier, one member killed mid-run
with its home shards rebalanced to survivors, and a round-boundary
checkpoint resumed to the identical loss.

  PYTHONPATH=src python examples/torch_sashimi_browser_sim.py --train

``--trace out.json`` runs the training-fabric demo with the
observability layer on: a ``repro_torch.obs.Tracer`` records the full causal
ticket lifecycle (enqueue -> route -> lease -> execute -> submit ->
barrier), the round timeline, straggler reticketing, and the member
kill + rebalance, then writes a Chrome trace-event JSON you can load
straight into https://ui.perfetto.dev (or chrome://tracing).

  PYTHONPATH=src python examples/torch_sashimi_browser_sim.py --trace out.json

The training demo's parameters and AdaGrad state live on ``--device``
(``cuda`` by default, ``cpu`` anywhere), and each round's server step is
``FusedServerStep``: on the card one launch of the fused server-step
kernel (K1), whose launch count the demo prints.  Each
``TransportServer.stop()`` is bounded: it waits for open connections.
"""
import argparse
import asyncio
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.distributor import (  # noqa: E402
    AdaptiveSizer, AsyncDistributor, ClientProfile, Distributor, TaskDef)
from repro_torch.core.federation import FederatedDistributor  # noqa: E402
from repro_torch.core.project import (  # noqa: E402
    CalculationFramework, ProjectBase, TaskBase)
from repro_torch.core.split_parallel import \
    SplitConcurrentDispatcher  # noqa: E402
from repro_torch.core.transport import (  # noqa: E402
    TransportServer, spawn_remote_clients)
from repro_torch.data import clustered_images  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.server_step.ops import \
    server_step_update  # noqa: E402

#: bound on ``TransportServer.stop()``, which awaits open connections
STOP_TIMEOUT_S = 60.0


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    i = 2
    while i * i <= n:
        if n % i == 0:
            return False
        i += 1
    return True


class IsPrimeTask(TaskBase):
    static_code_files = ("is_prime",)

    def run(self, input, static):  # noqa: A002
        return {"is_prime": static["is_prime"](input["candidate"])}


class PrimeListMakerProject(ProjectBase):
    """The paper's appendix example, 1..10000."""

    name = "PrimeListMakerProject"

    def run(self):
        task = self.create_task(IsPrimeTask)
        task.calculate([{"candidate": i} for i in range(1, 10001)])
        results = task.block(timeout=120)
        primes = [i + 1 for i, r in enumerate(results) if r["is_prime"]]
        return primes


def demo_primes_v1():
    """The paper's appendix example on the v1 thread simulator."""
    d = Distributor(timeout=5.0, redistribute_min=0.05)
    fw = CalculationFramework(d)
    fw.add_static("is_prime", is_prime)
    d.spawn_clients([
        ClientProfile(name="chrome-desktop"),
        ClientProfile(name="nexus7-tablet", latency=0.0005),
        ClientProfile(name="flaky-browser", fail_prob=0.05),
        ClientProfile(name="closed-tab", die_after=40),
    ])
    primes = fw.run_project(PrimeListMakerProject)
    console = d.console()
    d.shutdown()
    print(f"{len(primes)} primes found up to 10000 "
          f"(first: {primes[:8]} ... last: {primes[-3:]})")
    print(f"console: executed={console['executed']} "
          f"errors={console['errors']} "
          f"redistributions={console['redistributions']}")
    print(f"clients: {[(c['name'], c['executed']) for c in console['clients']]}")
    assert len(primes) == 1229  # π(10000)


async def demo_knn_v2():
    """Distributed kNN (Table-2 workload) on Distributor v2: a bimodal
    client mix, leases sized to each client's measured throughput."""
    train_x, train_y = clustered_images(2000, image_size=12, channels=1,
                                       seed=0)
    test_x, test_y = clustered_images(200, image_size=12, channels=1, seed=1)
    tr = train_x.reshape(len(train_x), -1)
    te = test_x.reshape(len(test_x), -1)

    def knn(args, static):
        lo, hi = args
        trx, try_ = static["train"]
        q = te[lo:hi]
        dist = ((q[:, None] - trx[None]) ** 2).sum(-1)
        return try_[np.argmin(dist, 1)].tolist()

    d = AsyncDistributor(timeout=10.0, redistribute_min=0.02,
                         sizer=AdaptiveSizer(target_lease_time=0.05,
                                             max_size=16),
                         watchdog_interval=0.01,
                         project_name="DistributedKnn")
    d.add_static("train", (tr, train_y))
    d.register_task(TaskDef("knn", knn, static_files=("train",)))
    tids = d.add_work("knn", [(i, i + 10) for i in range(0, len(te), 10)])
    d.spawn_clients(
        [ClientProfile(name=f"fast{i}", speed=400.0) for i in range(2)] +
        [ClientProfile(name=f"slow{i}", speed=50.0) for i in range(2)])
    assert await d.run_until_done(timeout=120)
    res = d.queue.results()
    pred = np.concatenate([res[t] for t in tids])
    acc = (pred == test_y).mean()
    snap = d.console()
    rates = {n: round(s["rate"] or 0.0, 1)
             for n, s in snap["clients"].items()}
    print(f"distributed kNN accuracy: {acc:.3f} "
          f"({snap['executed']} tickets, v2 adaptive leases)")
    print(f"measured client rates (work/s): {rates}")


async def demo_split_round_v2():
    """§4.1 split-concurrent rounds: backbone shard 'gradients' are
    computed by browser clients via the scheduler; the head would update
    server-side concurrently (here: the weighted aggregate).  Each round
    re-registers the stale-head weights as a versioned static — clients
    revalidate through their caches, so round t can never run against
    round t-1's weights (and unchanged data costs only a counter bump)."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(64, 8)).astype(np.float32)

    def backbone_shard(args, static):
        lo, hi = args["lo"], args["hi"]
        # stand-in for the backbone grad: per-shard mean feature, shifted
        # by this round's server-pushed weight offset
        return {"grad": data[lo:hi].mean(axis=0) + static["weights"],
                "n": hi - lo}

    d = AsyncDistributor(timeout=10.0, redistribute_min=0.02,
                         sizer=AdaptiveSizer(target_lease_time=0.05),
                         watchdog_interval=0.01,
                         project_name="SplitConcurrentRound")
    d.register_task(TaskDef("backbone_shard", backbone_shard,
                            static_files=("weights",)))
    d.spawn_clients([ClientProfile(name="fast", speed=400.0),
                     ClientProfile(name="slow", speed=80.0)])
    shards = [{"lo": i, "hi": i + 8} for i in range(0, 64, 8)]
    direct = data.mean(axis=0)
    # the dispatcher owns client lifetime: keep_alive between rounds,
    # restored when the context exits
    async with SplitConcurrentDispatcher(d) as disp:
        for rnd in range(3):
            outs = await disp.run_round(shards,
                                        shard_work=[8.0] * len(shards),
                                        statics={"weights": float(rnd)},
                                        timeout=60.0)
            agg = SplitConcurrentDispatcher.aggregate(
                [{"grad": o["grad"]} for o in outs], [o["n"] for o in outs])
            err = float(np.abs(agg["grad"] - (direct + rnd)).max())
            assert err < 1e-5, (rnd, err)
    await d.shutdown()
    reval = d.revalidation_count["task:backbone_shard"]
    print(f"split-concurrent: 3 rounds x {len(outs)} backbone shards via "
          f"scheduler, per-round weight re-registration picked up by every "
          f"client (max err {err:.2e}); weights downloaded "
          f"{d.download_count['weights']}x, unchanged task code "
          f"revalidated {reval}x")


async def demo_federation():
    """The federation fabric: 3 member distributors share one sharded
    ticket store (per-task shards, global VCT merge), a bimodal client
    mix is routed least-loaded, task code and datasets are served through
    per-member edge caches, and member 0 is killed mid-run — survivors'
    watchdogs release its stranded leases and steal the work."""
    fed = FederatedDistributor(
        3, n_shards=6, timeout=10.0, redistribute_min=0.5,
        sizer=AdaptiveSizer(target_lease_time=0.05, max_size=16),
        watchdog_interval=0.01, grace=2.0,
        project_name="FederationDemo")

    fed.add_static("is_prime", is_prime)
    fed.register_task(TaskDef(
        "prime", lambda n, s: s["is_prime"](n), static_files=("is_prime",)))
    fed.register_task(TaskDef("square", lambda x, _: x * x))
    prime_tids = fed.add_work("prime", list(range(2, 402)))
    square_tids = fed.add_work("square", list(range(200)))

    fed.spawn_clients(
        [ClientProfile(name=f"fast{i}", speed=4000.0) for i in range(3)] +
        [ClientProfile(name=f"slow{i}", speed=500.0) for i in range(3)])

    await asyncio.sleep(0.02)            # let leases get in flight
    downed = await fed.kill_member(0)
    ok = await fed.run_until_done(timeout=60.0)
    assert ok, fed.console()

    res = fed.queue.results()
    primes = [n for n, tid in zip(range(2, 402), prime_tids) if res[tid]]
    assert len(primes) == 79             # π(401)
    assert all(res[t] == i * i for i, t in enumerate(square_tids))

    con = fed.console()
    print(f"federation: {con['executed']} tickets across 2 task families, "
          f"{fed.queue.n_shards} shards, 3 members "
          f"(member0 killed mid-run, {downed} clients lost)")
    for m in con["members"]:
        e = m["edge"]
        print(f"  {m['name']}: alive={m['alive']} steals={m['steals']} "
              f"edge hit-rate={e['hit_rate']:.2f} "
              f"({e['hits']}/{e['requests']} requests served locally)")
    print(f"  origin egress: {dict(fed.download_count)} "
          f"(misses only — edges absorb the rest)")
    print(f"  lease releases (watchdog rescues): {con['lease_releases']}")


def prime_check(n, static):
    """Module-level so the task code pickles across the wire."""
    return static["is_prime"](n)


async def demo_transport():
    """Cross-host transport: a 2-member federation behind a loopback
    ``TransportServer``, every client a ``RemoteBrowserClient`` that holds
    no reference to any distributor object — leases, submits, asset
    fetches, and invalidations are all framed JSON round-trips
    (docs/PROTOCOL.md).  Mid-run the server hard-drops every connection;
    clients reconnect with resume and the round completes exactly."""
    fed = FederatedDistributor(
        2, n_shards=4, timeout=10.0, redistribute_min=0.05,
        sizer=AdaptiveSizer(target_lease_time=0.05, max_size=16),
        watchdog_interval=0.01, grace=2.0,
        project_name="TransportDemo")
    fed.add_static("is_prime", is_prime)
    fed.register_task(TaskDef("prime", prime_check,
                              static_files=("is_prime",)))
    prime_tids = fed.add_work("prime", list(range(2, 402)))

    server = TransportServer(fed)
    host, port = await server.start()
    clients, tasks = spawn_remote_clients(
        (host, port),
        [ClientProfile(name=f"remote{i}", speed=2000.0) for i in range(4)],
        reconnect_delay=0.02)

    await asyncio.sleep(0.05)            # let leases get in flight
    dropped = server.drop_connections()  # simulated network partition
    ok = await fed.run_until_done(timeout=60.0)
    assert ok, fed.console()
    await asyncio.gather(*tasks)
    wire = server.stats()
    await asyncio.wait_for(server.stop(), STOP_TIMEOUT_S)

    res = fed.queue.results()
    primes = [n for n, tid in zip(range(2, 402), prime_tids) if res[tid]]
    assert len(primes) == 79             # π(401)

    print(f"transport: {len(prime_tids)} tickets over {host}:{port}, "
          f"{dropped} connections dropped mid-run, "
          f"{sum(c.reconnects for c in clients)} reconnects — "
          f"all results exact")
    print(f"  wire: {wire['frames_in']}+{wire['frames_out']} frames, "
          f"{wire['bytes_in'] + wire['bytes_out']} bytes, "
          f"{wire['protocol_errors']} protocol errors")
    for c in clients:
        print(f"  {c.profile.name}: member={c.member} "
              f"executed={c.executed} revalidations={c.revalidations} "
              f"reconnects={c.reconnects}")
    print(f"  edges: "
          f"{[round(m.edge.stats()['hit_rate'], 2) for m in fed.members]} "
          f"hit rate; origin egress {dict(fed.download_count)}")


def training_grad_shard(args, static):
    """Module-level gradient task (pickles across the wire): exact
    linear-regression gradient of one row slice of the demo dataset,
    echoing the served weights' round tag (stale-weight detector)."""
    lo, hi = args
    X, y = static["train_data"]
    w = np.asarray(static["weights"]["params"]["w"])
    r = X[lo:hi] @ w - y[lo:hi]
    return {"grad": {"w": (2.0 * X[lo:hi].T @ r / (hi - lo))
                     .astype(np.float32)},
            "loss": float((r ** 2).mean()),
            "round": static["weights"]["round"]}


async def demo_training(checkpoint_dir, trace_path=None, device="cuda"):
    """Training fabric: §4.1 data-parallel rounds as a first-class
    federation workload — measured-rate shard sizing, straggler-aware
    K-of-N barrier, mid-run member death with shard rebalancing, and a
    bit-exact round-boundary checkpoint resume.  With ``trace_path``,
    the whole first run is recorded by a ``repro_torch.obs.Tracer`` and
    written out as Perfetto-loadable Chrome trace-event JSON.  The
    parameters live on ``device``."""
    from repro_torch.core.split_parallel import TrainState, adaptive_shard_sizes
    from repro_torch.obs import MetricsRegistry, Tracer, collect_fabric
    from repro_torch.optim import adagrad
    from repro_torch.train_fabric import (FederatedTrainer, FederatedTrainingLoop,
                                    FusedServerStep, Rebalancer,
                                    checkpoint_path, load_round_checkpoint)

    dev = resolve_device(device)
    rng = np.random.default_rng(3)
    X = rng.normal(size=(96, 6)).astype(np.float32)
    w_true = rng.normal(size=(6,)).astype(np.float32)
    y = (X @ w_true).astype(np.float32)
    lr = 0.3
    opt = adagrad(lr)

    async def run(rounds, resume_from=None, kill_at=None, tracer=None,
                  metrics=None):
        from repro_torch.core.distributor import FixedSizer
        fed = FederatedDistributor(
            3, n_shards=6, timeout=20.0, redistribute_min=0.02,
            # one-ticket leases: every client (straggler included) holds
            # exactly one rate-sized shard per round
            sizer=FixedSizer(1),
            watchdog_interval=0.01, grace=2.0,
            project_name="TrainingFabricDemo", tracer=tracer)
        if tracer is not None:
            tracer.clock = fed.queue.clock
        fed.add_static("train_data", (X, y))
        fed.register_task(TaskDef("grad_shard", training_grad_shard,
                                  static_files=("weights", "train_data")))
        fed.spawn_clients(
            [ClientProfile(name=f"fast{i}", speed=2000.0) for i in range(4)]
            + [ClientProfile(name="straggler", speed=40.0)])
        if resume_from is None:
            params = {"w": torch.zeros(6)}
            state = TrainState(params=params, head={}, head_stale={},
                               opt_state=opt.init(params), head_opt_state={},
                               prev_features=(), prev_labels=(),
                               prev_mask=(),
                               step=torch.zeros((), dtype=torch.int32))
            start = 0
        else:
            state, start, _ = load_round_checkpoint(resume_from)
        trainer = FederatedTrainer(
            fed, task_name="grad_shard", barrier_k=0.8,
            straggler_policy="reticket", timeout=30.0,
            rebalancer=Rebalancer(fed, steal_threshold=3, cooldown=1,
                                  metrics=metrics),
            metrics=metrics)
        loop = FederatedTrainingLoop(
            trainer, opt, state, round_index=start,
            checkpoint_dir=checkpoint_dir,
            # the fused server step: clip + weighted mean + modified
            # AdaGrad in one pass (bit-equal to the tree_map reference)
            server_step=FusedServerStep(opt, lr=lr), device=dev)
        shard_plans = []
        async with trainer:
            for _ in range(start, rounds):
                if kill_at is not None and loop.round_index == kill_at:
                    await fed.kill_member(0)
                # measured per-client EWMA rates size the round's shards:
                # the straggler's slice shrinks to its throughput, so the
                # barrier stays quiet once the fabric has measured it
                rates = {c: r for c, r in fed.client_rates().items() if r}
                if rates:
                    sizes = [s for s in
                             adaptive_shard_sizes(rates, 96).values()
                             if s > 0]
                else:
                    sizes = [12] * 8       # unmeasured: equal slices
                bounds = np.cumsum([0] + sizes)
                args = [(int(a), int(b))
                        for a, b in zip(bounds[:-1], bounds[1:])]
                shard_plans.append(sizes)
                await loop.run_round(args, [float(s) for s in sizes])
            await trainer.aclose(shutdown=True)
        return loop, fed, trainer, shard_plans

    tracer = Tracer() if trace_path is not None else None
    metrics = MetricsRegistry() if trace_path is not None else None
    server_step_update.launches = 0
    loop, fed, trainer, plans = await run(6, kill_at=2, tracer=tracer,
                                          metrics=metrics)
    launches = server_step_update.launches
    assert loop.stale_executions == 0
    assert loop.losses[-1] < loop.losses[0]
    con = fed.console()
    print(f"training fabric: {loop.round_index} rounds, loss "
          f"{loop.losses[0]:.4f} -> {loop.losses[-1]:.4f}, "
          f"{loop.stale_executions} stale-weight executions")
    print(f"  straggler re-ticketed {trainer.reticketed_total}x at the "
          f"K-of-N barrier; member0 killed at round 2, "
          f"{con['migrations']} home shards rebalanced to survivors")
    rates = {n: round(r or 0.0, 1) for n, r in fed.client_rates().items()}
    print(f"  measured client rates feeding shard sizes (rows/s): {rates}")
    print(f"  shard plan: round 0 (unmeasured) {plans[0]} -> "
          f"round {len(plans) - 1} (rate-sized) {plans[-1]}")
    print(f"kernel launches: server_step={launches} "
          f"({loop.round_index} rounds on {dev.type})", flush=True)
    if dev.type == "cuda":
        assert launches == loop.round_index, launches

    if trace_path is not None:
        assert tracer.balanced(), tracer.open_spans()
        tracer.write(trace_path)
        collect_fabric(metrics, distributor=fed)
        steals = metrics.get("federation.steals_total").total()
        migs = metrics.get("rebalancer.migrations_total").total()
        print(f"  trace: {tracer.event_count()} events "
              f"({tracer.spans_closed} spans, all balanced) -> {trace_path} "
              f"(open in ui.perfetto.dev)")
        step_h = metrics.get("round.server_step_seconds")
        print(f"  metrics: {len(metrics.names())} series — e.g. "
              f"federation.steals_total={steals:.0f} "
              f"rebalancer.migrations_total={migs:.0f} "
              f"round.barrier_wait_seconds count="
              f"{metrics.get('round.barrier_wait_seconds').count()}")
        print(f"  fused server step: "
              f"{metrics.get('round.model_params_count').value():.0f} "
              f"params updated {step_h.count()}x, "
              f"{1e3 * step_h.sum() / max(step_h.count(), 1):.2f} ms/round "
              f"(round.server_step_seconds)")

    # kill-and-resume: a fresh federation continues from the round-4
    # checkpoint and lands on the identical loss trajectory
    resumed, _, _, _ = await run(
        6, resume_from=checkpoint_path(checkpoint_dir, 4))
    delta = max(abs(a - b)
                for a, b in zip(loop.losses[4:], resumed.losses))
    assert delta < 1e-5, delta   # partitions may differ; the math is exact
    print(f"  resumed from round-4 checkpoint: max |Δloss| vs unkilled "
          f"run = {delta:.1e} (paper JSON+base64 format, bit-exact)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--federation", action="store_true",
                    help="run the federation-fabric demo only")
    ap.add_argument("--transport", action="store_true",
                    help="run the cross-host transport demo only")
    ap.add_argument("--train", action="store_true",
                    help="run the training-fabric demo only")
    ap.add_argument("--trace", metavar="PATH",
                    help="run the training-fabric demo with the tracer on "
                         "and write a Perfetto trace-event JSON to PATH")
    ap.add_argument("--all", action="store_true",
                    help="run every demo including federation + transport")
    ap.add_argument("--device", default="cuda",
                    help="where the training demo's parameters live")
    args = ap.parse_args(argv)
    if args.trace:
        with tempfile.TemporaryDirectory() as ckdir:
            asyncio.run(demo_training(ckdir, trace_path=args.trace,
                                      device=args.device))
        return
    if args.federation:
        asyncio.run(demo_federation())
        return
    if args.transport:
        asyncio.run(demo_transport())
        return
    if args.train:
        with tempfile.TemporaryDirectory() as ckdir:
            asyncio.run(demo_training(ckdir, device=args.device))
        return
    demo_primes_v1()
    asyncio.run(demo_knn_v2())
    asyncio.run(demo_split_round_v2())
    if args.all:
        asyncio.run(demo_federation())
        asyncio.run(demo_transport())
        with tempfile.TemporaryDirectory() as ckdir:
            asyncio.run(demo_training(ckdir, device=args.device))


if __name__ == "__main__":
    main()
