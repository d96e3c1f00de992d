"""The rest of the fabric in the port: its copies of ``repro.obs``, the
shard rebalancer, and the round engine's SLO seam
(``FederatedTrainer(slos=)``), held to the JAX package's behaviour.

The modules are byte copies (``tests/test_torch_guard.py`` holds them to
their originals), so what is tested here is that the port's round engine
wires them as the JAX package's does: the JAX package's own SLO and
rebalancer scenarios (``tests/test_fleet.py:375-408``,
``tests/test_train_fabric.py:284-317``) run against the port, each beside
the same scenario in the JAX package, and one CNN round on the CPU runs
with both, plus an SLO that must breach.
"""
import asyncio

import numpy as np
import pytest
import torch

from repro.core import distributor as jdist
from repro.core import federation as jfed
from repro.obs import DEFAULT_ROUND_SLOS as JAX_DEFAULT_ROUND_SLOS
from repro.obs import MetricsRegistry as JaxMetricsRegistry
from repro.train_fabric import FederatedTrainer as JaxFederatedTrainer
from repro.train_fabric import Rebalancer as JaxRebalancer
from repro_torch.configs.paper_cnn import FABRIC_CNN
from repro_torch.core import distributor as pdist
from repro_torch.core import federation as pfed
from repro_torch.models import cnn
from repro_torch.obs import DEFAULT_ROUND_SLOS, MetricsRegistry, Slo
from repro_torch.optim import adagrad
from repro_torch.train_fabric import (FederatedTrainer,
                                      FederatedTrainingLoop,
                                      FusedServerStep, Migration, Rebalancer)
from repro_torch.core.split_parallel import TrainState

#: (distributor module, federation module, trainer, rebalancer, registry,
#: default SLOs) of each package
PACKAGES = {
    "port": (pdist, pfed, FederatedTrainer, Rebalancer, MetricsRegistry,
             DEFAULT_ROUND_SLOS),
    "jax": (jdist, jfed, JaxFederatedTrainer, JaxRebalancer,
            JaxMetricsRegistry, JAX_DEFAULT_ROUND_SLOS),
}


def _make_fed(pkg, n_members=2, **kw):
    dist_mod, fed_mod = PACKAGES[pkg][:2]
    kw.setdefault("timeout", 5.0)
    kw.setdefault("redistribute_min", 0.02)
    kw.setdefault("sizer", dist_mod.AdaptiveSizer(target_lease_time=0.02,
                                                  max_size=8))
    kw.setdefault("watchdog_interval", 0.005)
    kw.setdefault("grace", 2.0)
    return fed_mod.FederatedDistributor(n_members, **kw)


# --- SLOs (tests/test_fleet.py:375-408) ---------------------------------------


def _slo_round(pkg):
    dist_mod, _, trainer_cls, _, registry_cls, slos = PACKAGES[pkg]

    def run(args, static):
        return {"grad": {"w": np.full(2, float(args), np.float32)},
                "loss": float(args)}

    async def body():
        fed = _make_fed(pkg)
        fed.register_task(dist_mod.TaskDef("backbone_shard", run,
                                           static_files=("weights",)))
        fed.spawn_clients([dist_mod.ClientProfile(name=f"c{i}", speed=400.0)
                           for i in range(3)])
        reg = registry_cls()
        async with trainer_cls(fed, timeout=20.0, metrics=reg,
                               slos=slos) as tr:
            res = await tr.run_round([1.0, 2.0], shard_work=[1.0, 1.0],
                                     statics={"weights": {"round": 0}})
        await fed.shutdown()
        return res

    return asyncio.run(body())


def test_trainer_round_result_carries_slo_verdicts():
    """Every default SLO is evaluated at round close and holds, with the
    names, stats and verdicts of the JAX package's trainer in the same
    round."""
    res = _slo_round("port")
    assert res.slos is not None and len(res.slos) == len(DEFAULT_ROUND_SLOS)
    assert res.slo_ok, res.slos
    assert {s["name"] for s in res.slos} == \
        {s.name for s in DEFAULT_ROUND_SLOS}
    want = _slo_round("jax")

    def shape(slos):
        return [(s["name"], s["metric"], s["stat"], s["op"], s["threshold"],
                 s["ok"]) for s in slos]

    assert shape(res.slos) == shape(want.slos)
    assert res.slo_ok == want.slo_ok


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_trainer_slos_require_metrics(pkg):
    """``slos=`` without ``metrics=`` raises ``ValueError`` in both
    packages."""
    trainer_cls, slos = PACKAGES[pkg][2], PACKAGES[pkg][5]
    fed = _make_fed(pkg)
    with pytest.raises(ValueError):
        trainer_cls(fed, slos=slos)
    fed.keep_alive = False


# --- the rebalancer (tests/test_train_fabric.py:284-317) ----------------------


def _migrations(migs) -> list:
    return [(m.shard_index, m.from_member, m.to_member, m.reason)
            for m in migs]


def _chronic_stealer(pkg):
    dist_mod, _, _, reb_cls = PACKAGES[pkg][:4]
    fed = _make_fed(pkg, 2, n_shards=4)
    reb = reb_cls(fed, steal_threshold=2, cooldown=1)
    fed.register_task(dist_mod.TaskDef("t", lambda a, s: a))
    home0 = fed.home_shard_indices(0)
    fed.add_work("t", list(range(10)), shard=home0[0])
    fed.members[1].steals = 5
    first = reb.observe_round()
    fed.members[1].steals += 5
    again = reb.observe_round()
    return (fed, home0, first, again)


def test_rebalancer_migrates_to_chronic_stealer():
    fed, home0, migs, again = _chronic_stealer("port")
    assert len(migs) == 1 and isinstance(migs[0], Migration)
    m = migs[0]
    assert m.reason == "steals"
    assert m.from_member == 0 and m.to_member == 1
    assert m.shard_index in home0
    assert m.shard_index in fed.home_shard_indices(1)
    assert fed.migrations == 1
    assert again == []                # cool-down
    _, _, jmigs, jagain = _chronic_stealer("jax")
    assert _migrations(migs) == _migrations(jmigs)
    assert _migrations(again) == _migrations(jagain)


def _failover(pkg):
    reb_cls = PACKAGES[pkg][3]
    fed = _make_fed(pkg, 3, n_shards=6)
    reb = reb_cls(fed)
    dead_home = fed.home_shard_indices(0)
    fed.members[0].alive = False
    return fed, dead_home, reb.observe_round()


def test_rebalancer_fails_over_dead_members_shards():
    fed, dead_home, migs = _failover("port")
    assert len(dead_home) == 2
    assert {m.reason for m in migs} == {"failover"}
    assert sorted(m.shard_index for m in migs) == sorted(dead_home)
    assert fed.home_shard_indices(0) == []
    assert len(fed.home_shard_indices(1)) == 3
    assert len(fed.home_shard_indices(2)) == 3
    _, _, jmigs = _failover("jax")
    assert _migrations(migs) == _migrations(jmigs)


# --- one CNN round through the port with both ---------------------------------

ROWS, SHARDS, LR = 96, 4, 0.05
ARGS = [(lo, lo + ROWS // SHARDS) for lo in range(0, ROWS, ROWS // SHARDS)]
WORK = [float(ROWS // SHARDS)] * SHARDS
#: the planted fault: a round-latency objective no real round meets
BREACHING = (Slo("round-latency-p95-1us", "round.duration_seconds", "<=",
                 1e-6, stat="p95"),)


async def _cnn_rounds(rounds, slos):
    fed = pfed.FederatedDistributor(
        2, n_shards=4, timeout=20.0, redistribute_min=0.02,
        sizer=pdist.FixedSizer(1), watchdog_interval=0.01, grace=2.0)
    fed.register_task(pdist.TaskDef(
        "cnn_grad_shard", cnn.CnnGradShard(FABRIC_CNN, n_rows=ROWS,
                                           device="cpu"),
        static_files=("weights",)))
    fed.spawn_clients([pdist.ClientProfile(name=f"c{i}", speed=2000.0)
                       for i in range(3)])
    opt = adagrad(LR)
    params = cnn.init_cnn(torch.Generator().manual_seed(0), FABRIC_CNN,
                          "cpu")
    state = TrainState(params=params, head={}, head_stale={},
                       opt_state=opt.init(params), head_opt_state={},
                       prev_features=(), prev_labels=(), prev_mask=(),
                       step=np.zeros((), np.int32))
    reb = Rebalancer(fed, steal_threshold=1, cooldown=1)
    trainer = FederatedTrainer(fed, task_name="cnn_grad_shard",
                               barrier_k=0.75, straggler_policy="reticket",
                               timeout=30.0, metrics=MetricsRegistry(),
                               slos=slos, rebalancer=reb)
    loop = FederatedTrainingLoop(trainer, opt, state,
                                 server_step=FusedServerStep(opt, lr=LR),
                                 device="cpu")
    results = []
    try:
        async with trainer:
            for _ in range(rounds):
                results.append(await loop.run_round(ARGS, WORK))
    finally:
        await fed.shutdown()
    return loop, reb, results


def test_cnn_rounds_with_slos_and_rebalancer():
    """Two FABRIC_CNN rounds with the default SLOs and a rebalancer: every
    SLO holds each round, the migrations the rebalancer made are counted
    in the round results, and the loss falls; the same rounds with a
    round-latency SLO of 1 us must breach it."""
    loop, reb, results = asyncio.run(_cnn_rounds(2, DEFAULT_ROUND_SLOS))
    rounds = results
    assert loop.stale_executions == 0 and loop.round_index == 2
    for r in rounds:
        assert r.slos is not None and r.slo_ok, r.slos
        assert {s["name"] for s in r.slos} == \
            {s.name for s in DEFAULT_ROUND_SLOS}
    assert sum(r.migrations for r in rounds) == len(reb.history)
    assert loop.losses[-1] < loop.losses[0]
    _, _, bad = asyncio.run(_cnn_rounds(1, BREACHING))
    (r,) = bad
    assert not r.slo_ok
    assert r.slos[0]["name"] == "round-latency-p95-1us"
    assert r.slos[0]["value"] > 1e-6
