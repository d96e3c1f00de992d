"""The compiled step on a mesh, on the CPU: ``StepBundle.lower()`` (the
counterpart of the JAX bundles' ``jax.jit`` under their shardings) and the
sharded decode step's cache write at a device index.

One 2-rank (1x2) gloo world of ``tests/torch_mesh_worker.py`` processes
(``run_world`` of ``tests/test_torch_mesh.py``, with its hard timeout)
runs every case; this process computes the unsharded references with the
port alone, from the same numpy weights (the port's init, from a seed).

What is held:

* (a) the decode step's sharded KV write at a device index
  (``models.layers.write_row``) equals a copy of the write it made before,
  from the index read to the host (``_parent_write_rows`` in the worker),
  bit for bit in the logits and every cache leaf, for qwen3-4b's and the
  Jamba cut's smoke configs in both decode layouts, at slots in rank 0's
  sequence shard, in rank 1's, on both sides of the shard boundary, on the
  last row, past the end (clamped) and, with a sliding window, ring-wrapped
  into rank 0's shard; greedy decoding on the mesh stays within
  ``SERVE_TOL`` of the unsharded port.
* (b) ``bundle.lower()``: 3 training steps under ``fsdp_tp`` and
  ``split_concurrent`` (qwen3-4b) and 4 decode steps (qwen3-4b, the Jamba
  cut, rwkv6-1.6b) equal a plain loop of the bundle's eager call bit for
  bit, on the CPU route and on the graph route's bookkeeping around a
  stand-in capture (``capture_type``), whose capture counts the
  collective calls it records.
* (c) a decode step that reads its index on the host (the planted
  host-int write) fails a check that refuses host reads, which the step
  as it is passes.
* (d) a new-state leaf placed otherwise than its buffer raises
  ``ValueError``, on both routes.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import make_lm_batch
from repro_torch.models.model import build_model, params_from_numpy
from repro_torch.sharding.spec import values_tree
from repro_torch.tree import to_numpy, tree_map
from test_torch_mesh import SERVE_TOL, run_world

MESH = (1, 2)
MOE_CAPACITY = 8.0                       # nothing drops: both runs route alike
B, PROMPT, GEN = 4, 12, 4
WINDOW = 8
#: decode indices of (a): with a 16-row cache split in two 8-row shards,
#: rank 0's rows 3 and 7, rank 1's 8, 12 and its last row 15, and 17
#: past the end (clamped onto 15); with the window's 8-row ring in two
#: 4-row shards, slots 4 and 7 (rank 1) and, wrapped, 0 and 3 (rank 0)
INDICES = {0: [3, 7, 8, 12, 15, 17], WINDOW: [12, 15, 16, 19]}
WRITE_CASES = [(arch, layout, window)
               for arch, window in (("qwen3-4b", 0), ("qwen3-4b", WINDOW),
                                    ("jamba-1.5-large-398b", 0))
               for layout in ("batch_sharded", "replicated_batch")]
LOWER_TRAIN = [(strategy, graphed) for strategy in ("fsdp_tp",
                                                   "split_concurrent")
               for graphed in (False, True)]
LOWER_DECODE = [(arch, graphed) for arch in ("qwen3-4b",
                                             "jamba-1.5-large-398b",
                                             "rwkv6-1.6b")
                for graphed in (False, True)]
TRAIN_STEPS, LR, SEQ = 3, 0.05, 16


def _cfg(arch, window=0):
    cfg = get_smoke_config(arch)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_CAPACITY))
    return cfg.with_sliding_window(window) if window else cfg


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The port's init of the smoke config, from a seed, as numpy."""
    api = build_model(_cfg(arch), compute_dtype=torch.float32)
    return tree_map(to_numpy,
                    values_tree(api.init(torch.Generator().manual_seed(0))))


def _tokens(arch):
    return np.random.default_rng(1).integers(
        0, get_smoke_config(arch).vocab_size, (B, PROMPT)).astype(np.int32)


def _serve_job(kind, arch, layout="batch_sharded", window=0, **kw):
    return dict(kind=kind, mesh=MESH, arch=arch, layout=layout,
                window=window, gen=GEN, moe_capacity=MOE_CAPACITY,
                params=_params(arch), tokens=_tokens(arch), **kw)


def _train_job(strategy, graphed):
    cfg = get_smoke_config("qwen3-4b")
    rng = np.random.default_rng(0)
    return dict(kind="lower_train", mesh=MESH, arch="qwen3-4b",
                strategy=strategy, graphed=graphed, lr=LR,
                params=_params_untied("qwen3-4b", strategy),
                batches=[make_lm_batch(rng, B, SEQ, cfg.vocab_size)
                         for _ in range(TRAIN_STEPS)])


def _params_untied(arch, strategy):
    """The init of the config the training bundle builds (a split
    strategy unties the head)."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.steps import arch_for_run
    cfg = arch_for_run(get_smoke_config(arch),
                       InputShape("c", SEQ, B, "train"), strategy)
    api = build_model(cfg, compute_dtype=torch.float32)
    return tree_map(to_numpy,
                    values_tree(api.init(torch.Generator().manual_seed(0))))


def _key(job):
    kind = job["kind"]
    if kind in ("decode_write", "host_read"):
        return (kind, job["arch"], job["layout"], job["window"])
    if kind == "lower_train":
        return (kind, job["strategy"], job["graphed"])
    if kind == "lower_decode":
        return (kind, job["arch"], job["graphed"])
    return (kind,)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jobs = ([_serve_job("decode_write", a, l, w,
                        indices=INDICES[w]) for a, l, w in WRITE_CASES]
            + [_train_job(s, g) for s, g in LOWER_TRAIN]
            + [_serve_job("lower_decode", a, graphed=g)
               for a, g in LOWER_DECODE]
            + [_serve_job("host_read", "qwen3-4b"),
               dict(kind="placement_mismatch", mesh=MESH)])
    res = run_world(tmp_path_factory.mktemp("w2g"), 2, jobs, timeout=240)
    return {_key(j): r for j, r in zip(jobs, res)}


@functools.lru_cache(maxsize=None)
def _unsharded_serve(arch, window):
    """The port's greedy decoding off the mesh: the prefill's logits, then
    each step's."""
    cfg = _cfg(arch, window)
    api = build_model(cfg, compute_dtype=torch.float32, remat=False)
    params = params_from_numpy(cfg, _params(arch), "cpu")
    with torch.no_grad():
        logits, cache = api.prefill(
            params, {"tokens": torch.from_numpy(_tokens(arch))},
            cache_len=PROMPT + GEN)
        out = [logits.numpy()]
        for i in range(GEN):
            tok = logits[:, -1:, :cfg.vocab_size].argmax(-1).to(torch.int32)
            logits, cache = api.decode_step(params, cache, tok, PROMPT + i)
            out.append(logits.numpy())
    return out


# --- (a) the device-index write --------------------------------------------


@pytest.mark.parametrize("arch,layout,window", WRITE_CASES)
def test_device_index_write_equals_the_host_int_write(world, arch, layout,
                                                      window):
    got = world[("decode_write", arch, layout, window)]
    rows = PROMPT + GEN if not window else WINDOW
    assert got["cache_rows"] == rows and got["shard_rows"] == rows // 2
    assert [i for i, _, _ in got["steps"]] == INDICES[window]
    slots = {(i % rows if window else min(i, rows - 1)) // (rows // 2)
             for i in INDICES[window]}
    assert slots == {0, 1}                     # both ranks' shards written
    for i, logits_equal, cache_equal in got["steps"]:
        assert logits_equal and cache_equal, (arch, layout, window, i)


@pytest.mark.parametrize("arch,layout,window", WRITE_CASES)
def test_sharded_greedy_decode_within_serve_tol(world, arch, layout,
                                                window):
    got = world[("decode_write", arch, layout, window)]["served"]
    want = _unsharded_serve(arch, window)
    assert len(got) == len(want) == GEN + 1
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, **SERVE_TOL, err_msg=f"logits {i}")


# --- (b) lower() against the bundle's eager call ----------------------------


@pytest.mark.parametrize("strategy,graphed", LOWER_TRAIN)
def test_lowered_train_equals_the_eager_bundle_loop(world, strategy,
                                                    graphed):
    got = world[("lower_train", strategy, graphed)]
    assert got["same"] == [(True, True)] * TRAIN_STEPS, got["same"]
    assert got["placed_as"]
    assert got["captured"] == graphed
    if graphed:
        assert sum(got["collectives"].values()) > 0, got["collectives"]
    else:
        assert got["collectives"] is None


@pytest.mark.parametrize("arch,graphed", LOWER_DECODE)
def test_lowered_decode_equals_the_eager_bundle_loop(world, arch, graphed):
    got = world[("lower_decode", arch, graphed)]
    assert got["same"] == [(True, True)] * GEN, got["same"]
    assert got["captured"] == graphed
    if graphed:
        assert sum(got["collectives"].values()) > 0, got["collectives"]


# --- (c) a host value frozen into the step ----------------------------------


def test_a_host_read_in_the_decode_step_fails_the_check(world):
    got = world[("host_read", "qwen3-4b", "batch_sharded", 0)]
    assert got["as_is"] is None, got["as_is"]
    assert got["planted"] and "host" in got["planted"], got


# --- (d) a placement mismatch ------------------------------------------------


def test_a_new_state_leaf_placed_otherwise_raises(world):
    got = world[("placement_mismatch",)]
    for route, msg in got.items():
        assert msg and "placed" in msg and "['w']" in msg, (route, msg)
