"""The port's sharded paths on gloo worlds of CPU ranks, held to its own
unsharded runs and to the JAX package's on the same numpy inputs.

Each world is a set of ``tests/torch_mesh_worker.py`` processes (torch
and ``repro_torch`` alone), rendezvousing through a ``FileStore`` under
``tmp_path`` (never a fixed port: several test workers run at once), each
under a hard timeout: on expiry every rank is killed and the test fails.
One 4-rank world runs every 2x2 case, one 2-rank world the 1x2 cases,
and the CLI runs under ``torchrun``.

What is held:

* 3 steps of ``dp_full``, ``fsdp_tp`` and ``split_concurrent`` on a 2x2
  mesh for the smoke configs of qwen3-4b, dbrx-132b and rwkv6-1.6b: every
  loss and state leaf within the f32 model bar (atol 2e-4 / rtol 1e-3) of
  the port's unsharded steps and of the JAX package's, from the JAX init.
  dbrx-132b runs at capacity factor 8 (no assignment dropped), as the
  JAX package's own sharded-MoE test does: the expert-parallel path sizes
  each rank's capacity by its own tokens, and its auxiliary loss is the
  mean over the data shards of each shard's loss (both the JAX
  package's design, ``moe.py:190, 273-279``), so the references
  compute the auxiliary loss that way too (:func:`_shard_mean_aux`).
* a prefill and 4 greedy decode steps under ``fsdp_tp`` in both decode
  layouts (qwen3-4b; dbrx-132b through the sharded MoE; rwkv6-1.6b with
  K5's plain version on each rank's batch and head shard; the Jamba smoke
  cut with K4's on its batch and inner shard, K3's and the sharded MoE;
  qwen3-4b and the Jamba cut on the 1x2 mesh too): logits within
  chip_smoke's ``SERVE_TOL`` (1e-3) and equal greedy tokens; the
  prefill's cache placed as the JAX prefill's (the batch over data),
  rank 0 holding its own shard of each leaf alone (1/``data`` of the KV
  cache), and redistributed once by the decode step to its layout.
* ``_apply_moe_sharded`` on dbrx-132b's smoke MoE (E 4) on 1x2 and 2x2
  meshes, and its partial-sum decode schedule: forward and gradients
  within 2e-5 (``tests/test_moe.py``'s bar) of the local dispatch; its
  planted fault (the sum over ``model`` left out) must fail.
* ``FusedServerStep(mesh=)`` over 2 and 4 ranks bitwise equal to one
  rank, with n not a multiple of ranks x the row pitch.
* every kernel wrapper refuses a DTensor; the decode graph runner adopts
  a DTensor cache (the decode bundle's ``lower()``), equal to the
  bundle's eager step bit for bit.
* the embedding lookup and the cross-entropy, whole and vocab-chunked,
  keep the vocab sharded on a 2x2 mesh under ``fsdp_tp`` (half the vocab
  a rank), within 1e-5 of the plain ones forward and backward; their planted fault (the lookup's sum
  over the vocab shards left out) must fail.
"""
import dataclasses
import functools
import os
import pickle
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import split_parallel as JSP
from repro.launch.steps import arch_for_run as jax_arch_for_run
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro.models.model import build_model as jax_build_model
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.configs import InputShape, get_smoke_config
from repro_torch.core import split_parallel as S
from repro_torch.data import make_lm_batch
from repro_torch.launch.steps import arch_for_run
from repro_torch.models import moe as port_moe
from repro_torch.models import transformer as port_transformer
from repro_torch.models.model import build_model, params_from_numpy
from repro_torch.optim import adagrad, get_optimizer
from repro_torch.train_fabric.server_step import FusedServerStep
from repro_torch.tree import to_numpy, tree_as_tensors, tree_leaves

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_mesh_worker.py")

TOL = dict(atol=2e-4, rtol=1e-3)          # the f32 model bar
SERVE_TOL = dict(atol=1e-3, rtol=0.0)     # chip_smoke.py's
MOE_TOL = dict(atol=2e-5, rtol=0.0)       # tests/test_moe.py's
B, SEQ, STEPS, LR = 4, 16, 3, 0.05
ARCHS = ("qwen3-4b", "dbrx-132b", "rwkv6-1.6b")
STRATEGIES = ("dp_full", "fsdp_tp", "split_concurrent")
#: strategies whose rules shard the experts over ``model``: the MoE takes
#: the expert-parallel path there (dp_full's replicate them)
EXPERT_PARALLEL = ("fsdp_tp", "split_concurrent")
MOE_CAPACITY = 8.0
DATA_SHARDS = 2
SERVE = [(arch, layout) for arch in ("qwen3-4b", "dbrx-132b", "rwkv6-1.6b",
                                    "jamba-1.5-large-398b")
         for layout in ("batch_sharded", "replicated_batch")]
#: the serve cases of the 1x2 world (one data shard: the batch is whole on
#: every rank, the heads and Mamba's inner dimension split)
SERVE_1X2 = [(arch, layout) for arch in ("qwen3-4b", "jamba-1.5-large-398b")
             for layout in ("batch_sharded", "replicated_batch")]
#: the prefill's cache placements on a (data, model) mesh, as the JAX
#: prefill's compile places it (``tests/test_torch_prefill_cache.py``):
#: the batch over data, Mamba's inner dimension and rwkv's WKV heads over
#: model, the positions replicated
PREFILL_CACHE_PLACEMENTS = {
    "k": "(Shard(dim=1), Replicate())", "v": "(Shard(dim=1), Replicate())",
    "pos": "(Replicate(), Replicate())",
    "ssm": "(Shard(dim=2), Shard(dim=3))",
    "conv": "(Shard(dim=2), Shard(dim=4))",
    "wkv": "(Shard(dim=1), Shard(dim=2))",
    "shift_tm": "(Shard(dim=1), Replicate())",
    "shift_cm": "(Shard(dim=1), Replicate())"}
PROMPT, GEN = 12, 4


def run_world(tmp_path, world: int, jobs: list, timeout: float) -> list:
    """Start ``world`` worker ranks on ``jobs``; return rank 0's results.
    Every rank is killed, and the test fails, at ``timeout`` seconds."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    store, jp, out = (str(tmp_path / n) for n in ("store", "jobs.pkl",
                                                  "out.pkl"))
    with open(jp, "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world),
                               store, jp, out], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    t0, logs = time.time(), []
    try:
        for p in procs:
            left = max(1.0, timeout - (time.time() - t0))
            try:
                logs.append(p.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                pytest.fail(f"a {world}-rank world ran past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, (bad, "\n".join(log[-3000:] for log in logs))
    with open(out, "rb") as f:
        return pickle.load(f)


# --- inputs -----------------------------------------------------------------


def _cfgs(arch: str, strategy: str = "fsdp_tp"):
    """(JAX cfg, port cfg) of the smoke config as each ``arch_for_run``
    gives it, a MoE's capacity factor set to ``MOE_CAPACITY``."""
    shape = InputShape("custom", SEQ, B, "train")
    out = []
    for cfg, surgery in ((jax_smoke_config(arch), jax_arch_for_run),
                         (get_smoke_config(arch), arch_for_run)):
        cfg = surgery(cfg, shape, strategy)
        if cfg.is_moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=MOE_CAPACITY))
        out.append(cfg)
    return tuple(out)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_init(arch: str, tied: bool):
    """The JAX package's init of the smoke config (its Param tree)."""
    cfg = dataclasses.replace(jax_smoke_config(arch), tie_embeddings=tied)
    return jax.jit(jax_build_model(cfg).init)(jax.random.PRNGKey(0))


def _jax_params(arch: str, tied: bool):
    """That init as a numpy values tree, the input of every run."""
    from repro.sharding.spec import values_tree
    return _np(values_tree(_jax_init(arch, tied)))


def _batches(vocab: int) -> list:
    rng = np.random.default_rng(0)
    return [make_lm_batch(rng, B, SEQ, vocab) for _ in range(STEPS)]


def _shard_mean_aux(apply_moe):
    """``apply_moe`` whose auxiliary loss is the mean over ``DATA_SHARDS``
    batch shards of each shard's own (the expert-parallel path's); y is
    the whole batch's."""
    def run(p, cfg, x, **kw):
        y, _ = apply_moe(p, cfg, x, **kw)
        rows = x.shape[0] // DATA_SHARDS
        auxes = [apply_moe(p, cfg, x[i * rows:(i + 1) * rows], **kw)[1]
                 for i in range(DATA_SHARDS)]
        return y, sum(auxes) / DATA_SHARDS
    return run


def _train_jobs():
    jobs = []
    for arch in ARCHS:
        for strategy in STRATEGIES:
            jcfg, _ = _cfgs(arch, strategy)
            jobs.append(dict(kind="train", mesh=(2, 2), arch=arch,
                             strategy=strategy, lr=LR,
                             moe_capacity=MOE_CAPACITY,
                             params=_jax_params(arch, jcfg.tie_embeddings),
                             batches=_batches(jcfg.vocab_size)))
    return jobs


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(1).integers(
        0, vocab, (B, PROMPT)).astype(np.int32)


def _serve_jobs(mesh=(2, 2), cases=SERVE):
    return [dict(kind="serve", mesh=mesh, arch=arch, layout=layout,
                 gen=GEN, moe_capacity=MOE_CAPACITY,
                 params=_jax_params(arch, jax_smoke_config(arch)
                                    .tie_embeddings),
                 tokens=_tokens(jax_smoke_config(arch).vocab_size))
            for arch, layout in cases]


def _moe_inputs(shape):
    """dbrx-132b's smoke MoE layer (the JAX init), an input ``shape`` and
    a cotangent, from a seed."""
    from repro.sharding.spec import values_tree
    cfg = jax_smoke_config("dbrx-132b")
    p = _np(values_tree(jax_moe.init_moe(jax.random.PRNGKey(0), cfg)))
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, shape + (cfg.d_model,)).astype(np.float32)
    w = rng.normal(0, 1, shape + (cfg.d_model,)).astype(np.float32)
    return p, x, w


#: name -> (mesh, input shape, rules over fsdp_tp's, planted fault)
MOE_CASES = {
    "1x2": ((1, 2), (4, 16), {}, False),
    "2x2": ((2, 2), (4, 16), {}, False),
    "2x2-partial-sum": ((2, 2), (2, 1), {"batch": None}, False),
    "2x2-fault": ((2, 2), (4, 16), {}, True),
}


def _moe_job(name):
    mesh, shape, rules, fault = MOE_CASES[name]
    p, x, w = _moe_inputs(shape)
    return dict(kind="moe", mesh=mesh, arch="dbrx-132b", params=p, x=x,
                w=w, rules=rules, fault=fault,
                capacity_factor=MOE_CAPACITY, name=name)


def _server_inputs(seed=3):
    """A round of 3 members over leaves of 1,000 + 37 + 1 elements: n 1,038
    is not a multiple of ranks x the row pitch (32) for 2 or 4 ranks."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (40, 25), "b": (37,), "c": ()}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    acc = {k: rng.uniform(0, 1, s).astype(np.float32)
           for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return dict(params=params, acc=acc, grads=grads, works=[1.0, 2.0, 3.0],
                lr=0.05, wd=0.01, clip=2.5)


def _server_job(ranks):
    return dict(kind="server_step", mesh=(ranks, 1), **_server_inputs())


#: the vocab-parallel embedding and loss: vocab, width, batch, sequence
VOCAB_V, VOCAB_D, VOCAB_B, VOCAB_S = 64, 16, 4, 6
#: the chunked loss's chunks: two of 16 columns on each rank's vocab half
VOCAB_CHUNKS = 4


def _vocab_inputs(seed=5):
    rng = np.random.default_rng(seed)
    v, d, b, s = VOCAB_V, VOCAB_D, VOCAB_B, VOCAB_S
    return dict(
        table=rng.normal(0, 1, (v, d)).astype(np.float32),
        logits=rng.normal(0, 3, (b, s, v)).astype(np.float32),
        tokens=rng.integers(0, v, (b, s)).astype(np.int32),
        labels=rng.integers(0, v, (b, s)).astype(np.int32),
        mask=(rng.uniform(0, 1, (b, s)) < 0.8).astype(np.float32),
        w=rng.normal(0, 1, (b, s, d)).astype(np.float32),
        feats=rng.normal(0, 1, (b, s, d)).astype(np.float32),
        head_w=rng.normal(0, 0.5, (d, v)).astype(np.float32),
        n_chunks=VOCAB_CHUNKS)


def _vocab_job(fault):
    return dict(kind="vocab", mesh=(2, 2), fault=fault, **_vocab_inputs())


@pytest.fixture(scope="module")
def world_2x2(tmp_path_factory):
    jobs = (_train_jobs() + _serve_jobs()
            + [_moe_job(n) for n in MOE_CASES if MOE_CASES[n][0] == (2, 2)]
            + [_server_job(4), dict(kind="refusals", mesh=(2, 2)),
               dict(kind="decode_graph", mesh=(2, 2)),
               _vocab_job(False), _vocab_job(True)])
    res = run_world(tmp_path_factory.mktemp("w4"), 4, jobs, timeout=420)
    return {_job_key(j): r for j, r in zip(jobs, res)}


@pytest.fixture(scope="module")
def world_1x2(tmp_path_factory):
    jobs = ([_moe_job("1x2"), _server_job(2)]
            + _serve_jobs((1, 2), SERVE_1X2))
    res = run_world(tmp_path_factory.mktemp("w2"), 2, jobs, timeout=240)
    return {_job_key(j): r for j, r in zip(jobs, res)}


def _job_key(job):
    kind = job["kind"]
    if kind == "train":
        return (kind, job["arch"], job["strategy"])
    if kind == "serve":
        return (kind, job["arch"], job["layout"])
    if kind == "moe":
        return (kind, job["name"])
    if kind == "server_step":
        return (kind, job["mesh"][0])
    if kind == "vocab":
        return (kind, job["fault"])
    return (kind,)


# --- references -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _port_train(arch: str, strategy: str):
    """The port's unsharded run: (states, metrics) after each step."""
    _, cfg = _cfgs(arch, strategy)
    api = build_model(cfg, compute_dtype=torch.float32, remat=True)
    init, step = S.make_train_step(
        api, get_optimizer("adagrad", LR, use_kernel=True),
        strategy=strategy)
    batches = [tree_as_tensors(b) for b in _batches(cfg.vocab_size)]
    state = init(params=params_from_numpy(
        cfg, _jax_params(arch, cfg.tie_embeddings), "cpu"))
    if strategy == "split_concurrent":
        state = S.init_prev_features(state, api, batches[0],
                                     dtype=torch.float32)
    states, metrics = [], []
    with pytest.MonkeyPatch.context() as mp:
        if cfg.is_moe and strategy in EXPERT_PARALLEL:
            mp.setattr(port_transformer, "apply_moe", _shard_mean_aux(
                port_transformer.apply_moe))
        for b in batches:
            state, m = step(state, b)
            states.append({k: [to_numpy(x) for x in tree_leaves(v)]
                           for k, v in vars(state).items()})
            metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


@functools.lru_cache(maxsize=None)
def _jax_train(arch: str, strategy: str):
    """The JAX package's unsharded run from its init (its fsdp_tp step is
    dp_full's)."""
    jcfg, _ = _cfgs(arch, strategy)
    api = dataclasses.replace(
        jax_build_model(jcfg, compute_dtype=jnp.float32, remat=True),
        init=lambda rng: _jax_init(arch, jcfg.tie_embeddings))
    init, step = JSP.make_train_step(api, jax_get_optimizer("adagrad", LR),
                                     strategy=strategy)
    batches = _batches(jcfg.vocab_size)
    state = init(jax.random.PRNGKey(0))
    if strategy == "split_concurrent":
        state = JSP.init_prev_features(state, api, batches[0],
                                       dtype=jnp.float32)
    states, metrics = [], []
    with pytest.MonkeyPatch.context() as mp:
        if jcfg.is_moe and strategy in EXPERT_PARALLEL:
            mp.setattr(jax_transformer, "apply_moe", _shard_mean_aux(
                jax_transformer.apply_moe))
        jstep = jax.jit(step)
        for b in batches:
            state, m = jstep(state, b)
            states.append({f.name: [np.asarray(x) for x in
                                    jax.tree_util.tree_leaves(
                                        getattr(state, f.name))]
                           for f in dataclasses.fields(state)})
            metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


def _assert_states(got, want, where):
    """``got`` (the world's state: {field: tree of numpy}) against
    ``want`` ({field: list of leaves}), leaf by leaf, at the f32 bar."""
    for f, leaves in want.items():
        mine = tree_leaves(got[f])
        assert len(mine) == len(leaves), (where, f)
        for a, b in zip(leaves, mine):
            np.testing.assert_allclose(np.asarray(b, np.float64),
                                       np.asarray(a, np.float64), **TOL,
                                       err_msg=f"{where} {f}")


# --- 1. training --------------------------------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_training_matches_unsharded_and_jax(world_2x2, arch,
                                                    strategy):
    """Every loss and state leaf of 3 steps on the 2x2 mesh against the
    port's unsharded steps and the JAX package's."""
    got = world_2x2[("train", arch, strategy)]
    mine, mine_m = _port_train(arch, strategy)
    theirs, theirs_m = _jax_train(arch, strategy)
    for i in range(STEPS):
        for key in ("loss", "total"):
            for ref in (mine_m[i][key], theirs_m[i][key]):
                np.testing.assert_allclose(float(got["metrics"][i][key]),
                                           ref, **TOL,
                                           err_msg=f"step {i} {key}")
        _assert_states(got["states"][i], mine[i], f"step {i} vs port")
        _assert_states(got["states"][i], theirs[i], f"step {i} vs jax")


# --- 2. serving ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_serve(arch: str):
    jcfg, _ = _cfgs(arch)
    api = jax_build_model(jcfg, compute_dtype=jnp.float32, remat=False)
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params(
        arch, jcfg.tie_embeddings))
    tokens = jnp.asarray(_tokens(jcfg.vocab_size))
    logits, cache = jax.jit(lambda p, t: api.prefill(
        p, {"tokens": t}, cache_len=PROMPT + GEN))(params, tokens)
    out, toks = [np.asarray(logits)], []
    step = jax.jit(api.decode_step)
    for i in range(GEN):
        tok = jnp.argmax(logits[:, -1:, :jcfg.vocab_size], -1).astype(
            jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = step(params, cache, tok, jnp.int32(PROMPT + i))
        out.append(np.asarray(logits))
    return out, toks


@functools.lru_cache(maxsize=None)
def _port_serve(arch: str):
    _, cfg = _cfgs(arch)
    api = build_model(cfg, compute_dtype=torch.float32, remat=False)
    params = params_from_numpy(cfg, _jax_params(arch, cfg.tie_embeddings),
                               "cpu")
    tokens = torch.from_numpy(_tokens(cfg.vocab_size))
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        real = port_moe._apply_moe_local
        mp.setattr(port_moe, "_apply_moe_local",
                   lambda *a, **k: calls.append(1) or real(*a, **k))
        logits, cache = api.prefill(params, {"tokens": tokens},
                                    cache_len=PROMPT + GEN)
        out, toks = [logits.numpy()], []
        for i in range(GEN):
            tok = logits[:, -1:, :cfg.vocab_size].argmax(-1).to(torch.int32)
            toks.append(tok.numpy())
            logits, cache = api.decode_step(params, cache, tok, PROMPT + i)
            out.append(logits.numpy())
    return out, toks, len(calls)


def _assert_prefill_cache(got, data: int, model: int):
    """The prefill's cache placed as the JAX prefill's, and rank 0 holding
    its own shard of each leaf alone: the KV cache 1/``data`` of the
    whole."""
    sizes = {"data": data, "model": model}
    for key, (pl, local, whole) in got["prefill_cache"].items():
        assert pl == PREFILL_CACHE_PLACEMENTS[key], key
        shards = 1
        for axis, q in zip(sizes, pl.strip("()").split(", ")):
            shards *= sizes[axis] if q.startswith("Shard") else 1
        assert local * shards == whole, key
    kv = got["prefill_cache"].get("k")
    if kv is not None:
        assert kv[1] * data == kv[2]


@pytest.mark.parametrize("arch,layout", SERVE)
def test_sharded_prefill_and_decode_match(world_2x2, arch, layout):
    """Prefill and 4 greedy decode steps under fsdp_tp on the 2x2 mesh:
    the prefill's cache batch-sharded over data, the decode's placed by
    the layout, the MoE on its expert-parallel path (its partial-sum
    schedule in the replicated-batch layout), logits within SERVE_TOL of
    the port's and JAX's unsharded runs, tokens equal."""
    got = world_2x2[("serve", arch, layout)]
    _assert_prefill_cache(got, 2, 2)
    # k: (layers, batch, kv_seq, kv_heads, hd); batch over data and the
    # sequence over model, or the sequence over (data, model); rwkv's WKV
    # state (layers, batch, rwkv_head, hd, hd): its heads over model
    key, want = ("k", {"batch_sharded": "(Shard(dim=1), Shard(dim=2))",
                       "replicated_batch": "(Shard(dim=2), Shard(dim=2))"}) \
        if "k" in got["cache_placements"] else \
        ("wkv", {"batch_sharded": "(Shard(dim=1), Shard(dim=2))",
                 "replicated_batch": "(Replicate(), Shard(dim=2))"})
    assert got["cache_placements"][key] == want[layout]
    mine, theirs = _port_serve(arch), _jax_serve(arch)
    for ref_logits, ref_tokens in (mine[:2], theirs):
        assert len(got["logits"]) == len(ref_logits) == GEN + 1
        for i, (a, b) in enumerate(zip(got["logits"], ref_logits)):
            np.testing.assert_allclose(a, b, **SERVE_TOL,
                                       err_msg=f"logits {i}")
        for a, b in zip(got["tokens"], ref_tokens):
            np.testing.assert_array_equal(a, b)
    # every MoE call of the unsharded run took the expert-parallel path
    assert got["moe_sharded_calls"] == mine[2]
    if mine[2]:
        assert (("data",) in got["sums"]) == (layout == "replicated_batch")


@pytest.mark.parametrize("arch,layout", SERVE_1X2)
def test_sharded_prefill_and_decode_match_on_1x2(world_1x2, arch, layout):
    """The same on the 1x2 mesh: the prefill's cache placed as on 2x2
    (one data shard holds the whole batch), then redistributed by the
    decode layout; logits within SERVE_TOL of the port's unsharded run,
    tokens equal."""
    got = world_1x2[("serve", arch, layout)]
    _assert_prefill_cache(got, 1, 2)
    logits, toks, _ = _port_serve(arch)
    assert len(got["logits"]) == len(logits) == GEN + 1
    for i, (a, b) in enumerate(zip(got["logits"], logits)):
        np.testing.assert_allclose(a, b, **SERVE_TOL, err_msg=f"logits {i}")
    for a, b in zip(got["tokens"], toks):
        np.testing.assert_array_equal(a, b)


def test_heads_the_model_axis_does_not_divide_on_a_2x4_mesh(tmp_path):
    """A 2x4 world of 8 ranks, where the smoke configs' 2 kv heads do not
    divide the 4-wide model axis (as qwen3-4b's 8 on the production
    mesh's 16): one ``split_concurrent`` step of qwen3-4b, its loss and
    every state leaf against the port's unsharded step, and one
    ``fsdp_tp`` prefill and decode step of dbrx-132b, its logits within
    SERVE_TOL of the unsharded run's and its token equal.  The kv heads
    stay whole on every rank (``layers._project_heads``)."""
    arch = "qwen3-4b"
    jcfg, _ = _cfgs(arch, "split_concurrent")
    jobs = [dict(kind="train", mesh=(2, 4), arch=arch,
                 strategy="split_concurrent", lr=LR,
                 moe_capacity=MOE_CAPACITY,
                 params=_jax_params(arch, jcfg.tie_embeddings),
                 batches=_batches(jcfg.vocab_size)[:1]),
            dict(kind="serve", mesh=(2, 4), arch="dbrx-132b",
                 layout="batch_sharded", gen=1, moe_capacity=MOE_CAPACITY,
                 params=_jax_params("dbrx-132b", jax_smoke_config(
                     "dbrx-132b").tie_embeddings),
                 tokens=_tokens(jax_smoke_config("dbrx-132b").vocab_size))]
    train, serve = run_world(tmp_path, 8, jobs, timeout=240)
    mine, mine_m = _port_train(arch, "split_concurrent")
    for key in ("loss", "total"):
        np.testing.assert_allclose(float(train["metrics"][0][key]),
                                   mine_m[0][key], **TOL)
    _assert_states(train["states"][0], mine[0], "2x4 step 0 vs port")
    logits, toks, _ = _port_serve("dbrx-132b")
    for i, (a, b) in enumerate(zip(serve["logits"], logits[:2])):
        np.testing.assert_allclose(a, b, **SERVE_TOL, err_msg=f"logits {i}")
    np.testing.assert_array_equal(serve["tokens"][0], toks[0])


# --- 3. the expert-parallel MoE -----------------------------------------------


def _local_moe(name):
    """The local dispatch on the whole input: y, aux (the mean of each
    data shard's own, as the sharded path defines it), and the gradients
    of mean(y * w) + aux."""
    mesh, shape, rules, _ = MOE_CASES[name]
    p, x, w = _moe_inputs(shape)
    cfg = get_smoke_config("dbrx-132b")
    pt = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    shards = mesh[0] if rules.get("batch", "data") else 1
    y, _ = port_moe._apply_moe_local(pt, cfg, xt,
                                     capacity_factor=MOE_CAPACITY)
    rows = shape[0] // shards
    aux = sum(port_moe._apply_moe_local(
        pt, cfg, xt[i * rows:(i + 1) * rows],
        capacity_factor=MOE_CAPACITY)[1] for i in range(shards)) / shards
    loss = (y * torch.from_numpy(w)).mean() + aux
    keys = sorted(pt)
    g = torch.autograd.grad(loss, [xt] + [pt[k] for k in keys])
    return (y.detach().numpy(), float(aux.detach()), g[0].numpy(),
            {k: t.numpy() for k, t in zip(keys, g[1:])})


def _moe_result(world_2x2, world_1x2, name):
    return (world_1x2 if MOE_CASES[name][0] == (1, 2) else world_2x2)[
        ("moe", name)]


def _moe_gaps(got, want) -> dict:
    y, aux, gx, gp = want
    gaps = {"y": np.abs(got["y"] - y).max(), "aux": abs(
        float(got["aux"]) - aux), "gx": np.abs(got["gx"] - gx).max()}
    gaps.update({k: np.abs(got["gp"][k] - v).max() for k, v in gp.items()})
    return gaps


@pytest.mark.parametrize("name", [n for n in MOE_CASES
                                  if not MOE_CASES[n][3]])
def test_sharded_moe_matches_local_dispatch(world_2x2, world_1x2, name):
    """Forward, auxiliary loss and the gradients of x and of every weight
    within 2e-5; the expert-parallel path was taken (its sum over
    ``model``), and the partial-sum schedule exactly where the batch is
    replicated over the FSDP axis with cap x n_fsdp < D."""
    got = _moe_result(world_2x2, world_1x2, name)
    gaps = _moe_gaps(got, _local_moe(name))
    assert max(gaps.values()) <= MOE_TOL["atol"], gaps
    assert ("model",) in got["sums"]
    assert (("data",) in got["sums"]) == (name == "2x2-partial-sum")


def test_sharded_moe_without_the_model_sum_fails(world_2x2):
    """The planted fault: each model shard's partial output left unsummed
    misses the experts of the other shard, far beyond the bar."""
    got = world_2x2[("moe", "2x2-fault")]
    gaps = _moe_gaps(got, _local_moe("2x2"))
    assert gaps["y"] > 100 * MOE_TOL["atol"], gaps


# --- 4. the row-sharded server step -------------------------------------------


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("ranks", [2, 4])
def test_row_sharded_server_step_is_bitwise_one_rank(world_2x2, world_1x2,
                                                     ranks):
    """Each rank's block of the flat buffer through K1's plain version,
    gathered: bitwise the one-rank step, leaf by leaf."""
    got = (world_1x2 if ranks == 2 else world_2x2)[("server_step", ranks)]
    assert got["ranks"] == ranks
    inp = _server_inputs()
    n = sum(np.size(v) for v in inp["params"].values())
    assert n % (ranks * 32)
    step = FusedServerStep(adagrad(inp["lr"]), lr=inp["lr"],
                           weight_decay=inp["wd"], clip_norm=inp["clip"])
    params = tree_as_tensors(inp["params"])
    new_p, new_opt = step.step(inp["grads"], inp["works"], params,
                               {"acc": tree_as_tensors(inp["acc"])})
    for k in params:
        assert _same_bits(got["params"][k], new_p[k].numpy()), k
        assert _same_bits(got["acc"][k], new_opt["acc"][k].numpy()), k


# --- 5. kernels under a mesh --------------------------------------------------


def test_every_kernel_wrapper_refuses_a_dtensor(world_2x2):
    got = world_2x2[("refusals",)]
    assert set(got) == {"adagrad_update", "adagrad_update_leaves",
                        "flash_attention", "mamba_scan", "wkv",
                        "server_step_update"}
    for name, msg in got.items():
        assert msg and "DTensor" in msg and "local shard" in msg, (name,
                                                                   msg)


def test_the_decode_graph_refuses_a_dtensor(world_2x2):
    """``launch.serve.DecodeGraph`` no longer refuses a DTensor: through
    the decode bundle's ``lower()`` on the 2x2 mesh it adopts the placed
    cache, each buffer (the token's too) a DTensor with the bundle's
    placements and a local storage of its own, and one step equals the
    bundle's eager call bit for bit, logits and cache."""
    got = world_2x2[("decode_graph",)]
    assert set(got["placements"]) == {"k", "v", "pos", "token"}
    assert got["placements"] == got["want_placements"], got
    assert got["own_storage"]
    assert got["logits_equal"] and got["cache_equal"], got


# --- 6. the vocab-parallel embedding and loss ---------------------------------


def _vocab_gaps(got):
    """The world's embedding rows, loss and their gradients against the
    port's plain lookup and ``lm_loss`` on the whole tensors."""
    from repro_torch.models.model import lm_loss, lm_loss_chunked
    inp = _vocab_inputs()
    table, logits, feats, head_w = (
        torch.from_numpy(inp[k]).requires_grad_(True)
        for k in ("table", "logits", "feats", "head_w"))
    labels, mask = (torch.from_numpy(inp[k]) for k in ("labels", "mask"))
    y = table[torch.from_numpy(inp["tokens"]).long()]
    loss = lm_loss(logits, labels, mask)
    chunked = lm_loss_chunked(feats, head_w, labels, mask,
                              n_chunks=VOCAB_CHUNKS)
    grads = torch.autograd.grad(
        (y * torch.from_numpy(inp["w"])).sum() + loss + 2 * chunked,
        [table, logits, feats, head_w])
    want = dict(y=y, loss=loss, chunked=chunked, **dict(zip(
        ("g_table", "g_logits", "g_feats", "g_head_w"), grads)))
    return {k: float(np.abs(np.asarray(got[k], np.float64)
                            - to_numpy(v.detach()).astype(np.float64)).max())
            for k, v in want.items()}


def test_vocab_parallel_embedding_and_loss_match_the_plain_ones(world_2x2):
    """Under fsdp_tp on 2x2 the table, the logits and the chunked loss's
    head keep their vocab shards on every rank (half the vocab each,
    never the whole), and the lookup, both losses and their gradients
    stay within 1e-5 of the plain ones."""
    got = world_2x2[("vocab", False)]
    gaps = _vocab_gaps(got)
    assert max(gaps.values()) <= 1e-5, gaps
    v, d, b, s = VOCAB_V, VOCAB_D, VOCAB_B, VOCAB_S
    for half in ((v // 2, d), (b // 2, s, v // 2), (d, v // 2)):
        assert half in got["shapes"], (half, got["shapes"])
    assert not any(sh in got["shapes"] for sh in (
        (v, d), (b // 2, s, v), (b, s, v), (d, v))), got["shapes"]


def test_vocab_parallel_embedding_without_the_vocab_sum_fails(world_2x2):
    """The planted fault: each rank's rows left unsummed over the vocab
    shards are zero for the tokens of the other shard."""
    gaps = _vocab_gaps(world_2x2[("vocab", True)])
    assert gaps["y"] > 0.1, gaps


# --- 7. the CLI under torchrun ------------------------------------------------


def test_cli_under_torchrun_on_a_2x2_mesh(tmp_path):
    """``torchrun --standalone --nproc-per-node 4 ... --data-par 2
    --model-par 2 --device cpu --steps 3``: every rank reports the losses
    of the unsharded CLI run of the same seed."""
    args = ["--arch", "qwen3-4b", "--smoke", "--steps", "3", "--batch",
            str(B), "--seq", str(SEQ), "--strategy", "fsdp_tp", "--lr",
            "0.1", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    torchrun = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", "4"]
    try:
        out = subprocess.run(
            torchrun + ["-m", "repro_torch.launch.train"] + args
            + ["--data-par", "2", "--model-par", "2"], env=env, cwd=tmp_path,
            capture_output=True, text=True, timeout=240)
    except subprocess.TimeoutExpired:
        pytest.fail("the 4-rank torchrun world ran past 240 s")
    assert out.returncode == 0, out.stderr[-3000:]
    from repro_torch.launch.train import main
    want = main(args)
    finals = re.findall(r"final loss (\S+) \(first (\S+)\) on cpu, rank "
                        r"(\d) of a 2x2 mesh", out.stdout)
    assert sorted(int(r) for _, _, r in finals) == [0, 1, 2, 3], out.stdout
    for last, first, _ in finals:
        np.testing.assert_allclose([float(first), float(last)],
                                   [want[0], want[-1]], atol=1e-4)
