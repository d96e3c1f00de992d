"""The port's §4.1 split training (``repro_torch.core.split_parallel``,
``models.model.train_loss``, ``launch.train``) against the JAX package, on
the CPU.

Weights are the JAX package's own init (its ``init_state``, jitted),
carried across as numpy through ``params_from_numpy``; batches are
``make_lm_batch`` arrays from ``np.random.default_rng`` fed to both.
Everything is f32, and the bar is the f32 model bar of ``ROADMAP.md``'s
conventions: atol 2e-4 / rtol 1e-3, on every per-step loss and every
``TrainState`` leaf.  One JAX jit a case, each run once per process.
"""
import asyncio
import dataclasses
import functools
import io
from contextlib import redirect_stdout
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import split_parallel as JS
from repro.launch.steps import arch_for_run as jax_arch_for_run
from repro.models import layers as JL
from repro.models.model import build_model as jax_build_model
from repro.models.model import lm_loss_chunked as jax_lm_loss_chunked
from repro.optim import get_optimizer as jax_get_optimizer
from repro.sharding.spec import values_tree as jax_values_tree
from repro.train_fabric import checkpointing as jax_ckpt
from repro_torch.configs import InputShape, get_smoke_config
from repro_torch.core import split_parallel as S
from repro_torch.core.distributor import (AdaptiveSizer, AsyncDistributor,
                                          ClientProfile, TaskDef)
from repro_torch.data import make_lm_batch
from repro_torch.launch import train
from repro_torch.launch.steps import arch_for_run
from repro_torch.models import layers as L
from repro_torch.models.model import (build_model, lm_loss_chunked,
                                      params_from_numpy)
from repro_torch.optim import get_optimizer, sgd
from repro_torch.sharding.spec import values_tree
from repro_torch.train_fabric import checkpointing as port_ckpt
from repro_torch.tree import (tree_as_tensors, tree_flatten, tree_leaves,
                              to_numpy)

TOL = dict(atol=2e-4, rtol=1e-3)
B, SEQ, STEPS = 4, 32, 3
_SHAPE = InputShape("custom", SEQ, B, "train")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(arch: str, strategy: str):
    """(JAX cfg, port cfg) of an arch's smoke config as each package's
    ``arch_for_run`` gives it for ``strategy``; qwen3-4b always untied."""
    jcfg, pcfg = jax_smoke_config(arch), get_smoke_config(arch)
    if arch == "qwen3-4b":
        jcfg = dataclasses.replace(jcfg, tie_embeddings=False)
        pcfg = dataclasses.replace(pcfg, tie_embeddings=False)
    return (jax_arch_for_run(jcfg, _SHAPE, strategy),
            arch_for_run(pcfg, _SHAPE, strategy))


def _batches(vocab: int, n: int, b: int = B, s: int = SEQ, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [make_lm_batch(rng, b, s, vocab) for _ in range(n)]


#: name -> (arch, strategy, weight decay, head_sync_period, grad_accum)
CASES = {
    "dp_full": ("qwen3-4b", "dp_full", 0.0, 4, 1),
    "split_sequential": ("qwen3-4b", "split_sequential", 0.0, 4, 1),
    "split_concurrent": ("qwen3-4b", "split_concurrent", 0.0, 2, 1),
    "split_concurrent_wd": ("qwen3-4b", "split_concurrent", 0.01, 2, 1),
    "qwen1.5_split_concurrent": ("qwen1.5-0.5b", "split_concurrent", 0.0,
                                 2, 1),
    "dp_full_accum2": ("qwen3-4b", "dp_full", 0.0, 4, 2),
    "split_concurrent_accum2": ("qwen3-4b", "split_concurrent", 0.0, 2, 2),
}


@functools.lru_cache(maxsize=None)
def _both(case: str):
    """Both packages run ``case`` for STEPS adagrad steps (lr 0.05) from
    the JAX init.  Returns (JAX states, JAX metrics, port states, port
    metrics, the port's api, opt and step_fn); states[0] is the initial
    state."""
    arch, strategy, wd, k, accum = CASES[case]
    jcfg, pcfg = _configs(arch, strategy)
    japi = jax_build_model(jcfg, compute_dtype=jnp.float32)
    jinit, jstep = JS.make_train_step(
        japi, jax_get_optimizer("adagrad", 0.05, weight_decay=wd),
        strategy=strategy, head_sync_period=k, grad_accum=accum)
    batches = _batches(jcfg.vocab_size, STEPS)
    jstate = jax.jit(jinit)(jax.random.PRNGKey(0))
    api = build_model(pcfg, compute_dtype=torch.float32)
    opt = get_optimizer("adagrad", 0.05, weight_decay=wd)
    init, step = S.make_train_step(api, opt, strategy=strategy,
                                   head_sync_period=k, grad_accum=accum)
    params = params_from_numpy(
        pcfg, JS.merge_params(_np(jstate.params), _np(jstate.head)), "cpu")
    state = init(params=params)
    first = tree_as_tensors(batches[0])
    if strategy == "split_concurrent":
        jstate = JS.init_prev_features(jstate, japi, batches[0],
                                       dtype=jnp.float32)
        state = S.init_prev_features(state, api, first, dtype=torch.float32)
    jstates, jmetrics, states, metrics = [jstate], [], [state], []
    jit_step = jax.jit(jstep)
    for b in batches:
        jstate, m = jit_step(jstate, b)
        jstates.append(jstate)
        jmetrics.append(_np(m))
        state, m = step(state, tree_as_tensors(b))
        states.append(state)
        metrics.append(m)
    return jstates, jmetrics, states, metrics, (api, opt, step)


def _assert_state_close(jstate, state, where=""):
    for f in fields(S.TrainState):
        want = jax.tree_util.tree_leaves(getattr(jstate, f.name))
        got = tree_leaves(getattr(state, f.name))
        assert len(got) == len(want), (where, f.name)
        for a, b in zip(want, got):
            a, b = np.asarray(a), to_numpy(b)
            assert a.shape == b.shape and a.dtype == b.dtype, (where, f.name)
            np.testing.assert_allclose(b, a, **TOL,
                                       err_msg=f"{where} {f.name}")


#: the trained fields, whose change from the initial state (and, for the
#: accumulators, whose value) is far below TOL's atol at these sizes
_TRAINED = ("params", "head", "opt_state", "head_opt_state")


def _assert_updates_close(jstates, states):
    """Each trained leaf's change since the initial state within 1e-3 of
    the JAX change's largest magnitude (rtol 1e-3 beside it): a bar an
    update of the wrong size or direction fails, where TOL's atol would
    pass it."""
    for f in _TRAINED:
        want0 = jax.tree_util.tree_leaves(getattr(jstates[0], f))
        got0 = tree_leaves(getattr(states[0], f))
        for i, (js, s) in enumerate(zip(jstates[1:], states[1:])):
            want = jax.tree_util.tree_leaves(getattr(js, f))
            got = tree_leaves(getattr(s, f))
            for a0, b0, a, b in zip(want0, got0, want, got):
                dw = np.asarray(a) - np.asarray(a0)
                dg = to_numpy(b) - to_numpy(b0)
                np.testing.assert_allclose(
                    dg, dw, rtol=1e-3, atol=1e-3 * np.abs(dw).max(),
                    err_msg=f"step {i} {f} update")


@pytest.mark.parametrize("case", list(CASES))
def test_strategy_matches_jax(case):
    """Per-step loss and total, and every state leaf after every step:
    params, head, head_stale, both accumulators, the feature-replay slots
    (the microbatches' features re-assembled along the batch under
    grad_accum) and step; and every update and accumulator on its own
    scale."""
    jstates, jmetrics, states, metrics, _ = _both(case)
    for i, (jm, m) in enumerate(zip(jmetrics, metrics)):
        for key in ("loss", "total"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                       err_msg=f"step {i} {key}")
    for i, (js, s) in enumerate(zip(jstates, states)):
        _assert_state_close(js, s, f"after step {i - 1}")
    _assert_updates_close(jstates, states)
    if CASES[case][1] == "split_concurrent":
        d_model = states[-1].params["embed"]["table"].shape[1]
        assert tuple(states[-1].prev_features.shape) == (B, SEQ, d_model)


def test_qwen15_is_untied_and_has_qkv_bias_through_arch_for_run():
    cfg = get_smoke_config("qwen1.5-0.5b")
    assert cfg.tie_embeddings and cfg.qkv_bias
    assert not arch_for_run(cfg, _SHAPE, "split_concurrent").tie_embeddings
    assert arch_for_run(cfg, _SHAPE, "dp_full").tie_embeddings
    _, _, states, _, _ = _both("qwen1.5_split_concurrent")
    assert "bq" in states[-1].params["blocks"]["attn"]
    assert set(states[-1].head) == {"head"}


def _same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_split_concurrent_head_trains_on_previous_features():
    """Step 0 leaves the head as it was at weight decay 0 (no features
    yet); step 1 moves it.  With weight decay the step-0 update (a zero
    gradient plus wd·p) moves it at once, as the JAX package's does."""
    _, _, states, _, _ = _both("split_concurrent")
    assert _same(states[0].head, states[1].head)
    assert not _same(states[1].head, states[2].head)
    _, _, wd_states, _, _ = _both("split_concurrent_wd")
    assert not _same(wd_states[0].head, wd_states[1].head)


def _port_setup():
    _, cfg = _configs("qwen3-4b", "split_concurrent")
    api = build_model(cfg, compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    return cfg, api, values_tree(api.init(gen))


def test_split_concurrent_stale_head_sync_period():
    """head_stale refreshes exactly where (i+1) % K == 0 (and i >= 1, the
    head having moved), to the head itself."""
    cfg, api, params = _port_setup()
    k = 3
    init, step = S.make_train_step(api, get_optimizer("adagrad", 0.05),
                                   strategy="split_concurrent",
                                   head_sync_period=k)
    batches = [tree_as_tensors(b) for b in _batches(cfg.vocab_size, 2 * k)]
    state = S.init_prev_features(init(params=params), api, batches[0],
                                 dtype=torch.float32)
    assert state.head_stale["head"]["w"] is not state.head["head"]["w"]
    syncs = []
    for b in batches:
        prev = state.head_stale
        state, _ = step(state, b)
        moved = not _same(prev, state.head_stale)
        syncs.append(moved)
        if moved:
            assert _same(state.head_stale, state.head)
    assert syncs == [((i + 1) % k == 0) and i >= 1 for i in range(2 * k)]


def test_split_sequential_equals_dp_full_with_one_sgd_step():
    """He et al.'s split is the same math as full data parallelism: one
    SGD step gives the same params within 1e-6."""
    cfg, api, params = _port_setup()
    batch = tree_as_tensors(_batches(cfg.vocab_size, 1)[0])
    init_dp, step_dp = S.make_train_step(api, sgd(0.1), strategy="dp_full")
    init_sp, step_sp = S.make_train_step(api, sgd(0.1),
                                         strategy="split_sequential")
    s_dp, _ = step_dp(init_dp(params=params), batch)
    s_sp, _ = step_sp(init_sp(params=params), batch)
    merged = S.merge_params(s_sp.params, s_sp.head)
    flat_dp, tdef = tree_flatten(s_dp.params)
    for a, b in zip(flat_dp, tdef.flatten_up_to(merged)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)


def test_split_params_roundtrip():
    _, _, params = _port_setup()
    backbone, head = S.split_params(params)
    assert "head" in head and "head" not in backbone
    assert S.merge_params(backbone, head).keys() == params.keys()


def test_split_requires_untied_head():
    cfg = get_smoke_config("qwen1.5-0.5b")          # tied embeddings
    assert cfg.tie_embeddings
    api = build_model(cfg, compute_dtype=torch.float32)
    init, _ = S.make_train_step(api, get_optimizer("adagrad", 0.05),
                                strategy="split_concurrent")
    with pytest.raises(ValueError, match="untied head"):
        init(torch.Generator().manual_seed(0))


def _grads(api, params, batch):
    _, _, (g,) = S._value_and_grad(lambda p: api.train_loss(p, batch),
                                   params)
    return g


def test_remat_gives_the_same_gradients():
    """Recomputing each block in the backward pass changes no bit of the
    gradients on the CPU."""
    cfg, _, params = _port_setup()
    batch = tree_as_tensors(_batches(cfg.vocab_size, 1)[0])
    g1 = _grads(build_model(cfg, compute_dtype=torch.float32, remat=True),
                params, batch)
    g0 = _grads(build_model(cfg, compute_dtype=torch.float32, remat=False),
                params, batch)
    assert _same(g1, g0)


def test_flash_attention_kernel_stays_out_of_training(monkeypatch):
    """Training takes the differentiable attention: with K3's wrapper
    raising, train_loss and every strategy's step still run, and the
    prefill (K3's path) raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("K3 reached")

    monkeypatch.setattr(L, "flash_attention", refuse)
    cfg, api, params = _port_setup()
    batch = tree_as_tensors(_batches(cfg.vocab_size, 1)[0])
    api.train_loss(params, batch)
    for strategy in ("dp_full", "split_sequential", "split_concurrent"):
        init, step = S.make_train_step(api, get_optimizer("adagrad", 0.05),
                                       strategy=strategy)
        state = init(params=params)
        if strategy == "split_concurrent":
            state = S.init_prev_features(state, api, batch,
                                         dtype=torch.float32)
        for _ in range(2):
            state, _ = step(state, batch)
    with pytest.raises(AssertionError, match="K3 reached"):
        api.prefill(params, {"tokens": batch["tokens"]})


def test_kernel_wrapper_refuses_inputs_that_require_grad():
    """A training caller that forgets ``differentiable`` raises at K3, on
    the CPU as on the card, instead of training on cut gradients."""
    cfg, api, params = _port_setup()
    leaves, tdef = tree_flatten(params)
    params = tdef.unflatten([x.requires_grad_(True) for x in leaves])
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="has no backward"):
        api.forward_features(params, {"tokens": tokens})


@pytest.mark.parametrize("window", [0, 6])
def test_chunked_attention_matches_jax(monkeypatch, window):
    """The differentiable attention with query chunks of 8 over S 24
    (three chunks; with a window each sees a sliced KV segment) against
    the JAX package's ``_chunked_attend`` at the same chunk size."""
    monkeypatch.setattr(JL, "ATTN_QUERY_CHUNK", 8)
    monkeypatch.setattr(L, "ATTN_QUERY_CHUNK", 8)
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(24, dtype=np.int32)
    want = JL._chunked_attend(q, k, v, 0.25, q_positions=pos,
                              kv_positions=pos, causal=True, window=window)
    got = L._chunked_attend(*map(torch.from_numpy, (q, k, v)), 0.25,
                            causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lm_loss_chunked_and_chunked_train_loss_match_jax():
    """lm_loss_chunked's value and gradients (feats and head), and
    train_loss(loss_chunks=4) with its gradients, against the JAX
    package's."""
    jcfg, cfg = _configs("qwen3-4b", "dp_full")
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    head_w = (rng.normal(size=(cfg.d_model, cfg.padded_vocab)) * 0.05
              ).astype(np.float32)
    batch = _batches(cfg.vocab_size, 1, b=2, s=16, seed=5)[0]
    jf = jax.value_and_grad(lambda f, w: jax_lm_loss_chunked(
        f, w, batch["labels"], batch["mask"], n_chunks=4), argnums=(0, 1))
    jloss, jgrads = jf(feats, head_w)
    f_t, w_t = (torch.from_numpy(x).requires_grad_(True)
                for x in (feats, head_w))
    loss = lm_loss_chunked(f_t, w_t, *map(torch.from_numpy,
                                          (batch["labels"], batch["mask"])),
                           n_chunks=4)
    grads = torch.autograd.grad(loss, (f_t, w_t))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)

    japi = jax_build_model(jcfg, compute_dtype=jnp.float32, loss_chunks=4)
    jparams = _np(jax.jit(lambda key: jax_values_tree(japi.init(key)))(
        jax.random.PRNGKey(0)))
    (jl, _), jg = jax.jit(jax.value_and_grad(japi.train_loss, has_aux=True))(
        jparams, batch)
    api = build_model(cfg, compute_dtype=torch.float32, loss_chunks=4)
    params = params_from_numpy(cfg, jparams, "cpu")
    loss, _, (g,) = S._value_and_grad(
        lambda p: api.train_loss(p, tree_as_tensors(batch)), params)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jg), tree_leaves(g)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_weighted_grad_mean_and_aggregate_match_jax():
    rng = np.random.default_rng(6)
    shards = [{"w": rng.normal(size=(3, 4)).astype(np.float32),
               "b": [rng.normal(size=5).astype(np.float32)]}
              for _ in range(3)]
    sizes = [1.0, 3.0, 2.0]
    want = _np(JS.weighted_grad_mean(shards, sizes))
    got = S.weighted_grad_mean([tree_as_tensors(s) for s in shards], sizes)
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), a, **TOL)
    agg = S.SplitConcurrentDispatcher.aggregate([{"w": 1.0}, {"w": 3.0}],
                                                [1.0, 3.0])
    assert agg["w"] == pytest.approx(
        JS.SplitConcurrentDispatcher.aggregate([{"w": 1.0}, {"w": 3.0}],
                                               [1.0, 3.0])["w"])
    assert agg["w"] == pytest.approx(2.5)


def test_split_dispatcher_round_aggregates_in_order():
    """One §4.1 training round through the port's v2 scheduler: backbone
    shard 'gradients' come back ordered like the inputs, and the
    distributor's keep_alive comes back when the driver closes."""

    async def main():
        d = AsyncDistributor(timeout=5.0, redistribute_min=0.02,
                             sizer=AdaptiveSizer(target_lease_time=0.02))
        d.register_task(TaskDef(
            "backbone_shard", lambda args, _: {"grad": args["lo"]}))
        d.spawn_clients([ClientProfile(name="c0", speed=2000.0),
                         ClientProfile(name="c1", speed=2000.0)])
        keep_alive = d.keep_alive
        disp = S.SplitConcurrentDispatcher(d)
        shards = [{"lo": i, "hi": i + 4} for i in range(0, 16, 4)]
        out = await asyncio.wait_for(
            disp.run_round(shards, shard_work=[4.0] * 4, timeout=30.0), 60)
        await disp.aclose()
        restored = d.keep_alive == keep_alive
        await asyncio.wait_for(d.shutdown(), 60)
        return out, disp, restored

    out, disp, restored = asyncio.run(main())
    assert [o["grad"] for o in out] == [0, 4, 8, 12]
    assert disp.rounds == 1 and restored


def test_train_state_checkpoint_moves_between_packages(tmp_path):
    """The qwen3-4b smoke, untied, one split_concurrent step, the replay
    buffer in bf16: a port state saved by the port loads bit-exactly in
    the JAX package, and a JAX state saved by JAX in the port."""
    jstates, _, states, _, _ = _both("split_concurrent")
    jstate = dataclasses.replace(
        jstates[1],
        prev_features=jnp.asarray(jstates[1].prev_features, jnp.bfloat16))
    state = dataclasses.replace(
        states[1], prev_features=states[1].prev_features.to(torch.bfloat16))

    def port_bits(state):
        return [(a.dtype.name, a.shape, a.tobytes()) for a in map(
            to_numpy, tree_leaves(port_ckpt.state_to_tree(state)))]

    def jax_bits(state):
        return [(a.dtype.name, a.shape, a.tobytes()) for a in map(
            np.asarray,
            jax.tree_util.tree_leaves(jax_ckpt.state_to_tree(state)))]

    p_path = port_ckpt.save_round_checkpoint(
        port_ckpt.checkpoint_path(str(tmp_path / "port"), 1), state,
        round_index=1, extra={"from": "port"})
    got, rnd, extra = jax_ckpt.load_round_checkpoint(p_path)
    assert rnd == 1 and extra == {"from": "port"} and int(got.step) == 1
    assert jax_bits(got) == port_bits(state)
    assert any(dtype == "bfloat16" for dtype, _, _ in port_bits(state))

    j_path = jax_ckpt.save_round_checkpoint(
        jax_ckpt.checkpoint_path(str(tmp_path / "jax"), 1), jstate,
        round_index=1, extra={"from": "jax"})
    got, rnd, extra = port_ckpt.load_round_checkpoint(j_path)
    assert rnd == 1 and extra == {"from": "jax"} and int(got.step) == 1
    assert port_bits(got) == jax_bits(jstate)


def test_train_cli_on_the_cpu_lowers_the_loss():
    """``python -m repro_torch.launch.train`` on qwen1.5-0.5b's smoke
    config (untied by arch_for_run), split_concurrent.  lr 0.1: at the
    CLI's default lr (1e-2) the loss of neither package falls within 6
    steps."""
    out = io.StringIO()
    with redirect_stdout(out):
        losses = train.main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps",
                             "6", "--lr", "0.1", "--strategy",
                             "split_concurrent", "--device", "cpu"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert "final loss" in out.getvalue()


@pytest.mark.parametrize("argv,match", [
    (["--data-par", "2"], "torchrun")])
def test_train_cli_refuses_what_later_slices_bring(argv, match):
    """A mesh (``--data-par``/``--model-par``) needs its ranks: outside
    ``torchrun``, with no process group, the CLI refuses it (the sharded
    run itself is ``tests/test_torch_mesh.py``'s)."""
    with pytest.raises(RuntimeError, match=match):
        train.main(["--smoke", "--steps", "1", "--device", "cpu"] + argv)
