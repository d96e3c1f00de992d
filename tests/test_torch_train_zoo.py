"""Training of every LM family through the port (``train_loss``,
``make_train_step``) against the JAX package, on the CPU, f32: each
strategy of every config no training test held before, remat, the
kernels kept out of training, and every strategy name on every arch.  The chunked scans, patches and frames under
gradient accumulation, bf16 and the CLI are in
``tests/test_torch_train_paths.py``.

The setup is ``tests/test_torch_split_parallel.py``'s: weights are the JAX
package's own init (its ``init_state``, jitted), carried across as numpy
through ``params_from_numpy``; batches are ``make_lm_batch`` arrays from
``np.random.default_rng``, with a vlm batch's patches and an encdec
batch's frames drawn from normal(0, 0.02) by the same generator, as
``tests/test_models_smoke.py`` draws them.  Each JAX jit runs once per
process.  The JAX package's training paths call no Pallas kernel, so none
plays a part here; the port's training forward must not reach its
kernels either.

Each case is held to the f32 model bar on every loss and ``TrainState``
leaf (atol 2e-4 / rtol 1e-3) and every update within 1e-3 of its own
scale.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import split_parallel as JS
from repro.launch.steps import arch_for_run as jax_arch_for_run
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build_model
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.configs import ARCH_IDS, InputShape, get_smoke_config
from repro_torch.core import split_parallel as S
from repro_torch.data import make_lm_batch
from repro_torch.launch.steps import arch_for_run
from repro_torch.models import layers as L
from repro_torch.models import mamba, rwkv
from repro_torch.models import moe as port_moe
from repro_torch.models.model import _paths, build_model, params_from_numpy
from repro_torch.optim import get_optimizer
from repro_torch.sharding.spec import values_tree
from repro_torch.tree import (tree_as_tensors, tree_flatten, tree_leaves,
                              to_numpy)

from test_torch_lm_models import _recording_router
from test_torch_split_parallel import _TRAINED, _assert_state_close, _np

B, SEQ, STEPS, LR = 4, 32, 3, 0.05
#: the families the dense slice left untrained, one smoke config each
NEW = ("qwen3-moe-30b-a3b", "internvl2-26b", "whisper-small", "rwkv6-1.6b",
       "jamba-1.5-large-398b")
#: every config no training test held before: the new families, the other
#: MoE, and the two dense configs (a relu2 layernorm GQA, a tied head)
PARITY = NEW + ("dbrx-132b", "minitron-4b", "command-r-35b")


def _configs(arch: str, strategy: str, seq: int):
    shape = InputShape("custom", seq, B, "train")
    return (jax_arch_for_run(jax_smoke_config(arch), shape, strategy),
            arch_for_run(get_smoke_config(arch), shape, strategy))


def _batches(cfg, n: int, seq: int = SEQ, seed: int = 0) -> list:
    """``n`` numpy batches of B rows: ``seq`` text tokens, and a vlm's
    patches or an encdec's frames, from normal(0, 0.02)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = make_lm_batch(rng, B, seq, cfg.vocab_size)
        if cfg.family == "vlm":
            batch["patches"] = rng.normal(
                0, 0.02, (B, cfg.num_patches, cfg.d_model)).astype(
                    np.float32)
        if cfg.family == "encdec":
            batch["frames"] = rng.normal(
                0, 0.02, (B, cfg.encoder_seq_len, cfg.d_model)).astype(
                    np.float32)
        out.append(batch)
    return out


@functools.lru_cache(maxsize=None)
def _jax_init(arch: str, tied: bool):
    """The JAX package's init of an arch's smoke config (Param tree),
    jitted once per process for all the cases that start from it."""
    cfg = dataclasses.replace(jax_smoke_config(arch), tie_embeddings=tied)
    return jax.jit(jax_build_model(cfg).init)(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _both(arch: str, strategy: str, *, steps: int = STEPS, seq: int = SEQ,
          accum: int = 1, dtype: str = "float32", remat: bool = True,
          routes: bool = False):
    """Both packages run ``steps`` adagrad steps (lr ``LR``) of
    ``strategy`` from the JAX init, computing in ``dtype``.  Returns (JAX
    states, JAX metrics, port states, port metrics, (JAX routes, port
    routes)); states[0] is the initial state.  ``routes``: every MoE
    call's top-k indices are recorded in each package (the forward's; with
    ``remat`` off the port calls each router once)."""
    jcfg, pcfg = _configs(arch, strategy, seq)
    japi = dataclasses.replace(
        jax_build_model(jcfg, compute_dtype=jnp.dtype(dtype), remat=remat),
        init=lambda rng: _jax_init(arch, jcfg.tie_embeddings))
    jinit, jstep = JS.make_train_step(
        japi, jax_get_optimizer("adagrad", LR), strategy=strategy,
        grad_accum=accum)
    api = build_model(pcfg, compute_dtype=getattr(torch, dtype), remat=remat)
    init, step = S.make_train_step(api, get_optimizer("adagrad", LR),
                                   strategy=strategy, grad_accum=accum)
    batches = _batches(jcfg, steps, seq)
    jstate = jinit(jax.random.PRNGKey(0))
    state = init(params=params_from_numpy(
        pcfg, JS.merge_params(_np(jstate.params), _np(jstate.head)), "cpu"))
    if strategy == "split_concurrent":
        jstate = JS.init_prev_features(jstate, japi, batches[0],
                                       dtype=jnp.dtype(dtype))
        state = S.init_prev_features(state, api, tree_as_tensors(batches[0]),
                                     dtype=getattr(torch, dtype))
    jroutes, proutes = [], []
    with pytest.MonkeyPatch.context() as mp:
        if routes:
            mp.setattr(jax_moe, "router_topk",
                       _recording_router(jax_moe, jroutes))
            mp.setattr(port_moe, "router_topk",
                       _recording_router(port_moe, proutes))
        jit_step = jax.jit(jstep)
        jstates, jmetrics, states, metrics = [jstate], [], [state], []
        for b in batches:
            jstate, m = jit_step(jstate, b)
            jstates.append(jax.block_until_ready(jstate))
            jmetrics.append(_np(m))
            state, m = step(state, tree_as_tensors(b))
            states.append(state)
            metrics.append(m)
    return jstates, jmetrics, states, metrics, (jroutes, proutes)


#: leaves whose gradient is zero in exact arithmetic, by their last key:
#: without RoPE (whisper-small) a key bias shifts every score of a query's
#: row alike, which the softmax cancels, so both packages' updates of it
#: are rounding noise (~1e-10 where the other updates are ~1e-4)
ZERO_GRAD = {"whisper-small": ("bk",)}


def _assert_updates_close(jstates, states, arch: str):
    """``test_torch_split_parallel._assert_updates_close``: every trained
    leaf's change since the initial state (and accumulator) within 1e-3 of
    the JAX change's largest magnitude with rtol 1e-3 beside it, or within
    one f32 spacing at the leaf's largest magnitude where that is more:
    a change is a difference of two f32 params, which cannot resolve less
    (Jamba's ``dt_b`` sits at -4.6, where the spacing is 4.8e-7, and
    changes by ~1.5e-4 a step).  The ``ZERO_GRAD`` leaves must change in
    both packages by less than 1e-6 of the largest change of any leaf,
    that is not at all."""
    zero = ZERO_GRAD.get(arch, ())
    for f in _TRAINED:
        want0 = jax.tree_util.tree_leaves(getattr(jstates[0], f))
        got0, tdef = tree_flatten(getattr(states[0], f))
        paths = _paths(tdef)
        for i, (js, s) in enumerate(zip(jstates[1:], states[1:])):
            want = jax.tree_util.tree_leaves(getattr(js, f))
            got = tree_leaves(getattr(s, f))
            diffs = [(path, np.asarray(a) - np.asarray(a0),
                      to_numpy(b) - to_numpy(b0), np.abs(np.asarray(a)).max())
                     for path, a0, b0, a, b in zip(paths, want0, got0, want,
                                                   got)]
            top = max((np.abs(dw).max() for _, dw, _, _ in diffs),
                      default=0.0)
            for path, dw, dg, big in diffs:
                if path.rsplit("/", 1)[-1] in zero:
                    assert max(np.abs(dw).max(), np.abs(dg).max()) \
                        < 1e-6 * top, (i, f, path)
                    continue
                np.testing.assert_allclose(
                    dg, dw, rtol=1e-3,
                    atol=max(1e-3 * np.abs(dw).max(),
                             np.spacing(np.float32(big))),
                    err_msg=f"step {i} {f}{path} update")


# --- 1. every family's strategies against JAX, f32 ---------------------------


@pytest.mark.parametrize("strategy", ["dp_full", "split_concurrent"])
@pytest.mark.parametrize("arch", PARITY)
def test_training_matches_jax(arch, strategy):
    """Per-step loss, aux loss and total, every state leaf after every step
    (params, head, head_stale, both accumulators, the feature-replay slots
    and step) and every update on its own scale."""
    jstates, jmetrics, states, metrics, _ = _both(arch, strategy)
    for i, (jm, m) in enumerate(zip(jmetrics, metrics)):
        for key in ("loss", "aux", "total"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       atol=2e-4, rtol=1e-3,
                                       err_msg=f"step {i} {key}")
    for i, (js, s) in enumerate(zip(jstates, states)):
        _assert_state_close(js, s, f"after step {i - 1}")
    _assert_updates_close(jstates, states, arch)
    if get_smoke_config(arch).is_moe:
        assert all(float(m["aux"]) > 0 for m in metrics)


# --- 2. remat, and the kernels kept out of training --------------------------


def _port_model(arch: str):
    """(cfg, api, the port's own init, one batch) of an arch's smoke
    config, f32."""
    _, cfg = _configs(arch, "dp_full", SEQ)
    api = build_model(cfg, compute_dtype=torch.float32)
    params = values_tree(api.init(torch.Generator().manual_seed(0)))
    return cfg, api, params, tree_as_tensors(_batches(cfg, 1)[0])


@pytest.mark.parametrize("arch", NEW)
def test_remat_gives_the_same_gradients(arch):
    """Recomputing each block (period, decoder block) in the backward pass
    changes no bit of the gradients on the CPU."""
    cfg, api, params, batch = _port_model(arch)
    grads = []
    for remat in (True, False):
        api = build_model(cfg, compute_dtype=torch.float32, remat=remat)
        _, _, (g,) = S._value_and_grad(lambda p: api.train_loss(p, batch),
                                       params)
        grads.append(tree_leaves(g))
    assert len(grads[0]) == len(grads[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("arch", NEW)
def test_kernels_stay_out_of_training(arch, monkeypatch):
    """With the wrappers of K3, K4 and K5 raising, ``train_loss`` and two
    steps of ``dp_full`` and of ``split_concurrent`` still run; the
    prefill, which runs the kernels, raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel reached")

    cfg, api, params, batch = _port_model(arch)
    for module, name in ((L, "flash_attention"), (rwkv, "wkv"),
                         (mamba, "mamba_scan")):
        monkeypatch.setattr(module, name, refuse)
    api.train_loss(params, batch)
    _, split_cfg = _configs(arch, "split_concurrent", SEQ)
    for strategy, c in (("dp_full", cfg), ("split_concurrent", split_cfg)):
        api = build_model(c, compute_dtype=torch.float32)
        init, step = S.make_train_step(api, get_optimizer("adagrad", LR),
                                       strategy=strategy)
        state = init(torch.Generator().manual_seed(0))
        if strategy == "split_concurrent":
            state = S.init_prev_features(state, api, batch,
                                         dtype=torch.float32)
        for _ in range(2):
            state, _ = step(state, batch)
    extras = {k: v for k, v in batch.items() if k in ("patches", "frames")}
    with pytest.raises(AssertionError, match="a kernel reached"):
        api.prefill(state.params | state.head,
                    {"tokens": batch["tokens"], **extras})


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_strategy_trains_every_arch(arch):
    """``train_loss`` and one step of each of the five strategy names on
    every arch ID's smoke config (each as ``arch_for_run`` gives it for the
    strategy): a finite loss, the step counted, and the backbone moved."""
    for strategy in ("dp_full", "fsdp_tp", "split_sequential",
                     "split_concurrent", "split_server_sharded"):
        _, cfg = _configs(arch, strategy, SEQ)
        api = build_model(cfg, compute_dtype=torch.float32)
        batch = tree_as_tensors(_batches(cfg, 1)[0])
        init, step = S.make_train_step(api, get_optimizer("adagrad", LR),
                                       strategy=strategy)
        state = init(torch.Generator().manual_seed(0))
        loss, _ = api.train_loss(S.merge_params(state.params, state.head),
                                 batch)
        if strategy in ("split_concurrent", "split_server_sharded"):
            state = S.init_prev_features(state, api, batch,
                                         dtype=torch.float32)
        new, metrics = step(state, batch)
        assert np.isfinite(float(loss)) and np.isfinite(
            float(metrics["loss"])), strategy
        assert int(new.step) == 1, strategy
        assert any(not torch.equal(a, b) for a, b in zip(
            tree_leaves(state.params), tree_leaves(new.params))), strategy
