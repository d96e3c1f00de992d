"""The training paths that the families add, through the port, against the
JAX package on the CPU: the recurrent families' chunked scans across a
chunk boundary, a vlm's patches and an encdec's frames split per
microbatch under gradient accumulation, one step at bf16 for every new
family, and ``launch/train.py`` at bf16.

The setup, ``_both`` and the f32 bars are ``tests/test_torch_train_zoo.py``'s
(the JAX init carried across through ``params_from_numpy``, the same numpy
batches fed to both, each JAX jit once per process); the bf16 cases are
held to the bars stated at ``BF16_TRAIN_TOL``.
"""
import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro.launch import train as jax_train
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.core import split_parallel as S
from repro_torch.launch import train
from repro_torch.models import mamba, rwkv
from repro_torch.models.model import _paths, build_model
from repro_torch.optim import get_optimizer
from repro_torch.tree import (tree_as_tensors, tree_flatten, tree_leaves,
                              to_numpy)

from test_torch_lm_models import _routed_alike
from test_torch_split_parallel import _assert_state_close
from test_torch_train_zoo import (B, LR, NEW, SEQ, ZERO_GRAD,
                                  _assert_updates_close, _batches, _both,
                                  _configs)

#: the recurrent families, whose scans run 256-step chunks from S 512 on
CHUNKED = ("rwkv6-1.6b", "jamba-1.5-large-398b")
LONG_SEQ = 512

# --- the chunked scans, across a chunk boundary ------------------------------


def _chunk_lengths(monkeypatch, module, name):
    """Record the sequence length of each call of ``module.name``."""
    lengths, chunk = [], getattr(module, name)

    def recorded(*args):
        lengths.append(args[1].shape[1])
        return chunk(*args)

    monkeypatch.setattr(module, name, recorded)
    return lengths


@pytest.mark.parametrize("arch", CHUNKED)
def test_chunked_scan_training_matches_jax(arch, monkeypatch):
    """S 512: two 256-step chunks of the scan, each recomputed in the
    backward pass, with the state carried across the boundary.  One
    ``dp_full`` step: the loss, every gradient (from its update and
    accumulator) and every state leaf held to JAX."""
    module, name = ((rwkv, "_wkv_chunk") if arch == "rwkv6-1.6b"
                    else (mamba, "_scan_chunk"))
    lengths = _chunk_lengths(monkeypatch, module, name)
    jstates, jmetrics, states, metrics, _ = _both.__wrapped__(
        arch, "dp_full", steps=1, seq=LONG_SEQ)
    assert lengths and set(lengths) == {256}, lengths
    np.testing.assert_allclose(float(metrics[0]["loss"]),
                               float(jmetrics[0]["loss"]), atol=2e-4,
                               rtol=1e-3)
    for js, s in zip(jstates, states):
        _assert_state_close(js, s, arch)
    _assert_updates_close(jstates, states, arch)


# --- patches and frames under gradient accumulation --------------------------


@pytest.mark.parametrize("arch", ["internvl2-26b", "whisper-small"])
def test_extra_inputs_split_per_microbatch(arch):
    """``grad_accum=2``: each microbatch takes its rows of the patches or
    frames; ``split_concurrent`` re-assembles the microbatches' features
    (P + S positions for the vlm) along the batch, held to JAX on every
    leaf after every step."""
    jstates, jmetrics, states, metrics, _ = _both(arch, "split_concurrent",
                                                 accum=2)
    for jm, m in zip(jmetrics, metrics):
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=2e-4, rtol=1e-3)
    for i, (js, s) in enumerate(zip(jstates, states)):
        _assert_state_close(js, s, f"after step {i - 1}")
    _assert_updates_close(jstates, states, arch)
    cfg = get_smoke_config(arch)
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    assert tuple(states[-1].prev_features.shape) == (B, extra + SEQ,
                                                     cfg.d_model)


# --- bf16 against JAX at bf16 ------------------------------------------------

#: The bf16 training bars: twice the largest gap measured between the two
#: packages on one ``dp_full`` step (B 4, S 32, lr 0.05, the JAX init,
#: seed 0) over the six cases of ``BF16_ARCHS``.  Both packages round every
#: product and the residual stream to bf16, at different places.
#:   loss: 0.00511 (qwen3-moe-30b-a3b, one token's route flipped; the
#:     others 6.1e-5 to 5.7e-4);
#:   update, each leaf's change as a fraction of its largest magnitude:
#:     0.0513 (rwkv6-1.6b; the others 0.017-0.048);
#:   accumulator (g² after one step), likewise: 0.101 (rwkv6-1.6b; the
#:     others 0.024-0.051).
#: The planted fault moved the loss by 0.044-0.054, every case over its
#: bar.
BF16_TRAIN_TOL = {"loss": 0.0103, "update": 0.103, "accumulator": 0.203}
#: the planted fault: the final norm's scale times 1.05 in the port
FAULT_SCALE = 1.05
BF16_ARCHS = NEW + ("qwen3-4b",)


def _bf16_gaps(jstates, jmetrics, states, metrics, arch: str) -> dict:
    """The gaps ``BF16_TRAIN_TOL`` bounds, after one step; the
    ``ZERO_GRAD`` leaves are left out (their changes are rounding noise,
    held at f32 by ``test_training_matches_jax``)."""
    gaps = {"loss": abs(float(metrics[0]["loss"])
                        - float(jmetrics[0]["loss"]))}
    zero = ZERO_GRAD.get(arch, ())
    for key, field in (("update", "params"), ("accumulator", "opt_state")):
        got0, tdef = tree_flatten(getattr(states[0], field))
        worst = 0.0
        for path, w0, g0, w1, g1 in zip(
                _paths(tdef), jax.tree_util.tree_leaves(
                    getattr(jstates[0], field)), got0,
                jax.tree_util.tree_leaves(getattr(jstates[1], field)),
                tree_leaves(getattr(states[1], field))):
            if path.rsplit("/", 1)[-1] in zero:
                continue
            dw = np.asarray(w1) - np.asarray(w0)
            dg = to_numpy(g1) - to_numpy(g0)
            if key == "accumulator":
                dw, dg = np.asarray(w1), to_numpy(g1)
            scale = np.abs(dw).max()
            if scale:
                worst = max(worst, float(np.abs(dg - dw).max() / scale))
        gaps[key] = worst
    return gaps


def _flips(cfg, jroutes, proutes) -> int:
    """Tokens whose top-k experts or kept assignments differ between the
    packages, summed over the MoE calls."""
    assert len(jroutes) == len(proutes)
    return int(sum((~_routed_alike(cfg, np.asarray(j), np.asarray(p))).sum()
                   for j, p in zip(jroutes, proutes)))


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_step_matches_jax(arch):
    """One ``dp_full`` step at bf16 (params, gradients and accumulators
    f32, as in JAX) against the JAX package at bf16, at the bars of
    ``BF16_TRAIN_TOL``, with remat off so that each package calls each
    MoE router once.  For a family with a router the two packages' top-k
    choices are compared at every MoE call first: where bf16 flips a
    near-tie the tokens take other experts, so with any flip the loss
    alone is held (the gradients are held at f32 by
    ``test_training_matches_jax``); with none, every leaf.  Then a
    planted fault must exceed the bars."""
    run = _both(arch, "dp_full", steps=1, dtype="bfloat16", remat=False,
                routes=True)
    jstates, jmetrics, states, metrics, (jroutes, proutes) = run
    cfg = get_smoke_config(arch)
    flips = _flips(cfg, jroutes, proutes) if cfg.is_moe else 0
    gaps = _bf16_gaps(jstates, jmetrics, states, metrics, arch)
    held = ("loss",) if flips else tuple(BF16_TRAIN_TOL)
    for key in held:
        assert gaps[key] <= BF16_TRAIN_TOL[key], (key, gaps, flips)

    _, pcfg = _configs(arch, "dp_full", SEQ)
    api = build_model(pcfg, compute_dtype=torch.bfloat16, remat=False)
    init, step = S.make_train_step(api, get_optimizer("adagrad", LR),
                                   strategy="dp_full")
    params = dict(states[0].params)
    params["final_norm"] = {k: v * FAULT_SCALE if k == "scale" else v
                            for k, v in params["final_norm"].items()}
    faulty = init(params=params)
    new, m = step(faulty, tree_as_tensors(_batches(pcfg, 1)[0]))
    fault = _bf16_gaps(jstates, jmetrics, [faulty, new], [m], arch)
    assert any(fault[key] > BF16_TRAIN_TOL[key] for key in held), (fault,
                                                                   held)


# --- the CLI and train_loop --------------------------------------------------


def _cli(*argv):
    out = io.StringIO()
    with redirect_stdout(out):
        losses = train.main(list(argv) + ["--device", "cpu"])
    assert "final loss" in out.getvalue()
    return losses


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-1.6b",
                                  "jamba-1.5-large-398b"])
def test_train_cli_at_bf16_lowers_the_loss(arch):
    """``python -m repro_torch.launch.train --compute-dtype bfloat16`` on
    a smoke config, ``split_concurrent``, lr 0.1 (at the CLI's default
    1e-2 neither package's smoke loss falls within 6 steps)."""
    losses = _cli("--arch", arch, "--smoke", "--steps", "6", "--lr", "0.1",
                  "--batch", "4", "--seq", "32", "--compute-dtype",
                  "bfloat16")
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_train_loop_keeps_params_f32_at_bf16():
    """At bf16 the params, the accumulators and the gradients K2 takes are
    f32, and the replay slot holds bf16 features, as in JAX."""
    cfg = get_smoke_config("qwen3-4b")
    run = RunConfig(arch="qwen3-4b", strategy="split_concurrent",
                    learning_rate=0.1, compute_dtype="bfloat16")
    losses, state = train.train_loop(cfg, run, steps=2, batch=2, seq=16,
                                     device="cpu")
    assert all(np.isfinite(losses))
    for leaf in tree_leaves((state.params, state.head, state.opt_state,
                             state.head_opt_state)):
        assert leaf.dtype == torch.float32
    assert state.prev_features.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["internvl2-26b", "whisper-small"])
def test_train_loop_refuses_families_whose_batches_need_more(arch):
    """``train_loop`` makes token batches alone: the port refuses a vlm or
    encdec config with a ValueError that says so, where the JAX package's
    ``train_loop`` fails with a KeyError on the missing input."""
    need = "patches" if arch == "internvl2-26b" else "frames"
    run = RunConfig(arch=arch, strategy="split_concurrent",
                    compute_dtype="float32")
    with pytest.raises(ValueError, match=need):
        train.train_loop(get_smoke_config(arch), run, steps=1, batch=2,
                         seq=8, device="cpu")
    jrun = JaxRunConfig(arch=arch, strategy="split_concurrent",
                        compute_dtype="float32")
    with pytest.raises(KeyError, match=need):
        jax_train.train_loop(jax_smoke_config(arch), jrun, steps=1, batch=2,
                             seq=8)
