"""Serving with bf16 parameters, as ``build_decode_step`` and the dry-run
give them: every float parameter cast to bf16, compute at bf16, on all ten
smoke configs, in the port against the JAX package on the CPU.

Both packages start from the JAX init cast to bf16 (the same rounding on
both sides), run one prefill and ``GEN`` decode steps along the JAX
package's greedy tokens, and are compared after each: the logits within
``tests/test_torch_lm_models.py::BF16_TOL`` and every cache leaf within
``BF16_STATE_TOL`` (else ``BF16_TOL``).  A row of an MoE model is compared
up to the first token whose route bf16 flipped in some layer, as the zoo's
bf16 tests do: from there on it takes other experts' outputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import moe as port_moe
from repro_torch.models.model import build_model, params_from_numpy
from repro_torch.tree import tree_map
from test_torch_lm_models import (BF16_STATE_TOL, BF16_TOL, _alike_tokens,
                                  _close, _f32, _init, _recording_router)
from test_torch_zoo import _extras, _jax_batch, _offset, _torch_batch

B, S, GEN = 2, 12, 4


def _bf16_jax(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.bfloat16)
        if jnp.issubdtype(x.dtype, jnp.floating) else jnp.asarray(x), tree)


def _bf16_port(tree):
    return tree_map(lambda x: x.to(torch.bfloat16)
                    if x.is_floating_point() else x, tree)


def _run_jax(cfg, params, prompts, extras):
    """Prefill, then GEN greedy decode steps: per step the logits, the
    cache, the token fed next and the MoE calls' top-k indices."""
    api = jax_build_model(cfg, compute_dtype=jnp.bfloat16, remat=False)
    off = _offset(cfg)
    prefill = jax.jit(lambda p, bt: api.prefill(p, bt,
                                                cache_len=off + S + GEN))
    step = jax.jit(api.decode_step)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        calls = []
        mp.setattr(jax_moe, "router_topk", _recording_router(jax_moe, calls))
        logits, cache = jax.block_until_ready(
            prefill(params, _jax_batch(prompts, extras)))
        for i in range(GEN + 1):
            tok = jnp.argmax(logits[:, -1:, :cfg.vocab_size].astype(
                jnp.float32), -1).astype(jnp.int32)
            out.append(dict(logits=np.asarray(logits.astype(jnp.float32)),
                            cache=jax.tree_util.tree_map(np.asarray, cache),
                            token=np.asarray(tok), routes=list(calls)))
            if i == GEN:
                break
            calls.clear()
            logits, cache = jax.block_until_ready(
                step(params, cache, tok, jnp.int32(off + S + i)))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_params_prefill_and_decode_match_jax(arch, monkeypatch):
    cfg = jax_smoke_config(arch)
    api = jax_build_model(cfg, compute_dtype=jnp.bfloat16, remat=False)
    params = _init(api.init)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extras = _extras(cfg, rng)
    want = _run_jax(cfg, _bf16_jax(params), prompts, extras)

    port_cfg = get_smoke_config(arch)
    port_api = build_model(port_cfg, compute_dtype=torch.bfloat16)
    port_params = _bf16_port(params_from_numpy(port_cfg, params,
                                               device="cpu"))
    off = _offset(port_cfg)
    calls = []
    monkeypatch.setattr(port_moe, "router_topk",
                        _recording_router(port_moe, calls))
    logits, cache = port_api.prefill(
        port_params, _torch_batch(prompts, extras),
        cache_len=off + S + GEN)
    # rows whose every prompt token routed alike in both packages
    alike = _alike_tokens(port_cfg, want[0]["routes"], calls, prompts.shape)
    rows = alike.all(1)
    for i, w in enumerate(want):
        if i:
            calls.clear()
            logits, cache = port_api.decode_step(
                port_params, cache, torch.tensor(want[i - 1]["token"]),
                off + S + i - 1)
            rows &= _alike_tokens(port_cfg, w["routes"], calls,
                                  (B, 1)).all(1)
        assert rows.any(), f"{arch}: bf16 flipped a route in every row"
        assert logits.dtype == torch.bfloat16
        _close(_f32(logits)[rows], w["logits"][rows], **BF16_TOL)
        assert set(cache) == set(w["cache"])
        for key, got in cache.items():
            ref = w["cache"][key]
            assert str(got.dtype).split(".")[1] == str(ref.dtype), key
            if got.dtype == torch.int32:
                np.testing.assert_array_equal(got.numpy(), ref)
                continue
            batch_dim = 2 if key in ("ssm", "conv") else 1  # steps.py
            _close(_f32(got).take(np.flatnonzero(rows), batch_dim),
                   _f32(ref).take(np.flatnonzero(rows), batch_dim),
                   **BF16_STATE_TOL.get(key, BF16_TOL))
