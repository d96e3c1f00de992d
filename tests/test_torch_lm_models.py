"""The port's LM layers, models and serving loop against the JAX package,
on the CPU.

Weights are the JAX package's own init, carried across as numpy
(``params_from_numpy``); inputs are numpy arrays from a seed fed to both.
Attention in the port runs its flash-attention wrapper and the RWKV
recurrence its WKV wrapper, here on their plain versions.  The f32 cases
use the JAX package's own bar for the attention layer
(``test_flash_attention_matches_model_attention_layer``): atol 2e-4, rtol
1e-3.  The bf16 cases (bf16 is ``build_model``'s default compute dtype in
both packages) use the bars stated at ``BF16_TOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch_config as jax_arch_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.serve import generate as jax_generate
from repro.models import layers as JL
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build_model
from repro.models.model import count_params_analytic as jax_count_params
from repro.models.model import lm_loss as jax_lm_loss
from repro.sharding.spec import values_tree as jax_values_tree
from repro_torch.configs import INPUT_SHAPES, get_arch_config, \
    get_smoke_config
from repro_torch.launch.serve import generate
from repro_torch.models import hybrid
from repro_torch.models import layers as L
from repro_torch.models import moe as port_moe
from repro_torch.models.model import (build_model, count_params_analytic,
                                      lm_loss, params_from_numpy)
from repro_torch.models.moe import dispatch_load
from repro_torch.tree import tree_as_tensors

TOL = dict(atol=2e-4, rtol=1e-3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(init_fn, seed=0):
    """The values tree of a JAX init, jitted (eager init dispatches one
    small computation per op, which costs seconds on the CPU)."""
    return _np(jax.jit(lambda k: jax_values_tree(init_fn(k)))(
        jax.random.PRNGKey(seed)))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _perturbed(tree, rng):
    """A values tree with every leaf moved off its init (norm scales of 1
    and biases of 0 would hide a missing term)."""
    return jax.tree_util.tree_map(
        lambda x: (x + rng.normal(size=x.shape) * 0.05).astype(np.float32),
        tree)


# --- layers ------------------------------------------------------------------

#: (arch, window): GQA + qk-norm; MHA + qkv-bias + tied head; GQA +
#: layernorm + relu2 with a sliding window
LAYER_CASES = [("qwen3-4b", 0), ("qwen1.5-0.5b", 0), ("minitron-4b", 6)]


@pytest.mark.parametrize("arch,window", LAYER_CASES)
def test_attention_full_sequence_matches_jax(arch, window):
    cfg = jax_smoke_config(arch)
    rng = np.random.default_rng(1)
    p = _perturbed(_init(lambda k: JL.init_attention(k, cfg)), rng)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)
    y1, (k1, v1) = jax.jit(lambda p, x, pos: JL.attention(
        p, cfg, x, positions=pos, window=window))(p, x, pos)
    y2, (k2, v2) = L.attention(tree_as_tensors(p), get_smoke_config(arch),
                               torch.from_numpy(x),
                               positions=torch.from_numpy(pos),
                               window=window)
    _close(y2, y1)
    _close(k2, k1)
    _close(v2, v1)


@pytest.mark.parametrize("arch,window", LAYER_CASES)
def test_attention_decode_matches_jax(arch, window):
    """One token against a cache with empty slots (-1); with a window the
    cache is a ring and the slot wraps."""
    cfg = jax_smoke_config(arch)
    rng = np.random.default_rng(2)
    p = _perturbed(_init(lambda k: JL.init_attention(k, cfg)), rng)
    size, index = (window, 9) if window else (12, 7)
    shape = (2, size, cfg.num_kv_heads, cfg.resolved_head_dim)
    ck, cv = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    kv_pos = (np.arange(size, dtype=np.int32) if not window
              else np.array([6, 7, 8, 3, 4, 5], np.int32))
    if not window:
        kv_pos[index:] = -1
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    y1, (ck1, cv1, pos1) = jax.jit(lambda p, x, cache: JL.attention(
        p, cfg, x, positions=jnp.full((1,), index, jnp.int32),
        window=window, cache=cache, cache_index=index))(p, x,
                                                        (ck, cv, kv_pos))
    cache = tuple(torch.from_numpy(a.copy()) for a in (ck, cv, kv_pos))
    y2, (ck2, cv2, pos2) = L.attention(
        tree_as_tensors(p), get_smoke_config(arch), torch.from_numpy(x),
        positions=torch.full((1,), index, dtype=torch.int32), window=window,
        cache=cache, cache_index=index)
    assert ck2 is cache[0] and pos2 is cache[2]     # updated in place
    _close(y2, y1)
    _close(ck2, ck1)
    _close(cv2, cv1)
    np.testing.assert_array_equal(pos2.numpy(), np.asarray(pos1))


def test_dense_attend_and_grouped_attend_match_jax():
    """The two softmax-attention helpers on their own, with a mask: the
    repeated-KV form and the grouped (decode) form."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 5, 8, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 9, 2, 32)).astype(np.float32)
            for _ in range(2))
    mask = rng.uniform(size=(5, 9)) > 0.3
    mask[:, 0] = True
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    _close(L._attend(tq, L._repeat_kv(tk, 8), L._repeat_kv(tv, 8), tm, 0.2),
           JL._attend(jq, JL._repeat_kv(jk, 8), JL._repeat_kv(jv, 8), jm,
                      0.2))
    _close(L._attend_grouped(tq, tk, tv, tm, 0.2),
           JL._attend_grouped(jq, jk, jv, jm, 0.2))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match_jax(norm):
    cfg = dataclasses.replace(jax_smoke_config("qwen3-4b"), norm=norm)
    rng = np.random.default_rng(3)
    p = _perturbed(_np(jax_values_tree(JL.init_norm(cfg))), rng)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32) * 3
    _close(L.apply_norm(tree_as_tensors(p), cfg, torch.from_numpy(x)),
           JL.apply_norm(p, cfg, jnp.asarray(x)))
    head = x.reshape(2, 5, 4, 64)
    scale = p["scale"][:64]
    _close(L._rms_head(torch.from_numpy(head), torch.from_numpy(scale)),
           JL._rms_head(jnp.asarray(head), jnp.asarray(scale)))


def test_rope_matches_jax():
    rng = np.random.default_rng(4)
    pos = np.arange(600, dtype=np.int32)
    cos1, sin1 = JL.rope_cos_sin(jnp.asarray(pos), 128, 1e6)
    cos2, sin2 = L.rope_cos_sin(torch.from_numpy(pos), 128, 1e6)
    _close(cos2, cos1, atol=1e-5, rtol=0)
    _close(sin2, sin1, atol=1e-5, rtol=0)
    x = rng.normal(size=(2, 600, 3, 128)).astype(np.float32)
    _close(L.apply_rope(torch.from_numpy(x), cos2, sin2),
           JL.apply_rope(jnp.asarray(x), cos1, sin1))


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_mlp_matches_jax(act):
    cfg = dataclasses.replace(jax_smoke_config("qwen3-4b"), act=act)
    rng = np.random.default_rng(5)
    p = _init(lambda k: JL.init_mlp(k, cfg), seed=1)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    _close(L.apply_mlp(tree_as_tensors(p), cfg, torch.from_numpy(x)),
           JL.apply_mlp(p, cfg, jnp.asarray(x)))


# --- models ------------------------------------------------------------------

B, S, GEN = 2, 12, 3


@pytest.fixture(scope="module",
                params=["qwen3-4b", "rwkv6-1.6b", "jamba-1.5-large-398b"])
def served(request):
    """The JAX side of one smoke model, run once: params, prompts, prefill,
    GEN decode steps along the greedy tokens, and ``generate``."""
    cfg = jax_smoke_config(request.param)
    api = jax_build_model(cfg, compute_dtype=jnp.float32, remat=False)
    params = _init(api.init)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    logits, cache = jax.jit(lambda p, t: api.prefill(
        p, {"tokens": t}, cache_len=S + GEN))(params, jnp.asarray(prompts))
    steps = [(logits, _np(cache))]
    step = jax.jit(api.decode_step)
    for i in range(GEN):
        tok = jnp.argmax(logits[:, :, :cfg.vocab_size], -1).astype(jnp.int32)
        logits, cache = step(params, cache, tok, jnp.int32(S + i))
        steps.append((logits, _np(cache)))
    toks = jax_generate(api, params, jnp.asarray(prompts), gen=GEN)
    feats = jax.jit(api.forward_features)(params,
                                          {"tokens": jnp.asarray(prompts)})
    port_cfg = get_smoke_config(request.param)
    return dict(arch=request.param, cfg=port_cfg, prompts=prompts,
                np_params=params, steps=steps,
                toks=np.asarray(toks), features=feats,
                api=build_model(port_cfg, compute_dtype=torch.float32),
                params=params_from_numpy(port_cfg, params, device="cpu"))


def _tokens(a):
    return torch.from_numpy(np.asarray(a)).to(torch.int32)


def test_prefill_and_decode_steps_match_jax(served):
    """Prefill logits and cache, then GEN decode steps (each logits and the
    whole cache after it) along the same greedy tokens."""
    api, params, cfg = served["api"], served["params"], served["cfg"]
    logits, cache = api.prefill(params, {"tokens": _tokens(
        served["prompts"])}, cache_len=S + GEN)
    for i, (want_logits, want_cache) in enumerate(served["steps"]):
        _close(logits, want_logits)
        assert set(cache) == set(want_cache)
        for key in cache:
            _close(cache[key], want_cache[key])
        if i == GEN:
            break
        tok = logits[:, :, :cfg.vocab_size].argmax(-1).to(torch.int32)
        logits, cache = api.decode_step(params, cache, tok, S + i)


def test_forward_features_matches_jax(served):
    api, params = served["api"], served["params"]
    logits, aux, feats = api.forward_features(
        params, {"tokens": _tokens(served["prompts"])})
    want_logits, want_aux, want_feats = served["features"]
    _close(logits, want_logits)
    _close(feats, want_feats)
    _close(aux, want_aux)                   # the MoE load-balance loss
    assert (float(aux) > 0) == served["cfg"].is_moe
    assert torch.equal(api.head_logits(params, feats), logits)


def test_generate_matches_jax_generate(served):
    toks = generate(served["api"], served["params"],
                    _tokens(served["prompts"]), gen=GEN)
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), served["toks"])


def test_generate_matches_teacher_forced_forward(served, monkeypatch):
    """The port's own version of ``tests/test_serve.py``'s check, at every
    generated position: the greedy tokens are the argmax of one full
    forward over prompt + generated tokens (causal, so each position sees
    only its past).  A MoE layer that dropped an assignment in one pass
    and not in the other would route the two otherwise, so first no pass
    may have dropped one."""
    api, params, cfg = served["api"], served["params"], served["cfg"]
    dropped = []
    routed = hybrid.apply_moe

    def counted(p, cfg, x, *, capacity_factor=None):
        _, _, drops = dispatch_load(p, cfg, x,
                                    capacity_factor=capacity_factor)
        dropped.append(int(drops.sum()))
        return routed(p, cfg, x, capacity_factor=capacity_factor)

    monkeypatch.setattr(hybrid, "apply_moe", counted)
    prompts = _tokens(served["prompts"])
    toks = generate(api, params, prompts, gen=GEN)
    logits, _, _ = api.forward_features(
        params, {"tokens": torch.cat([prompts, toks], 1)})
    assert len(dropped) == (2 + GEN if cfg.is_moe else 0)
    assert sum(dropped) == 0
    picked = logits[:, S - 1:S + GEN - 1, :cfg.vocab_size].argmax(-1)
    np.testing.assert_array_equal(picked.numpy(), toks.numpy())


def test_params_from_numpy_checks_keys_shapes_and_dtypes(served):
    cfg, tree = served["cfg"], served["np_params"]
    extra = dict(tree, stray={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        params_from_numpy(cfg, extra, device="cpu")
    table = tree["embed"]["table"]
    for bad in (table[:-1], table.astype(np.float64)):
        with pytest.raises(ValueError, match="/embed/table"):
            params_from_numpy(cfg, dict(tree, embed={"table": bad}),
                              device="cpu")


def test_generate_through_a_sliding_window_ring_matches_jax():
    """A prompt longer than the window: prefill keeps a ring of the last
    ``window`` positions and decode wraps around it."""
    jcfg = dataclasses.replace(jax_smoke_config("minitron-4b"),
                               sliding_window=8)
    cfg = dataclasses.replace(get_smoke_config("minitron-4b"),
                              sliding_window=8)
    api = jax_build_model(jcfg, compute_dtype=jnp.float32, remat=False)
    params = _init(api.init)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 16)).astype(np.int32)
    want = jax_generate(api, params, jnp.asarray(prompts), gen=6)
    got = generate(build_model(cfg, compute_dtype=torch.float32),
                   params_from_numpy(cfg, params, device="cpu"),
                   _tokens(prompts), gen=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lm_loss_and_batch_spec_match_jax():
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(2, 6, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 6)).astype(np.int32)
    mask = (rng.uniform(size=(2, 6)) > 0.3).astype(np.float32)
    _close(lm_loss(*map(torch.from_numpy, (logits, labels, mask))),
           jax_lm_loss(*map(jnp.asarray, (logits, labels, mask))))
    from repro.configs import INPUT_SHAPES as JAX_SHAPES
    want = jax_build_model(jax_smoke_config("qwen3-4b")).batch_spec(
        JAX_SHAPES["train_4k"], global_batch=8)
    got = build_model(get_smoke_config("qwen3-4b")).batch_spec(
        INPUT_SHAPES["train_4k"], global_batch=8)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} \
        == {k: (shape, str(dtype).split(".")[1])
            for k, (shape, dtype) in got.items()}


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-1.6b",
                                  "jamba-1.5-large-398b"])
def test_param_count_matches_jax_at_full_size(arch):
    cfg = get_arch_config(arch)
    assert count_params_analytic(cfg) == jax_count_params(
        jax_arch_config(arch))
    assert count_params_analytic(cfg, active_only=True) == jax_count_params(
        jax_arch_config(arch), active_only=True)
    assert cfg.param_count() == count_params_analytic(cfg)
    assert cfg.active_param_count() == count_params_analytic(
        cfg, active_only=True)


def test_jamba_cut_served_on_one_card_counts_as_jax():
    """The depth cut ``chip_smoke.py`` serves: every published width, 2
    layers (1 Mamba + dense FFN, 1 attention + MoE FFN)."""
    cut = dict(num_layers=2, attn_layer_period=2, attn_layer_offset=1)
    cfg = dataclasses.replace(get_arch_config("jamba-1.5-large-398b"), **cut)
    jcfg = dataclasses.replace(jax_arch_config("jamba-1.5-large-398b"), **cut)
    assert count_params_analytic(cfg) == jax_count_params(jcfg) \
        == 11_912_896_512
    assert count_params_analytic(cfg, active_only=True) \
        == jax_count_params(jcfg, active_only=True) == 3_457_179_648


# --- bf16, the default compute dtype -----------------------------------------

#: The bf16 bars, at most twice the largest gap between the two packages
#: measured on these smoke models (B 2, S 12, the JAX init, seed 0).  Both
#: packages round every product and the residual stream to bf16, at
#: different places, and one bf16 ulp is 0.0156 at |x| in [2, 4) and 0.031
#: in [4, 8): prefill logits and the KV caches were within 0.047 and the
#: forward's logits within 0.070 (Jamba, over the tokens routed alike) at
#: |x| <= 4.5, so 0.1 absolute (the tests require |logits| <= 5, where
#: that is 2%); rwkv's f32 WKV state was within 0.086 at |s| <= 13.4 and
#: Jamba's f32 SSM state within 0.0023 at |h| <= 0.24.
BF16_TOL = dict(atol=0.1, rtol=0.0)
BF16_STATE_TOL = {"wkv": dict(atol=0.17, rtol=0.0),
                  "ssm": dict(atol=4.5e-3, rtol=0.0)}
#: the planted fault: the final norm's scale times 1.05.  A 1% scale of
#: any one weight moved these logits by at most 0.086, no more than bf16
#: rounding does, so it cannot be told from it at this bar.
FAULT_SCALE = 1.05


def _recording_router(module, calls):
    """``module.router_topk`` wrapped to append each call's top-k indices
    (as numpy) to ``calls``; under ``jax.jit`` through a debug callback."""
    routed = module.router_topk

    def recorded(logits, k):
        probs, weights, idx = routed(logits, k)
        if isinstance(idx, torch.Tensor):
            calls.append(idx.numpy().copy())
        else:
            jax.debug.callback(lambda i: calls.append(np.asarray(i)), idx)
        return probs, weights, idx
    return recorded


def _routed_alike(cfg, jax_idx, port_idx, capacity_factor=None):
    """(n,) bool over the tokens of one MoE call: True where both packages
    chose the same top-k experts and kept the same of them under the
    expert capacity (each package's ranks, the port's rule)."""
    n, k = jax_idx.shape
    cap = port_moe.expert_capacity(n, cfg.moe, capacity_factor)
    kept = []
    for idx in (jax_idx, port_idx):
        e_flat = torch.from_numpy(np.asarray(idx, np.int64).reshape(-1))
        pos = port_moe._positions_within_expert(e_flat, cfg.moe.num_experts)
        keep = (pos < cap).numpy().reshape(n, k)
        kept.append([frozenset(e for e, kp in zip(row, ks) if kp)
                     for row, ks in zip(idx, keep)])
    same_set = (np.sort(jax_idx, -1) == np.sort(port_idx, -1)).all(-1)
    same_kept = np.array([a == b for a, b in zip(*kept)])
    return same_set & same_kept


def _alike_tokens(cfg, jax_calls, port_calls, shape):
    """(B, S) bool: the tokens that every MoE layer routed alike in both
    packages (all True for a model without MoE)."""
    alike = np.ones(shape, bool)
    assert len(jax_calls) == len(port_calls)
    for ji, pi in zip(jax_calls, port_calls):
        alike &= _routed_alike(cfg, ji, pi).reshape(shape)
    return alike


@pytest.fixture(scope="module",
                params=["qwen3-4b", "rwkv6-1.6b", "jamba-1.5-large-398b"])
def served_bf16(request):
    """One smoke model at bf16 in both packages, on the JAX init: prefill
    logits and cache and ``forward_features``, with every MoE call's
    top-k indices recorded on both sides."""
    cfg = jax_smoke_config(request.param)
    api = jax_build_model(cfg, compute_dtype=jnp.bfloat16, remat=False)
    params = _init(api.init)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    port_cfg = get_smoke_config(request.param)
    port_api = build_model(port_cfg, compute_dtype=torch.bfloat16)
    port_params = params_from_numpy(port_cfg, params, device="cpu")
    out = dict(cfg=port_cfg, api=port_api, params=port_params,
               prompts=prompts)
    with pytest.MonkeyPatch.context() as mp:
        for name, module, call in (
                ("prefill", None, lambda: jax.jit(lambda p, t: api.prefill(
                    p, {"tokens": t}, cache_len=S + GEN))(
                        params, jnp.asarray(prompts))),
                ("features", None, lambda: jax.jit(api.forward_features)(
                    params, {"tokens": jnp.asarray(prompts)}))):
            calls = []
            mp.setattr(jax_moe, "router_topk",
                       _recording_router(jax_moe, calls))
            result = jax.block_until_ready(call())
            out[f"jax_{name}"] = jax.tree_util.tree_map(np.asarray, result)
            out[f"jax_{name}_routes"] = calls
            mp.undo()
    return out


def _port_routed(monkeypatch, fn):
    calls = []
    monkeypatch.setattr(port_moe, "router_topk",
                        _recording_router(port_moe, calls))
    result = fn()
    monkeypatch.undo()
    return result, calls


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _port_prefill(served, params=None):
    return served["api"].prefill(
        params if params is not None else served["params"],
        {"tokens": _tokens(served["prompts"])}, cache_len=S + GEN)


def test_bf16_prefill_matches_jax(served_bf16, monkeypatch):
    """Prefill logits and every cache entry at bf16 against the JAX
    package, at the bars of ``BF16_TOL``: logits (at the positions whose
    token every MoE layer routed alike), KV caches, the token shifts and
    conv tails in bf16, rwkv's WKV and Jamba's SSM states in f32."""
    (logits, cache), routes = _port_routed(
        monkeypatch, lambda: _port_prefill(served_bf16))
    want_logits, want_cache = served_bf16["jax_prefill"]
    assert logits.dtype == torch.bfloat16
    assert np.abs(_f32(want_logits)).max() <= 5.0
    alike = _alike_tokens(served_bf16["cfg"], served_bf16["jax_prefill_"
                                                          "routes"],
                          routes, served_bf16["prompts"].shape)
    last = alike[:, -logits.shape[1]:]
    assert last.all()               # no flipped route reaches these logits
    _close(_f32(logits), _f32(want_logits), **BF16_TOL)
    assert set(cache) == set(want_cache)
    for key, got in cache.items():
        want = want_cache[key]
        assert str(got.dtype).split(".")[1] == str(want.dtype), key
        if got.dtype == torch.int32:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            _close(_f32(got), _f32(want),
                   **BF16_STATE_TOL.get(key, BF16_TOL))


def test_bf16_forward_features_matches_jax(served_bf16, monkeypatch):
    """Logits and features of ``forward_features`` at bf16, over every
    token that each MoE layer routed alike in both packages (a token whose
    top-k set or kept experts differ takes other experts' outputs: bf16
    rounding flips near-ties of the router)."""
    api, params = served_bf16["api"], served_bf16["params"]
    (logits, aux, feats), routes = _port_routed(
        monkeypatch, lambda: api.forward_features(
            params, {"tokens": _tokens(served_bf16["prompts"])}))
    want_logits, want_aux, want_feats = served_bf16["jax_features"]
    alike = _alike_tokens(served_bf16["cfg"],
                          served_bf16["jax_features_routes"], routes,
                          served_bf16["prompts"].shape)
    assert alike.sum() >= alike.size - 2
    assert np.abs(_f32(want_logits)).max() <= 5.0
    _close(_f32(logits)[alike], _f32(want_logits)[alike], **BF16_TOL)
    _close(_f32(feats)[alike], _f32(want_feats)[alike], **BF16_TOL)
    _close(aux, want_aux, atol=1e-3, rtol=0.0)


def test_bf16_greedy_argmax_matches_jax_where_decisive(served_bf16,
                                                       monkeypatch):
    """Wherever JAX's top two logits lie further apart than the bar, the
    port picks the same token: the prefill's and every alike-routed
    position of ``forward_features``."""
    vocab = served_bf16["cfg"].vocab_size
    api, params = served_bf16["api"], served_bf16["params"]
    (pre, _), _ = _port_routed(monkeypatch, lambda: _port_prefill(
        served_bf16))
    (feat, _, _), routes = _port_routed(
        monkeypatch, lambda: api.forward_features(
            params, {"tokens": _tokens(served_bf16["prompts"])}))
    alike = _alike_tokens(served_bf16["cfg"],
                          served_bf16["jax_features_routes"], routes,
                          served_bf16["prompts"].shape)
    for got, want, rows in (
            (pre, served_bf16["jax_prefill"][0],
             np.ones(pre.shape[:2], bool)),
            (feat, served_bf16["jax_features"][0], alike)):
        got, want = _f32(got)[..., :vocab], _f32(want)[..., :vocab]
        top2 = np.sort(want, -1)[..., -2:]
        decisive = (top2[..., 1] - top2[..., 0] > BF16_TOL["atol"]) & rows
        assert decisive.any()
        np.testing.assert_array_equal(got.argmax(-1)[decisive],
                                      want.argmax(-1)[decisive])


def test_bf16_planted_fault_exceeds_the_bar(served_bf16):
    """The bar can fail: the final norm's scale times ``FAULT_SCALE``
    moves the prefill logits past ``BF16_TOL`` from the JAX package's."""
    params = dict(served_bf16["params"])
    norm = dict(params["final_norm"])
    norm["scale"] = norm["scale"] * FAULT_SCALE
    params["final_norm"] = norm
    logits, _ = _port_prefill(served_bf16, params)
    gap = np.abs(_f32(logits) - _f32(served_bf16["jax_prefill"][0])).max()
    assert gap > BF16_TOL["atol"]
