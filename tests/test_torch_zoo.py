"""The rest of the model zoo in the port against the JAX package, on the
CPU: the transformer-family MoE (qwen3-moe-30b-a3b, dbrx-132b), the
vision-language patch prefix (internvl2-26b) and the Whisper
encoder-decoder (whisper-small), each on its smoke config.

Weights are the JAX package's own init, carried across as numpy
(``params_from_numpy``); tokens, patches and frames are numpy arrays from a
seed fed to both packages.  Attention runs the flash-attention wrapper,
here its plain version: the prefill's, the encoder's (non-causal) and the
cross-attention's (Sq != Skv).  The f32 bar is
``tests/test_torch_lm_models.py``'s (atol 2e-4, rtol 1e-3); the bf16 bars
are that file's ``BF16_TOL``, over the tokens every MoE layer routed alike
in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_arch_config as jax_arch_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.serve import generate as jax_generate
from repro.models import layers as JL
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build_model
from repro.models.model import count_params_analytic as jax_count_params
from repro_torch.configs import INPUT_SHAPES, get_arch_config, \
    get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.serve import generate
from repro_torch.models import layers as L
from repro_torch.models import moe as port_moe
from repro_torch.models import transformer
from repro_torch.models.model import (build_model, count_params_analytic,
                                      params_from_numpy)
from repro_torch.models.moe import dispatch_load
from repro_torch.tree import tree_as_tensors
from test_torch_lm_models import (BF16_STATE_TOL, BF16_TOL, FAULT_SCALE,
                                  _alike_tokens, _close, _f32, _init, _np,
                                  _perturbed, _recording_router, _tokens)

ARCHS = ["qwen3-moe-30b-a3b", "dbrx-132b", "internvl2-26b", "whisper-small"]
B, S, GEN = 2, 12, 3
#: the depth cuts ``chip_smoke.py`` serves on one card: every published
#: width, 24 of 48 layers, and their parameter counts
CUTS = {"qwen3-moe-30b-a3b": 15_577_751_552, "internvl2-26b": 10_538_489_856}


def _offset(cfg):
    """Positions before the text: a vlm sequence starts with its patches."""
    return cfg.num_patches if cfg.family == "vlm" else 0


def _extras(cfg, rng):
    """The family's extra inputs as numpy, at unit scale (so the patch
    projection and the encoder carry weight in the logits)."""
    if cfg.family == "vlm":
        return {"patches": rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"frames": rng.normal(
            size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)}
    return {}


def _torch_batch(tokens, extras):
    return dict({k: torch.from_numpy(v) for k, v in extras.items()},
                tokens=_tokens(tokens))


def _jax_batch(tokens, extras):
    return dict({k: jnp.asarray(v) for k, v in extras.items()},
                tokens=jnp.asarray(tokens))


@pytest.fixture(scope="module", params=ARCHS)
def zoo(request):
    """The JAX side of one smoke model in f32, run once: prefill, GEN
    decode steps along its greedy tokens (a vlm's at P + S + i),
    ``forward_features`` and ``generate``."""
    cfg = jax_smoke_config(request.param)
    api = jax_build_model(cfg, compute_dtype=jnp.float32, remat=False)
    params = _init(api.init)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extras = _extras(cfg, rng)
    off = _offset(cfg)
    logits, cache = jax.jit(lambda p, bt: api.prefill(
        p, bt, cache_len=off + S + GEN))(params, _jax_batch(prompts, extras))
    steps = [(np.asarray(logits), _np(cache))]
    step = jax.jit(api.decode_step)
    for i in range(GEN):
        tok = jnp.argmax(logits[:, :, :cfg.vocab_size], -1).astype(jnp.int32)
        logits, cache = step(params, cache, tok, jnp.int32(off + S + i))
        steps.append((np.asarray(logits), _np(cache)))
    features = _np(jax.jit(api.forward_features)(
        params, _jax_batch(prompts, extras)))
    toks = np.asarray(jax_generate(
        api, params, jnp.asarray(prompts), gen=GEN,
        extra_inputs={k: jnp.asarray(v) for k, v in extras.items()}))
    port_cfg = get_smoke_config(request.param)
    return dict(arch=request.param, jax_api=api, np_params=params,
                cfg=port_cfg, prompts=prompts, extras=extras, steps=steps,
                features=features, jax_toks=toks,
                api=build_model(port_cfg, compute_dtype=torch.float32),
                params=params_from_numpy(port_cfg, params, device="cpu"))


def test_zoo_prefill_and_decode_steps_match_jax(zoo):
    """Prefill logits and every cache leaf (a Whisper cache's cross K/V
    included), then GEN decode steps along the same greedy tokens, each
    step's logits and the whole cache after it."""
    api, params, cfg = zoo["api"], zoo["params"], zoo["cfg"]
    off = _offset(cfg)
    logits, cache = api.prefill(params, _torch_batch(zoo["prompts"],
                                                     zoo["extras"]),
                                cache_len=off + S + GEN)
    want_keys = {"k", "v", "pos"} | ({"cross_k", "cross_v"}
                                     if cfg.family == "encdec" else set())
    assert set(cache) == want_keys
    for i, (want_logits, want_cache) in enumerate(zoo["steps"]):
        _close(logits, want_logits)
        assert set(cache) == set(want_cache)
        for key in cache:
            _close(cache[key], want_cache[key])
        if i == GEN:
            break
        tok = logits[:, :, :cfg.vocab_size].argmax(-1).to(torch.int32)
        logits, cache = api.decode_step(params, cache, tok, off + S + i)


def test_zoo_forward_features_matches_jax(zoo):
    """Logits, features and the aux loss (the MoE's load-balance loss, 0
    for the others) of one forward."""
    api, params, cfg = zoo["api"], zoo["params"], zoo["cfg"]
    logits, aux, feats = api.forward_features(
        params, _torch_batch(zoo["prompts"], zoo["extras"]))
    want_logits, want_aux, want_feats = zoo["features"]
    assert logits.shape[1] == _offset(cfg) + S
    _close(logits, want_logits)
    _close(feats, want_feats)
    _close(aux, want_aux)
    assert (float(aux) > 0) == cfg.is_moe
    assert torch.equal(api.head_logits(params, feats), logits)


def _counting_moe(monkeypatch):
    """``transformer.apply_moe`` wrapped to record, per call, the (B, S)
    tokens that had an assignment dropped."""
    dropped = []
    routed = transformer.apply_moe

    def counted(p, cfg, x, *, capacity_factor=None):
        dropped.append(dispatch_load(p, cfg, x,
                                     capacity_factor=capacity_factor)[2])
        return routed(p, cfg, x, capacity_factor=capacity_factor)

    monkeypatch.setattr(transformer, "apply_moe", counted)
    return dropped


def test_zoo_generate_matches_teacher_forced_forward(zoo, monkeypatch):
    """The port's ``generate`` gives the argmax of one forward over prompt
    + generated tokens at every generated position (for vlm: after the
    patches).  Each MoE call's dropped assignments are counted: a batch
    row where a drop touched the served passes or the forward may route
    otherwise in the two, and only such a row may differ."""
    api, params, cfg = zoo["api"], zoo["params"], zoo["cfg"]
    extras = {k: torch.from_numpy(v) for k, v in zoo["extras"].items()}
    prompts = _tokens(zoo["prompts"])
    dropped = _counting_moe(monkeypatch)
    toks = generate(api, params, prompts, gen=GEN, extra_inputs=extras)
    n_served = len(dropped)
    logits, _, _ = api.forward_features(
        params, dict(extras, tokens=torch.cat([prompts, toks], 1)))
    assert n_served == (cfg.num_layers * (1 + GEN) if cfg.is_moe else 0)
    assert len(dropped) == n_served + (cfg.num_layers if cfg.is_moe else 0)
    touched = np.zeros(B, bool)
    for d in dropped:
        touched |= d.any(-1).numpy()
    start = _offset(cfg) + S - 1
    picked = logits[:, start:start + GEN, :cfg.vocab_size].argmax(-1)
    differs = (picked != toks).any(-1).numpy()
    assert not (differs & ~touched).any(), (touched, differs)
    assert not touched.all()                # a row is left to compare
    np.testing.assert_array_equal(picked[~touched].numpy(),
                                  toks[~touched].numpy())


def test_zoo_generate_against_jax_generate(zoo):
    """Where the JAX ``generate`` is right (every family but vlm), the
    port's gives its tokens; on vlm it decodes at the wrong index, and the
    two differ (``test_vlm_reference_generate_departs_from_its_forward``)."""
    extras = {k: torch.from_numpy(v) for k, v in zoo["extras"].items()}
    toks = generate(zoo["api"], zoo["params"], _tokens(zoo["prompts"]),
                    gen=GEN, extra_inputs=extras)
    assert toks.dtype == torch.int32
    if zoo["cfg"].family == "vlm":
        assert (toks.numpy() != zoo["jax_toks"]).any()
    else:
        np.testing.assert_array_equal(toks.numpy(), zoo["jax_toks"])


def test_vlm_reference_generate_departs_from_its_forward():
    """A fault of the JAX package's ``generate``, recorded, not fixed: on
    vlm it sizes the cache S + gen and decodes at S + i, though the prefill
    put the P patch positions before the text, so each decode step writes
    over a prompt slot and masks out the prompt's tail.  On internvl2-26b's
    smoke config (B 2, S 12, 4 tokens, the inputs of the JAX ``main()``:
    seed 0, patches from normal(0, 0.02)) its tokens depart from its own
    teacher-forced forward's, and its first decode step's logits lie far
    from the forward's; decoded at P + S the step agrees with the forward.
    The port's ``generate`` decodes at P + S + i and gives the forward's
    tokens."""
    arch, b, s, gen = "internvl2-26b", 2, 12, 4
    jcfg = jax_smoke_config(arch)
    api = jax_build_model(jcfg, compute_dtype=jnp.float32, remat=False)
    params = _init(api.init)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    patches = rng.normal(0, 0.02, (b, jcfg.num_patches, jcfg.d_model))
    patches = patches.astype(np.float32)
    p = jcfg.num_patches
    jax_toks = np.asarray(jax_generate(api, params, jnp.asarray(prompts),
                                       gen=gen, extra_inputs={
                                           "patches": jnp.asarray(patches)}))

    cfg = get_smoke_config(arch)
    port_api = build_model(cfg, compute_dtype=torch.float32)
    port_params = params_from_numpy(cfg, params, device="cpu")
    toks = generate(port_api, port_params, _tokens(prompts), gen=gen,
                    extra_inputs={"patches": torch.from_numpy(patches)})
    # JAX's own forward over the port's tokens: the greedy tokens are its
    # argmax at every generated position
    fwd = np.asarray(jax.jit(api.forward_features)(params, {
        "tokens": jnp.asarray(np.concatenate([prompts, toks.numpy()], 1)),
        "patches": jnp.asarray(patches)})[0])[..., :jcfg.vocab_size]
    greedy = fwd[:, p + s - 1:p + s + gen - 1].argmax(-1)
    np.testing.assert_array_equal(toks.numpy(), greedy)
    assert (jax_toks != greedy).any()
    np.testing.assert_array_equal(jax_toks[:, 0], greedy[:, 0])  # prefill

    # the first decode step at the reference's index and at the right one
    # (cache of P + S + gen positions either way)
    logits, cache = jax.jit(lambda pr, t, pa: api.prefill(
        pr, {"tokens": t, "patches": pa}, cache_len=p + s + gen))(
            params, jnp.asarray(prompts), jnp.asarray(patches))
    tok = jnp.argmax(logits[:, :, :jcfg.vocab_size], -1).astype(jnp.int32)
    step = jax.jit(api.decode_step)
    gaps = {}
    for index in (s, p + s):
        got, _ = step(params, cache, tok, jnp.int32(index))
        gaps[index] = np.abs(np.asarray(got)[:, 0, :jcfg.vocab_size]
                             - fwd[:, p + s]).max()
    assert gaps[s] > 1.0 and gaps[p + s] < 1e-4, gaps


def test_dbrx_served_row_departs_only_where_the_prefill_dropped(monkeypatch):
    """dbrx-132b's smoke config (B 2, S 12, 4 tokens, seed 0) serves a row
    whose tokens differ from its teacher-forced forward's from the first
    token on.  The drops are counted: that row is the one where the prefill
    (24 tokens, expert capacity 16) dropped assignments; decode (capacity
    factor 2) dropped none."""
    arch, b, s, gen = "dbrx-132b", 2, 12, 4
    cfg = get_smoke_config(arch)
    params = params_from_numpy(
        cfg, _init(jax_build_model(jax_smoke_config(arch)).init),
        device="cpu")
    api = build_model(cfg, compute_dtype=torch.float32)
    prompts = _tokens(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)))
    dropped = _counting_moe(monkeypatch)
    toks = generate(api, params, prompts, gen=gen)
    logits, _, _ = api.forward_features(
        params, {"tokens": torch.cat([prompts, toks], 1)})
    n = cfg.num_layers
    rows = [np.stack([d.any(-1).numpy() for d in calls]).any(0)
            for calls in (dropped[:n], dropped[n:-n], dropped[-n:])]
    prefill_rows, decode_rows, _ = rows
    picked = logits[:, s - 1:s + gen - 1, :cfg.vocab_size].argmax(-1)
    differs = (picked != toks).any(-1).numpy()
    assert differs.any() and not decode_rows.any()
    np.testing.assert_array_equal(differs, prefill_rows)
    np.testing.assert_array_equal(differs, (picked != toks)[:, 0].numpy())


# --- layers ------------------------------------------------------------------

#: cross-attention blocks: Whisper's (MHA, QKV bias), and a GQA one with
#: qk-norm in the config, which a cross block leaves out
CROSS_CASES = ["whisper-small", "qwen3-4b"]


@pytest.mark.parametrize("arch", CROSS_CASES)
def test_cross_attention_full_sequence_matches_jax(arch):
    """Queries from the decoder (S 10), keys and values from the encoder
    (T 37): non-causal, no RoPE; the K/V returned are the ones a decode
    step reads."""
    cfg = jax_smoke_config(arch)
    rng = np.random.default_rng(8)
    p = _perturbed(_init(lambda k: JL.init_attention(k, cfg, cross=True)),
                   rng)
    port_p = L.init_attention(None, get_smoke_config(arch), cross=True)
    assert set(port_p) == set(p) and "q_norm" not in p
    x = rng.normal(size=(2, 10, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32)
    y1, (k1, v1) = jax.jit(lambda p, x, e, pos: JL.attention(
        p, cfg, x, positions=pos, encoder_out=e, use_rope=False))(
            p, x, enc, pos)
    y2, (k2, v2) = L.attention(tree_as_tensors(p), get_smoke_config(arch),
                               torch.from_numpy(x),
                               positions=torch.from_numpy(pos),
                               encoder_out=torch.from_numpy(enc),
                               use_rope=False)
    assert k2.shape == (2, 37, cfg.num_kv_heads, cfg.resolved_head_dim)
    _close(y2, y1)
    _close(k2, k1)
    _close(v2, v1)


@pytest.mark.parametrize("arch", CROSS_CASES)
def test_cross_attention_decode_matches_jax(arch):
    """One token against the cached encoder K/V, which come back as they
    were."""
    cfg = jax_smoke_config(arch)
    rng = np.random.default_rng(9)
    p = _perturbed(_init(lambda k: JL.init_attention(k, cfg, cross=True)),
                   rng)
    shape = (2, 37, cfg.num_kv_heads, cfg.resolved_head_dim)
    ck, cv = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    y1, _ = jax.jit(lambda p, x, cache: JL.attention(
        p, cfg, x, positions=jnp.full((1,), 5, jnp.int32), cache=cache,
        use_rope=False))(p, x, (ck, cv))
    cache = (torch.from_numpy(ck), torch.from_numpy(cv))
    y2, out = L.attention(tree_as_tensors(p), get_smoke_config(arch),
                          torch.from_numpy(x),
                          positions=torch.full((1,), 5, dtype=torch.int32),
                          cache=cache, use_rope=False)
    assert out is cache
    assert np.array_equal(cache[0].numpy(), ck)
    _close(y2, y1)


def _sinusoid_tol(index: int) -> dict:
    """The bar of a sinusoid at position ``index`` against the JAX
    package's: XLA's ``exp`` and the port's round some of the table's
    frequencies (all <= 1) one ulp apart (neither is exact; XLA's jitted
    and eager ``exp`` differ too), and ``index * freq`` carries two ulps
    of a frequency, 2**-23, into the angle; ``sin`` and ``cos`` add an
    ulp."""
    return dict(atol=1e-6 + index * 2.0 ** -23, rtol=0.0)


def test_sinusoidal_positions_match_jax():
    """The encoder's table at Whisper's width over its 1,500 frames."""
    want = np.asarray(jax.jit(lambda: JL.sinusoidal_positions(1500, 768))())
    got = L.sinusoidal_positions(1500, 768)
    assert got.dtype == torch.float32 and got.shape == (1500, 768)
    _close(got, want, **_sinusoid_tol(1499))
    _close(got[:64], want[:64], **_sinusoid_tol(63))


def test_whisper_decode_position_row_matches_jax():
    """A decode step's sinusoid, computed alone: bitwise the port's table's
    row ``min(index, max_seq_len - 1)``, and JAX's (the row its decode
    step slices from the whole table) within ``_sinusoid_tol``."""
    cfg = get_arch_config("whisper-small")
    n, d = cfg.max_seq_len, cfg.d_model
    table = L.sinusoidal_positions(2000, d)
    jax_row = jax.jit(lambda i: jax.lax.dynamic_slice_in_dim(
        JL.sinusoidal_positions(n, d), jnp.minimum(i, n - 1), 1))
    for index in (0, 1, 79, 1999, n - 1, n + 5000):
        row = L.sinusoidal_position(index, d, n)
        assert row.shape == (1, d) and row.dtype == torch.float32
        if index < len(table):
            assert torch.equal(row[0], table[index]), index
        _close(row, np.asarray(jax_row(jnp.int32(index))),
               **_sinusoid_tol(min(index, n - 1)))
    assert torch.equal(L.sinusoidal_position(n + 5000, d, n),
                       L.sinusoidal_position(n - 1, d, n))


# --- bf16, the default compute dtype -----------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def zoo_bf16(request):
    """One smoke model at bf16 in both packages on the JAX init: prefill
    logits and cache, and ``forward_features``, with every MoE call's
    top-k indices recorded on both sides."""
    cfg = jax_smoke_config(request.param)
    api = jax_build_model(cfg, compute_dtype=jnp.bfloat16, remat=False)
    params = _init(api.init)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extras = _extras(cfg, rng)
    cache_len = _offset(cfg) + S + GEN
    port_cfg = get_smoke_config(request.param)
    out = dict(cfg=port_cfg, prompts=prompts, extras=extras,
               api=build_model(port_cfg, compute_dtype=torch.bfloat16),
               params=params_from_numpy(port_cfg, params, device="cpu"))
    batch = _jax_batch(prompts, extras)
    with pytest.MonkeyPatch.context() as mp:
        for name, call in (
                ("prefill", lambda: jax.jit(lambda p, bt: api.prefill(
                    p, bt, cache_len=cache_len))(params, batch)),
                ("features", lambda: jax.jit(api.forward_features)(
                    params, batch))):
            calls = []
            mp.setattr(jax_moe, "router_topk",
                       _recording_router(jax_moe, calls))
            out[f"jax_{name}"] = _np(jax.block_until_ready(call()))
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


def _clean(cfg, jax_routes, port_routes, prompts):
    """(B, P + S) bool: the positions that no MoE route flipped by bf16
    reaches.  A token that some layer routed otherwise in the two packages
    takes other experts' outputs, and through causal attention every later
    position of its row reads it, so a row is compared up to its first
    flipped token (a vlm's patch positions come first and route nothing)."""
    alike = _alike_tokens(cfg, jax_routes, port_routes, prompts.shape)
    clean = np.logical_and.accumulate(alike, axis=1)
    assert clean.all(1).any()                  # a whole row to compare
    return np.concatenate([np.ones((B, _offset(cfg)), bool), clean], 1)


def test_zoo_bf16_prefill_matches_jax(zoo_bf16, monkeypatch):
    """Prefill logits and every cache leaf (the cross K/V included) at
    bf16 within ``BF16_TOL``, over the rows and positions ``_clean``
    keeps."""
    z = zoo_bf16
    cfg = z["cfg"]
    (logits, cache), routes = _port_routed(monkeypatch, lambda: z[
        "api"].prefill(z["params"], _torch_batch(z["prompts"], z["extras"]),
                       cache_len=_offset(cfg) + S + GEN))
    want_logits, want_cache = z["jax_prefill"]
    assert logits.dtype == torch.bfloat16
    assert np.abs(_f32(want_logits)).max() <= 5.0
    clean = _clean(cfg, z["jax_prefill_routes"], routes, z["prompts"])
    rows = clean.all(1)
    _close(_f32(logits)[rows], _f32(want_logits)[rows], **BF16_TOL)
    assert set(cache) == set(want_cache)
    for key, got in cache.items():
        want = want_cache[key]
        assert str(got.dtype).split(".")[1] == str(want.dtype), key
        if got.dtype == torch.int32:
            np.testing.assert_array_equal(got.numpy(), want)
            continue
        if key in ("k", "v"):    # the prompt's positions, then empty slots
            seen = np.ones((B, got.shape[2]), bool)
            seen[:, :clean.shape[1]] = clean
            got, want = got[:, seen], want[:, seen]
        _close(_f32(got), _f32(want), **BF16_STATE_TOL.get(key, BF16_TOL))


def test_zoo_bf16_forward_features_matches_jax(zoo_bf16, monkeypatch):
    """Logits and features at bf16 within ``BF16_TOL`` over the positions
    ``_clean`` keeps, and the aux loss."""
    z = zoo_bf16
    cfg = z["cfg"]
    (logits, aux, feats), routes = _port_routed(
        monkeypatch, lambda: z["api"].forward_features(
            z["params"], _torch_batch(z["prompts"], z["extras"])))
    want_logits, want_aux, want_feats = z["jax_features"]
    clean = _clean(cfg, z["jax_features_routes"], routes, z["prompts"])
    assert np.abs(_f32(want_logits)).max() <= 5.0
    _close(_f32(logits)[clean], _f32(want_logits)[clean], **BF16_TOL)
    _close(_f32(feats)[clean], _f32(want_feats)[clean], **BF16_TOL)
    _close(aux, want_aux, atol=1e-3, rtol=0.0)


# --- configurations ----------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_param_count_matches_jax_at_full_size(arch):
    cfg = get_arch_config(arch)
    assert count_params_analytic(cfg) == jax_count_params(
        jax_arch_config(arch))
    assert count_params_analytic(cfg, active_only=True) == jax_count_params(
        jax_arch_config(arch), active_only=True)


@pytest.mark.parametrize("arch", sorted(CUTS))
def test_zoo_cut_served_on_one_card_counts_as_jax(arch):
    """The depth cuts ``chip_smoke.py`` serves: every published width, 24
    of 48 layers."""
    cfg = dataclasses.replace(get_arch_config(arch), num_layers=24)
    jcfg = dataclasses.replace(jax_arch_config(arch), num_layers=24)
    assert count_params_analytic(cfg) == jax_count_params(jcfg) \
        == CUTS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_batch_spec_matches_jax(arch):
    """Tokens of the text length (a vlm's sequence less its patches), and
    the patches or frames."""
    jax_api = jax_build_model(jax_smoke_config(arch))
    api = build_model(get_smoke_config(arch))
    for shape in ("train_4k", "prefill_32k"):
        want = jax_api.batch_spec(JAX_SHAPES[shape], global_batch=8)
        got = api.batch_spec(INPUT_SHAPES[shape], global_batch=8)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} \
            == {k: (s, str(dtype).split(".")[1])
                for k, (s, dtype) in got.items()}



def test_zoo_bf16_planted_fault_exceeds_the_bar(zoo_bf16):
    """The bar can fail: the final norm's scale times ``FAULT_SCALE``
    moves the prefill logits past ``BF16_TOL`` from the JAX package's."""
    z = zoo_bf16
    params = dict(z["params"])
    params["final_norm"] = dict(params["final_norm"],
                                scale=params["final_norm"]["scale"]
                                * FAULT_SCALE)
    logits, _ = z["api"].prefill(params, _torch_batch(z["prompts"],
                                                      z["extras"]),
                                 cache_len=_offset(z["cfg"]) + S + GEN)
    gap = np.abs(_f32(logits) - _f32(z["jax_prefill"][0])).max()
    assert gap > BF16_TOL["atol"]


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_serve_cli_runs_every_family_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --smoke --device cpu`` draws a
    vlm's patches and an encdec model's frames as the JAX ``main()`` does;
    a vlm's ``--prompt-len`` counts its patches, and one that leaves no
    text is refused."""
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "20", "--gen", "3"])
    assert "generated (2, 3) tokens" in capsys.readouterr().out
    if get_smoke_config(arch).family == "vlm":
        with pytest.raises(SystemExit):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--prompt-len", "16"])
