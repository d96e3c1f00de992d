"""The compiled half of the port's serving, on the CPU: the decode step
takes its index as a 0-d int32 tensor, as the JAX package's step takes a
traced ``jnp.int32`` under ``jax.jit``, and ``launch.serve.DecodeGraph``
runs each step on static buffers (a CUDA graph's replay on the card, the
same step run eagerly here).

What is held, on the ten smoke configs at f32 with weights from a seed:

* ``decode_step`` with a tensor index equals the one with an int index,
  bit for bit, in its logits and every cache leaf: at a slot in the middle
  of the cache, at its last slot, past it (the slot clamps), and at a ring
  wrap under an explicit ``window``;
* one decode step traced once at one index (``make_fx``, which records
  the ops eager runs, as a CUDA graph records the kernels of one run),
  replayed at two later indices with other tokens, equals the eager step
  there bit for bit: no index value is baked in; a step that reads
  ``int(index)`` fails that check;
* ``DecodeGraph`` on the CPU equals a plain loop of ``decode_step`` in
  tokens, logits and the final cache (RWKV's and Mamba's new states
  copied back), and a runner that never updates its index buffer departs
  from it.

``generate`` against the JAX package's (``test_torch_lm_models.py``,
``test_torch_zoo.py``) runs through the runner's CPU route.
"""
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.sharding.spec import values_tree

#: batch, prompt and new tokens: the cache covers 2S positions past any
#: prefix, as a ``generate`` of GEN = S tokens sizes it
B, S, GEN = 2, 8, 8
#: the explicit sliding window of the ring-wrap case (smaller than S)
WINDOW = 5
#: one smoke config a family: dense, MoE, vlm, encdec, ssm, hybrid
FAMILIES = ("qwen3-4b", "qwen3-moe-30b-a3b", "internvl2-26b",
            "whisper-small", "rwkv6-1.6b", "jamba-1.5-large-398b")


def _offset(cfg):
    return cfg.num_patches if cfg.family == "vlm" else 0


@pytest.fixture(scope="module", params=ARCH_IDS)
def model(request):
    cfg = get_smoke_config(request.param)
    api = build_model(cfg, compute_dtype=torch.float32)
    params = values_tree(api.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).to(torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    off = _offset(cfg)
    logits, cache = api.prefill(params, batch, cache_len=off + 2 * S)
    _, ring = api.prefill(params, batch, cache_len=off + 2 * S,
                          window=WINDOW)
    return dict(arch=request.param, cfg=cfg, api=api, params=params,
                batch=batch, rng=rng, off=off, logits=logits, cache=cache,
                ring=ring)


def _tokens(m):
    return torch.from_numpy(m["rng"].integers(
        0, m["cfg"].vocab_size, (B, 1))).to(torch.int32)


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _index(i):
    return torch.tensor(i, dtype=torch.int32)


def _assert_same(got, want, what):
    """Logits and every cache leaf (the returned dict, and the dict the
    step was given, which it writes in place), bit for bit."""
    (g_logits, g_cache, g_given), (w_logits, w_cache, w_given) = got, want
    assert torch.equal(g_logits, w_logits), f"{what}: logits"
    for name, g, w in (("returned", g_cache, w_cache),
                       ("given", g_given, w_given)):
        assert set(g) == set(w), (what, name)
        for key in w:
            assert g[key].dtype == w[key].dtype, (what, name, key)
            assert torch.equal(g[key], w[key]), f"{what}: {name} {key}"


def _step(step, params, cache, token, index):
    given = _clone(cache)
    logits, out = step(params, given, token, index)
    return logits, out, given


@pytest.mark.parametrize("where", ["mid", "last", "past", "ring"])
def test_tensor_index_equals_int_index(model, where):
    """``index`` as an int and as a 0-d int32 tensor: the same logits and
    cache, bit for bit.  The cache covers 2S positions past any prefix;
    ``ring`` has WINDOW slots and decodes where the ring has wrapped."""
    api, params, off = model["api"], model["params"], model["off"]
    window = WINDOW if where == "ring" else None
    cache = model["ring" if window else "cache"]
    index = {"mid": off + S, "last": off + 2 * S - 1,
             "past": off + 2 * S + 3, "ring": off + S + 2}[where]
    token = _tokens(model)

    def step(p, c, t, i):
        return api.decode_step(p, c, t, i, window=window)

    _assert_same(_step(step, params, cache, token, _index(index)),
                 _step(step, params, cache, token, index),
                 f"{model['arch']} at {index} ({where})")


def _replays_like_eager(api, params, cache, off, rng, step=None):
    """Trace ``step`` (default: ``api.decode_step``) once at index off + S
    with one token, then replay the trace at off + S + 1 and off + 2S - 1
    with other tokens: each replay must equal the eager step there, bit
    for bit (a trace records the ops eager runs, and any value it read to
    the host stays what it was at the trace)."""
    step = step or api.decode_step
    vocab = api.cfg.vocab_size

    def tok():
        return torch.from_numpy(rng.integers(0, vocab, (B, 1))).to(
            torch.int32)

    traced = make_fx(lambda p, c, t, i: step(p, c, t, i))(
        params, _clone(cache), tok(), _index(off + S))
    for index in (off + S + 1, off + 2 * S - 1):
        token = tok()
        _assert_same(_step(traced, params, cache, token, _index(index)),
                     _step(api.decode_step, params, cache, token,
                           _index(index)),
                     f"{api.cfg.name}: the trace replayed at {index}")


@pytest.mark.parametrize("model", FAMILIES, indirect=True)
def test_traced_step_replays_at_other_indices(model):
    _replays_like_eager(model["api"], model["params"], model["cache"],
                        model["off"], model["rng"])


@pytest.mark.parametrize("model", ["qwen3-4b"], indirect=True)
def test_a_step_that_reads_its_index_fails_the_replay_check(model):
    """A planted fault: the step reads ``int(index)`` to the host (as a
    step that takes a host int would), which a trace, like a CUDA graph,
    cannot carry to another index."""
    api = model["api"]

    def host_index(p, c, t, i):
        return api.decode_step(p, c, t, int(i))

    with pytest.raises(RuntimeError, match="value out of a tracing tensor"):
        _replays_like_eager(api, model["params"], model["cache"],
                            model["off"], model["rng"], step=host_index)


class _StaleIndex(serve.DecodeGraph):
    """A planted fault: the runner never updates its index buffer."""

    def _load(self, token, index):
        self.token.copy_(token)


def _greedy(m, graph):
    """``generate``'s loop from the fixture's prefill, through ``graph`` (a
    ``DecodeGraph`` class) or, for ``None``, a plain loop of
    ``api.decode_step``: (tokens, the steps' logits, the final cache)."""
    api, params, s = m["api"], m["params"], m["off"] + S
    logits, cache = m["logits"], _clone(m["cache"])
    run = graph(api, params, cache, B) if graph else None
    toks, steps = [], []
    tok = logits[:, :, :api.cfg.vocab_size].argmax(-1).to(torch.int32)
    for i in range(GEN):
        toks.append(tok)
        if run is None:
            logits, cache = api.decode_step(params, cache, tok, s + i)
        else:
            logits = run.step(tok, s + i)
        steps.append(logits.clone())
        tok = logits[:, :, :api.cfg.vocab_size].argmax(-1).to(torch.int32)
    if run is not None:
        cache = dict(run.cache, **run.fresh)
    return torch.cat(toks, 1), torch.cat(steps, 1), cache


def test_decode_graph_on_the_cpu_equals_a_plain_loop(model):
    api, params, batch = model["api"], model["params"], model["batch"]
    with torch.inference_mode():
        want = _greedy(model, None)
        got = _greedy(model, serve.DecodeGraph)
        served = serve.generate(api, params, batch["tokens"], gen=GEN,
                                extra_inputs={k: v for k, v in batch.items()
                                              if k != "tokens"})
    assert torch.equal(got[0], want[0]) and torch.equal(served, want[0])
    assert torch.equal(got[1], want[1])
    assert set(got[2]) == set(want[2])
    for key in want[2]:
        assert torch.equal(got[2][key], want[2][key]), key


@pytest.mark.parametrize("model", ["qwen3-4b", "internvl2-26b",
                                   "whisper-small", "jamba-1.5-large-398b"],
                         indirect=True)
def test_a_runner_that_never_updates_its_index_departs(model):
    """The stale-index fault of ``chip_smoke.py``'s serve phases, on the
    CPU: every step decodes at index 0, so the logits depart from the
    plain loop's (the families whose step reads its index)."""
    with torch.inference_mode():
        want = _greedy(model, None)
        bad = _greedy(model, _StaleIndex)
    assert not torch.equal(bad[1], want[1])
    assert (bad[1] - want[1]).abs().max() > 1e-2
