"""The port's Mamba scan (K4), Mamba block, MoE FFN and hybrid pieces
against the JAX package, on the CPU.

Here the scan's wrapper runs its plain PyTorch version (the CUDA kernel
runs only on the card, where ``chip_smoke.py`` holds it to that version).
It is held to the JAX ``mamba_scan_ref`` oracle, because the Pallas kernel
does not run on the installed jax (it calls ``pl.load``, ROADMAP.md Queue
3), with ``tests/test_kernels.py``'s bars: y within ``_tol`` (f32 atol
3e-5 / rtol 1e-4, bf16 2e-2), hT within 1e-3.  The layers are held to
their JAX twins on the same numpy inputs and weights in f32 within atol
2e-4 / rtol 1e-3, the bar of ``tests/test_torch_lm_models.py``, and the
Mamba block and MoE FFN also at bf16, at the bars stated beside those
tests.  The whole Jamba model (prefill, decode, forward, generate) is in
that file's ``served`` and ``served_bf16`` fixtures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.mamba.ref import mamba_scan_ref as jax_mamba_scan_ref
from repro.models import hybrid as JH
from repro.models import mamba as JM
from repro.models import moe as JMoE
from repro.sharding.spec import values_tree as jax_values_tree
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.mamba.ops import mamba_scan
from repro_torch.models import hybrid, mamba, moe
from repro_torch.tree import as_tensor, tree_as_tensors
from test_torch_lm_models import _recording_router, _routed_alike

ARCH = "jamba-1.5-large-398b"
TOL = dict(atol=2e-4, rtol=1e-3)


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=1e-4)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_f32(got), _f32(want), **(tol or TOL))


def _init(init_fn, seed=0):
    """The values tree of a JAX init, jitted, as numpy."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jax_values_tree(init_fn(k)))(jax.random.PRNGKey(seed)))


def _perturbed(tree, rng):
    """Every leaf moved off its init (D of 1, conv_b of 0 would hide a
    missing term)."""
    return jax.tree_util.tree_map(
        lambda x: (x + rng.normal(size=x.shape) * 0.05).astype(np.float32),
        tree)


# --- K4: the selective scan --------------------------------------------------


def _scan_inputs(rng, b, t, di, ds, dtype="float32", h0_scale=0.1):
    """test_mamba_scan_sweep's inputs, as (jax arrays, tensors)."""
    arrays = (rng.uniform(0.001, 0.1, size=(b, t, di)),
              rng.normal(size=(b, t, di)), rng.normal(size=(b, t, ds)),
              rng.normal(size=(b, t, ds)),
              -rng.uniform(0.5, 4.0, size=(di, ds)),
              rng.normal(size=(b, di, ds)) * h0_scale)
    dtypes = ("float32", dtype, dtype, dtype, "float32", "float32")
    jx = tuple(jnp.asarray(a, jnp.dtype(d)) for a, d in zip(arrays, dtypes))
    return jx, tuple(as_tensor(np.asarray(x)) for x in jx)


@pytest.mark.parametrize("b,t,di,ds", [(1, 64, 512, 16), (2, 96, 1024, 8),
                                       (1, 64, 512, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_matches_jax_ref(b, t, di, ds, dtype):
    rng = np.random.default_rng(t * 31 + ds)
    jx, tx = _scan_inputs(rng, b, t, di, ds, dtype)
    before = mamba_scan.launches
    y, hT = mamba_scan(*tx)
    want_y, want_h = jax_mamba_scan_ref(*jx)
    assert mamba_scan.launches == before        # the CPU runs no kernel
    assert y.dtype == hT.dtype == torch.float32
    assert y.shape == (b, t, di) and hT.shape == (b, di, ds)
    _close(y, want_y, **_tol(dtype))
    _close(hT, want_h, atol=1e-3, rtol=1e-3)


def test_mamba_scan_one_step_from_a_state_matches_jax_ref():
    """T = 1 with h0 != 0: a decode step."""
    rng = np.random.default_rng(5)
    jx, tx = _scan_inputs(rng, 3, 1, 256, 16, h0_scale=1.0)
    y, hT = mamba_scan(*tx)
    want_y, want_h = jax_mamba_scan_ref(*jx)
    _close(y, want_y, **_tol("float32"))
    _close(hT, want_h, **_tol("float32"))


def test_mamba_scan_two_calls_chain_to_one():
    """Two calls chained through hT give one call over the whole sequence,
    bit for bit (the same operations in the same order)."""
    rng = np.random.default_rng(6)
    _, (dt, x, b_t, c_t, a, h0) = _scan_inputs(rng, 2, 40, 128, 8)
    y_full, h_full = mamba_scan(dt, x, b_t, c_t, a, h0)
    cut = lambda z, sl: z[:, sl].contiguous()          # noqa: E731
    first, second = slice(0, 17), slice(17, None)
    y1, h1 = mamba_scan(*(cut(z, first) for z in (dt, x, b_t, c_t)), a, h0)
    y2, h2 = mamba_scan(*(cut(z, second) for z in (dt, x, b_t, c_t)), a, h1)
    assert torch.equal(torch.cat([y1, y2], 1), y_full)
    assert torch.equal(h2, h_full)


def _states_and_c(rng, b, t, di, ds):
    """Each step's state h_t (B, T, DI, ds) of the plain version, one call
    a step chained through hT (bit for bit one call over T, as the test
    above holds), its c_t (B, T, ds) and its y, as float32 numpy."""
    _, (dt, x, b_t, c_t, a, h0) = _scan_inputs(rng, b, t, di, ds)
    y, _ = mamba_scan(dt, x, b_t, c_t, a, h0)
    hs, h = [], h0
    for s in range(t):
        _, h = mamba_scan(*(z[:, s:s + 1].contiguous()
                            for z in (dt, x, b_t, c_t)), a, h)
        hs.append(h.numpy())
    return np.stack(hs, 1), c_t.numpy(), y.numpy()


def _lane_hand_off(h, c, per_lane):
    """K4's y as its lanes make it: G = ds / per_lane lanes a channel,
    skewed one step each (lane q takes step i - q at iteration i); lane q
    continues the partial sum lane q - 1 handed it the iteration before
    (lane 0 starts at 0), adds its own products in order and hands it on
    (a shuffle up by one lane); the last lane's sum is y."""
    b, t, di, ds = h.shape
    lanes = ds // per_lane
    y = np.empty((b, t, di), np.float32)
    carry = np.zeros((lanes, b, di), np.float32)
    for i in range(t + lanes - 1):
        part = np.zeros_like(carry)
        for q in range(lanes):
            if not 0 <= i - q < t:
                continue
            p = carry[q]
            for s in range(q * per_lane, (q + 1) * per_lane):
                p = p + h[:, i - q, :, s] * c[:, i - q, None, s]
            part[q] = p
        if i >= lanes - 1:
            y[:, i - lanes + 1] = part[-1]
        carry = np.concatenate([np.zeros_like(part[:1]), part[:-1]])
    return y


def _lane_sums(h, c, per_lane):
    """The order K4 must not take: each lane's products summed from 0, the
    lane sums then added up."""
    ds = h.shape[-1]
    sums = []
    for q in range(ds // per_lane):
        p = np.zeros(h.shape[:3], np.float32)
        for s in range(q * per_lane, (q + 1) * per_lane):
            p = p + h[..., s] * c[:, :, None, s]
        sums.append(p)
    y = sums[0]
    for p in sums[1:]:
        y = y + p
    return y


@pytest.mark.parametrize("ds,per_lane", [(16, 4), (16, 8), (32, 4),
                                         (32, 8)])
def test_lane_hand_off_is_bitwise_and_lane_sums_are_not(ds, per_lane):
    """A numpy emulation of K4's lane hand-off gives the plain version's y
    bit for bit (the kernel's order is the plain version's); summing each
    lane from 0 and then combining does not, on the same inputs."""
    h, c, y = _states_and_c(np.random.default_rng(ds + per_lane), 2, 9,
                            64, ds)
    assert np.array_equal(_lane_hand_off(h, c, per_lane), y)
    assert not np.array_equal(_lane_sums(h, c, per_lane), y)


@pytest.mark.parametrize("di", [100, 1000])
@pytest.mark.parametrize("t", [1, 2, 3])
@pytest.mark.parametrize("ds", [8, 16, 32])
def test_mamba_scan_at_ragged_di_and_short_t_matches_jax_ref(di, t, ds):
    """The widths K4's blocks of channels do not divide, and sequences
    that only fill and drain its lanes' skew, from a state."""
    rng = np.random.default_rng(di + 7 * t + ds)
    jx, tx = _scan_inputs(rng, 2, t, di, ds, h0_scale=1.0)
    y, hT = mamba_scan(*tx)
    want_y, want_h = jax_mamba_scan_ref(*jx)
    _close(y, want_y, **_tol("float32"))
    _close(hT, want_h, **_tol("float32"))


def _refusal(case):
    rng = np.random.default_rng(0)
    _, (dt, x, b_t, c_t, a, h0) = _scan_inputs(rng, 1, 4, 16, 8)
    if case == "grad":
        dt.requires_grad_(True)
    elif case == "dtype":
        x = x.double()
    elif case == "mixed":
        b_t = b_t.bfloat16()
    elif case == "shape":
        a = a[:, :4].contiguous()
    elif case == "d_state":
        b_t, c_t, a, h0 = b_t[..., :4], c_t[..., :4], a[:, :4], h0[..., :4]
        b_t, c_t, a, h0 = (z.contiguous() for z in (b_t, c_t, a, h0))
    elif case == "strided":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "device":       # dt on the meta device, the rest not
        dt = dt.to("meta")
    return dt, x, b_t, c_t, a, h0


@pytest.mark.parametrize("case,error", [
    ("grad", ValueError), ("dtype", TypeError), ("mixed", TypeError),
    ("shape", ValueError), ("d_state", ValueError), ("strided", ValueError),
    ("device", ValueError)])
def test_mamba_scan_refuses_what_the_kernel_does_not_take(case, error):
    with pytest.raises(error):
        mamba_scan(*_refusal(case))


# --- the Mamba block ---------------------------------------------------------


@pytest.fixture(scope="module")
def mamba_block():
    cfg = jax_smoke_config(ARCH)
    p = _perturbed(_init(lambda k: JM.init_mamba(k, cfg)),
                   np.random.default_rng(1))
    return cfg, p


def test_mamba_forward_matches_jax_chunked_scan(mamba_block):
    """S = 512: the JAX side scans two chunks of 256 (its remat path), the
    port one K4 call over the whole sequence; then one decode step from
    the state each side handed over."""
    cfg, p = mamba_block
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 512, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    fwd = jax.jit(lambda p, x, st: JM.mamba_forward(p, cfg, x, state=st))
    want, want_state = fwd(p, x, None)
    want1, want_state1 = fwd(p, x1, want_state)

    tp, tcfg = tree_as_tensors(p), get_smoke_config(ARCH)
    got, state = mamba.mamba_forward(tp, tcfg, torch.from_numpy(x))
    got1, state1 = mamba.mamba_decode_step(tp, tcfg, torch.from_numpy(x1),
                                           state)
    for g, w in ((got, want), (state[0], want_state[0]),
                 (state[1], want_state[1]), (got1, want1),
                 (state1[0], want_state1[0]), (state1[1], want_state1[1])):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


#: The Mamba block's bf16 bars, at most twice the gaps measured on this
#: fixture (S 64): y 0.094 at |y| <= 6.9 and 0.023 at |y| <= 3.2 a decode
#: step later; the f32 SSM state 0.016 at |h| <= 2.6; the bf16 conv tail
#: equal (one bf16 ulp in [4, 8) is 0.031).
MAMBA_BF16_TOL = {"y": dict(atol=0.18, rtol=0.0),
                  "ssm": dict(atol=0.03, rtol=0.0),
                  "conv": dict(atol=0.031, rtol=0.0)}


def test_bf16_mamba_forward_and_decode_step_match_jax(mamba_block):
    """The Mamba block at bf16 activations (its default dtype in the
    model), S = 64 and then one decode step from the state each side
    handed over: y in bf16, the SSM state in f32, the conv tail in bf16."""
    cfg, p = mamba_block
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    fwd = jax.jit(lambda p, x, st: JM.mamba_forward(p, cfg, x, state=st))
    want, want_state = fwd(p, jnp.asarray(x, jnp.bfloat16), None)
    want1, want_state1 = fwd(p, jnp.asarray(x1, jnp.bfloat16), want_state)

    tp, tcfg = tree_as_tensors(p), get_smoke_config(ARCH)
    got, state = mamba.mamba_forward(tp, tcfg,
                                     torch.from_numpy(x).bfloat16())
    got1, state1 = mamba.mamba_decode_step(
        tp, tcfg, torch.from_numpy(x1).bfloat16(), state)
    for g, w, bar in ((got, want, "y"), (got1, want1, "y"),
                      (state[0], want_state[0], "ssm"),
                      (state1[0], want_state1[0], "ssm"),
                      (state[1], want_state[1], "conv"),
                      (state1[1], want_state1[1], "conv")):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[1] == str(w.dtype)
        _close(g, np.asarray(jnp.asarray(w, jnp.float32)),
               **MAMBA_BF16_TOL[bar])


def test_mamba_init_matches_jax_tree(mamba_block):
    cfg, p = mamba_block
    got = mamba.init_mamba(torch.Generator().manual_seed(0),
                           get_smoke_config(ARCH))
    assert set(got) == set(p)
    for key, leaf in got.items():
        assert tuple(leaf.value.shape) == p[key].shape, key
    want = _init(lambda k: JM.init_mamba(k, cfg))
    for key in ("conv_b", "dt_b", "A_log", "D"):      # the non-random leaves
        _close(got[key].value, want[key], atol=0, rtol=0)


# --- the MoE FFN -------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_layer():
    cfg = jax_smoke_config(ARCH)
    p = _init(lambda k: JMoE.init_moe(k, cfg), seed=3)
    return cfg, p


#: (tokens (B, S), capacity factor): the default, one that drops
#: assignments, and a decode step's (B tokens at max(2.0, cf))
MOE_CASES = {"default": ((2, 24), None), "drops": ((2, 24), 0.5),
             "decode": ((4, 1), 2.0)}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe_matches_jax_local_dispatch(moe_layer, case):
    cfg, p = moe_layer
    (b, s), capf = MOE_CASES[case]
    x = np.random.default_rng(4).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)
    want_y, want_aux = jax.jit(lambda p, x: JMoE._apply_moe_local(
        p, cfg, x, capacity_factor=capf))(p, x)
    tcfg, tp = get_smoke_config(ARCH), tree_as_tensors(p)
    y, aux = moe.apply_moe(tp, tcfg, torch.from_numpy(x),
                           capacity_factor=capf)
    _close(y, want_y)
    _close(aux, want_aux)
    cap, loads, dropped = moe.dispatch_load(tp, tcfg, torch.from_numpy(x),
                                            capacity_factor=capf)
    assert int(loads.sum()) == b * s * cfg.moe.num_experts_per_tok
    assert bool(dropped.any()) == (int(loads.max()) > cap)
    assert bool(dropped.any()) == (case == "drops")


#: The MoE FFN's bf16 bar, twice the gap measured on this fixture: 0.0156
#: (one bf16 ulp at |y| in [1, 2)) at |y| <= 1.7.
MOE_BF16_TOL = dict(atol=0.031, rtol=0.0)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_bf16_apply_moe_matches_jax_where_routed_alike(moe_layer, case,
                                                       monkeypatch):
    """The MoE FFN at bf16 over the tokens that both packages routed
    alike (the same top-k experts, the same of them kept under capacity);
    a token bf16 rounding sent elsewhere is left out, at most 2 here."""
    cfg, p = moe_layer
    (b, s), capf = MOE_CASES[case]
    x = np.random.default_rng(4).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)
    jax_routes, port_routes = [], []
    monkeypatch.setattr(JMoE, "router_topk",
                        _recording_router(JMoE, jax_routes))
    want_y, want_aux = jax.block_until_ready(jax.jit(
        lambda p, x: JMoE._apply_moe_local(p, cfg, x, capacity_factor=capf))(
            p, jnp.asarray(x, jnp.bfloat16)))
    monkeypatch.setattr(moe, "router_topk",
                        _recording_router(moe, port_routes))
    tcfg = get_smoke_config(ARCH)
    y, aux = moe.apply_moe(tree_as_tensors(p), tcfg,
                           torch.from_numpy(x).bfloat16(),
                           capacity_factor=capf)
    (jax_idx,), (port_idx,) = jax_routes, port_routes
    alike = _routed_alike(tcfg, jax_idx, port_idx, capf).reshape(b, s)
    assert alike.sum() >= alike.size - 2
    assert y.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(want_y, jnp.float32))
    _close(y.float().numpy()[alike], want[alike], **MOE_BF16_TOL)
    _close(aux, want_aux, atol=1e-6, rtol=0.0)


def test_expert_capacity_is_the_jax_rule():
    m = get_smoke_config(ARCH).moe            # 4 experts, top-2, cf 1.25
    assert moe.expert_capacity(48, m) == 32   # ceil(30) -> 32
    assert moe.expert_capacity(48, m, 0.5) == 16
    assert moe.expert_capacity(4, m, 2.0) == 8    # at least 2k, then 8
    full = dataclasses.replace(m, num_experts=16)
    assert moe.expert_capacity(2048, full) == 320
    assert moe.expert_capacity(2112, full) == 336
    assert moe.expert_capacity(4, full, 2.0) == 8


def test_router_topk_and_positions_match_jax():
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(40, 8)).astype(np.float32)
    probs, w, idx = moe.router_topk(torch.from_numpy(logits), 3)
    want_probs, want_w, want_idx = JMoE.router_topk(jnp.asarray(logits), 3)
    _close(probs, want_probs)
    _close(w, want_w)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    e_flat = rng.integers(0, 6, 97)
    got = moe._positions_within_expert(torch.from_numpy(e_flat), 6)
    want = JMoE._positions_within_expert(jnp.asarray(e_flat, jnp.int32), 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the hybrid period ------------------------------------------------------


def test_period_layout_matches_jax():
    """The smoke layout (1 Mamba + 1 attention, MoE on the second) and the
    published one (7 Mamba + 1 attention at 4, MoE every other layer)."""
    from repro.configs import get_arch_config as jax_arch_config
    from repro_torch.configs import get_arch_config
    for port, ref in ((get_smoke_config, jax_smoke_config),
                      (get_arch_config, jax_arch_config)):
        assert hybrid._period_layout(port(ARCH)) \
            == JH._period_layout(ref(ARCH))
