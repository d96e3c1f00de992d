"""The port's kernel wrappers against the JAX package's kernels, on the CPU.

Here a wrapper runs its plain PyTorch version (the CUDA kernels run only on
the card, where ``chip_smoke.py`` holds each one bitwise to the plain
version); the JAX side runs its Pallas kernels as its own tests do
(interpret mode, and the XLA oracle for the server step).  Same numpy
inputs on both sides; tolerances as ``tests/test_kernels.py::_tol``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.adagrad.ops import adagrad_update as jax_adagrad_update
from repro.kernels.server_step.ops import \
    server_step_update as jax_server_step_update
from repro_torch.kernels import build
from repro_torch.kernels.adagrad.ops import (adagrad_update,
                                             adagrad_update_leaves)
from repro_torch.kernels.server_step.ops import server_step_update
from repro_torch.train_fabric.server_step import row_pitch
from repro_torch.tree import as_tensor


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=1e-4)


def _jnp(a, dtype):
    return jnp.asarray(a, jnp.dtype(dtype))


def _torch(a, dtype):
    return as_tensor(np.asarray(_jnp(a, dtype)))


@pytest.mark.parametrize("shape", [(1,), (127,), (8192,), (33, 77)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("members,wd", [(1, 0.0), (3, 0.0), (1, 0.01),
                                        (3, 0.01)])
def test_server_step_matches_jax_interpret_and_xla(shape, dtype, members,
                                                   wd):
    """K1's plain version against the Pallas kernel (interpret) and the
    XLA oracle.  The port's kernel takes the flat f32 buffer
    FusedServerStep builds, so bf16 inputs go in widened to f32 (exact).
    The same gradients as a pitched stack (rows 32-element aligned, as
    FusedServerStep builds it) give the contiguous stack's result bit for
    bit, so they meet the same bar."""
    rng = np.random.default_rng(7)
    p = rng.normal(size=shape)
    acc = np.abs(rng.normal(size=shape))
    g = rng.normal(size=(members,) + shape)
    coeffs = rng.uniform(0.1, 1.0, size=members).astype(np.float32)
    kw = dict(lr=0.05, beta=1.5, weight_decay=wd)
    tp, tg = _torch(p, dtype).float(), _torch(g, dtype).float()
    tacc, tc = torch.from_numpy(acc.astype(np.float32)), \
        torch.from_numpy(coeffs)
    p1, a1 = server_step_update(tp, tg, tacc, tc, **kw)
    assert p1.dtype == a1.dtype == torch.float32
    pp, pa = server_step_update(tp, _pitched(tg, row_pitch(tp.numel())),
                                tacc, tc, **kw)
    assert torch.equal(pp, p1) and torch.equal(pa, a1)
    for mode in ("interpret", "xla"):
        p2, a2 = jax_server_step_update(
            _jnp(p, dtype), _jnp(g, dtype), _jnp(acc, "float32"),
            jnp.asarray(coeffs), mode=mode, **kw)
        np.testing.assert_allclose(p1.numpy(), np.asarray(p2, np.float32),
                                   **_tol(dtype))
        np.testing.assert_allclose(a1.numpy(), np.asarray(a2),
                                   **_tol("float32"))


@pytest.mark.parametrize("shape", [(127,), (8192,), (33, 77), (3, 5, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adagrad_matches_jax_kernel(shape, dtype, wd):
    rng = np.random.default_rng(3)
    p, g = rng.normal(size=shape), rng.normal(size=shape)
    acc = np.abs(rng.normal(size=shape)).astype(np.float32)
    kw = dict(lr=0.05, beta=1.5, weight_decay=wd)
    p1, a1 = adagrad_update(_torch(p, dtype), _torch(g, dtype),
                            torch.from_numpy(acc), **kw)
    p2, a2 = jax_adagrad_update(_jnp(p, dtype), _jnp(g, dtype),
                                jnp.asarray(acc), **kw)
    assert str(p1.dtype).endswith(dtype) and a1.dtype == torch.float32
    np.testing.assert_allclose(p1.float().numpy(),
                               np.asarray(p2, np.float32), **_tol(dtype))
    np.testing.assert_allclose(a1.numpy(), np.asarray(a2), atol=1e-4,
                               rtol=1e-4)


def test_adagrad_mixed_dtypes_match_the_plain_order():
    """bf16 params with an f32 gradient (TreeServerStep's mean is f32) are
    taken, and computed in f32 with p' rounded to bf16 last."""
    rng = np.random.default_rng(4)
    p = torch.from_numpy(rng.normal(size=50).astype(np.float32)) \
        .to(torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=50).astype(np.float32))
    acc = torch.zeros(50)
    p1, a1 = adagrad_update(p, g, acc, lr=0.1)
    a_want = acc + g * g
    p_want = (p.float() - 0.1 * g * torch.rsqrt(1.0 + a_want)) \
        .to(torch.bfloat16)
    assert torch.equal(a1, a_want) and torch.equal(p1, p_want)


def _pitched(g, ld):
    """``g`` (M, *shape) copied into the first columns of an (M, ld)
    buffer whose pad columns hold NaN: a view with rows ``ld`` apart."""
    m, n = g.shape[0], g[0].numel()
    buf = torch.full((m, ld), float("nan"))
    view = buf[:, :n].view(g.shape)
    view.copy_(g)
    return view


@pytest.mark.parametrize("n", [1, 3, 126, 127, 8192, 8195])
@pytest.mark.parametrize("members", [1, 2, 4, 9])
@pytest.mark.parametrize("pitch", ["aligned", "n_plus_3"])
def test_server_step_on_a_pitched_stack_equals_the_contiguous_call(
        n, members, pitch):
    """Rows ``ld`` elements apart (n rounded up to 32, or n + 3) give the
    contiguous stack's result bit for bit, never read the pad columns
    (NaN here), and on the CPU count no launch."""
    rng = np.random.default_rng(n + members)
    p, acc = (torch.from_numpy(rng.normal(size=n).astype(np.float32))
              for _ in range(2))
    acc = acc.abs()
    g = torch.from_numpy(rng.normal(size=(members, n)).astype(np.float32))
    c = torch.from_numpy(rng.uniform(0.1, 1, members).astype(np.float32))
    ld = row_pitch(n) if pitch == "aligned" else n + 3
    gp = _pitched(g, ld)
    assert gp.stride(1) == 1 and (members == 1 or gp.stride(0) == ld)
    kw = dict(lr=0.05, beta=1.5, weight_decay=0.01)
    before = server_step_update.launches
    got = server_step_update(p, gp, acc, c, **kw)
    want = server_step_update(p, g, acc, c, **kw)
    assert server_step_update.launches == before
    for x, y in zip(got, want):
        assert torch.equal(x, y) and not torch.isnan(x).any()


def _k1_args(n=16, members=2):
    return (torch.zeros(n), torch.zeros(members, n), torch.zeros(n),
            torch.full((members,), 0.5))


@pytest.mark.parametrize("bad", ["dtype", "shape", "members", "contiguous",
                                 "coeffs", "row_stride", "pitch_below_n"])
def test_server_step_wrapper_rejects_what_the_kernel_does_not_take(bad):
    p, g, acc, c = _k1_args()
    if bad == "dtype":
        p = p.double()
    elif bad == "shape":
        acc = torch.zeros(15)
    elif bad == "members":
        g = torch.zeros(0, 16)
        c = torch.zeros(0)
    elif bad == "contiguous":
        g = torch.zeros(16, 2).t()
    elif bad == "row_stride":           # the last dimension not unit-stride
        g = torch.zeros(2, 32)[:, ::2]
    elif bad == "pitch_below_n":        # rows 8 elements apart, 16 long
        g = torch.zeros(40).as_strided((2, 16), (8, 1))
    else:
        c = torch.full((3,), 0.5)
    with pytest.raises((TypeError, ValueError)):
        server_step_update(p, g, acc, c, lr=0.1)


@pytest.mark.parametrize("bad", ["dtype", "g_dtype", "acc_dtype", "shape",
                                 "contiguous"])
def test_adagrad_wrapper_rejects_what_the_kernel_does_not_take(bad):
    p, g, acc = torch.zeros(6, 4), torch.zeros(6, 4), torch.zeros(6, 4)
    if bad == "dtype":
        p = p.half()
    elif bad == "g_dtype":      # f32 params with a bf16 gradient: no caller
        g = g.to(torch.bfloat16)
    elif bad == "acc_dtype":
        acc = acc.to(torch.bfloat16)
    elif bad == "shape":
        g = torch.zeros(24)
    else:
        g = torch.zeros(4, 6).t()
    with pytest.raises((TypeError, ValueError)):
        adagrad_update(p, g, acc, lr=0.1)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    k1, k2 = server_step_update.launches, adagrad_update.launches
    server_step_update(*_k1_args(), lr=0.1)
    adagrad_update(torch.ones(8), torch.ones(8), torch.zeros(8), lr=0.1)
    assert (server_step_update.launches, adagrad_update.launches) == (k1, k2)


def test_a_device_without_a_kernel_raises():
    """Neither the CPU fallback nor a silent no-op: every wrapper
    dispatches through ``build.route``, which refuses a device other than
    the CPU, CUDA and meta.  Meta tensors take the dry-run's route: empty
    outputs, a meta launch counted, and no launch."""
    for kernel in ("server-step", "adagrad"):
        with pytest.raises(ValueError, match=f"no {kernel} kernel"):
            build.route(torch.device("xpu"), kernel)
    meta = [t.to("meta") for t in _k1_args()]
    before = (server_step_update.launches, server_step_update.meta_launches)
    p, acc = server_step_update(*meta, lr=0.1)
    assert p.is_meta and acc.is_meta and p.shape == meta[0].shape
    assert (server_step_update.launches,
            server_step_update.meta_launches) == (before[0], before[1] + 1)


def _leaves(kind, rng):
    """Lists of (p, g, acc) leaves: ragged sizes; 0-d and empty leaves; or
    all three (p, g) dtype pairs interleaved."""
    def leaf(shape, pt=torch.float32, gt=torch.float32):
        p, g, acc = (torch.from_numpy(np.asarray(rng.normal(size=shape),
                                                 np.float32))
                     for _ in range(3))
        acc = acc.abs()
        return p.to(pt), g.to(gt), acc
    if kind == "ragged":
        return [leaf((n,)) for n in (1, 3, 127, 1000, 4099)] + [leaf((5, 7))]
    if kind == "0d_and_empty":
        return [leaf(()), leaf((0,)), leaf((3, 0)), leaf((9,))]
    pairs = ((torch.float32, torch.float32),
             (torch.bfloat16, torch.bfloat16),
             (torch.bfloat16, torch.float32))
    return [leaf((n,), *pairs[i % 3]) for i, n in enumerate((1, 8, 33, 70,
                                                             257, 1031))]


@pytest.mark.parametrize("kind", ["ragged", "0d_and_empty", "mixed_dtypes"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adagrad_update_leaves_equals_one_leaf_calls(kind, wd):
    """On the CPU the list wrapper runs the plain version leaf by leaf: bit
    for bit what one ``adagrad_update`` a leaf gives, and no launch."""
    leaves = _leaves(kind, np.random.default_rng(8))
    kw = dict(lr=0.05, beta=1.5, weight_decay=wd)
    before = (adagrad_update.launches, adagrad_update_leaves.launches)
    ps, accs = adagrad_update_leaves(*zip(*leaves), **kw)
    assert (adagrad_update.launches,
            adagrad_update_leaves.launches) == before
    assert len(ps) == len(accs) == len(leaves)
    for leaf, p1, a1 in zip(leaves, ps, accs):
        p2, a2 = adagrad_update(*leaf, **kw)
        assert p1.dtype == p2.dtype and p1.shape == p2.shape
        assert torch.equal(p1, p2) and torch.equal(a1, a2)


def test_adagrad_update_leaves_of_no_leaf_is_empty():
    assert adagrad_update_leaves([], [], [], lr=0.1) == ([], [])


@pytest.mark.parametrize("bad", ["lengths", "shape", "devices", "dtype",
                                 "meta"])
def test_adagrad_update_leaves_refuses(bad):
    leaves = _leaves("ragged", np.random.default_rng(9))
    ps, gs, accs = (list(z) for z in zip(*leaves))
    if bad == "lengths":
        gs = gs[:-1]
    elif bad == "shape":
        accs[2] = torch.zeros(5)
    elif bad == "devices":
        ps[1], gs[1], accs[1] = (t.to("meta") for t in leaves[1])
    elif bad == "dtype":
        gs[0] = gs[0].to(torch.bfloat16)    # f32 p with a bf16 gradient
    else:                    # p on the meta device, g and acc on the CPU
        ps = [t.to("meta") for t in ps]
    with pytest.raises((TypeError, ValueError)):
        adagrad_update_leaves(ps, gs, accs, lr=0.1)
