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
from repro_torch.kernels.adagrad.ops import adagrad_update
from repro_torch.kernels.server_step.ops import server_step_update
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
    FusedServerStep builds, so bf16 inputs go in widened to f32 (exact)."""
    rng = np.random.default_rng(7)
    p = rng.normal(size=shape)
    acc = np.abs(rng.normal(size=shape))
    g = rng.normal(size=(members,) + shape)
    coeffs = rng.uniform(0.1, 1.0, size=members).astype(np.float32)
    kw = dict(lr=0.05, beta=1.5, weight_decay=wd)
    p1, a1 = server_step_update(
        _torch(p, dtype).float(), _torch(g, dtype).float(),
        torch.from_numpy(acc.astype(np.float32)), torch.from_numpy(coeffs),
        **kw)
    assert p1.dtype == a1.dtype == torch.float32
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


def _k1_args(n=16, members=2):
    return (torch.zeros(n), torch.zeros(members, n), torch.zeros(n),
            torch.full((members,), 0.5))


@pytest.mark.parametrize("bad", ["dtype", "shape", "members", "contiguous",
                                 "coeffs"])
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
    """Neither the CPU fallback nor a silent no-op: a tensor that is on
    neither the CPU nor CUDA is refused."""
    meta = [t.to("meta") for t in _k1_args()]
    with pytest.raises(ValueError, match="no server-step kernel"):
        server_step_update(*meta, lr=0.1)
    with pytest.raises(ValueError, match="no adagrad kernel"):
        adagrad_update(*(torch.zeros(4, device="meta"),) * 3, lr=0.1)
