"""The port's attention (K3) and WKV (K5) wrappers against the JAX package,
on the CPU.

Here each wrapper runs its plain PyTorch version (the CUDA kernels run only
on the card, where ``chip_smoke.py`` holds K3 to its plain version within
the bars below and K5 bit for bit).  K3 is held to the JAX
``flash_attention`` in interpret mode; K5 to the JAX ``wkv_ref`` oracle,
because the Pallas WKV kernel does not run on the installed jax (it calls
``pl.load``, ROADMAP.md Queue 3).  Same numpy inputs on both sides;
tolerances as ``tests/test_kernels.py::_tol``: f32 atol 3e-5 / rtol 1e-4,
bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro.kernels.rwkv6.ref import wkv_ref as jax_wkv_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rwkv6.ops import wkv
from repro_torch.tree import as_tensor


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=1e-4)


def _both(a, dtype):
    """``a`` as a jax array of ``dtype`` and the same values as a tensor."""
    x = jnp.asarray(a, jnp.dtype(dtype))
    return x, as_tensor(np.asarray(x))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# --- K3: flash attention -----------------------------------------------------


@pytest.mark.parametrize("b,s,hq,hkv,hd,dtype,causal,window", [
    (1, 128, 4, 4, 64, "float32", True, 0),      # MHA
    (2, 256, 8, 2, 64, "float32", False, 0),     # GQA 4:1
    (2, 256, 8, 2, 64, "bfloat16", True, 64),
    (1, 512, 4, 1, 128, "float32", True, 64),    # MQA
    (1, 512, 4, 1, 128, "bfloat16", True, 0),
    (2, 192, 6, 2, 32, "float32", True, 64),     # padding path of the TPU
    (2, 100, 4, 2, 64, "float32", True, 0),      # ragged: no tile divides S
    (2, 100, 4, 2, 64, "bfloat16", False, 0),
    (1, 77, 8, 2, 32, "float32", True, 16),
])
def test_flash_attention_matches_jax_interpret(b, s, hq, hkv, hd, dtype,
                                               causal, window):
    rng = np.random.default_rng(s * 7 + hd)
    (q1, q2), (k1, k2), (v1, v2) = (
        _both(rng.normal(size=(b, s, h, hd)), dtype)
        for h in (hq, hkv, hkv))
    want = jax_flash_attention(q1, k1, v1, causal=causal, window=window)
    got = flash_attention(q2, k2, v2, causal=causal, window=window)
    assert got.dtype == q2.dtype and got.shape == q2.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_flash_attention_row_with_no_visible_key_is_zero():
    """With more queries than keys and a window, the last rows see no key:
    the port writes 0 there (the Pallas kernel's value for such a row
    depends on its block size).  The other rows are plain softmax
    attention."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 12, 4, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, 6, 2, 32)).astype(
        np.float32)) for _ in range(2))
    out = flash_attention(q, k, v, causal=False, window=3)
    # query row i sees keys i-2 .. 5: rows 8.. see none
    assert torch.equal(out[:, 8:], torch.zeros_like(out[:, 8:]))
    kr, vr = k.repeat_interleave(2, dim=2), v.repeat_interleave(2, dim=2)
    for i in range(8):
        keys = slice(max(0, i - 2), 6)
        w = torch.softmax(torch.einsum("bhe,bshe->bhs", q[:, i],
                                       kr[:, keys]) / 32 ** 0.5, dim=-1)
        np.testing.assert_allclose(
            out[:, i].numpy(),
            torch.einsum("bhs,bshe->bhe", w, vr[:, keys]).numpy(),
            atol=1e-6, rtol=1e-5)


def test_flash_attention_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 4, 64)
    kv = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="no backward"):
        flash_attention(q.clone().requires_grad_(), kv, kv)
    with pytest.raises(ValueError, match="hd in"):
        flash_attention(torch.zeros(1, 8, 4, 48), torch.zeros(1, 8, 2, 48),
                        torch.zeros(1, 8, 2, 48))
    with pytest.raises(ValueError, match="shapes disagree"):
        flash_attention(q, torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), kv, kv)
    with pytest.raises(TypeError):
        flash_attention(q.half(), kv.half(), kv.half())


def test_attention_ref_matches_the_wrapper_layout():
    """``attention_ref`` takes (B, H, S, hd), the wrapper (B, S, H, hd)."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 40, h, 32)).astype(
        np.float32)) for h in (4, 2, 2))
    got = flash_attention(q, k, v, causal=True, window=8)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=True,
                         window=8).transpose(1, 2)
    assert torch.equal(got, want)


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the nearest
    value with 10 mantissa bits, ties away from zero (add half of the
    dropped 13 bits to the magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a, b, passes):
    """a @ b as K3's tensor cores compute it: each operand split as
    hi = tf32(x), lo = tf32(x - hi), and (lo.hi + hi.lo) + hi.hi summed in
    f32 (a product of two TF32 values is exact in f32); one pass is
    hi.hi alone."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _tf32_attention(q, k, v, passes):
    """Causal GQA attention, (B, H, S, hd) layout, with both products
    through ``_tf32_matmul`` and the softmax in f32, normalised at the end
    as the kernel does."""
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    s = _tf32_matmul(q, k.transpose(-1, -2), passes) / q.shape[-1] ** 0.5
    n = q.shape[2]
    mask = torch.ones(n, n, dtype=torch.bool).tril()
    s = torch.where(mask, s, -1e30)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    return _tf32_matmul(p, v, passes) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("s,hd", [(256, 64), (128, 128)])
def test_flash_attention_needs_three_tf32_passes(s, hd):
    """Why K3 runs three TF32 passes on the tensor cores: on causal 4:1 GQA
    inputs the hi/lo split (lo.hi + hi.lo + hi.hi) stays within the f32 bar
    of the plain version, and a single TF32 pass does not."""
    rng = np.random.default_rng(s + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, h, s, hd)).astype(
        np.float32)) for h in (8, 2, 2))
    want = attention_ref(q, k, v, causal=True).numpy()
    np.testing.assert_allclose(_tf32_attention(q, k, v, 3).numpy(), want,
                               **_tol("float32"))
    assert not np.allclose(_tf32_attention(q, k, v, 1).numpy(), want,
                           **_tol("float32"))


# --- K5: the WKV recurrence --------------------------------------------------


def _wkv_inputs(rng, b, t, h, hd, dtype, s0_scale=0.1):
    r, k, v = (_both(rng.normal(size=(b, t, h, hd)) * 0.5, dtype)
               for _ in range(3))
    w = _both(rng.uniform(0.7, 0.999, size=(b, t, h, hd)), "float32")
    u = _both(rng.normal(size=(h, hd)) * 0.1, "float32")
    s0 = _both(rng.normal(size=(b, h, hd, hd)) * s0_scale, "float32")
    return r, k, v, w, u, s0


@pytest.mark.parametrize("b,t,h,hd", [(1, 64, 2, 64), (2, 200, 4, 64),
                                      (1, 128, 8, 32), (2, 1, 4, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_matches_jax_ref(b, t, h, hd, dtype):
    """T 200 is ragged against the TPU kernel's 128-step blocks; T 1 with
    a non-zero s0 is one decode step."""
    rng = np.random.default_rng(t * 3 + hd)
    ins = _wkv_inputs(rng, b, t, h, hd, dtype)
    y1, s1 = jax_wkv_ref(*(x for x, _ in ins))
    y2, s2 = wkv(*(x for _, x in ins))
    assert y2.dtype == ins[0][1].dtype and s2.dtype == torch.float32
    np.testing.assert_allclose(_f32(y2), _f32(y1), **_tol(dtype))
    np.testing.assert_allclose(s2.numpy(), np.asarray(s1), atol=1e-3,
                               rtol=1e-3)


def test_wkv_two_chunks_chain_to_one_shot():
    """The state handed from one call to the next reproduces one call over
    the whole sequence (the prefill -> decode handoff)."""
    rng = np.random.default_rng(5)
    (_, r), (_, k), (_, v), (_, w), (_, u), (_, s0) = _wkv_inputs(
        rng, 1, 64, 2, 64, "float32", s0_scale=0.0)
    y_full, s_full = wkv(r, k, v, w, u, s0)
    y1, s1 = wkv(r[:, :40], k[:, :40], v[:, :40], w[:, :40], u, s0)
    y2, s2 = wkv(*(z[:, 40:].contiguous() for z in (r, k, v, w)), u, s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=1e-4)


def test_wkv_refuses_what_the_kernel_does_not_take():
    r = torch.zeros(1, 4, 2, 64)
    w, u, s0 = torch.ones(1, 4, 2, 64), torch.zeros(2, 64), \
        torch.zeros(1, 2, 64, 64)
    with pytest.raises(ValueError, match="no backward"):
        wkv(r.clone().requires_grad_(), r, r, w, u, s0)
    with pytest.raises(TypeError, match="w must be float32"):
        wkv(r.bfloat16(), r.bfloat16(), r.bfloat16(), w.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="shapes disagree"):
        wkv(r, r, r, w, u, torch.zeros(1, 2, 32, 32))
    with pytest.raises(ValueError, match="hd in"):
        z = torch.zeros(1, 4, 1, 128)
        wkv(z, z, z, z, torch.zeros(1, 128), torch.zeros(1, 1, 128, 128))
