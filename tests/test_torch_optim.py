"""``repro_torch.optim`` against ``repro.optim`` on the same numpy inputs:
three steps of each optimizer over a small nested tree, f32 and bf16, and
of the kernel's AdaGrad over the paper's FIG2 net."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
import repro_torch.optim as topt
from repro_torch.configs.paper_cnn import FIG2_CNN
from repro_torch.models import cnn
from repro_torch.tree import as_tensor, tree_leaves, tree_map


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=1e-4)


def _tree(rng, scale=1.0):
    mk = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)
    return {"w": mk(4, 3), "b": mk(3), "deep": [mk(2, 2, 2), mk(5)]}


def _run(opt, params, grads):
    state = opt.init(params)
    for g in grads:
        params, state = opt.update(g, state, params)
    return params, state


CASES = [
    ("adagrad", dict(adagrad_beta=1.5)),
    ("adagrad", dict(adagrad_beta=1.5, weight_decay=0.01)),
    ("adagrad", dict(adagrad_beta=1.5, use_kernel=True)),
    ("adagrad", dict(adagrad_beta=1.5, weight_decay=0.01, use_kernel=True)),
    ("adamw", dict()),
    ("adamw", dict(weight_decay=0.01)),
    ("sgd", dict()),
    ("sgd", dict(momentum=0.9)),
]


@pytest.mark.parametrize("name,kw", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_optimizer_matches_jax(name, kw, dtype):
    rng = np.random.default_rng(12)
    params = _tree(rng)
    grads = [_tree(rng, 0.5) for _ in range(3)]
    jdt = jnp.dtype(dtype)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    jg = [jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), g)
          for g in grads]
    # the identical rounded values on the port's side
    to_t = lambda t: tree_map(lambda a: as_tensor(np.asarray(a)),
                              jax.device_get(t))
    tp, tg = to_t(jp), [to_t(g) for g in jg]
    j_out = _run(jopt.get_optimizer(name, 0.05, **kw), jp, jg)
    t_out = _run(topt.get_optimizer(name, 0.05, **kw), tp, tg)
    j_leaves = jax.tree_util.tree_leaves(j_out)
    t_leaves = tree_leaves(t_out)
    assert len(j_leaves) == len(t_leaves)
    for a, b in zip(j_leaves, t_leaves):
        a = np.asarray(a)
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
        np.testing.assert_allclose(b.float().numpy(), a.astype(np.float32),
                                   **_tol(str(a.dtype)))


def test_updates_leave_their_inputs_alone():
    rng = np.random.default_rng(1)
    params = tree_map(as_tensor, _tree(rng))
    grads = tree_map(as_tensor, _tree(rng))
    before = [p.clone() for p in tree_leaves(params)]
    for opt in (topt.adagrad(0.1), topt.adagrad(0.1, use_kernel=True),
                topt.adamw(0.1), topt.sgd(0.1, momentum=0.5)):
        opt.update(grads, opt.init(params), params)
    assert all(np.array_equal(a.numpy(), b.numpy())
               for a, b in zip(before, tree_leaves(params)))


def test_unknown_optimizer_raises():
    with pytest.raises(KeyError):
        topt.get_optimizer("lamb", 0.1)


def test_adagrad_kernel_over_the_fig2_tree_matches_jax():
    """The quickstart's optimizer: every FIG2 leaf through one
    ``adagrad_update_leaves`` call a step (here its plain version) against
    the JAX package's kernel, launched once a leaf (interpret mode)."""
    params = cnn.params_to_numpy(cnn.init_cnn(torch.Generator().manual_seed(0),
                                              FIG2_CNN, "cpu"))
    rng = np.random.default_rng(13)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.5, params)
        for _ in range(3)]
    kw = dict(adagrad_beta=1.0, use_kernel=True)
    j_out = _run(jopt.get_optimizer("adagrad", 0.02, **kw),
                 jax.tree_util.tree_map(jnp.asarray, params),
                 [jax.tree_util.tree_map(jnp.asarray, g) for g in grads])
    t_out = _run(topt.get_optimizer("adagrad", 0.02, **kw),
                 tree_map(as_tensor, params),
                 [tree_map(as_tensor, g) for g in grads])
    j_leaves = jax.tree_util.tree_leaves(j_out)
    t_leaves = tree_leaves(t_out)
    assert len(j_leaves) == len(t_leaves) == 2 * 8
    for a, b in zip(j_leaves, t_leaves):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   **_tol("float32"))
