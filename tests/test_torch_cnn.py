"""The port's paper CNN against ``repro.models.cnn`` on weights initialised
by JAX and carried across: logits, loss, gradients and error rate; and the
gradient shard's result crossing the port's binary wire codec."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_cnn as jcfgs
from repro.models import cnn as jcnn
from repro.sharding.spec import values_tree
from repro_torch.configs import paper_cnn as tcfgs
from repro_torch.core.wire import decode_binary, encode_binary
from repro_torch.models import cnn as tcnn
from repro_torch.tree import tree_leaves

F32 = dict(atol=3e-5, rtol=1e-4)

# the smoke net, the fabric net, and a deep-FC net (FIG4's classifier
# shape at toy width) so every layer kind of the paper's nets is covered
CONFIGS = {
    "smoke": lambda m: m.smoke_config(),
    "fabric": lambda m: m.FABRIC_CNN,
    "deep_fc": lambda m: m.CNNConfig(name="deep-fc", image_size=8,
                                     convs=(m.ConvSpec(4), m.ConvSpec(6)),
                                     fc_hidden=(16,)),
}


@functools.lru_cache(maxsize=None)
def _weights(name):
    """JAX-initialised weights as numpy; the deep-FC net's come from the
    port's ``init_cnn`` instead (carried the other way), which spares a
    JAX random-init compile for a third set of shapes."""
    if name == "deep_fc":
        return tcnn.params_to_numpy(tcnn.init_cnn(
            torch.Generator().manual_seed(0), CONFIGS[name](tcfgs), "cpu"))
    return jax.device_get(values_tree(jcnn.init_cnn(
        jax.random.PRNGKey(0), CONFIGS[name](jcfgs))))


def _pair(name, batch=5, seed=0):
    jc, tc = CONFIGS[name](jcfgs), CONFIGS[name](tcfgs)
    jp = _weights(name)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, jc.image_size, jc.image_size,
                         jc.in_channels)).astype(np.float32)
    y = rng.integers(0, jc.num_classes, size=batch).astype(np.int32)
    return jc, tc, jp, x, y


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_loss_and_grads_match_jax_on_carried_weights(name):
    jc, tc, jp, x, y = _pair(name)
    tp = tcnn.params_from_numpy(jp, "cpu")
    jl = jcnn.forward(jp, jc, jnp.asarray(x))
    tl = tcnn.forward(tp, tc, torch.from_numpy(x))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **F32)
    jloss, jg = jcnn.loss_and_grads(jc)(jp, jnp.asarray(x), jnp.asarray(y))
    tloss, tg = tcnn.loss_and_grads(tc)(tp, torch.from_numpy(x),
                                        torch.from_numpy(y))
    np.testing.assert_allclose(float(tloss), float(jloss), **F32)
    j_leaves = jax.tree_util.tree_leaves(jax.device_get(jg))
    t_leaves = tree_leaves(tg)
    assert [a.shape for a in j_leaves] == [tuple(b.shape) for b in t_leaves]
    for a, b in zip(j_leaves, t_leaves):
        assert b.is_contiguous()
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)
    np.testing.assert_allclose(
        float(tcnn.error_rate(tl, torch.from_numpy(y))),
        float(jcnn.error_rate(jl, jnp.asarray(y))), atol=0)


def test_conv_features_flatten_in_jax_order():
    """The FC rows are in (H, W, C) order: flattening NCHW instead would
    compute a different net with the same weights."""
    jc, tc, jp, x, _ = _pair("fabric", batch=2)
    tf = tcnn.conv_features(tcnn.params_from_numpy(jp, "cpu"), tc,
                            torch.from_numpy(x))
    jf = jcnn.conv_features(jp, jc, jnp.asarray(x))
    assert tf.shape == (2, tc.feature_dim)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **F32)


def test_init_cnn_shapes_match_jax_and_follow_the_seed():
    jc, tc, jp, _, _ = _pair("fabric")
    a = tcnn.init_cnn(torch.Generator().manual_seed(3), tc, "cpu")
    b = tcnn.init_cnn(torch.Generator().manual_seed(3), tc, "cpu")
    assert [x.shape for x in jax.tree_util.tree_leaves(jp)] == \
        [tuple(x.shape) for x in tree_leaves(a)]
    assert all(torch.equal(u, v) for u, v in zip(tree_leaves(a),
                                                 tree_leaves(b)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_cross_the_numpy_boundary_bit_exactly(dtype):
    jc, _, jp, _, _ = _pair("smoke")
    src = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.dtype(dtype))), jp)
    back = tcnn.params_to_numpy(tcnn.params_from_numpy(src, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(src),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_grad_shard_result_round_trips_the_wire_and_matches_jax():
    jc, tc, jp, _, _ = _pair("fabric")
    served = {"weights": {"round": 4, "params": jp}}
    out = tcnn.CnnGradShard(tc, n_rows=64, device="cpu")((8, 24), served)
    assert out["round"] == 4 and isinstance(out["loss"], float)
    assert all(isinstance(g, np.ndarray)
               for g in jax.tree_util.tree_leaves(out["grad"]))
    manifest, blob = encode_binary(out)
    back = decode_binary(manifest, blob)
    assert back["loss"] == out["loss"] and back["round"] == 4
    for a, b in zip(jax.tree_util.tree_leaves(out["grad"]),
                    jax.tree_util.tree_leaves(back["grad"])):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    ref = jcnn.CnnGradShard(jc, n_rows=64)((8, 24), served)
    np.testing.assert_allclose(out["loss"], ref["loss"], **F32)
    for a, b in zip(jax.tree_util.tree_leaves(ref["grad"]),
                    jax.tree_util.tree_leaves(out["grad"])):
        np.testing.assert_allclose(b, np.asarray(a), **F32)


def test_grad_shard_pickles_with_its_device():
    import pickle
    task = tcnn.CnnGradShard(tcfgs.FABRIC_CNN, n_rows=32, device="cpu")
    assert pickle.loads(pickle.dumps(task)) == task
