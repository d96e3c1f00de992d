"""Checkpoints move between the packages bit-exactly: ``save_json_model``
trees and the ``sashimi-train-ckpt-v1`` round envelope, written by either
package and loaded by the other, bf16 and 0-d int32 leaves included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_json_model as jax_load_json
from repro.checkpoint import save_json_model as jax_save_json
from repro.core.split_parallel import TrainState as JaxTrainState
from repro.train_fabric import load_round_checkpoint as jax_load_round
from repro.train_fabric import save_round_checkpoint as jax_save_round
from repro_torch.checkpoint import (load_json_model, load_npz,
                                    save_json_model, save_npz)
from repro_torch.core.split_parallel import TrainState
from repro_torch.train_fabric import (load_round_checkpoint,
                                      save_round_checkpoint, state_to_tree)
from repro_torch.tree import as_tensor, to_numpy, tree_leaves


def _numpy_tree():
    """Every leaf kind a round checkpoint holds, as numpy (bf16 through
    ml_dtypes, which jax has registered with numpy here)."""
    rng = np.random.default_rng(2)
    return {"convs": [{"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                       "b": np.zeros(4, np.float32)}],
            "emb": np.asarray(jnp.asarray(rng.normal(size=(2, 5)),
                                          jnp.bfloat16)),
            "pair": (np.arange(3, dtype=np.int32),
                     np.float32(1.5) * np.ones(2, np.float32)),
            "step": np.asarray(7, np.int32)}


def _bits(x) -> tuple:
    a = to_numpy(x)
    return str(a.dtype), a.shape, a.tobytes()


def _assert_same_leaves(a_tree, b_tree):
    a_leaves, b_leaves = tree_leaves(a_tree), tree_leaves(b_tree)
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        assert _bits(a) == _bits(b)


def test_json_model_from_jax_loads_bit_exactly_in_the_port(tmp_path):
    tree = _numpy_tree()
    path = str(tmp_path / "m.json")
    jax_save_json(path, jax.tree_util.tree_map(jnp.asarray, tree))
    got = load_json_model(path)
    assert isinstance(got["emb"], torch.Tensor)
    assert got["emb"].dtype == torch.bfloat16
    assert got["step"].shape == () and got["step"].dtype == torch.int32
    assert isinstance(got["pair"], tuple)
    _assert_same_leaves(tree, got)


def test_json_model_from_the_port_loads_bit_exactly_in_jax(tmp_path):
    tree = jax.tree_util.tree_map(as_tensor, _numpy_tree())
    path = str(tmp_path / "m.json")
    save_json_model(path, tree)
    got = jax_load_json(path)
    assert got["emb"].dtype.name == "bfloat16" and got["step"].shape == ()
    _assert_same_leaves(tree, got)


def _state(make):
    tree = _numpy_tree()
    params = {"w": tree["convs"][0]["w"], "emb": tree["emb"]}
    return make(params=params, head={}, head_stale={},
                opt_state={"acc": {"w": np.abs(tree["convs"][0]["w"]),
                                   "emb": np.ones((2, 5), np.float32)}},
                head_opt_state={}, prev_features=(), prev_labels=(),
                prev_mask=(), step=tree["step"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_round_checkpoint_crosses_packages_bit_exactly(tmp_path, writer):
    path = str(tmp_path / "round_3.json")
    extra = {"losses": [2.5, 2.25], "policy": "reticket"}
    if writer == "jax":
        state = _state(JaxTrainState)
        jax_save_round(path, state, round_index=3, extra=extra)
        got, rnd, got_extra = load_round_checkpoint(path)
        assert isinstance(got, TrainState)
        assert got.step.dtype == torch.int32 and got.step.shape == ()
    else:
        state = _state(TrainState)
        state.params = jax.tree_util.tree_map(as_tensor, state.params)
        save_round_checkpoint(path, state, round_index=3, extra=extra)
        got, rnd, got_extra = jax_load_round(path)
        assert isinstance(got, JaxTrainState)
    assert rnd == 3 and got_extra == extra
    _assert_same_leaves(state_to_tree(state),
                        {k: getattr(got, k) for k in state_to_tree(state)})


def test_round_checkpoint_refuses_an_unknown_envelope(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"__dict__": {}}')
    with pytest.raises(ValueError):
        load_round_checkpoint(str(bad))


def test_npz_round_trip_keeps_structure_and_bits(tmp_path):
    tree = _numpy_tree()
    path = str(tmp_path / "m.npz")
    save_npz(path, jax.tree_util.tree_map(as_tensor, tree))
    got = load_npz(path)
    assert isinstance(got["pair"], tuple) and isinstance(got["convs"], list)
    _assert_same_leaves(tree, got)
