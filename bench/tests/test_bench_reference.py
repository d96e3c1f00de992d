"""The plain references held to the program at a small size, and the
control (the reference with its products in TF32) coming out as not
correct against the cells' limits."""
import pytest
import torch

from bench.tests.common import tiny_cell
from bench.core import traffic, weights
from bench.core.serve import logit_gap, reference_logits
from bench.core.train import (arch_config, gaps, model_dims,
                              reference_steps)
from bench.reference import common

SEED = 2**31 + 77


@pytest.mark.parametrize("cell_name", ["rwkv6-train", "minitron-d8-train"])
def test_reference_forward_is_the_programs(cell_name):
    from repro_torch.models.model import build_model

    cell = tiny_cell(cell_name)
    dims = model_dims(cell.config)
    params = weights.make(cell.reference.layout(dims), SEED, "cpu")
    api = build_model(arch_config(cell.config), compute_dtype=torch.float32)
    tokens = torch.randint(0, dims["vocab_size"], (2, 64),
                           generator=torch.Generator().manual_seed(1))
    logits, _, feats = api.forward_features(params, {"tokens": tokens},
                                            differentiable=True)
    model = cell.reference.Model(dims)
    with torch.no_grad():
        mine = model.features(params, tokens)
        mine_logits = model.logits(params["head"], mine)
    assert torch.allclose(mine, feats, atol=1e-4, rtol=1e-4)
    assert torch.allclose(mine_logits, logits, atol=1e-4, rtol=1e-4)


def _train_numbers(cell, prec, **kw):
    dims = model_dims(cell.config)
    layout = cell.reference.layout(dims)
    batches = traffic.train_batches(
        dict(cell.mix, pool=cell.mix["compare_steps"]), dims["vocab_size"],
        SEED, "cpu")
    ref = reference_steps(cell, dims, layout, SEED, batches, "cpu", "f32")
    got = reference_steps(cell, dims, layout, SEED, batches, "cpu", prec,
                          **kw)
    return gaps(got, ref)


@pytest.mark.parametrize("cell_name", ["rwkv6-train", "minitron-d8-train"])
def test_training_control_is_not_correct(cell_name):
    cell = tiny_cell(cell_name)
    same = _train_numbers(cell, "f32")
    assert all(v == 0 for v in same.values())
    control = _train_numbers(cell, "tf32")
    assert any(control[k] > v for k, v in cell.limits.items()), control


@pytest.mark.parametrize("cell_name", ["rwkv6-serve",
                                       "minitron-d8-prefill"])
def test_serving_control_is_not_correct(cell_name):
    """The tokens the TF32 reference puts first, read against the f32
    reference, at every served position of a batch of long sequences."""
    cell = tiny_cell(cell_name, batch=32, prompt=8, gen=120,
                     sample_requests=32, ref_block=32)
    cell.config = dict(cell.config, arch=dict(cell.config["arch"],
                                              vocab_size=4096))
    dims = model_dims(cell.config)
    layout = cell.reference.layout(dims)
    seqs = torch.randint(0, 4096, (32, 128),
                         generator=torch.Generator().manual_seed(3))
    args = (cell, dims, layout, SEED, seqs, cell.mix, "cpu")
    f32 = reference_logits(*args, "f32")
    assert logit_gap(f32, f32.argmax(-1)) == 0
    tf32 = reference_logits(*args, "tf32")
    assert logit_gap(f32, tf32.argmax(-1)) > cell.limits["served_logit_gap"]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10])
    assert common.tf32_round(x).tolist() == [1.0, 1.0, 1.0 + 2**-9,
                                             1.0 + 2**-10]
