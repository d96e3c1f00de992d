"""The benchmark's work counts against hand counts at small shapes, and
the window's rate arithmetic."""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench.tests.common import ROOT
from bench.core import harness, manifest
from bench.reference import dense
from bench.work import counts

DENSE = dict(family="dense", num_layers=1, d_model=4, num_heads=2,
             num_kv_heads=1, head_dim=2, d_ff=8, vocab_size=10,
             rope_theta=10000.0)
RWKV = dict(family="ssm", num_layers=1, d_model=4, d_ff=8, vocab_size=10,
            rwkv={"head_size": 2}, decay_lora_dim=3)


def test_dense_counts_by_hand():
    # a token: q 4x4, k and v 4x2 each, o 4x4, up and down 4x8 each
    per_token = 2 * (16 + 8 + 8 + 16 + 32 + 32)
    pair = 4 * 2 * 2                       # q.k and p.v, 2 heads of 2
    assert counts.forward_flops(DENSE, 1, 3) == 3 * per_token + 6 * pair
    head = 2 * 4 * 10
    assert counts.head_flops(DENSE, 5) == 5 * head
    assert counts.train_step_flops(DENSE, 1, 3) == (
        3 * (3 * per_token + 6 * pair) + 4 * 3 * head)
    # prefill over 3, then 2 decode steps at positions 3 and 4
    assert counts.serve_call_flops(DENSE, 1, 3, 2) == (
        3 * per_token + 6 * pair + 2 * per_token + (4 + 5) * pair
        + 3 * head)


def test_rwkv_counts_by_hand():
    # r k v g o 4x4 each, the decay LoRA 4x3 and 3x4, channel mix
    # 4x8, 8x4, 4x4; two heads of a 2x2 state, readout and update
    per_token = 2 * (5 * 16 + 2 * 12 + 2 * 32 + 16) + 4 * 2 * 4
    assert counts.forward_flops(RWKV, 2, 3) == 6 * per_token


def test_dense_count_matches_flop_counter():
    """At one token the reference's products are every product the count
    counts (the causal pairs are the whole square)."""
    cfg = dict(DENSE, num_layers=2, d_model=16, num_heads=4,
               num_kv_heads=2, head_dim=8, d_ff=32, vocab_size=64)
    params = {p: torch.randn(s) for p, s, _ in dense.layout(cfg)}
    from bench.reference.common import unflat
    params = unflat(params.items())
    tokens = torch.zeros(3, 1, dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        dense.Model(cfg).features(params, tokens)
    assert fc.get_total_flops() == counts.forward_flops(cfg, 3, 1)


def test_kernel_work_by_hand():
    flops, nbytes = counts.attention_work(1, 2, 2, 2, 1, 4, True)
    assert flops == 4 * 2 * 4 * 3 and nbytes == 4 * 2 * 4 * (2 * 2 + 2)
    flops, _ = counts.attention_work(1, 2, 3, 2, 1, 4, False)
    assert flops == 4 * 2 * 4 * 6
    assert counts.wkv_bytes(1, 2, 1, 2) == 4 * (5 * 4 + 2 + 2 * 4)
    assert counts.adagrad_bytes(10) == 200
    assert counts.bound_s(counts.PEAK_TF32, 0) == 1.0
    assert counts.bound_s(0, counts.HBM_BYTES_PER_S) == 1.0
    assert counts.n_params([(("a",), (2, 3), None),
                            (("b",), (4,), None)]) == 10


class _Steady:
    """A loop whose every step takes ``dt`` seconds of a fake clock and
    does 10 tokens of work."""

    dt = 0.03
    now = 0.0

    def __init__(self, cell, seed, device, faults=()):
        self.dims, self.layout = {}, []

    def setup(self):
        _Steady.now += 2.0

    def step(self):
        _Steady.now += self.dt

    def work(self, done):
        return {"tokens": 10 * done, "attempted": done, "failed": 0}

    def release(self):
        pass

    def numbers(self):
        return {"gap": 0.5}


@pytest.mark.parametrize("seconds", [0.05, 0.1])
def test_rate_is_whole_steps_over_their_time(monkeypatch, seconds):
    monkeypatch.setitem(harness.LOOPS, "fake", _Steady)
    monkeypatch.setattr(harness, "clock", lambda: _Steady.now)
    man = manifest.manifest(ROOT)
    cell = manifest.Cell("fake", 1, {}, {"kind": "fake"}, {"gap": 1.0},
                         [m for m in man["end_to_end"]
                          if m["name"] in ("setup_s", "train_tokens_per_s")],
                         [])
    out = harness.run(cell, 1, seconds, False, device="cpu")
    # whole steps until the window's seconds have passed, the last one
    # counted whole: the rate is the steps' work over their own time
    done = out["attempted"]
    assert done == math.ceil(seconds / _Steady.dt)
    rate = out["metrics"]["train_tokens_per_s"]["value"]
    assert rate == pytest.approx(10 / _Steady.dt)
    assert out["metrics"]["setup_s"]["value"] == pytest.approx(2.0)
    assert out["correct"] is True
    assert list(out)[-1] == "checks"
    assert out["checks"] == {"gap": {"value": 0.5, "limit": 1.0}}
