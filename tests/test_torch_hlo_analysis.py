"""The port's roofline terms and accounting mode
(``repro_torch.launch.hlo_analysis``) against the JAX package's
``repro.launch.hlo_analysis``, on the CPU.

``Roofline`` keeps the JAX arithmetic and changes only the peaks (the
H100's data-sheet figures), so it is held to the JAX class with that
module's constants set to the same figures for the test (its file is not
changed).  ``shape_bytes`` and ``parse_collectives`` read HLO text, which
an eager step has none of: their counterpart is the accounting mode,
tested here on plain ops and on kernels, and on meta DTensors in
``tests/test_torch_dryrun.py``.  ``model_flops_for`` is held to the JAX
dry-run's for every architecture and input shape.
"""
import os

import numpy as np
import pytest
import torch

import repro.launch.hlo_analysis as jax_hlo
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_arch_config as jax_arch_config
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_arch_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ops import work as k3_work
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                             Accounting, CollectiveStats,
                                             Roofline, roofline_from_counts)

# the JAX dry-run module sets XLA's device-count flag when it is imported
# (its first lines); keep it out of the environment of later subprocesses
_flags = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as jax_dryrun  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags


def test_h100_peaks_are_the_data_sheet_figures():
    assert PEAK_FLOPS == {"float32": 67e12, "tf32": 495e12,
                          "bfloat16": 989e12}
    assert HBM_BW == 3.35e12 and LINK_BW == 450e9


CASES = [(256 * 67e12, 256 * 3.35e12 * 2, 256 * 450e9 * 0.5, 256, 0.8,
          "float32"),
         (8 * 989e12 * 3, 8 * 3.35e12, 8 * 450e9 * 5, 8, 0.1, "bfloat16"),
         (5e15, 1e13, 0.0, 1, 2.0, "tf32"),
         (0.0, 1e9, 1e6, 4, 0.0, "float32")]


@pytest.mark.parametrize("flops,hbm,coll,chips,useful,dtype", CASES)
def test_roofline_matches_jax_at_the_h100_peaks(monkeypatch, flops, hbm, coll,
                                                chips, useful, dtype):
    monkeypatch.setattr(jax_hlo, "PEAK_FLOPS", PEAK_FLOPS[dtype])
    monkeypatch.setattr(jax_hlo, "HBM_BW", HBM_BW)
    monkeypatch.setattr(jax_hlo, "ICI_BW", LINK_BW)
    want = jax_hlo.Roofline(flops=flops, hbm_bytes=hbm,
                            collective_bytes=coll, chips=chips,
                            model_flops=flops * useful).as_dict()
    got = Roofline(flops=flops, hbm_bytes=hbm, collective_bytes=coll,
                   chips=chips, model_flops=flops * useful,
                   compute_dtype=dtype).as_dict()
    assert got == want


def test_roofline_terms_and_dominant():
    """``tests/test_hlo_analysis.py``'s case at the H100's f32 peaks."""
    r = Roofline(flops=256 * 67e12, hbm_bytes=256 * 3.35e12 * 2,
                 collective_bytes=256 * 450e9 * 0.5, chips=256,
                 model_flops=256 * 67e12 * 0.8)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(0.5)
    assert r.dominant == "memory"
    assert r.useful_flops_ratio == pytest.approx(0.8)
    assert r.as_dict()["dominant"] == "memory"
    bf16 = Roofline(flops=989e12, hbm_bytes=0.0, collective_bytes=0.0,
                    chips=1, compute_dtype="bfloat16")
    assert bf16.t_compute == pytest.approx(1.0)


def test_collective_stats_total():
    st = CollectiveStats({"all-gather": 10, "all-reduce": 6},
                         {"all-gather": 2, "all-reduce": 1})
    assert st.total_bytes == 16


def test_accounting_counts_products_bytes_and_no_views():
    a = torch.randn(8, 16)
    b = torch.randn(16, 4)
    with Accounting() as acct:
        y = a @ b                       # mm: 2 * 8 * 16 * 4
        z = y.t()                       # a view: no bytes
        w = (z * 2.0).sum()
    c = acct.counts()
    assert c["product_flops"] == 2 * 8 * 16 * 4
    assert c["flops_by_op"] == {"aten.mm": 2 * 8 * 16 * 4}
    mm = (8 * 16 + 16 * 4 + 8 * 4) * 4
    mul = (8 * 4 + 8 * 4) * 4
    sum_ = (8 * 4 + 1) * 4
    assert c["bytes"] == mm + mul + sum_
    assert set(c["bytes_by_op"]) == {"aten.mm", "aten.mul", "aten.sum"}
    assert c["collectives"] == {} and c["kernels"] == {}
    # y, z * 2 and the sum were live at once, at most
    assert c["temp_bytes"] == (8 * 4 + 4 * 8 + 1) * 4
    del y, z, w


def test_accounting_takes_a_kernel_as_one_opaque_call():
    """K3's plain version runs torch products on the CPU; the mode counts
    the kernel's work once, and none of the products inside it."""
    q = torch.randn(1, 16, 2, 32)
    with Accounting() as acct:
        out = flash_attention(q, q, q)
    c = acct.counts()
    flops, nbytes = k3_work(q, q, q)
    assert c["kernels"] == {"flash_attention": {"calls": 1, "flops": flops,
                                                "bytes": nbytes}}
    assert c["product_flops"] == 0 and c["bytes"] == nbytes
    assert c["flops"] == flops
    assert out.is_contiguous()          # as the kernel writes it


def test_roofline_from_counts_scales_one_rank_to_the_fleet():
    counts = {"flops": 10.0, "bytes": 20.0,
              "collectives": {"all-gather": 3, "all-reduce": 4}}
    r = roofline_from_counts(counts, 8, model_flops=5.0)
    assert (r.flops, r.hbm_bytes, r.collective_bytes, r.chips) == (
        80.0, 160.0, 56.0, 8)
    assert r.useful_flops_ratio == pytest.approx(5.0 / 80.0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_for_matches_jax(arch):
    for shape in INPUT_SHAPES:
        got = dryrun.model_flops_for(get_arch_config(arch),
                                     INPUT_SHAPES[shape])
        want = jax_dryrun.model_flops_for(jax_arch_config(arch),
                                          JAX_SHAPES[shape])
        assert got == want and np.isfinite(got), (arch, shape)
