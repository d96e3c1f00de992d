"""Helpers of the benchmark's CPU tests: cells cut to a size a test run
holds, with every width small."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.core import manifest  # noqa: E402

TINY_ARCH = {
    "rwkv6-1.6b": dict(num_layers=2, d_model=128, num_heads=2,
                       num_kv_heads=2, d_ff=256, vocab_size=512,
                       head_dim=64),
    "minitron-4b-d8": dict(num_layers=2, d_model=64, num_heads=4,
                           num_kv_heads=2, d_ff=128, vocab_size=512,
                           head_dim=32),
}
TINY_MIX = {"train": dict(batch=2, seq=64, pool=6),
            "serve": dict(batch=4, prompt=16, gen=8, pool=2,
                          sample_requests=4, ref_block=2)}


def tiny_cell(name: str, **mix) -> manifest.Cell:
    """Cell ``name`` of ``BENCHMARK.json`` with a tiny configuration of
    its family and a tiny traffic mix of its kind."""
    cell = manifest.load_cell(name, ROOT)
    cfg = dict(cell.config)
    cfg["arch"] = dict(cfg["arch"], **TINY_ARCH[cfg["name"]])
    cell.config = cfg
    cell.mix = dict(cell.mix, **dict(TINY_MIX[cell.mix["kind"]], **mix))
    return cell
