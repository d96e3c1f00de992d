"""Whole runs of the harness on the CPU at a tiny size: the look for a
chip skipped, the rest of a run driven, once sound and once with each
fault a cell can have planted in its timed path, which must make
``correct`` false.  And the guard that nothing the benchmark loads is
JAX or the JAX package."""
import json
import subprocess
import sys

import pytest

from bench.tests.common import ROOT, tiny_cell
from bench.core import harness

SEED = 2**31 + 4242

CASES = [("rwkv6-train", ()), ("rwkv6-train", ("state_unchanged",)),
         ("rwkv6-train", ("half_batch",)), ("rwkv6-train", ("frozen_refresh",)),
         ("minitron-d8-train", ()), ("minitron-d8-train", ("half_batch",)),
         ("minitron-d8-train", ("state_unchanged",)),
         ("minitron-d8-train", ("frozen_refresh",)),
         ("rwkv6-serve", ()), ("rwkv6-serve", ("token_altered",)),
         ("minitron-d8-prefill", ()),
         ("minitron-d8-prefill", ("token_altered",))]


@pytest.mark.parametrize("cell_name,faults", CASES,
                         ids=[f"{c}-{'+'.join(f) or 'sound'}"
                              for c, f in CASES])
def test_a_fault_in_the_timed_path_is_not_correct(cell_name, faults):
    cell = tiny_cell(cell_name)
    out = harness.run(cell, SEED, 0.05, False, device="cpu",
                      faults=faults)
    assert out["correct"] is (not faults), out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"
    json.dumps(out)


GUARD = r"""
import json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import importlib, pkgutil
import bench, bench.run, bench.control
for mod in pkgutil.walk_packages(bench.__path__, "bench."):
    if ".tests" not in mod.name:
        importlib.import_module(mod.name)
from bench.core import harness, manifest
for m in manifest.manifest()["per_layer"]:
    manifest.reader(m["name"])
from bench.tests.common import tiny_cell
harness.run(tiny_cell("minitron-d8-prefill"), 5, 0.01, False, device="cpu")
print(json.dumps(bench.run.forbidden_modules()))
"""


def test_nothing_loaded_is_jax_or_the_jax_package():
    """In a process of its own: every module of the benchmark and a
    whole run load no module whose top-level name is ``jax``, ``jaxlib``,
    ``flax`` or ``repro`` (``repro_torch`` is not ``repro``)."""
    out = subprocess.run([sys.executable, "-c",
                          GUARD.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_guard_compares_whole_names():
    import bench.run

    assert bench.run.forbidden_modules(["repro_torch", "repro_torch.x",
                                        "jaxtyping", "torch"]) == []
    assert bench.run.forbidden_modules(["repro.core", "jax", "flax.nn",
                                        "jaxlib"]) == ["flax", "jax",
                                                       "jaxlib", "repro"]
