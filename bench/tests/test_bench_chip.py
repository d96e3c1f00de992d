"""One short run of each cell on the card, its result line read back
(``pytest -m chip bench/tests``, on a machine with a CUDA device)."""
import json
import subprocess
import sys

import pytest

from bench.tests.common import ROOT
from bench.core import manifest

CELLS = [w["name"] for w in manifest.manifest(ROOT)["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs only on the card")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         str(2**31 + 99), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
