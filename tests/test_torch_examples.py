"""The four torch examples (``examples/torch_*.py``) with ``--device cpu``
at their smallest flags, each in a process of its own: each exits 0 and
prints what its JAX twin prints, and the line of its kernel launches (0
here: on the CPU every kernel runs its plain version)."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(tmp_path, script: str, *argv: str, timeout: float = 120) -> str:
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), *argv],
        capture_output=True, text=True, env=env, cwd=tmp_path,
        timeout=timeout)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    return r.stdout


def _launches(out: str) -> dict:
    lines = [ln for ln in out.splitlines()
             if ln.startswith("kernel launches:")]
    assert len(lines) == 1, out[-2000:]
    return {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", lines[0])}


def test_quickstart_trains_and_round_trips_the_json_model(tmp_path):
    path = tmp_path / "model.json"
    out = _example(tmp_path, "torch_quickstart.py", "--device", "cpu",
                   "--batches", "2", "--out", str(path))
    assert "batch    1 loss" in out and "test_err" in out
    assert f"model saved (paper JSON+base64 format, bit-exact): {path}" in out
    assert path.exists()
    assert _launches(out) == {"adagrad": 0}


def test_serve_llm_generates_with_every_kernel_counted(tmp_path):
    out = _example(tmp_path, "torch_serve_llm.py", "--device", "cpu",
                   "--batch", "1", "--prompt-len", "8", "--gen", "2")
    assert "serving rwkv6-smoke (ssm): batch=1 prompt=8 gen=2" in out
    assert "generated 1x2 tokens" in out and "sample tokens:" in out
    assert _launches(out) == {"flash_attention": 0, "rwkv6": 0, "mamba": 0}


def test_train_llm_lowers_the_loss(tmp_path):
    out = _example(tmp_path, "torch_train_llm.py", "--device", "cpu",
                   "--steps", "4", "--batch", "2", "--seq", "16",
                   "--d-model", "64", "--layers", "1", "--vocab", "256")
    assert "strategy=split_concurrent" in out and "step    3 loss" in out
    first, last = (float(x) for x in re.search(
        r"loss: ([\d.]+) -> ([\d.]+)", out).groups())
    assert last < first
    assert _launches(out) == {"adagrad": 0}


@pytest.mark.parametrize("flags,expect", [
    ((), ("1229 primes found up to 10000", "distributed kNN accuracy",
          "split-concurrent: 3 rounds")),
    (("--federation",), ("federation:", "member0 killed mid-run")),
    (("--transport",), ("transport: 400 tickets", "all results exact")),
    (("--train",), ("training fabric: 6 rounds", "resumed from round-4")),
    (("--trace", "trace.json"), ("training fabric: 6 rounds", "trace:",
                                 "fused server step:")),
])
def test_sashimi_browser_sim_runs_every_mode(tmp_path, flags, expect):
    out = _example(tmp_path, "torch_sashimi_browser_sim.py", "--device",
                   "cpu", *flags)
    for text in expect:
        assert text in out, (text, out[-2000:])
    if "--train" in flags or "--trace" in flags:
        assert _launches(out) == {"server_step": 0}
    if "--trace" in flags:
        assert (tmp_path / "trace.json").exists()
