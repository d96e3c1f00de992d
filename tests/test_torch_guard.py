"""The port's boundaries: it reaches no jax and nothing of ``repro``, its
fabric modules are byte copies of the JAX package's, and its entry points
default to CUDA and refuse to fall back to the CPU."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

# Runs in a fresh interpreter: tests/conftest.py imports jax into every
# test process, so the check cannot be made in this one.
_GUARD = r"""
import importlib, pkgutil, sys

BANNED = ("jax", "jaxlib", "ml_dtypes", "repro")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import glob, importlib.util, os
for path in sorted(glob.glob(os.path.join("examples", "torch_*.py"))):
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(path)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not leaked, leaked
print(" ".join(names))
"""

#: Modules the guard must have imported (a subpackage that fails to be
#: walked would otherwise go unchecked).
SLICE_MODULES = (
    "configs.base", "configs.qwen3_4b", "configs.rwkv6_1_6b",
    "configs.jamba_1_5_large_398b", "sharding.spec", "models.layers",
    "models.transformer", "models.rwkv", "models.model", "launch.serve",
    "kernels.flash_attention.ops", "kernels.flash_attention.ref",
    "kernels.rwkv6.ops", "kernels.rwkv6.ref", "kernels.mamba.ops",
    "kernels.mamba.ref", "models.mamba", "models.moe", "models.hybrid",
    "launch.train", "launch.steps", "models.encdec", "launch.mesh",
    "sharding.rules", "obs.slo", "obs.fleet", "train_fabric.rebalancer",
    "core.profiles", "core.project", "sharding.collectives",
    "models.flags", "launch.hlo_analysis", "launch.dryrun")

#: The modules the port carries as byte copies (the only change is
#: ``repro.`` -> ``repro_torch.`` in imports, ``importlib`` ones included).
COPIES = ("configs/paper_cnn.py", "core/wire.py", "core/tickets.py",
          "core/distributor.py", "core/shards.py", "core/federation.py",
          "core/transport.py", "data/synthetic.py", "configs/base.py",
          "configs/command_r_35b.py", "configs/dbrx_132b.py",
          "configs/internvl2_26b.py", "configs/jamba_1_5_large_398b.py",
          "configs/minitron_4b.py", "configs/qwen1_5_0_5b.py",
          "configs/qwen3_4b.py", "configs/qwen3_moe_30b_a3b.py",
          "configs/rwkv6_1_6b.py", "configs/whisper_small.py",
          "obs/__init__.py", "obs/metrics.py", "obs/trace.py",
          "obs/collect.py", "obs/slo.py", "obs/fleet.py",
          "core/profiles.py", "core/project.py",
          "train_fabric/rebalancer.py", "sharding/rules.py",
          "models/flags.py")

_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)repro\.", re.MULTILINE)
_IMPORT_MODULE = re.compile(r"(import_module\(f?[\"'])repro\.")


def test_port_and_chip_smoke_import_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, ROOT]))
    out = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    imported = set(out.stdout.split())
    assert len(imported) >= 60                    # every module was imported
    assert {f"repro_torch.{m}" for m in SLICE_MODULES} <= imported
    assert {f"examples/torch_{name}.py" for name in (
        "quickstart", "serve_llm", "train_llm", "sashimi_browser_sim")} \
        <= imported


@pytest.mark.parametrize("rel", COPIES)
def test_fabric_copy_differs_from_its_original_only_in_import_prefix(rel):
    with open(os.path.join(SRC, "repro", rel)) as f:
        original = f.read()
    with open(os.path.join(SRC, "repro_torch", rel)) as f:
        copy = f.read()
    renamed = _IMPORT.sub(r"\1repro_torch.", original)
    assert copy == _IMPORT_MODULE.sub(r"\1repro_torch.", renamed)


def _entry_points():
    from repro_torch.configs.paper_cnn import smoke_config
    from repro_torch.core.split_parallel import TrainState
    from repro_torch.device import resolve_device
    from repro_torch.models import cnn
    from repro_torch.train_fabric import (FederatedTrainer,
                                          FederatedTrainingLoop)

    ccfg = smoke_config()

    class Dist:                       # the duck-typed distributor surface
        keep_alive = False
        queue = None

    def loop():
        state = TrainState({}, {}, {}, {}, {}, (), (), (),
                           np.zeros((), np.int32))
        return FederatedTrainingLoop(FederatedTrainer(Dist()), None, state)

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve, train
    from repro_torch.models import model

    lm = get_smoke_config("rwkv6-1.6b")
    return {
        "resolve_device": lambda: resolve_device(),
        "init_cnn": lambda: cnn.init_cnn(torch.Generator(), ccfg),
        "params_from_numpy": lambda: cnn.params_from_numpy(
            {"w": np.zeros(3, np.float32)}),
        "CnnGradShard": lambda: cnn.CnnGradShard(ccfg),
        "FederatedTrainingLoop": loop,
        "lm_params_from_numpy": lambda: model.params_from_numpy(lm, {}),
        "lm_init_cache": lambda: model.build_model(lm).init_cache(1, 8),
        "serve_main": lambda: serve.main(["--smoke"]),
        "train_main": lambda: train.main(["--smoke"]),
    }


@pytest.mark.parametrize("entry", ["resolve_device", "init_cnn",
                                   "params_from_numpy", "CnnGradShard",
                                   "FederatedTrainingLoop",
                                   "lm_params_from_numpy", "lm_init_cache",
                                   "serve_main", "train_main"])
def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch,
                                                          entry):
    from dataclasses import fields

    from repro_torch.models.cnn import CnnGradShard

    default = {f.name: f.default for f in fields(CnnGradShard)}["device"]
    assert default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[entry]()


def _state_makers():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import encdec, hybrid, mamba, rwkv, transformer

    dense = get_smoke_config("qwen3-4b")
    ssm = get_smoke_config("rwkv6-1.6b")
    jamba = get_smoke_config("jamba-1.5-large-398b")
    return {
        "transformer.init_cache": lambda **kw: transformer.init_cache(
            dense, 1, 8, **kw),
        "rwkv.init_cache": lambda **kw: rwkv.init_cache(ssm, 1, 8, **kw),
        "rwkv.rwkv_init_state": lambda **kw: rwkv.rwkv_init_state(
            ssm, 1, **kw),
        "hybrid.init_cache": lambda **kw: hybrid.init_cache(jamba, 1, 8,
                                                            **kw),
        "mamba.mamba_init_state": lambda **kw: mamba.mamba_init_state(
            jamba, 1, **kw),
        "encdec.init_cache": lambda **kw: encdec.init_cache(
            get_smoke_config("whisper-small"), 1, 8, **kw),
    }


@pytest.mark.parametrize("maker", ["transformer.init_cache",
                                   "rwkv.init_cache", "rwkv.rwkv_init_state",
                                   "hybrid.init_cache",
                                   "mamba.mamba_init_state",
                                   "encdec.init_cache"])
def test_cache_and_state_makers_default_to_cuda(monkeypatch, maker):
    """Each asks for ``cuda`` unless told otherwise: on a host without CUDA
    it raises, and with ``device="cpu"`` it makes its tensors there."""
    make = _state_makers()[maker]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    made = make(device="cpu")
    tensors = made.values() if isinstance(made, dict) else made
    assert all(t.device.type == "cpu" for t in tensors)
