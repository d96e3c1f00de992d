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
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not leaked, leaked
print(len(names))
"""

#: The fabric modules the port carries as byte copies (the only change is
#: ``repro.`` -> ``repro_torch.`` in import lines).
COPIES = ("configs/paper_cnn.py", "core/wire.py", "core/tickets.py",
          "core/distributor.py", "core/shards.py", "core/federation.py",
          "core/transport.py", "data/synthetic.py")

_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)repro\.", re.MULTILINE)


def test_port_and_chip_smoke_import_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, ROOT]))
    out = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 25      # every module was imported


@pytest.mark.parametrize("rel", COPIES)
def test_fabric_copy_differs_from_its_original_only_in_import_prefix(rel):
    with open(os.path.join(SRC, "repro", rel)) as f:
        original = f.read()
    with open(os.path.join(SRC, "repro_torch", rel)) as f:
        copy = f.read()
    assert copy == _IMPORT.sub(r"\1repro_torch.", original)


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

    return {
        "resolve_device": lambda: resolve_device(),
        "init_cnn": lambda: cnn.init_cnn(torch.Generator(), ccfg),
        "params_from_numpy": lambda: cnn.params_from_numpy(
            {"w": np.zeros(3, np.float32)}),
        "CnnGradShard": lambda: cnn.CnnGradShard(ccfg),
        "FederatedTrainingLoop": loop,
    }


@pytest.mark.parametrize("entry", ["resolve_device", "init_cnn",
                                   "params_from_numpy", "CnnGradShard",
                                   "FederatedTrainingLoop"])
def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch,
                                                          entry):
    from dataclasses import fields

    from repro_torch.models.cnn import CnnGradShard

    default = {f.name: f.default for f in fields(CnnGradShard)}["device"]
    assert default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[entry]()
