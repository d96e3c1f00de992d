"""A cell, found by its name: ``BENCHMARK.json`` names its configuration,
its traffic mix and its metrics, and each is a file of its own
that this module finds by that name:

- ``bench/configs/<config>.json``: the configuration as it is run;
- ``bench/traffic/<traffic>.json``: the traffic mix's parameters;
- ``bench/limits/<workload>.json``: the limit of each number the check
  compares;
- ``bench/metrics/<metric>.py``: the reader of one metric, end-to-end or
  per-layer;
- ``bench/reference/<reference>.py``: the plain reference the
  configuration's file names.

A later change adds a cell, a mix or a metric by adding files and
entries; no file here needs an edit for it.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # bench/configs/<config>.json
    mix: dict               # bench/traffic/<traffic>.json
    limits: dict            # bench/limits/<workload>.json
    end_to_end: list        # the manifest's entries this cell reports
    per_layer: list

    @property
    def reference(self):
        """The configuration's plain reference module."""
        return importlib.import_module(
            f"bench.reference.{self.config['reference']}")


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str, moves_reported) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``;
    without that key, an end-to-end metric is in every cell, a per-layer
    one wherever the end-to-end metric it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moves_reported is None or metric["moves"] in moves_reported


def load_cell(name: str, root: Path = ROOT) -> Cell:
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    e2e = [m for m in man["end_to_end"] if reports(m, name, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if reports(m, name, names)]
    return Cell(name, w["chips"], config, mix, limits, e2e, per_layer)


def reader(metric: str):
    """The ``read(run)`` function of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
