"""BENCHMARK.json against the rules of a benchmark manifest, and every cell's files
found by the names it gives."""
import json
import re

import pytest

from bench.tests.common import ROOT
from bench.core import manifest

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_command():
    assert list(MAN) == ["command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"]
    assert MAN["paths"] == ["bench"]
    assert len(MAN["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in MAN["command"])
    assert (ROOT / MAN["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_unique_names_and_pairs():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds():
    names = [m["name"] for m in MAN["end_to_end"]]
    assert names == ["setup_s", "train_tokens_per_s", "gen_tokens_per_s"]
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_run_seconds_fit_the_check():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = manifest.load_cell(cell, ROOT)
    assert c.mix["kind"] in ("train", "serve")
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert c.reference.layout and c.reference.Model
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.reader(m["name"]))


def test_every_metric_has_its_reader_and_config_its_file():
    for m in METRICS:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_layout_is_the_programs_tree(config):
    """The weights the benchmark draws fit the program's parameter tree,
    leaf for leaf and shape for shape."""
    from repro_torch.models.model import build_model
    from repro_torch.sharding.spec import values_tree

    from bench.core.train import arch_config, model_dims
    from bench.reference.common import flat

    entry = next(c for c in MAN["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    ref = __import__(f"bench.reference.{data['reference']}",
                     fromlist=["layout"])
    mine = {p: tuple(s) for p, s, _ in ref.layout(model_dims(data))}
    api = build_model(arch_config(data))
    theirs = {p: tuple(v.shape) for p, v in flat(values_tree(api.init(None)))}
    assert mine == theirs
