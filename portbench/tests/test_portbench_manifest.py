"""BENCHMARK.json against the benchmark's contract, and every name in it
against a file of the harness that carries it."""
import importlib
import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for k in ("why", "layer", "source"):
        if k in entry:
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k] \
                and "\t" not in entry[k]


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))


def test_end_to_end_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_at_most_a_quarter_of_cells_on_four_chips():
    cells = BENCH["workloads"]
    four = sum(c["chips"] == 4 for c in cells)
    assert all(c["chips"] in (1, 4) for c in cells)
    assert four <= max(1, math.floor(0.25 * len(cells)))


def _e2e_of(cell):
    return {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_and_workloads(m):
    cells = {c["name"] for c in BENCH["workloads"]}
    e2e = {x["name"] for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for c in m["workloads"]:
        assert c in cells
        assert m["moves"] in _e2e_of(c)


def test_one_layer_name_a_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 for x in layers)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    name = cell["name"]
    assert "setup_s" in _e2e_of(name) and len(_e2e_of(name)) >= 2
    assert any(name in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    f = json.loads((ROOT / "portbench" / "workloads"
                    / f"{cell['name']}.json").read_text())
    assert f["config"] == cell["config"] and f["traffic"] == cell["traffic"]
    assert f["chips"] == cell["chips"] and f["why"] == cell["why"]
    mix = json.loads((ROOT / "portbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    ref = importlib.import_module(f"portbench.reference.{cell['config']}")
    for s in mix["shapes"]:
        importlib.import_module(f"portbench.shapes.{s['shape']}")
        assert s["shape"] in ref.SHAPES


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = ROOT / cfg["file"]
    assert cfg["file"].startswith("portbench/")
    f = json.loads(path.read_text())
    assert f["name"] == cfg["name"] and f["reduced"] == cfg["reduced"]
    assert f["source"] == cfg["source"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
