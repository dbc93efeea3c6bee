"""A whole run of each cell, on the CPU at a tiny size, past the harness's
look for a card: sound, it is correct; with the control (the reference on
int16 copies of the int32 columns in the program's place) or with the timed
path broken underneath, ``correct`` comes out false."""
import json
import time
from pathlib import Path

import pytest
import torch

from portbench import run as run_py
from portbench.lib import cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# one sampled study, the window's first: a loaded test machine may run only
# one study in the window
TINY = {"config": {"n_patients": 2000},
        "mix": {"sample": 1, "sample_within": 1}}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(name, control=False, seconds=0.6):
    res = cell.run_cell(name, 2 ** 33 + 71, seconds, False,
                        time.perf_counter(), device="cpu", overrides=TINY,
                        control=control)
    return run_py.result_line(BENCH, name, res, False, {"platform": "cpu"})


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = _run(name)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    line = _run(name, control=True)
    assert not line["correct"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def _patch_nodes(monkeypatch, fault):
    from repro_torch.study import executor

    orig = executor._eval_node

    def broken(node, ins, *a, **kw):
        return fault(node, ins, orig(node, ins, *a, **kw))

    monkeypatch.setattr(executor, "_eval_node", broken)


def _altered_answer(node, ins, out):
    """One answer altered where it is produced: the first row of every
    compaction gets another value."""
    if node.op == "compact" and "value" in out.columns:
        cols = dict(out.columns)
        cols["value"] = cols["value"].clone()
        cols["value"][0] += 1
        return type(out)(cols, out.valid, out.count, out.capacity)
    return out


def _half_left_out(node, ins, out):
    """Half of the batch left out: every scan of a table hands on only its
    first half of rows (the rest marked invalid)."""
    if node.op in ("scan", "scan_star"):
        from repro_torch.core.columnar import ColumnarTable

        keep = torch.arange(out.capacity) < out.capacity // 2
        return ColumnarTable.from_columns(
            out.columns, valid=out.valid_bool() & keep, device="cpu")
    return out


@pytest.mark.parametrize("fault", [_altered_answer, _half_left_out],
                         ids=["answer_altered", "half_left_out"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    _patch_nodes(monkeypatch, fault)
    line = _run(name)
    assert not line["correct"], line["checks"]
