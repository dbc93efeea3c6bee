"""Each plain reference against the port's ``torch`` engines (and the
``cuda`` engines' plain versions) on the CPU at a tiny size: every output
the comparison reads must agree exactly."""
import itertools
import json
from pathlib import Path

import pytest

from portbench.lib import cell, compare, data, traffic

ROOT = Path(__file__).resolve().parents[2]
P = 1500


def _star(config, seed):
    cfg = dict(json.loads((ROOT / "portbench" / "configs"
                           / f"{config}.json").read_text()), n_patients=P)
    return cfg, data.make_star(cfg, seed, "cpu")


def _queries(mix, seed, n):
    m = traffic.load_mix(mix)
    return list(itertools.islice(traffic.closed_queries(m, seed), n))


CASES = [("dcir_2m", "batch", 2), ("snds_1m", "cohort", 1)]


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("config,mix,n", CASES)
def test_reference_equals_the_port(config, mix, n, engine):
    cfg, star = _star(config, 2 ** 32 + 9)
    run = {"cfg": cfg, "mix": traffic.load_mix(mix)}
    prog = cell.setup_program(dict(run, cell={"config": config}), 2 ** 32 + 9,
                              "cpu")
    ref = cell.reference(config)
    state = ref.prepare(prog["star"], cfg)
    if "setup_flat" in prog:
        want = ref.setup_answer(state)
        for k, t in prog["setup_flat"].items():
            got = compare.table_rows(t)
            assert compare.rows_differing(got, want["flat"][k]) == 0
            assert next(iter(got.values())).shape[0] > 0
    for q in _queries(mix, 5, n):
        res = cell.shape(q["shape"]).build(q, P).run(
            dict(prog["tables"]), engine=engine, predicate_engine=engine,
            device="cpu")
        got = compare.digest(res, P)
        want = ref.answer(state, q)
        nums = compare.compare(got, compare.answer_digest(want), P)
        assert all(v == 0 for v in nums.values()), (q["shape"], nums)
        # the comparison reads something in every output
        assert all(next(iter(t.values())).shape[0] > 0
                   for t in want["events"].values())
        assert any(int(m.sum()) > 0 for m in want["cohorts"].values())


def test_a_shape_added_as_its_own_reference_file(monkeypatch):
    import sys
    import types

    mod = types.ModuleType("portbench.reference.dcir_2m__probe")
    mod.answer = lambda state, q: ("probe", state, q["x"])
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    assert cell.ref_answer("dcir_2m", "S", {"shape": "probe", "x": 3}) == \
        ("probe", "S", 3)
    assert "probe" not in cell.reference("dcir_2m").SHAPES


def test_control_differs_from_the_reference():
    cfg, star = _star("dcir_2m", 3)
    ref = cell.reference("dcir_2m")
    q = _queries("batch", 3, 1)[0]
    a = ref.answer(ref.prepare(star, cfg), q)
    b = ref.answer(ref.prepare(star, cfg, control=True), q)
    assert sum(compare.compare(compare.answer_digest(b),
                               compare.answer_digest(a), P).values()) > 0


def test_references_import_nothing_of_the_program():
    src = "\n".join(p.read_text() for p in
                    (ROOT / "portbench" / "reference").glob("*.py"))
    assert "repro_torch" not in src.replace("repro_torch.data.synthetic", "")
    assert "import jax" not in src
