"""The port's static plan analyzer and normalizer against the reference.

``repro_torch.study.analyze`` must report what ``repro.study.analyze``
reports — the same (code, severity, node) for every seeded defect and for
the golden example plans (``tests/goldens/*_diag.json``) under both engine
pairs — and ``repro_torch.study.normalize`` must give the canonical plans
of ``tests/goldens/*_normal.json`` (engine names mapped through
``kernels.ENGINE_NAMES``), the same cut points, and subgraph hashes that
partition the cut points as the reference's do.  A normalized plan runs
through the port's executor with its hoisted literals as arguments and
gives the un-normalized plan's answer.
"""
import json
import os

import numpy as np
import pytest

from repro.data import synthetic as rsyn
from repro.study import analyze as r_analyze
from repro.study import col as r_col
from repro.study import cut_points as r_cut_points
from repro.study import normalize as r_normalize
from repro.study import subgraph_hashes as r_subgraph_hashes
from repro.study.defects import DEFECTS as R_DEFECTS
from repro.study.defects import build_defect as r_build_defect
from repro.study.defects import golden_studies as r_golden_studies
from repro_torch.core import DCIR_SCHEMA, drug_dispenses, medical_acts_dcir
from repro_torch.interop import tables_from_numpy
from repro_torch.kernels import ENGINE_NAMES
from repro_torch.kernels.predicate import MAX_ISIN_VALUES
from repro_torch.study import (DIAGNOSTIC_CODES, PlanBuilder,
                               PlanValidationError, Study, analyze,
                               assign_engines, col, cut_points,
                               device_params, errors, execute, normalize,
                               subgraph_hashes)
from repro_torch.study.defects import DEFECTS, build_defect, golden_studies
from repro_torch.study.expr import as_param
from test_plan_goldens import plan_snapshot

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
# (port engine, port predicate engine, reference engine, reference predicate)
ENGINE_PAIRS = [("torch", "torch", "xla", "jnp"),
                ("cuda", "cuda", "pallas", "pallas")]


def _triples(diags):
    return [(d.code, d.severity, d.node) for d in diags]


@pytest.mark.parametrize("code", sorted(DEFECTS))
def test_seeded_defect_fires(code):
    """Each seeded defect fires its own code, and the port reports exactly
    what the reference reports on the reference's fixture."""
    plan, kwargs = build_defect(code, device="cpu")
    got = analyze(plan, **kwargs)
    assert code in {d.code for d in got}, [str(d) for d in got]
    rplan, rkwargs = r_build_defect(code)
    assert _triples(got) == _triples(r_analyze(rplan, **rkwargs))


def test_defect_registry_covers_every_code():
    assert sorted(DEFECTS) == sorted(DIAGNOSTIC_CODES) == sorted(R_DEFECTS)


def _golden_diag(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}_diag.json")) as f:
        return [(d["code"], d["severity"], d["node"]) for d in json.load(f)]


@pytest.mark.parametrize("pair", ENGINE_PAIRS, ids=["torch-xla", "cuda-pallas"])
@pytest.mark.parametrize("name", ["quickstart", "cohort_study"])
def test_check_matches_reference_and_goldens(name, pair):
    eng, peng, r_eng, r_peng = pair
    got = golden_studies()[name].check(predicate_engine=peng, engine=eng,
                                       device="cpu")
    want = r_golden_studies()[name].check(predicate_engine=r_peng,
                                          engine=r_eng)
    assert _triples(got) == _triples(want)
    if peng == "cuda":        # the goldens pin the kernel engine's surface
        assert _triples(got) == _golden_diag(name)
    assert not errors(got)


def _normal_snapshot(normalize_fn, cut_fn, plan) -> dict:
    nplan = normalize_fn(plan)
    snap = plan_snapshot(nplan.plan)
    snap["lits"] = [float(v) if isinstance(v, float) else v
                    for v in nplan.lits]
    snap["vecs"] = [list(v) for v in nplan.vecs]
    snap["cut_points"] = [[i, nplan.plan.nodes[i].op]
                          for i in cut_fn(nplan.plan)]
    return json.loads(json.dumps(snap, sort_keys=True))


@pytest.mark.parametrize("name", ["quickstart", "cohort_study"])
def test_normalized_plans_match_goldens(name):
    """The goldens were made under the reference's jnp engine: the port's
    torch engine gives the same canonical plan, hoisted literals and cut
    points."""
    plan = golden_studies()[name].optimized_plan(predicate_engine="torch",
                                                 device="cpu")
    got = _normal_snapshot(normalize, cut_points, plan)
    with open(os.path.join(GOLDEN_DIR, f"{name}_normal.json")) as f:
        want = json.load(f)
    for node in want["nodes"]:
        if "engine" in node["params"]:
            node["params"]["engine"] = ENGINE_NAMES[node["params"]["engine"]]
    assert got == want


def _partition(hashes, cuts):
    groups = {}
    for i in cuts:
        groups.setdefault(hashes[i], []).append(i)
    return sorted(groups.values())


def _codes_study(S, schema, drugs, acts, codes):
    return (S(n_patients=100)
            .flatten(schema)
            .extract(drugs(), name="d1")
            .extract(acts(codes=codes), name="acts")
            .cohort("a", "acts")
            .cohort("both", "a - d1"))


@pytest.mark.parametrize("pair", ENGINE_PAIRS, ids=["torch-xla", "cuda-pallas"])
def test_subgraph_hashes_partition_like_reference(pair):
    """Port hashes name the port's engines, so they differ from the
    reference's; which cut points share a hash must not, and a change of
    literals must change the same nodes' hashes in both packages (and
    leave the canonical plan alone)."""
    from repro.core import DCIR_SCHEMA as R_DCIR
    from repro.core import drug_dispenses as r_drugs
    from repro.core import medical_acts_dcir as r_acts
    from repro.study import Study as RStudy

    _, peng, _, r_peng = pair
    parts, changed = [], []
    for S, schema, drugs, acts, kw, norm, cuts, hashes in (
            (Study, DCIR_SCHEMA, drug_dispenses, medical_acts_dcir,
             {"predicate_engine": peng, "device": "cpu"}, normalize,
             cut_points, subgraph_hashes),
            (RStudy, R_DCIR, r_drugs, r_acts, {"predicate_engine": r_peng},
             r_normalize, r_cut_points, r_subgraph_hashes)):
        n1 = norm(_codes_study(S, schema, drugs, acts, list(range(30)))
                  .optimized_plan(**kw))
        n2 = norm(_codes_study(S, schema, drugs, acts,
                               list(range(100, 130))).optimized_plan(**kw))
        assert n1.plan.key() == n2.plan.key() and n1.vecs != n2.vecs
        cp = cuts(n1.plan)
        h1, h2 = hashes(n1, salt=("v1",)), hashes(n2, salt=("v1",))
        parts.append(_partition(h1, cp))
        changed.append([i for i in cp if h1[i] != h2[i]])
        assert changed[-1] and len(changed[-1]) < len(cp)
    assert parts[0] == parts[1]
    assert changed[0] == changed[1]


def test_normalize_keeps_hoisted_literals_on_cuda():
    b = PlanBuilder()
    t = b.scan("T")
    m = b.predicate(t, col("x") > 5)
    b.set_output("out", b.compact(m))
    nplan = normalize(assign_engines(b.build(), predicate_engine="cuda"))
    assert nplan.demoted == ()
    pred = [n for n in nplan.plan.nodes if n.op == "predicate"]
    assert pred and all(n.get("engine") == "cuda" for n in pred)


def test_normalize_demotes_kernel_infeasible_stamp():
    b = PlanBuilder()
    t = b.scan("T")
    m = b.add("predicate", (t,),
              expr=as_param(col("x").isin(range(MAX_ISIN_VALUES + 1))),
              engine="cuda", bitset_block=1024, bitset_word="uint32")
    b.set_output("out", b.compact(m))
    nplan = normalize(b.build())
    assert nplan.demoted
    for nid in nplan.demoted:
        assert nplan.plan.nodes[nid].get("engine") == "torch"


def test_sp015_diagnostic():
    s = Study(n_patients=16).patients("IR_BEN").cohort("base",
                                                      "extract_patients")
    plan = s.optimized_plan(device="cpu")

    def sp015(**kw):
        return [d for d in analyze(plan, **kw) if d.code == "SP015"]

    bad = sp015(chunk_capacity=100)
    assert bad and bad[0].severity == "error"
    assert not sp015(chunk_capacity=96)
    assert sp015(n_shards=2, chunk_capacity=96)
    assert not sp015(n_shards=2, chunk_capacity=128)
    assert sp015(chunk_capacity=0)
    with pytest.raises(PlanValidationError, match="SP015"):
        raise PlanValidationError(analyze(plan, chunk_capacity=100))


N_PATIENTS = 200


@pytest.fixture(scope="module")
def dcir():
    ref = rsyn.generate_dcir(rsyn.SyntheticConfig(n_patients=N_PATIENTS,
                                                  seed=5))
    star = {name: {"columns": {k: np.asarray(v)
                               for k, v in t.columns.items()},
                   "valid": np.asarray(t.valid), "count": int(t.count),
                   "capacity": t.capacity} for name, t in ref.items()}
    return ref, tables_from_numpy(star, device="cpu")


def test_study_check_flags_contradiction_with_tables(dcir):
    ref_tables, port_tables = dcir
    from repro.core import DCIR_SCHEMA as R_DCIR
    from repro.core import medical_acts_dcir as r_acts
    from repro.study import Study as RStudy

    def bad(S, schema, acts, c):
        return (S(n_patients=N_PATIENTS).flatten(schema)
                .extract(acts(), name="acts")
                .filter("acts", (c("value") < 3) & (c("value") > 5),
                        name="never")
                .cohort("bad", "never"))

    got = bad(Study, DCIR_SCHEMA, medical_acts_dcir, col).check(
        tables=dict(port_tables), device="cpu")
    want = bad(RStudy, R_DCIR, r_acts, r_col).check(tables=dict(ref_tables))
    assert _triples(got) == _triples(want)
    assert {"SP003", "SP014"} <= {d.code for d in got}


@pytest.mark.parametrize("pair", ENGINE_PAIRS, ids=["torch-xla", "cuda-pallas"])
def test_normalized_quickstart_runs_like_the_plan(dcir, pair):
    """normalize -> execute(expr_params=device_params(...)) equals the
    un-normalized plan's values; under the cuda engine every hoisted
    predicate keeps the kernel (no demotion)."""
    eng, peng, _, _ = pair
    _, port_tables = dcir
    study = golden_studies()["quickstart"]
    study.n_patients = N_PATIENTS
    plan = study.optimized_plan(predicate_engine=peng, engine=eng,
                                device="cpu")
    nplan = normalize(plan)
    assert nplan.demoted == ()
    if peng == "cuda":
        assert any(n.get("engine") == "cuda" for n in nplan.plan.nodes)
    want = execute(plan, dict(port_tables), n_patients=N_PATIENTS,
                   engine=eng, predicate_engine=peng)
    got = execute(nplan.plan, dict(port_tables), n_patients=N_PATIENTS,
                  engine=eng, predicate_engine=peng,
                  expr_params=device_params(nplan, device="cpu"))
    canon = nplan.orig_to_canon()
    outs = dict(nplan.out_map)
    for name, i in plan.outputs:
        if i not in want:                 # the flow: a host op
            continue
        a = want[i]
        b = got[dict(nplan.plan.outputs)[outs[name]]]
        assert canon[i] == dict(nplan.plan.outputs)[outs[name]]
        if hasattr(a, "columns"):
            assert int(a.count) == int(b.count), name
            np.testing.assert_array_equal(a.valid.numpy(), b.valid.numpy())
            for c in a.columns:
                np.testing.assert_array_equal(a.columns[c].numpy(),
                                              b.columns[c].numpy())
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
