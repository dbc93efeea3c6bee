"""The quickstart study — the port's main path — against the reference.

One numpy-seeded DCIR star goes through ``repro`` and ``repro_torch`` (CPU)
under both engine pairs: ``torch`` for the reference's ``xla``/``jnp`` and
``cuda`` (whose kernels run their plain versions on CPU tensors) for
``pallas``.  Compared exactly: events (every slot, so the engine-specific
contents past ``count`` too), validity words, counts, FlatteningStats with
their modular key checksums, cohort words, flow rows, OperationLog entries
(without ``ts``, engine names mapped) and the optimized plan node for node.
PMSI ``flatten_star``/``flatten_sliced`` cover ``expand_join`` and
``slice_time``.
"""
import numpy as np
import pytest
import torch

from repro.core import DCIR_SCHEMA as R_DCIR, PMSI_MCO_SCHEMA as R_PMSI
from repro.core import diagnoses as r_diagnoses
from repro.core import drug_dispenses as r_drugs
from repro.core import flatten_sliced as r_flatten_sliced
from repro.core import flatten_star as r_flatten_star
from repro.core import medical_acts_dcir as r_acts
from repro.core import patients as r_patients
from repro.data import synthetic as rsyn
from repro.study import Study as RStudy
from repro.study import flow_rows_from_log as r_flow_rows
from repro_torch.core import DCIR_SCHEMA, PMSI_MCO_SCHEMA, diagnoses, \
    drug_dispenses, flatten_sliced, flatten_star, medical_acts_dcir, patients
from repro_torch.interop import tables_from_numpy
from repro_torch.kernels import ENGINE_NAMES, launch_counts
from repro_torch.study import Study, clear_jit_cache, column_audit_from_log, \
    flow_rows_from_log, jit_cache_info

N_PATIENTS = 300
# (port engine, port predicate engine, reference engine, reference predicate)
ENGINE_PAIRS = [("torch", "torch", "xla", "jnp"),
                ("cuda", "cuda", "pallas", "pallas")]


def _star(ref_tables) -> dict:
    return {name: {"columns": {k: np.asarray(v) for k, v in t.columns.items()},
                   "valid": np.asarray(t.valid), "count": int(t.count),
                   "capacity": t.capacity}
            for name, t in ref_tables.items()}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_table(rt, pt, what: str) -> None:
    assert pt.capacity == rt.capacity, what
    assert int(pt.count) == int(rt.count), what
    np.testing.assert_array_equal(pt.valid.numpy().view(np.uint32),
                                  np.asarray(rt.valid), err_msg=what)
    assert sorted(pt.columns) == sorted(rt.columns), what
    for k in rt.columns:
        np.testing.assert_array_equal(_bits(pt.columns[k].numpy()),
                                      _bits(rt.columns[k]),
                                      err_msg=f"{what}.{k}")


def _map_engines(d):
    return {k: (ENGINE_NAMES.get(v, v) if k == "engine" else v)
            for k, v in d.items()}


def assert_same_plan(rp, pp) -> None:
    assert rp.outputs == pp.outputs
    assert len(rp.nodes) == len(pp.nodes)
    for rn, pn in zip(rp.nodes, pp.nodes):
        assert (rn.op, rn.inputs) == (pn.op, pn.inputs)
        assert _map_engines(dict(rn.params)) == dict(pn.params), rn.op


def _quickstart(S, schema, drugs, acts):
    return (S(n_patients=N_PATIENTS)
            .flatten(schema)
            .extract(drugs(), name="drug_purchases")
            .extract(acts(codes=list(range(30))), name="acts")
            .patients("IR_BEN")
            .cohort("base", "extract_patients")
            .cohort("drugged", "drug_purchases")
            .cohort("final", "drugged & base - acts")
            .flow("base", "drugged", "final"))


@pytest.fixture(scope="module")
def dcir():
    ref = rsyn.generate_dcir(rsyn.SyntheticConfig(n_patients=N_PATIENTS,
                                                  seed=0))
    return ref, tables_from_numpy(_star(ref), device="cpu")


@pytest.mark.parametrize("pair", ENGINE_PAIRS, ids=["torch-xla", "cuda-pallas"])
def test_quickstart_bit_identical(dcir, pair):
    eng, peng, r_eng, r_peng = pair
    ref_tables, port_tables = dcir
    rs = _quickstart(RStudy, R_DCIR, r_drugs, r_acts)
    ps = _quickstart(Study, DCIR_SCHEMA, drug_dispenses, medical_acts_dcir)
    want = rs.run(dict(ref_tables), engine=r_eng, predicate_engine=r_peng)
    before = dict(launch_counts)
    got = ps.run(dict(port_tables), engine=eng, predicate_engine=peng,
                 device="cpu")
    assert launch_counts == before       # CPU tensors never launch kernels
    got.assert_no_loss()

    assert_same_plan(want.plan, got.plan)
    assert sorted(want.events) == sorted(got.events)
    for name in want.events:
        assert_same_table(want.events[name], got.events[name], name)
    assert want.flatten_stats == got.flatten_stats
    assert sorted(want.cohorts) == sorted(got.cohorts)
    for name, c in want.cohorts.items():
        np.testing.assert_array_equal(
            got.cohorts[name].subjects.numpy().view(np.uint32),
            np.asarray(c.subjects), err_msg=name)
        assert got.cohorts[name].description == c.description
        assert got.cohorts[name].subject_count() == c.subject_count()
    assert got.flow.flowchart() == want.flow.flowchart()
    assert flow_rows_from_log(got.log) == r_flow_rows(want.log)
    strip = [{k: (_map_engines(v) if k == "params" else v)
              for k, v in e.items() if k != "ts"} for e in want.log.entries]
    assert [{k: v for k, v in e.items() if k != "ts"}
            for e in got.log.entries] == strip
    assert column_audit_from_log(got.log)


def assert_cuda_cohort_groups(want, plan, env, n_patients, monkeypatch):
    """Under the ``cuda`` engine on the CPU each group of ``cohort_op``
    nodes is one ``bitset_expr`` call (its plain version) whose counts are
    the nodes' counts: every node's count and every cohort node's words
    equal the ``torch`` engine's, and the OperationLog's plan entries (op,
    inputs and outputs with their counts) and the named cohorts' words
    equal the reference's (``want``, a run under either engine)."""
    from repro_torch.core.metadata import OperationLog
    from repro_torch.kernels import bitset_ops
    from repro_torch.study.executor import cohort_groups, execute, \
        run_plan_body
    from repro_torch.study.plan import COHORT_OPS

    ids = tuple(i for i, nd in enumerate(plan.nodes) if nd.op in COHORT_OPS)
    calls = []
    plain = bitset_ops.bitset_expr_plain
    monkeypatch.setattr(bitset_ops, "bitset_expr_plain",
                        lambda leaves, prog: calls.append(prog)
                        or plain(leaves, prog))
    got = {eng: run_plan_body(plan, dict(env), n_patients, eng,
                              predicate_engine=eng, keep=ids)
           for eng in ("torch", "cuda")}
    groups = cohort_groups(plan)
    assert [len(p) for p in calls] == [len(ms) for ms in groups.values()]
    assert sum(len(ms) for ms in groups.values()) == \
        sum(plan.nodes[i].op == "cohort_op" for i in ids) > 0
    (tv, tc, _), (cv, cc, _) = got["torch"], got["cuda"]
    assert {i: int(c) for i, c in cc.items()} == \
        {i: int(c) for i, c in tc.items()}
    for i in ids:
        assert torch.equal(cv[i], tv[i]), plan.nodes[i].label()
    for name, i in plan.outputs:
        if plan.nodes[i].op == "cohort_op":
            np.testing.assert_array_equal(
                cv[i].numpy().view(np.uint32),
                np.asarray(want.cohorts[name].subjects), err_msg=name)
    log = OperationLog()
    execute(plan, dict(env), n_patients, engine="cuda", log=log,
            predicate_engine="cuda")
    def entries(lg):
        return [(e["op"], e["inputs"], e["outputs"]) for e in lg.entries
                if e["op"].startswith("plan:")]

    assert entries(log) == entries(want.log)


def test_cuda_engine_runs_each_cohort_expression_as_one_group(
        dcir, monkeypatch):
    """The quickstart's ``drugged & base - acts`` is one group of two ops."""
    ref_tables, port_tables = dcir
    rs = _quickstart(RStudy, R_DCIR, r_drugs, r_acts)
    ps = _quickstart(Study, DCIR_SCHEMA, drug_dispenses, medical_acts_dcir)
    want = rs.run(dict(ref_tables), engine="pallas", predicate_engine="pallas")
    plan = ps.optimized_plan(tables=dict(port_tables), engine="cuda",
                             predicate_engine="cuda", device="cpu")
    assert_cuda_cohort_groups(want, plan, port_tables, N_PATIENTS,
                              monkeypatch)
    from repro_torch.study.executor import cohort_groups

    assert [len(ms) for ms in cohort_groups(plan).values()] == [2]


def test_cuda_engine_chunks_a_long_cohort_expression(dcir, monkeypatch):
    """A group of 10 ``cohort_op`` nodes runs as launches of at most 8 ops
    (8, then 2 reading the first launch's last result); every node's words
    and count equal the torch engine's."""
    from repro_torch.kernels import bitset_ops
    from repro_torch.study.executor import cohort_groups, run_plan_body
    from repro_torch.study.plan import COHORT_OPS

    expr = "base"
    for k in range(10):
        expr = f"({expr}) {'&-|'[k % 3]} {('drugged', 'acts', 'base')[k % 3]}"
    ps = (_quickstart(Study, DCIR_SCHEMA, drug_dispenses, medical_acts_dcir)
          .cohort("acts_cohort", "acts")
          .cohort("long", expr.replace("acts", "acts_cohort")))
    plan = ps.optimized_plan(tables=dict(dcir[1]), engine="cuda",
                             predicate_engine="cuda", device="cpu")
    assert sorted(len(ms) for ms in cohort_groups(plan).values()) == [2, 10]
    calls = []
    plain = bitset_ops.bitset_expr_plain
    monkeypatch.setattr(bitset_ops, "bitset_expr_plain",
                        lambda leaves, prog: calls.append(prog)
                        or plain(leaves, prog))
    ids = tuple(i for i, nd in enumerate(plan.nodes) if nd.op in COHORT_OPS)
    (tv, tc, _), (cv, cc, _) = (
        run_plan_body(plan, dict(dcir[1]), N_PATIENTS, eng,
                      predicate_engine=eng, keep=ids)
        for eng in ("torch", "cuda"))
    assert sorted(len(p) for p in calls) == [2, 2, 8]
    assert {i: int(c) for i, c in cc.items()} == \
        {i: int(c) for i, c in tc.items()}
    for i in ids:
        assert torch.equal(cv[i], tv[i]), plan.nodes[i].label()


def test_optimized_plan_matches_reference_per_engine(dcir):
    ref_tables, port_tables = dcir
    rs = _quickstart(RStudy, R_DCIR, r_drugs, r_acts)
    ps = _quickstart(Study, DCIR_SCHEMA, drug_dispenses, medical_acts_dcir)
    for eng, peng, r_eng, r_peng in ENGINE_PAIRS + [("torch", "auto", "xla",
                                                     "auto")]:
        assert_same_plan(
            rs.optimized_plan(tables=dict(ref_tables), engine=r_eng,
                              predicate_engine=r_peng),
            ps.optimized_plan(tables=dict(port_tables), engine=eng,
                              predicate_engine=peng))


def test_runner_cache_counts(dcir):
    _, port_tables = dcir
    ps = _quickstart(Study, DCIR_SCHEMA, drug_dispenses, medical_acts_dcir)
    clear_jit_cache()
    ps.run(dict(port_tables), device="cpu")
    ps.run(dict(port_tables), device="cpu")
    info = jit_cache_info()
    assert info == {"plans": 1, "compiles": 1, "hits": 1}
    ps.run(dict(port_tables), engine="cuda", device="cpu")
    assert jit_cache_info()["compiles"] == 2


@pytest.fixture(scope="module")
def pmsi():
    ref = rsyn.generate_pmsi(rsyn.SyntheticConfig(n_patients=N_PATIENTS,
                                                  seed=2))
    return ref, tables_from_numpy(_star(ref), device="cpu")


def _assert_same_stats(rstats, pstats) -> None:
    assert [s.stage for s in rstats] == [s.stage for s in pstats]
    for r, p in zip(rstats, pstats):
        for k in ("rows_in", "rows_out", "matched", "overflow", "null_keys",
                  "key_sum_in", "key_sum_out"):
            assert int(getattr(p, k)) == int(getattr(r, k)), (r.stage, k)


def test_flatten_star_pmsi_expand_join(pmsi):
    ref_tables, port_tables = pmsi
    rflat, rstats = r_flatten_star(R_PMSI, ref_tables)
    pflat, pstats = flatten_star(PMSI_MCO_SCHEMA, port_tables)
    assert_same_table(rflat, pflat, "flat")
    _assert_same_stats(rstats, pstats)
    # an extractor with a distinct (dedupe) over the 1:N flat table
    assert_same_table(r_diagnoses()(rflat), diagnoses()(pflat), "diagnoses")
    assert_same_table(r_diagnoses()(rflat, engine="pallas"),
                      diagnoses()(pflat, engine="cuda"), "diagnoses-cuda")


def test_flatten_sliced_pmsi(pmsi):
    ref_tables, port_tables = pmsi
    args = ("stay_start", 3, 14_600, 14_600 + 3 * 365)
    rflat, rstats = r_flatten_sliced(R_PMSI, ref_tables, *args)
    pflat, pstats = flatten_sliced(PMSI_MCO_SCHEMA, port_tables, *args)
    assert_same_table(rflat, pflat, "sliced")
    _assert_same_stats(rstats, pstats)


def test_patients_extractor(dcir):
    ref_tables, port_tables = dcir
    assert_same_table(r_patients(ref_tables["IR_BEN"]),
                      patients(port_tables["IR_BEN"]), "patients")


def test_unported_surfaces_name_their_roadmap_item(dcir, tmp_path):
    """The surfaces that once raised naming their ROADMAP items are ported:
    ``check`` (A5) and ``run_chunked`` (A6) run on the CPU when asked, and
    a mesh run (A8's study side) takes a process group."""
    from repro_torch.data import partition_star

    _, port_tables = dcir
    s = (Study(n_patients=N_PATIENTS).flatten(DCIR_SCHEMA)
         .extract(drug_dispenses(), name="d").cohort("got", "d"))
    assert not [d for d in s.check(device="cpu") if d.severity == "error"]
    store = partition_star(port_tables, str(tmp_path / "store"),
                           source="ER_PRS", chunk_capacity=1024)
    got = s.run_chunked(store, device="cpu")
    want = s.run(dict(port_tables), device="cpu")
    assert torch.equal(got.cohorts["got"].subjects,
                       want.cohorts["got"].subjects)
    # mesh runs are ported (A8's study side): a mesh is a process group
    with pytest.raises(TypeError, match="process group"):
        s.run(dict(port_tables), mesh=object(), device="cpu")


def test_run_moves_tables_to_device(dcir):
    ref_tables, port_tables = dcir
    ps = _quickstart(Study, DCIR_SCHEMA, drug_dispenses, medical_acts_dcir)
    got = ps.run({k: t.to("cpu") for k, t in port_tables.items()},
                 device=torch.device("cpu"))
    assert got.cohorts["final"].subjects.device.type == "cpu"


@pytest.mark.parametrize("pair", ENGINE_PAIRS, ids=["torch-xla", "cuda-pallas"])
def test_execute_binds_hoisted_params(dcir, pair):
    """A plan whose literals are hoisted slots runs with ``expr_params``
    bound (the normalized-plan path) and agrees with the reference."""
    from repro.study import PlanBuilder as RBuilder
    from repro.study import assign_engines as r_assign
    from repro.study import execute as r_execute
    from repro.study import optimize as r_optimize
    from repro.study.expr import HoistedIsIn, HoistedLit, col
    from repro_torch.study import PlanBuilder, assign_engines, execute, \
        optimize

    eng, peng, r_eng, r_peng = pair
    ref_tables, port_tables = dcir
    e = ((col("execution_date") >= HoistedLit(0))
         & HoistedIsIn(col("prestation_code"), 0, 4, False)).to_param()
    lits = (np.int32(14_600 + 200),)
    vecs = (np.array([1003, 1050, 1001, 1099], np.int32),)

    def plan(B, opt, assign, p_eng, e_eng):
        b = B()
        b.set_output("out", b.predicate(b.scan("ER_PRS"), e))
        return assign(opt(b.build()), predicate_engine=p_eng, engine=e_eng)

    rp = plan(RBuilder, r_optimize, r_assign, r_peng, r_eng)
    pp = plan(PlanBuilder, optimize, assign_engines, peng, eng)
    assert_same_plan(rp, pp)
    want = r_execute(rp, {"ER_PRS": ref_tables["ER_PRS"]}, engine=r_eng,
                     expr_params=(tuple(lits), tuple(vecs)))
    got = execute(pp, {"ER_PRS": port_tables["ER_PRS"]}, engine=eng,
                  expr_params=(lits, vecs))
    i = pp.output_ids["out"]
    assert_same_table(want[i], got[i], "hoisted")
