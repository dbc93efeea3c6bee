"""The port's cohort-query service (``repro_torch.study.service``) against
the reference's, at 300 patients on the CPU.

The reference's ``tests/test_service.py`` scenarios run through both
services on one numpy-seeded DCIR star: every port ticket must equal the
reference ticket (``results_equal`` with ``layout=True``: raw columns and
uint32-viewed validity words, cohort words, flow, features) and the port's
solo ``Study.run`` (plus FlatteningStats), its OperationLog must equal the
reference ticket's (the reference's local path records no plan entries,
ROADMAP C12), with equal compile, hit and miss counts, pipelined and
synchronous; eviction under a budget, table-version invalidation, queue
rejection, ``submit_spec`` wire payloads, admission-time rejection, the
demotion audit, ``drain(on_done=)`` and ``from_npz_dir``.  The sharded
service is ``tests/test_torch_sharded_service.py``.
"""
import json
import random

import numpy as np
import pytest

from repro.core import DCIR_SCHEMA as R_DCIR
from repro.core import drug_dispenses as r_drugs
from repro.core import medical_acts_dcir as r_acts
from repro.data.synthetic import SyntheticConfig, generate_dcir
from repro.study import CohortQueryService as RService
from repro.study import ServiceConfig as RConfig
from repro.study import Study as RStudy
from repro.study import col as r_col
from repro.study import spec_from_study as r_spec_from_study
from repro_torch.core import DCIR_SCHEMA, drug_dispenses, medical_acts_dcir
from repro_torch.interop import tables_from_numpy
from repro_torch.study import (CohortQueryService, ServiceConfig, Study, col,
                               spec_from_study)
from repro_torch.study.fuzz import gen_valid_spec, results_equal
from test_torch_study import _map_engines

N_PAT = 300
CODES_A = list(range(100, 140))
CODES_B = list(range(60, 100))
PORT = (Study, DCIR_SCHEMA, drug_dispenses, medical_acts_dcir, col)
REF = (RStudy, R_DCIR, r_drugs, r_acts, r_col)


def _star(ref_tables) -> dict:
    return {name: {"columns": {k: np.asarray(v) for k, v in t.columns.items()},
                   "valid": np.asarray(t.valid), "count": int(t.count),
                   "capacity": t.capacity}
            for name, t in ref_tables.items()}


@pytest.fixture(scope="module")
def dcir():
    ref = generate_dcir(SyntheticConfig(n_patients=N_PAT, seed=13))
    return ref, tables_from_numpy(_star(ref), device="cpu")


def _study(pkg, threshold, codes):
    """The reference test's shared shape: flatten -> whitelist extract ->
    threshold filter -> cohort algebra."""
    S, schema, drugs, acts, c = pkg
    s = S(n_patients=N_PAT)
    s.flatten(schema)
    s.extract(drugs(codes=codes), name="drugs")
    s.extract(acts(), name="acts")
    s.filter("acts", c("value") >= threshold, name="acts_hi")
    s.cohort("base", "drugs")
    s.cohort("final", "base & acts_hi")
    return s


def _other_shape(pkg, codes):
    S, schema, drugs, _, _ = pkg
    s = S(n_patients=N_PAT)
    s.flatten(schema)
    s.extract(drugs(codes=codes), name="drugs")
    s.cohort("exposed", "drugs")
    return s


def _log(result, ref: bool = False):
    """A result's OperationLog without ``ts``; a reference's with its
    engines named as the port names them."""
    return [{k: (_map_engines(v) if ref and k == "params" else v)
             for k, v in e.items() if k != "ts"} for e in result.log.entries]


def _assert_solo(port_tables, study, result, ref_result):
    """A served result equals the port's solo run (everything
    ``results_equal`` compares, FlatteningStats) and its log equals the
    reference ticket's."""
    solo = study.run(dict(port_tables), device="cpu")
    assert results_equal(solo, result) is None
    assert solo.flatten_stats == result.flatten_stats
    assert _log(result) == _log(ref_result, ref=True)


def _counts(svc):
    s = svc.stats
    return (s.compile_count, s.cache_hits, s.cache_misses,
            s.cache_evictions, s.cache_entries, s.cache_bytes)


def _services(dcir, **cfg):
    ref_tables, port_tables = dcir
    return (CohortQueryService(dict(port_tables), device="cpu",
                               config=ServiceConfig(**cfg)),
            RService(dict(ref_tables), config=RConfig(**cfg)))


def _jobs(pkg):
    return [("alice", _study(pkg, 100, CODES_A)),
            ("bob", _study(pkg, 500, CODES_B)),
            ("carol", _study(pkg, 250, CODES_A)),
            ("alice", _other_shape(pkg, CODES_B))]


# ---------------------------------------------------------------------------
# multi-tenant parity, port against reference, both modes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_multi_tenant_parity_with_reference(dcir, pipeline):
    _, port_tables = dcir
    svc, rsvc = _services(dcir, pipeline=pipeline)
    jobs = _jobs(PORT)
    tickets = [svc.submit(s, tenant=t) for t, s in jobs]
    r_tickets = [rsvc.submit(s, tenant=t) for t, s in _jobs(REF)]
    svc.drain()
    rsvc.drain()
    for (_, study), t, r in zip(jobs, tickets, r_tickets):
        assert t.status == r.status == "done", t.error
        assert results_equal(t.result, r.result) is None
        assert t.result.flatten_stats == r.result.flatten_stats
        assert (t.cache_hits, t.cache_misses, t.compiled) == \
            (r.cache_hits, r.cache_misses, r.compiled)
        _assert_solo(port_tables, study, t.result, r.result)
    assert _counts(svc) == _counts(rsvc)
    assert svc.stats.compile_count == 2 and svc.stats.hit_rate() >= 0.5
    assert svc._sched.inflight() == 0
    assert not svc._pending and not svc._inflight_cuts
    ops = [e["op"] for e in svc.log.entries]
    assert ops.count("service:compile") == 2
    assert sum(op.startswith("service:query:") for op in ops) == 4


def test_async_pipeline_stress_matches_reference(dcir):
    """Three tenants x two shapes through the pipelined service with 4
    slots: every ticket equals its solo run and the reference's ticket;
    the stage accounting is reported as measured."""
    _, port_tables = dcir

    def jobs(pkg):
        out = []
        for q in range(9):
            if q % 3 == 2:
                s = _other_shape(pkg, list(range(60 + q, 100 + q)))
            else:
                s = _study(pkg, 40 + q, list(range(100 + q, 140 + q)))
            out.append((f"t{q % 3}", s))
        return out

    svc, rsvc = _services(dcir, pipeline=True, n_slots=4)
    port_jobs = jobs(PORT)
    tickets = [svc.submit(s, tenant=t) for t, s in port_jobs]
    r_tickets = [rsvc.submit(s, tenant=t) for t, s in jobs(REF)]
    svc.drain()
    rsvc.drain()
    assert svc._sched.inflight() == 0
    for (_, study), t, r in zip(port_jobs, tickets, r_tickets):
        assert t.status == "done", t.error
        assert t.submit_s > 0 and t.realize_s > 0
        assert (t.cache_hits, t.cache_misses) == (r.cache_hits,
                                                  r.cache_misses)
        assert results_equal(t.result, r.result) is None
        _assert_solo(port_tables, study, t.result, r.result)
    assert _counts(svc) == _counts(rsvc)
    snap = svc.stats.snapshot()
    assert snap["queries"] == 9 and snap["compile_count"] == 2
    assert snap["wall_s"] > 0 and snap["overlap_s"] >= 0


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_repeat_query_hits_everywhere(dcir, pipeline):
    """A repeat query from another tenant hits every cut (pipelined: while
    the first copy is still realizing, it waits for the insert)."""
    svc, rsvc = _services(dcir, pipeline=pipeline)
    t1 = svc.submit(_study(PORT, 100, CODES_A), tenant="a")
    t2 = svc.submit(_study(PORT, 100, CODES_A), tenant="b")
    r1 = rsvc.submit(_study(REF, 100, CODES_A), tenant="a")
    r2 = rsvc.submit(_study(REF, 100, CODES_A), tenant="b")
    svc.drain()
    rsvc.drain()
    assert t1.cache_misses > 0 and t1.cache_hits == 0
    assert t2.cache_misses == 0 and t2.cache_hits == t1.cache_misses
    assert not t2.compiled
    assert (t2.cache_hits, t1.cache_misses) == (r2.cache_hits,
                                                r1.cache_misses)
    # the hit cut nodes: the flatten's joins and the extractors' masks
    assert sorted(set(t2.hit_ops)) == ["fused_mask", "key_count",
                                       "lookup_join"]
    assert results_equal(t1.result, t2.result) is None


def test_cache_eviction_under_budget(dcir):
    _, port_tables = dcir
    svc, rsvc = _services(dcir, cache_budget_bytes=200_000)
    r1 = svc.query(_study(PORT, 100, CODES_A), tenant="a")
    r2 = svc.query(_study(PORT, 500, CODES_B), tenant="b")
    w1 = rsvc.query(_study(REF, 100, CODES_A), tenant="a")
    w2 = rsvc.query(_study(REF, 500, CODES_B), tenant="b")
    assert svc.stats.cache_evictions > 0
    assert svc.stats.cache_bytes <= 200_000
    assert svc.stats.cache_entries == len(svc._cache)
    assert _counts(svc) == _counts(rsvc)
    _assert_solo(port_tables, _study(PORT, 100, CODES_A), r1, w1)
    _assert_solo(port_tables, _study(PORT, 500, CODES_B), r2, w2)


def test_table_version_invalidation(dcir):
    ref_v2 = generate_dcir(SyntheticConfig(n_patients=N_PAT, seed=99))
    port_v2 = tables_from_numpy(_star(ref_v2), device="cpu")
    svc, rsvc = _services(dcir)
    svc.query(_study(PORT, 100, CODES_A), tenant="a")
    rsvc.query(_study(REF, 100, CODES_A), tenant="a")
    assert svc.stats.cache_entries > 0
    svc.update_tables(port_v2)
    rsvc.update_tables(ref_v2)
    assert svc.stats.table_version == 1
    assert svc.stats.cache_entries == 0 and svc.stats.cache_bytes == 0
    r = svc.query(_study(PORT, 100, CODES_A), tenant="a")
    want = rsvc.query(_study(REF, 100, CODES_A), tenant="a")
    _assert_solo(port_v2, _study(PORT, 100, CODES_A), r, want)
    assert results_equal(r, want) is None
    assert _counts(svc) == _counts(rsvc)


def test_queue_rejection_and_stats(dcir):
    svc, _ = _services(dcir, max_queue=1)
    s = _study(PORT, 100, CODES_A)
    t1 = svc.submit(s, tenant="a")
    t2 = svc.submit(s, tenant="b")
    assert t1.status == "queued" and t2.status == "rejected"
    assert t2.wire_payload()["errors"][0]["code"] == "SPEC-429"
    svc.drain()
    assert t1.status == "done" and t2.result is None
    assert svc.stats.tenant("b").rejected == 1
    assert svc.stats.tenant("a").completed == 1
    t3 = svc.submit(s, tenant="c")
    svc.drain()
    assert t3.status == "done"


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_drain_hands_each_ticket_over_once(dcir, pipeline):
    """``drain(on_done=)`` sees every ticket it resolves exactly once, on
    the calling thread, and a result let go there is not kept."""
    svc, _ = _services(dcir, pipeline=pipeline, n_slots=2)
    seen = []

    def take(t):
        seen.append((t.seq, t.status, int(t.result.cohorts["final"]
                                          .subject_count())))
        t.result = None

    tickets = [svc.submit(_study(PORT, 100 + 50 * q, CODES_A),
                          tenant=f"t{q}") for q in range(4)]
    svc.drain(on_done=take)
    assert sorted(s for s, _, _ in seen) == [t.seq for t in tickets]
    assert all(st == "done" for _, st, _ in seen)
    assert all(t.result is None for t in tickets)
    assert svc._on_done is None


# ---------------------------------------------------------------------------
# the wire path
# ---------------------------------------------------------------------------
def _wire_study(pkg):
    S, schema, drugs, acts, c = pkg
    return (S(n_patients=N_PAT)
            .flatten(schema)
            .extract(drugs(codes=list(range(80))), name="drugs")
            .extract(acts(), name="acts")
            .filter("acts", c("value") >= 120, name="acts_hi")
            .patients("IR_BEN")
            .cohort("base", "extract_patients")
            .cohort("drugged", "drugs")
            .cohort("final", "(drugged & base) - acts_hi")
            .flow("base", "drugged", "final"))


def test_submit_spec_parity_and_payloads(dcir):
    _, port_tables = dcir
    spec = json.loads(json.dumps(spec_from_study(_wire_study(PORT))))
    assert spec == r_spec_from_study(_wire_study(REF))
    py_svc, _ = _services(dcir)
    t_py = py_svc.submit(_wire_study(PORT))
    py_svc.drain()
    wire_svc, rsvc = _services(dcir)
    t_wire = wire_svc.submit_spec(spec)
    r_wire = rsvc.submit_spec(spec)
    wire_svc.drain()
    rsvc.drain()
    assert t_py.status == t_wire.status == "done", (t_py.error, t_wire.error)
    assert results_equal(t_py.result, t_wire.result) is None
    assert (t_wire.cache_hits, t_wire.cache_misses) == \
        (t_py.cache_hits, t_py.cache_misses)
    assert wire_svc.stats.compile_count == py_svc.stats.compile_count
    _assert_solo(port_tables, _wire_study(PORT), t_wire.result,
                 r_wire.result)
    payload = t_wire.wire_payload()
    assert payload == r_wire.wire_payload()
    assert payload["flow"] == [r["subjects"]
                               for r in t_py.result.flow.flowchart()]
    json.dumps(payload)


def test_submit_spec_structured_rejections(dcir):
    ref_tables, _ = dcir
    svc, rsvc = _services(dcir)
    spec = gen_valid_spec(random.Random(5))
    spec["cohorts"]["bad"] = "base & ("
    where = {"op": "cmp", "cmp": "<", "lhs": {"op": "col", "name": "start"},
             "rhs": {"op": "lit", "value": 1}}
    unhashable = {"spec_version": 1, "n_patients": 4,
                  "concepts": [{"kind": "filter", "source": ["a"],
                                "where": where}]}
    for s in (spec, unhashable):
        t = svc.submit_spec(s, tenant="t1")
        r = rsvc.submit_spec(s, tenant="t1")
        assert t.status == "invalid"
        assert t.wire_payload() == r.wire_payload()
        assert "Traceback" not in json.dumps(t.wire_payload())
    assert any(e["code"] == "SPEC-012"
               for e in svc.submit_spec(spec).wire_payload()["errors"])
    assert svc.stats.plans_rejected == 3
    assert any(e["op"] == "service:invalid:t1" for e in svc.log.entries)
    assert svc.step() == 0                  # no queue slot was taken


def test_admission_rejects_a_contradiction(dcir):
    """An always-false filter (SP003) never reaches a runner: the Python
    ticket is ``invalid``, the wire ticket renders SP003."""
    svc, rsvc = _services(dcir)

    def bad(pkg):
        S, schema, _, acts, c = pkg
        return (S(n_patients=N_PAT).flatten(schema)
                .extract(acts(), name="acts")
                .filter("acts", (c("value") < 3) & (c("value") > 5),
                        name="never")
                .cohort("bad", "never"))

    t = svc.submit(bad(PORT), tenant="x")
    w = svc.submit_spec(spec_from_study(bad(PORT)), tenant="x")
    r = rsvc.submit_spec(r_spec_from_study(bad(REF)), tenant="x")
    svc.drain()
    rsvc.drain()
    assert t.status == w.status == "invalid"
    assert svc.stats.plans_rejected == 2 and svc.stats.compile_count == 0
    assert w.wire_payload() == r.wire_payload()
    assert "SP003" in {e["code"] for e in w.wire_payload()["errors"]}


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_served_log_equals_the_reference_ticket_log(dcir, pipeline):
    """C12: a locally served result's OperationLog is the reference
    ticket's: the flow entries realization writes and no plan entry,
    where the solo run's log also holds the plan's entries."""
    _, port_tables = dcir
    svc, rsvc = _services(dcir, pipeline=pipeline)
    got = svc.query(_wire_study(PORT), tenant="a")
    want = rsvc.query(_wire_study(REF), tenant="a")
    assert _log(got) == _log(want, ref=True)
    assert [e["op"] for e in _log(got)] == ["flow:base", "flow:drugged",
                                            "flow:final"]
    solo = _wire_study(PORT).run(dict(port_tables), device="cpu")
    assert any(e["op"].startswith("plan:") for e in solo.log.entries)


# ---------------------------------------------------------------------------
# residency, the demotion audit
# ---------------------------------------------------------------------------
def test_from_npz_dir(dcir, tmp_path):
    from repro_torch.data import save_star

    _, port_tables = dcir
    save_star(port_tables, str(tmp_path / "star"))
    svc = CohortQueryService.from_npz_dir(str(tmp_path / "star"),
                                          device="cpu")
    assert svc.device.type == "cpu"
    r = svc.query(_study(PORT, 100, CODES_A))
    want = _services(dcir)[1].query(_study(REF, 100, CODES_A))
    _assert_solo(port_tables, _study(PORT, 100, CODES_A), r, want)
    (load,) = [e for e in svc.log.entries if e["op"] == "service:load_tables"]
    assert load["params"]["resident_bytes"] > 0


def test_demotion_audit_names_the_port_engines(dcir):
    from repro_torch.kernels.predicate import MAX_ISIN_VALUES
    from repro_torch.study import PlanBuilder, QueryTicket, normalize
    from repro_torch.study.expr import as_param

    b = PlanBuilder()
    m = b.add("predicate", (b.scan("T"),),
              expr=as_param(col("x").isin(range(MAX_ISIN_VALUES + 1))),
              engine="cuda", bitset_block=1024, bitset_word="uint32")
    b.set_output("out", b.compact(m))
    nplan = normalize(b.build())
    svc, _ = _services(dcir)
    svc._audit_demotions(QueryTicket(tenant="t", study=None), nplan)
    assert svc.stats.demotions == len(nplan.demoted) == 1
    assert svc.stats.tenant("t").demoted == 1
    (e,) = [e for e in svc.log.entries if e["op"] == "service:demote:t"]
    assert e["params"]["engine"] == "cuda->torch"

