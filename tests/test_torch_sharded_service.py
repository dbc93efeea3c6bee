"""The sharded cohort-query service (``CohortQueryService(mesh=group)``)
against the reference, at 300 patients on the CPU.

The reference runs once per module in a subprocess on a forced 4-device CPU
mesh (as ``tests/test_distributed.py`` does): its service on a 1-device
mesh over the jobs of ``tests/test_service.py``'s sharded scenario, its
``Study.run(mesh=mesh4)`` of every job's study, and its service on the
4-device mesh, whose plans lose their exchanges (ROADMAP C13).  The port's
ranks run at the same time through ``distributed.launch.spawn`` (gloo, CPU):
``launch.service_rank`` serves the jobs on 4 ranks and on 1, and
``launch.study_rank`` gives the port's own ``Study.run(mesh=group)``.

Held exactly: a world-1 group against the reference's 1-device-mesh
service (every ticket's events at every slot, words, counts, cohorts, flow,
FlatteningStats, the log without ``ts``, the plan; runner, hit and miss
counts), synchronous and pipelined; 4 ranks against the reference's
``Study.run(mesh=mesh4)`` and the port's ``Study.run(mesh=group)`` (every
rank gathers the same whole result, and holds no more than its block); one
runner a shape, repeat hits, equal hit and miss counts on every rank and in
both modes; eviction and invalidation on every rank; a featurizing query
served pipelined; ranks that disagree raise instead of hanging.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.data.synthetic import SyntheticConfig, generate_dcir
from repro_torch.core import DCIR_SCHEMA, drug_dispenses, medical_acts_dcir
from repro_torch.distributed import launch
from repro_torch.study import Study, col
from test_torch_distributed import assert_same_summary
from test_torch_service import _star

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
N_PAT = 300
N_SHARDS = 4
CODES_A = list(range(100, 140))
CODES_B = list(range(60, 100))
TIMEOUT = 300
MODES = {"sync": {"pipeline": False}, "pipelined": {"pipeline": True}}
SMALL_BUDGET = 1_000_000     # two or three of the global cut tables

REFERENCE = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.core import (ColumnarTable, DCIR_SCHEMA, drug_dispenses,
                            medical_acts_dcir)
    from repro.study import CohortQueryService, ServiceConfig, Study, col

    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    N = inp["n_patients"]
    A, B = inp["codes"]

    def table(t):
        return ColumnarTable({k: jnp.asarray(v)
                              for k, v in t["columns"].items()},
                             jnp.asarray(t["valid"]), jnp.int32(t["count"]),
                             t["capacity"])

    def host(t):
        return {"columns": {k: np.asarray(v) for k, v in t.columns.items()},
                "valid": np.asarray(t.valid), "count": int(t.count),
                "capacity": t.capacity}

    def summary(r):
        return {"events": {k: host(t) for k, t in r.events.items()},
                "cohorts": {k: {"subjects": np.asarray(c.subjects),
                                "description": c.description,
                                "count": c.subject_count()}
                            for k, c in r.cohorts.items()},
                "flow": r.flow.flowchart() if r.flow is not None else None,
                "flatten_stats": r.flatten_stats,
                "log": [{k: v for k, v in e.items() if k != "ts"}
                        for e in r.log.entries],
                "plan": [(n.op, n.inputs, dict(n.params))
                         for n in r.plan.nodes]}

    def study(threshold, codes):
        s = Study(n_patients=N)
        s.flatten(DCIR_SCHEMA)
        s.extract(drug_dispenses(codes=codes), name="drugs")
        s.extract(medical_acts_dcir(), name="acts")
        s.filter("acts", col("value") >= threshold, name="acts_hi")
        s.cohort("base", "drugs")
        s.cohort("final", "base & acts_hi")
        return s

    def other_shape(codes):
        s = Study(n_patients=N)
        s.flatten(DCIR_SCHEMA)
        s.extract(drug_dispenses(codes=codes), name="drugs")
        s.cohort("exposed", "drugs")
        return s

    def quickstart():
        return (Study(n_patients=N).flatten(DCIR_SCHEMA)
                .extract(drug_dispenses(), name="drug_purchases")
                .extract(medical_acts_dcir(codes=list(range(30))),
                         name="acts")
                .patients("IR_BEN")
                .cohort("base", "extract_patients")
                .cohort("drugged", "drug_purchases")
                .cohort("final", "drugged & base - acts")
                .flow("base", "drugged", "final"))

    star = {k: table(t) for k, t in inp["star"].items()}
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("data",))
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("data",))
    # tests/test_service.py's sharded scenario
    jobs = [("a", study(100, A)), ("b", study(500, B)),
            ("c", study(100, A)), ("a", other_shape(B))]
    out = {"service": {}}
    for pipeline in (False, True):
        svc = CohortQueryService(dict(star), mesh=mesh1,
                                 config=ServiceConfig(pipeline=pipeline))
        tickets = [svc.submit(s, tenant=t) for t, s in jobs]
        svc.drain()
        st = svc.stats
        out["service"][pipeline] = {
            "tickets": [{"status": t.status, "cache_hits": t.cache_hits,
                         "cache_misses": t.cache_misses,
                         "compiled": t.compiled,
                         "summary": summary(t.result)} for t in tickets],
            "counts": (st.compile_count, st.cache_hits, st.cache_misses,
                       st.cache_evictions, st.cache_entries, st.cache_bytes),
            "demotions": st.demotions}
    studies = {"a100": study(100, A), "b500": study(500, B),
               "other": other_shape(B), "quickstart": quickstart()}
    out["runs"] = {k: summary(s.run(dict(star), mesh=mesh4))
                   for k, s in studies.items()}
    # C13: the 4-device service plans for one shard
    svc = CohortQueryService(dict(star), mesh=mesh4)
    t = svc.submit(quickstart())
    svc.drain()
    out["c13"] = {"status": t.status,
                  "exchanges": sum(n.op == "exchange"
                                   for n in t.result.plan.nodes),
                  "counts": {k: int(v.count)
                             for k, v in t.result.events.items()}}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def _study(threshold, codes):
    """``tests/test_service.py``'s shared shape."""
    s = Study(n_patients=N_PAT)
    s.flatten(DCIR_SCHEMA)
    s.extract(drug_dispenses(codes=codes), name="drugs")
    s.extract(medical_acts_dcir(), name="acts")
    s.filter("acts", col("value") >= threshold, name="acts_hi")
    s.cohort("base", "drugs")
    s.cohort("final", "base & acts_hi")
    return s


def _other_shape(codes):
    s = Study(n_patients=N_PAT)
    s.flatten(DCIR_SCHEMA)
    s.extract(drug_dispenses(codes=codes), name="drugs")
    s.cohort("exposed", "drugs")
    return s


def _quickstart():
    return (Study(n_patients=N_PAT).flatten(DCIR_SCHEMA)
            .extract(drug_dispenses(), name="drug_purchases")
            .extract(medical_acts_dcir(codes=list(range(30))), name="acts")
            .patients("IR_BEN")
            .cohort("base", "extract_patients")
            .cohort("drugged", "drug_purchases")
            .cohort("final", "drugged & base - acts")
            .flow("base", "drugged", "final"))


def _featurized():
    return (_quickstart()
            .featurize("X", cohort="final", kind="dense", n_buckets=4,
                       bucket_days=90, n_features=16)
            .featurize("T", cohort="final", kind="tokens", seq_len=16))


# tests/test_service.py's sharded scenario (the third a repeat of the
# first), and on 4 ranks the quickstart besides: the study with most
# exchanges, and a flow
JOBS = [("a", _study(100, CODES_A)), ("b", _study(500, CODES_B)),
        ("c", _study(100, CODES_A)), ("a", _other_shape(CODES_B))]
JOBS4 = JOBS + [("d", _quickstart())]
# the reference's Study.run(mesh=mesh4) summary of each job of JOBS4
JOB_RUNS = ["a100", "b500", "a100", "other", "quickstart"]
SOLO = {"a100": _study(100, CODES_A), "b500": _study(500, CODES_B),
        "other": _other_shape(CODES_B), "quickstart": _quickstart()}
CUDA_JOBS = [("a", _study(100, CODES_A)), ("b", _quickstart())]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, 4 port ranks, 1 port rank), computed side by side: the
    reference's subprocess starts first, then the port's ranks."""
    tmp = tmp_path_factory.mktemp("sharded_service")
    star = _star(generate_dcir(SyntheticConfig(n_patients=N_PAT, seed=13)))
    star2 = _star(generate_dcir(SyntheticConfig(n_patients=N_PAT, seed=99)))
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"n_patients": N_PAT, "star": star,
                     "codes": (CODES_A, CODES_B)}, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "in.pkl"),
         str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        cuda = {"engine": "cuda", "predicate_engine": "cuda",
                "pipeline": True}
        tasks = [(launch.service_rank, (star, JOBS4, MODES[m]))
                 for m in MODES]
        tasks += [(launch.study_rank, (s, star, [("torch", "torch"),
                                                 ("cuda", "cuda")]))
                  for s in SOLO.values()]
        tasks += [(launch.service_rank, (star, CUDA_JOBS, cuda)),
                  (launch.service_rank, (star, JOBS[:2],
                                         {"cache_budget_bytes":
                                          SMALL_BUDGET})),
                  (launch.service_rank, (star, JOBS[:1], {}, "data",
                                         [(star2, JOBS[:1])])),
                  (launch.study_rank, (_study(100, CODES_A), star2,
                                       [("torch", "torch")])),
                  (launch.service_rank, (star, [("f", _featurized())],
                                         MODES["pipelined"])),
                  (launch.study_rank, (_featurized(), star,
                                       [("torch", "torch")]))]
        ranks = launch.spawn(launch.tasks_rank, N_SHARDS, (tasks,),
                             device="cpu", timeout=TIMEOUT,
                             store_dir=str(tmp))
        world1 = launch.spawn(
            launch.tasks_rank, 1,
            ([(launch.service_rank, (star, JOBS, MODES[m])) for m in MODES],),
            device="cpu", timeout=TIMEOUT, store_dir=str(tmp))[0]
        _, err = ref_proc.communicate(timeout=TIMEOUT)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.communicate()
    assert ref_proc.returncode == 0, err[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    names = list(SOLO)
    port = [{"service": {m: r[k][0] for k, m in enumerate(MODES)},
             "solo": {n: r[2 + k] for k, n in enumerate(names)},
             "cuda": r[6][0], "evict": r[7][0], "update": r[8],
             "solo_v2": r[9][0], "featurize": r[10][0],
             "featurize_solo": r[11][0]} for r in ranks]
    return ref, port, {m: world1[k][0] for k, m in enumerate(MODES)}


def _tickets(batch):
    return [(t["status"], t["cache_hits"], t["cache_misses"], t["compiled"])
            for t in batch["tickets"]]


def _assert_held_blocks(ticket, n_shards=N_SHARDS):
    """A rank holds its own block of every event table and nothing more."""
    for name, b in ticket["blocks"].items():
        assert b["capacity"] * n_shards == ticket["events"][name]["capacity"]
        assert b["storage"] <= b["capacity"], name


@pytest.mark.parametrize("mode", list(MODES))
def test_world_one_equals_reference_mesh_service(runs, mode):
    """A 1-rank group serves as the reference's 1-device-mesh service:
    every ticket bit for bit (plan, every slot, words, counts, cohorts,
    FlatteningStats, log), the same runner, hit and miss counts."""
    ref, _, world1 = runs
    want = ref["service"][MODES[mode]["pipeline"]]
    got = world1[mode]
    assert _tickets(got) == [(t["status"], t["cache_hits"], t["cache_misses"],
                              t["compiled"]) for t in want["tickets"]]
    for t, w in zip(got["tickets"], want["tickets"]):
        assert_same_summary(w["summary"], t)
        _assert_held_blocks(t, 1)
    st = got["stats"]
    assert (st["compile_count"], st["cache_hits"], st["cache_misses"],
            st["cache_evictions"], st["cache_entries"],
            st["cache_bytes"]) == want["counts"]
    assert st["compile_count"] == 2 and st["demotions"] == 0
    assert got["tickets"][2]["cache_misses"] == 0
    assert got["tickets"][2]["cache_hits"] == \
        got["tickets"][0]["cache_misses"]


@pytest.mark.parametrize("mode", list(MODES))
def test_four_ranks_equal_reference_sharded_runs(runs, mode):
    """On 4 ranks every served ticket equals the reference's
    ``Study.run(mesh=mesh4)`` of its study: every rank gathers the same
    whole result (every slot, words, counts, FlatteningStats with the
    exchanges', cohort words, flow, log, plan)."""
    ref, port, _ = runs
    for rank in port:
        batch = rank["service"][mode]
        for t, run in zip(batch["tickets"], JOB_RUNS):
            assert t["status"] == "done", t["error"]
            assert_same_summary(ref["runs"][run], t)
    exchanges = [n for n in port[0]["service"][mode]["tickets"][4]["plan"]
                 .nodes if n.op == "exchange"]
    assert len(exchanges) == 5


@pytest.mark.parametrize("engines", ["torch", "cuda"])
def test_four_ranks_equal_port_sharded_runs(runs, engines):
    """Served on 4 ranks under either engine pair, each ticket equals the
    port's own ``Study.run(mesh=group)``, its FlatteningStats and log too,
    and a rank holds no more of an output than its block."""
    _, port, _ = runs
    k = ("torch", "cuda").index(engines)
    for rank in port:
        if engines == "torch":
            served = zip(rank["service"]["pipelined"]["tickets"], JOB_RUNS)
        else:
            served = zip(rank["cuda"]["tickets"], ("a100", "quickstart"))
        for t, run in served:
            want = rank["solo"][run][k]
            assert t["status"] == "done", t["error"]
            assert t["log"] == want["log"]
            assert [(n.op, n.inputs, n.params) for n in t["plan"].nodes] == \
                [(n.op, n.inputs, n.params) for n in want["plan"].nodes]
            for name, w in want["events"].items():
                g = t["events"][name]
                assert g["capacity"] == w["capacity"]
                assert g["count"] == w["count"]
                np.testing.assert_array_equal(g["valid"], w["valid"])
                for c, v in w["columns"].items():
                    np.testing.assert_array_equal(g["columns"][c].view(
                        np.int32), v.view(np.int32), err_msg=f"{name}.{c}")
            assert t["flatten_stats"] == want["flatten_stats"]
            assert t["flow"] == want["flow"]
            for name, c in want["cohorts"].items():
                np.testing.assert_array_equal(t["cohorts"][name]["subjects"],
                                              c["subjects"], err_msg=name)
            assert t["blocks"] == want["blocks"]
            _assert_held_blocks(t)


def test_one_runner_a_shape_and_repeat_hits(runs):
    """Three shapes build three runners; the repeat query hits every cut
    the first one inserted; hit and miss counts are equal on every rank and
    between the modes, and every rank ends with the same cache."""
    _, port, _ = runs
    first = port[0]["service"]["sync"]
    for rank in port:
        for mode in MODES:
            batch = rank["service"][mode]
            assert _tickets(batch) == _tickets(first)
            assert batch["stats"]["compile_count"] == 3
            assert batch["stats"]["demotions"] == 0
            assert batch["cache_entries"] == first["cache_entries"] > 0
            for key in ("cache_hits", "cache_misses", "cache_bytes"):
                assert batch["stats"][key] == first["stats"][key]
    t = first["tickets"]
    assert t[0]["cache_hits"] == 0 and t[0]["cache_misses"] > 0
    assert t[2]["cache_misses"] == 0 and t[2]["cache_hits"] == \
        t[0]["cache_misses"]
    assert [x["compiled"] for x in t] == [True, False, False, True, True]
    # the flatten's cut nodes and the extractors' masks are shared
    assert {"lookup_join", "fused_mask"} <= set(t[2]["hit_ops"])


def test_eviction_agrees_on_every_rank(runs):
    """Under a budget smaller than one query's cuts, every rank evicts the
    same entries and the results stay those of the sharded runs."""
    ref, port, _ = runs
    first = port[0]["evict"]
    assert first["stats"]["cache_evictions"] > 0
    assert first["stats"]["cache_bytes"] <= SMALL_BUDGET
    for rank in port:
        b = rank["evict"]
        assert _tickets(b) == _tickets(first)
        assert b["stats"]["cache_evictions"] == \
            first["stats"]["cache_evictions"]
        assert b["cache_entries"] == first["cache_entries"] == \
            b["stats"]["cache_entries"]
        for t, run in zip(b["tickets"], ("a100", "b500")):
            assert_same_summary(ref["runs"][run], t)


def test_update_tables_invalidates_on_every_rank(runs):
    """``update_tables`` bumps the version and drops the cache and the
    runners on every rank, as in the reference: the same query builds its
    runner again, misses every cut and equals the sharded run over the new
    star."""
    _, port, _ = runs
    for rank in port:
        before, after = rank["update"]
        assert after["stats"]["table_version"] == 1
        (t0,), (t1,) = before["tickets"], after["tickets"]
        assert t1["cache_hits"] == 0
        assert t1["cache_misses"] == t0["cache_misses"] > 0
        assert t1["compiled"]
        want = rank["solo_v2"]
        assert t1["log"] == want["log"]
        assert t1["flatten_stats"] == want["flatten_stats"]
        for name, w in want["events"].items():
            assert t1["events"][name]["count"] == w["count"]
            np.testing.assert_array_equal(t1["events"][name]["valid"],
                                          w["valid"])


def test_featurize_served_pipelined_equals_sharded_run(runs):
    """A featurizing ticket (its cohort's events are gathered) served
    pipelined on 4 ranks equals ``Study.run(mesh=group)``: features, their
    checks, cohorts, flow and log."""
    _, port, _ = runs
    for rank in port:
        (t,) = rank["featurize"]["tickets"]
        want = rank["featurize_solo"]
        assert t["status"] == "done", t["error"]
        assert t["feature_checks"] == want["feature_checks"]
        np.testing.assert_array_equal(t["features"]["X"],
                                      want["features"]["X"])
        for g, w in zip(t["features"]["T"], want["features"]["T"]):
            np.testing.assert_array_equal(g, w)
        assert t["log"] == want["log"]
        assert t["flow"] == want["flow"]
        assert t["cohorts"]["final"]["count"] == \
            want["cohorts"]["final"]["count"] > 0


def test_reference_mesh_service_drops_exchanges_c13(runs):
    """ROADMAP C13, pinned: the reference's service on a 4-device mesh
    plans for one shard (no exchange) and loses rows against its own
    ``Study.run(mesh=mesh4)``; the port's 4-rank service keeps the
    exchanges and equals that run."""
    ref, port, _ = runs
    c13 = ref["c13"]
    want = ref["runs"]["quickstart"]["events"]["drug_purchases"]["count"]
    assert c13["status"] == "done" and c13["exchanges"] == 0
    assert c13["counts"]["drug_purchases"] != want
    got = port[0]["service"]["sync"]["tickets"][4]
    assert got["events"]["drug_purchases"]["count"] == want


def test_ranks_that_disagree_fail_the_ticket_on_every_rank(tmp_path):
    """Ranks submitting different literals: the agreement on the ticket
    raises on every rank before any collective of its run, so the ticket
    fails everywhere (naming the disagreement) and the next one, the same
    on every rank, is served."""
    star = _star(generate_dcir(SyntheticConfig(n_patients=64, seed=3)))
    same = ("b", _other_shape(CODES_A))
    jobs = {0: [("a", _other_shape(CODES_A)), same],
            1: [("a", _other_shape(CODES_B)), same]}
    ranks = launch.spawn(launch.service_rank, 2, (star, jobs, {}),
                         device="cpu", timeout=120, store_dir=str(tmp_path))
    for (batch,) in ranks:
        bad, good = batch["tickets"]
        assert bad["status"] == "failed"
        assert "disagree with rank 0 on ticket 0" in bad["error"]
        assert good["status"] == "done", good["error"]
