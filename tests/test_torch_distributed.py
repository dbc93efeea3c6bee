"""Sharded study execution — the port's process groups against the
reference's device mesh.

The reference runs once per module in a subprocess on a forced 4-device CPU
mesh (as ``tests/test_distributed.py`` does); the port runs 4 gloo ranks on
the CPU through ``repro_torch.distributed.launch``, at the same time.  One
numpy-seeded DCIR star feeds both.  Compared exactly under both engine
pairs: the quickstart plan through ``Study.run(mesh=...)`` (every event
table including the slots past the count, validity words, counts, the
FlatteningStats of every exchange and join with overflow and key sums,
cohort words, flow, the OperationLog without ``ts``, the plan),
``distributed_flatten`` and ``exposures_sharded``; also with
``axis_name=None``, since the group alone makes the exchanges real.  Table
outputs stay on their ranks (``ShardedTable``): every comparison gathers
them explicitly (``launch.result_to_numpy``), and a rank holds no more than
its own block when ``run`` returns.  A world-1 group matches the mesh-less
run in everything but the capacities its padding to 32 rows changes (as
the reference's 1-device mesh does).  ``spawn`` runs its ranks on the card
unless asked for the CPU.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.core import DCIR_SCHEMA, NULL_INT, drug_dispenses, \
    medical_acts_dcir
from repro_torch.data import synthetic as psyn
from repro_torch.distributed import launch
from repro_torch.interop import tables_from_numpy, tables_to_numpy
from repro_torch.kernels.hash_partition import hash_dest
from repro_torch.study import Study
from test_torch_study import _map_engines

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
N_PATIENTS = 300
N_SHARDS = 4
# (port engine, port predicate engine, reference engine, its predicate)
ENGINE_PAIRS = [("torch", "torch", "xla", "jnp"),
                ("cuda", "cuda", "pallas", "pallas")]
EXPOSURE_KW = {"purview_days": 60}
TIMEOUT = 300

REFERENCE = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.core import (ColumnarTable, DCIR_SCHEMA, distributed_flatten,
                            drug_dispenses, exposures_sharded,
                            medical_acts_dcir)
    from repro.study import Study

    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    N = inp["n_patients"]

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
                "flow": r.flow.flowchart(),
                "flatten_stats": r.flatten_stats,
                "log": [{k: v for k, v in e.items() if k != "ts"}
                        for e in r.log.entries],
                "plan": [(n.op, n.inputs, dict(n.params))
                         for n in r.plan.nodes]}

    star = {k: table(t) for k, t in inp["star"].items()}
    study = (Study(n_patients=N).flatten(DCIR_SCHEMA)
             .extract(drug_dispenses(), name="drug_purchases")
             .extract(medical_acts_dcir(codes=list(range(30))), name="acts")
             .patients("IR_BEN")
             .cohort("base", "extract_patients")
             .cohort("drugged", "drug_purchases")
             .cohort("final", "drugged & base - acts")
             .flow("base", "drugged", "final"))
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("data",))
    out = {"study": {e: summary(study.run(dict(star), mesh=mesh4, engine=e,
                                          predicate_engine=p))
                     for e, p in (("xla", "jnp"), ("pallas", "pallas"))}}
    flat, ovf = distributed_flatten(DCIR_SCHEMA, dict(star), mesh4)
    out["flat"] = {"flat": host(flat), "overflow": int(ovf)}
    # jit'd: the reference's shard_map dispatches op by op otherwise (~30 s)
    out["exposures"] = host(jax.jit(lambda t: exposures_sharded(
        t, N, mesh4, **inp["exposure_kw"]))(table(inp["drugs"])))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def _quickstart():
    return (Study(n_patients=N_PATIENTS)
            .flatten(DCIR_SCHEMA)
            .extract(drug_dispenses(), name="drug_purchases")
            .extract(medical_acts_dcir(codes=list(range(30))), name="acts")
            .patients("IR_BEN")
            .cohort("base", "extract_patients")
            .cohort("drugged", "drug_purchases")
            .cohort("final", "drugged & base - acts")
            .flow("base", "drugged", "final"))


def _featurized():
    """The quickstart with a dense and a token export of its final cohort:
    a featurize needs the whole events, which it gathers under a mesh."""
    return (_quickstart()
            .featurize("X", cohort="final", kind="dense", n_buckets=4,
                       bucket_days=90, n_features=16)
            .featurize("T", cohort="final", kind="tokens", seq_len=16))


def _patient_partitioned(events, n_shards):
    """The valid rows of a numpy event table laid out as the patient
    exchange leaves them: shard ``s``'s block holds the rows whose patient
    hashes to ``s``, in table order, each block padded with invalid NULL
    rows to one 32-aligned length."""
    import torch

    valid = np.unpackbits(events["valid"].view(np.uint8),
                          bitorder="little")[:events["capacity"]].astype(bool)
    cols = {k: v[valid] for k, v in events["columns"].items()}
    pid = torch.from_numpy(cols["patient_id"])
    dest = hash_dest(pid, torch.ones_like(pid, dtype=torch.bool),
                     n_shards).numpy()
    blocks = [np.flatnonzero(dest == s) for s in range(n_shards)]
    per = -(-max(len(b) for b in blocks) // 32) * 32
    out = {k: [] for k in cols}
    mask = []
    for b in blocks:
        for k, v in cols.items():
            fill = np.full(per - len(b), np.nan if v.dtype == np.float32
                           else NULL_INT, v.dtype)
            out[k].append(np.concatenate([v[b], fill]))
        mask.append(np.arange(per) < len(b))
    mask = np.concatenate(mask)
    words = np.packbits(mask, bitorder="little").view(np.uint32)
    return {"columns": {k: np.concatenate(v) for k, v in out.items()},
            "valid": words, "count": int(mask.sum()),
            "capacity": len(mask)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, port) results, computed side by side: the reference's
    subprocess starts first, then the port's ranks."""
    tmp = tmp_path_factory.mktemp("distributed")
    star = tables_to_numpy(psyn.generate_dcir(
        psyn.SyntheticConfig(n_patients=N_PATIENTS, seed=0), device="cpu"))
    single = _quickstart().run(tables_from_numpy(star, device="cpu"),
                               device="cpu")
    drugs = _patient_partitioned(
        tables_to_numpy(single.events)["drug_purchases"], N_SHARDS)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"n_patients": N_PATIENTS, "star": star, "drugs": drugs,
                     "exposure_kw": EXPOSURE_KW}, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "in.pkl"),
         str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        study = _quickstart()
        tasks = [(launch.study_rank,
                  (study, star, [p[:2] for p in ENGINE_PAIRS]))]
        tasks += [(launch.flatten_rank, (DCIR_SCHEMA, star, e))
                  for e in ("torch", "cuda")]
        tasks += [(launch.exposures_rank,
                   (drugs, N_PATIENTS, dict(EXPOSURE_KW, engine=e)))
                  for e in ("torch", "cuda")]
        # axis_name=None: the group alone makes the exchanges real
        tasks += [(launch.study_rank, (study, star, [("torch", "torch")],
                                       None))]
        tasks += [(launch.study_rank, (_featurized(), star,
                                       [("cuda", "cuda")]))]
        ranks = launch.spawn(launch.tasks_rank, N_SHARDS, (tasks,),
                             device="cpu", timeout=TIMEOUT, store_dir=str(tmp))
        world1 = launch.spawn(launch.study_rank, 1,
                              (study, star, [("torch", "torch")]),
                              device="cpu", timeout=TIMEOUT,
                              store_dir=str(tmp))[0]
        _, err = ref_proc.communicate(timeout=TIMEOUT)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.communicate()
    assert ref_proc.returncode == 0, err[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    return ref, ranks, single, world1


def assert_same_np_table(want, got, what):
    assert got["capacity"] == want["capacity"], what
    assert got["count"] == want["count"], what
    np.testing.assert_array_equal(got["valid"], want["valid"], err_msg=what)
    assert sorted(got["columns"]) == sorted(want["columns"]), what
    for k, v in want["columns"].items():
        g = got["columns"][k]
        assert g.dtype == v.dtype, f"{what}.{k}"
        np.testing.assert_array_equal(g.view(np.int32), v.view(np.int32),
                                      err_msg=f"{what}.{k}")


def assert_same_summary(want, got):
    for rn, (pop, pin, pparams) in zip(want["plan"],
                                       ((n.op, n.inputs, dict(n.params))
                                        for n in got["plan"].nodes)):
        assert (rn[0], rn[1]) == (pop, pin)
        assert _map_engines(rn[2]) == pparams, rn[0]
    assert len(want["plan"]) == len(got["plan"].nodes)
    assert sorted(want["events"]) == sorted(got["events"])
    for name in want["events"]:
        assert_same_np_table(want["events"][name], got["events"][name], name)
    assert got["flatten_stats"] == want["flatten_stats"]
    assert sorted(got["cohorts"]) == sorted(want["cohorts"])
    for name, c in want["cohorts"].items():
        g = got["cohorts"][name]
        np.testing.assert_array_equal(g["subjects"].view(np.uint32),
                                      c["subjects"], err_msg=name)
        assert (g["description"], g["count"]) == (c["description"],
                                                  c["count"])
    assert got["flow"] == want["flow"]
    assert got["log"] == [{k: (_map_engines(v) if k == "params" else v)
                           for k, v in e.items()} for e in want["log"]]


@pytest.mark.parametrize("pair", ENGINE_PAIRS, ids=["torch-xla",
                                                    "cuda-pallas"])
def test_sharded_quickstart_bit_identical(runs, pair):
    ref, ranks, _, _ = runs
    k = ENGINE_PAIRS.index(pair)
    want = ref["study"][pair[2]]
    for rank in ranks:
        # each rank gathers the blocks of every rank: the same whole result
        assert_same_summary(want, rank[0][k])


def test_sharded_plan_runs_five_exchanges_without_overflow(runs):
    ref, ranks, _, _ = runs
    got = ranks[0][0][0]
    ex = [i for i, n in enumerate(got["plan"].nodes) if n.op == "exchange"]
    assert [got["plan"].nodes[i].get("key") for i in ex] == \
        ["flow_id"] * 3 + ["patient_id"] * 2
    assert all(got["flatten_stats"][i]["overflow"] == 0 for i in ex)
    # per exchange one all-to-all per column (the key at least) and one for
    # the validity, one sum of the cohort words and one of the counts and
    # stats; no table output is gathered by the run itself
    c = got["comm"]
    assert c["all_to_all"] >= 2 * len(ex)
    assert (c["all_reduce"], c["all_gather"]) == (2, 0)
    assert c["collectives"] == c["all_to_all"] + 2
    assert c["staged_bytes"] == 0        # CPU tensors: no staging
    assert got["cohorts"]["final"]["count"] == \
        ref["study"]["xla"]["cohorts"]["final"]["count"] > 0


@pytest.mark.parametrize("pair", ENGINE_PAIRS, ids=["torch-xla",
                                                    "cuda-pallas"])
def test_sharded_outputs_stay_on_their_ranks(runs, pair):
    """When ``Study.run(mesh=...)`` returns, each rank holds its own block
    of every table output and nothing more: a quarter of the reference's
    global capacity, no tensor storage past it, and the blocks' counts sum
    to the reference's count."""
    ref, ranks, _, _ = runs
    k = ENGINE_PAIRS.index(pair)
    whole = ref["study"][pair[2]]["events"]
    for name, t in whole.items():
        blocks = [rank[0][k]["blocks"][name] for rank in ranks]
        assert sum(b["count"] for b in blocks) == t["count"], name
        for b in blocks:
            assert b["capacity"] * N_SHARDS == t["capacity"], name
            assert b["storage"] <= b["capacity"], name


def test_sharded_featurize_equals_single_card(runs):
    """Dense and token exports under the 4-rank group (each featurize
    gathers its cohort's events) equal the mesh-less run's on every rank,
    checks included."""
    _, ranks, _, _ = runs
    star = tables_to_numpy(psyn.generate_dcir(
        psyn.SyntheticConfig(n_patients=N_PATIENTS, seed=0), device="cpu"))
    single = _featurized().run(tables_from_numpy(star, device="cpu"),
                               device="cpu")
    for rank in ranks:
        got = rank[6][0]
        assert got["feature_checks"] == single.feature_checks
        np.testing.assert_array_equal(got["features"]["X"],
                                      single.features["X"].numpy())
        for g, w in zip(got["features"]["T"], single.features["T"]):
            np.testing.assert_array_equal(g, w.numpy())
        assert got["cohorts"]["final"]["count"] > 0


def test_sharded_equals_single_card_as_multisets(runs):
    _, ranks, single, _ = runs
    got = ranks[0][0][0]
    for name, t in tables_to_numpy(single.events).items():
        g = got["events"][name]
        rows = []
        for tab in (t, g):
            valid = np.unpackbits(tab["valid"].view(np.uint8),
                                  bitorder="little")[:tab["capacity"]]
            cols = [tab["columns"][k][valid.astype(bool)].view(np.int32)
                    for k in sorted(tab["columns"])]
            rows.append(np.sort(np.rec.fromarrays(cols)))
        np.testing.assert_array_equal(rows[0], rows[1], err_msg=name)
    for name, c in single.cohorts.items():
        np.testing.assert_array_equal(got["cohorts"][name]["subjects"],
                                      c.subjects.numpy(), err_msg=name)
    assert got["flow"] == single.flow.flowchart()
    joins = [{k: v for k, v in d.items()} for _, d in
             sorted(single.flatten_stats.items())]
    assert [d for _, d in sorted(got["flatten_stats"].items())
            if not d["stage"].startswith("exchange")] == joins


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_distributed_flatten_bit_identical(runs, engine):
    ref, ranks, _, _ = runs
    got = ranks[0][1 + ("torch", "cuda").index(engine)]
    assert got["overflow"] == ref["flat"]["overflow"] == 0
    assert_same_np_table(ref["flat"]["flat"], got["flat"], "flat")
    for rank in ranks[1:]:
        assert_same_np_table(got["flat"],
                             rank[1 + ("torch", "cuda").index(engine)]["flat"],
                             "flat on every rank")


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_exposures_sharded_bit_identical(runs, engine):
    ref, ranks, _, _ = runs
    got = ranks[0][3 + ("torch", "cuda").index(engine)]
    assert got["count"] > 0
    assert_same_np_table(ref["exposures"], got, "exposures")


def test_sharded_without_axis_name_still_exchanges(runs):
    ref, ranks, _, _ = runs
    for rank in ranks:
        assert_same_summary(ref["study"]["xla"], rank[5][0])


def test_spawn_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.spawn(launch.study_rank, 1, (None, {}, []), timeout=5)


def test_world_one_group_equals_meshless(runs):
    _, _, single, world1 = runs
    got = world1[0]
    assert [(n.op, n.inputs, n.params) for n in got["plan"].nodes] == \
        [(n.op, n.inputs, n.params) for n in single.plan.nodes]
    assert got["flatten_stats"] == single.flatten_stats
    assert got["flow"] == single.flow.flowchart()
    assert got["log"] == [{k: v for k, v in e.items() if k != "ts"}
                          for e in single.log.entries]
    for name, t in tables_to_numpy(single.events).items():
        g = got["events"][name]
        n = t["count"]
        assert g["count"] == n and g["capacity"] == -(-t["capacity"] // 32) \
            * 32, name
        assert g["valid"][:len(t["valid"])].tolist() == t["valid"].tolist()
        for k, v in t["columns"].items():
            np.testing.assert_array_equal(g["columns"][k][:n].view(np.int32),
                                          v[:n].view(np.int32),
                                          err_msg=f"{name}.{k}")
    for name, c in single.cohorts.items():
        np.testing.assert_array_equal(got["cohorts"][name]["subjects"],
                                      c.subjects.numpy(), err_msg=name)
