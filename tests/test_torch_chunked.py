"""Out-of-core chunked execution in the port, against the port's resident
run and the reference's chunked run.

One numpy-seeded DCIR star (``N_PAT`` patients, as ``tests/test_chunked.py``)
goes through ``repro`` and ``repro_torch`` (CPU, where every kernel wrapper
runs its plain version).  ``run_chunked`` must equal the port's ``Study.run``
bit for bit — valid rows in order, validity words of cohorts, counts,
FlatteningStats, flow and the ``record_plan`` entries of the OperationLog —
and the reference's ``run_chunked``, at chunk capacities 64, 96 and 512
under both engine pairs; plus the branch-aware concat merge, one cached
runner, kill-and-resume, a torn journal tail, a foreign journal, the
chunk-unsafe guard, a doctored manifest, stores and columnar files
interchangeable between the packages, and the mmap pass-through.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core import DCIR_SCHEMA as R_DCIR
from repro.core import drug_dispenses as r_drugs
from repro.core import medical_acts_dcir as r_acts
from repro.data import ChunkStore as RChunkStore
from repro.data import SyntheticConfig, generate_dcir
from repro.data import partition_star as r_partition_star
from repro.data.io import load_columnar as r_load_columnar
from repro.data.io import save_columnar as r_save_columnar
from repro.study import Study as RStudy
from repro.study import col as r_col
from repro_torch.core import DCIR_SCHEMA, drug_dispenses, medical_acts_dcir
from repro_torch.data import (ChunkStore, load_columnar, load_columnar_arrays,
                              load_star, partition_star, save_columnar,
                              save_star)
from repro_torch.data.io import read_columnar_into
from repro_torch.interop import tables_from_numpy
from repro_torch.kernels import ENGINE_NAMES
from repro_torch.study import (ChunkedExecutor, PlanValidationError, Study,
                               clear_jit_cache, col, jit_cache_info)
from repro_torch.study.chunked import _InjectedCrash, chunk_unsafe_ops

N_PAT = 120
# (port engine, port predicate engine, reference engine, reference predicate)
ENGINE_PAIRS = [("torch", "torch", "xla", "jnp"),
                ("cuda", "cuda", "pallas", "pallas")]
PAIR_IDS = ["torch-xla", "cuda-pallas"]


@pytest.fixture(scope="module")
def stars():
    ref = generate_dcir(SyntheticConfig(n_patients=N_PAT,
                                        flows_per_patient=5.0, seed=3))
    star = {name: {"columns": {k: np.asarray(v)
                               for k, v in t.columns.items()},
                   "valid": np.asarray(t.valid), "count": int(t.count),
                   "capacity": t.capacity} for name, t in ref.items()}
    return ref, tables_from_numpy(star, device="cpu")


def _study(S=Study, schema=DCIR_SCHEMA, drugs=drug_dispenses,
           acts=medical_acts_dcir):
    """The quickstart's shape (flatten, two extractors, patients, cohort
    algebra, flow) with a dense featurize."""
    return (S(n_patients=N_PAT)
            .flatten(schema)
            .extract(drugs(), name="drugs")
            .extract(acts(codes=list(range(30))), name="acts")
            .patients("IR_BEN")
            .cohort("base", "extract_patients")
            .cohort("drugged", "drugs")
            .cohort("final", "drugged & base - acts")
            .flow("base", "drugged", "final")
            .featurize("X", cohort="final", kind="dense",
                       n_buckets=12, bucket_days=31, n_features=64))


def _ref_study():
    return _study(RStudy, R_DCIR, r_drugs, r_acts)


def _plan_entries(log, map_engines=False):
    out = []
    for e in log.entries:
        if not e["op"].startswith("plan:"):
            continue
        e = {k: v for k, v in e.items() if k != "ts"}
        if map_engines:
            e["params"] = {k: (ENGINE_NAMES.get(v, v) if k == "engine"
                               else v) for k, v in e["params"].items()}
        out.append(e)
    return out


def _words(w) -> np.ndarray:
    a = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
    return a.view(np.uint32)


def _assert_same(got, want, features=True, log=True):
    """``got`` (a port chunked result) against ``want`` (a port resident
    result or a reference result): valid rows in order, cohort words and
    counts, flow, FlatteningStats, features; with ``log``, the plan
    entries of the OperationLog (engine names mapped for the reference)."""
    assert sorted(got.events) == sorted(want.events)
    for k, t in want.events.items():
        a, b = got.events[k].to_numpy(), t.to_numpy()
        assert sorted(a) == sorted(b), k
        for c in b:
            np.testing.assert_array_equal(a[c], b[c], err_msg=f"{k}.{c}")
        assert int(got.events[k].count) == int(t.count), k
    assert sorted(got.cohorts) == sorted(want.cohorts)
    for k, c in want.cohorts.items():
        np.testing.assert_array_equal(_words(got.cohorts[k].subjects),
                                      _words(c.subjects), err_msg=k)
        assert got.cohorts[k].subject_count() == c.subject_count(), k
    assert got.flatten_stats == want.flatten_stats
    if want.flow is not None:
        assert got.flow.flowchart() == want.flow.flowchart()
    if features:
        for k, f in want.features.items():
            np.testing.assert_array_equal(got.features[k].numpy(),
                                          np.asarray(f), err_msg=k)
        assert got.feature_checks == want.feature_checks
    if log:
        port = isinstance(next(iter(want.cohorts.values())).subjects,
                          torch.Tensor)
        assert _plan_entries(got.log) == _plan_entries(want.log,
                                                       map_engines=not port)


@pytest.mark.parametrize("pair", ENGINE_PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("chunk_capacity", [64, 96, 512])
def test_chunked_matches_resident_and_reference(stars, tmp_path, pair,
                                                chunk_capacity):
    eng, peng, r_eng, r_peng = pair
    ref_tables, port_tables = stars
    res = _study().run(dict(port_tables), engine=eng, predicate_engine=peng,
                       device="cpu")
    store = partition_star(port_tables, str(tmp_path / "store"),
                           source="ER_PRS", chunk_capacity=chunk_capacity)
    assert store.n_chunks == -(-port_tables["ER_PRS"].capacity
                               // chunk_capacity)
    rep = {}
    chk = _study().run_chunked(store, engine=eng, predicate_engine=peng,
                               device="cpu", report_sink=rep)
    assert rep["executed"] == store.n_chunks and rep["resumed"] == 0
    _assert_same(chk, res)
    rstore = RChunkStore(store.dirpath)
    want = _ref_study().run_chunked(rstore, engine=r_eng,
                                    predicate_engine=r_peng)
    _assert_same(chk, want, log=False)


def test_prefetch_off_matches_on(stars, tmp_path):
    _, port_tables = stars
    store = partition_star(port_tables, str(tmp_path / "store"),
                           source="ER_PRS", chunk_capacity=96)
    on = _study().run_chunked(store, engine="cuda", predicate_engine="cuda",
                              device="cpu")
    rep = {}
    off = _study().run_chunked(store, engine="cuda", predicate_engine="cuda",
                               device="cpu", prefetch=False, report_sink=rep)
    assert rep["load_s"] > 0 and rep["exec_s"] > 0
    _assert_same(off, on)


@pytest.mark.parametrize("pair", ENGINE_PAIRS, ids=PAIR_IDS)
def test_chunked_concat_preserves_branch_order(stars, tmp_path, pair):
    """The resident concat lays rows out branch-major ([drugs; acts]) while
    each chunk emits its own [drugs_ci; acts_ci]: the merge slices the
    branches back apart (nested: concat-of-concat flattens the same way)."""
    eng, peng, r_eng, r_peng = pair
    ref_tables, port_tables = stars

    def build(S, schema, drugs, acts, c):
        return (S(n_patients=N_PAT)
                .flatten(schema)
                .extract(drugs(), name="drugs")
                .extract(acts(), name="acts")
                .filter("acts", c("value") >= 100, name="acts_hi")
                .concat("pair", "drugs", "acts")
                .concat("triple", "pair", "acts_hi")
                .patients("IR_BEN")
                .cohort("base", "extract_patients")
                .cohort("hit", "pair")
                .flow("hit", "base"))

    mk = (Study, DCIR_SCHEMA, drug_dispenses, medical_acts_dcir, col)
    res = build(*mk).run(dict(port_tables), engine=eng,
                         predicate_engine=peng, device="cpu")
    store = partition_star(port_tables, str(tmp_path / "store"),
                           source="ER_PRS", chunk_capacity=64)
    assert store.n_chunks > 1
    chk = build(*mk).run_chunked(store, engine=eng, predicate_engine=peng,
                                 device="cpu")
    # valid rows IN ORDER per column: an interleaved merge fails here
    _assert_same(chk, res, features=False, log=False)
    want = build(RStudy, R_DCIR, r_drugs, r_acts, r_col).run_chunked(
        RChunkStore(store.dirpath), engine=r_eng, predicate_engine=r_peng)
    _assert_same(chk, want, features=False, log=False)


def test_one_cached_runner_across_all_chunks(stars, tmp_path):
    _, port_tables = stars
    store = partition_star(port_tables, str(tmp_path / "store"),
                           source="ER_PRS", chunk_capacity=96)
    assert store.n_chunks > 3
    clear_jit_cache()
    rep = {}
    _study().run_chunked(store, engine="cuda", predicate_engine="cuda",
                         device="cpu", report_sink=rep)
    assert rep["executed"] == store.n_chunks
    assert rep["compiles"] == 1
    info = jit_cache_info()
    assert info["compiles"] == 1 and info["hits"] == store.n_chunks - 1


def test_kill_and_resume(stars, tmp_path):
    _, port_tables = stars
    res = _study().run(dict(port_tables), engine="cuda",
                       predicate_engine="cuda", device="cpu")
    store = partition_star(port_tables, str(tmp_path / "store"),
                           source="ER_PRS", chunk_capacity=96)
    ck = str(tmp_path / "ckpt")
    kw = {"engine": "cuda", "predicate_engine": "cuda", "device": "cpu",
          "checkpoint_dir": ck}

    ex = ChunkedExecutor(store, crash_after=2, **kw)
    with pytest.raises(_InjectedCrash):
        ex.run(_study())
    assert ex.report.executed == 2
    lines = [json.loads(ln) for ln in open(os.path.join(ck, "journal.jsonl"))]
    assert lines[0]["kind"] == "header"
    assert [ln["index"] for ln in lines[1:]] == [0, 1]

    # crash again mid-resume: completed chunks are NOT re-executed
    ex2 = ChunkedExecutor(store, crash_after=3, **kw)
    with pytest.raises(_InjectedCrash):
        ex2.run(_study())
    assert ex2.report.resumed == 2 and ex2.report.executed == 3

    ex3 = ChunkedExecutor(store, **kw)
    out = ex3.run(_study())
    assert ex3.report.resumed == 5
    assert ex3.report.executed == store.n_chunks - 5
    _assert_same(out, res)


def test_resume_tolerates_torn_journal_tail(stars, tmp_path):
    """A kill mid-append leaves a torn final journal line; resume keeps
    every completed line before it (one chunk's cost, not a restart), and
    a fully journaled run resumes with nothing to execute."""
    _, port_tables = stars
    store = partition_star(port_tables, str(tmp_path / "store"),
                           source="ER_PRS", chunk_capacity=96)
    ck = str(tmp_path / "ckpt")
    kw = {"engine": "torch", "predicate_engine": "torch", "device": "cpu",
          "checkpoint_dir": ck}
    res = _study().run_chunked(store, **kw)
    jp = os.path.join(ck, "journal.jsonl")
    assert sum(1 for ln in open(jp) if '"chunk"' in ln) == store.n_chunks
    with open(jp, "rb") as f:
        raw = f.read()
    with open(jp, "wb") as f:
        f.write(raw.rstrip(b"\n")[:-7])
    rep = {}
    out = _study().run_chunked(store, report_sink=rep, **kw)
    assert rep["resumed"] == store.n_chunks - 1 and rep["executed"] == 1
    _assert_same(out, res)

    with open(jp, "ab") as f:
        f.write(b'{"kind": "chu')
    rep2 = {}
    out2 = _study().run_chunked(store, report_sink=rep2, **kw)
    assert rep2["resumed"] == store.n_chunks and rep2["executed"] == 0
    _assert_same(out2, res)


def test_resume_ignores_foreign_journal(stars, tmp_path):
    _, port_tables = stars
    store = partition_star(port_tables, str(tmp_path / "store"),
                           source="ER_PRS", chunk_capacity=96)
    ck = str(tmp_path / "ckpt")
    _study().run_chunked(store, checkpoint_dir=ck, device="cpu")
    other = (Study(n_patients=N_PAT)
             .flatten(DCIR_SCHEMA)
             .extract(drug_dispenses().filtered(col("cip13") >= 3),
                      name="drugs")
             .cohort("drugged", "drugs"))
    rep = {}
    out = other.run_chunked(store, checkpoint_dir=ck, report_sink=rep,
                            device="cpu")
    assert rep["resumed"] == 0 and rep["executed"] == store.n_chunks
    _assert_same(out, other.run(dict(port_tables), device="cpu"),
                 features=False)


def test_chunk_unsafe_ops_rejected(stars, tmp_path):
    _, port_tables = stars
    store = partition_star(port_tables, str(tmp_path / "store"),
                           source="ER_PRS", chunk_capacity=96)
    unsafe = (Study(n_patients=N_PAT)
              .flatten(DCIR_SCHEMA)
              .extract(drug_dispenses(), name="drugs")
              .transform("exposures", "drugs", name="exposed",
                         purview_days=60)
              .cohort("exp", "exposed"))
    with pytest.raises(ValueError, match="chunk-unsafe"):
        unsafe.run_chunked(store, device="cpu")
    assert any(op == "transform"
               for _, op in chunk_unsafe_ops(unsafe.plan(), "ER_PRS"))
    ChunkedExecutor(store, allow_unsafe=True, device="cpu").run(unsafe)


def test_doctored_manifest_rejected(stars, tmp_path):
    _, port_tables = stars
    store = partition_star(port_tables, str(tmp_path / "store"),
                           source="ER_PRS", chunk_capacity=96)
    mpath = os.path.join(store.dirpath, "manifest.json")
    doc = json.load(open(mpath))
    doc["chunk_capacity"] = 100
    json.dump(doc, open(mpath, "w"))
    with pytest.raises(ValueError, match="multiple of 32"):
        ChunkedExecutor(ChunkStore(store.dirpath), device="cpu").run(
            _study())


def test_preflight_refuses_error_plans(stars, tmp_path):
    _, port_tables = stars
    store = partition_star(port_tables, str(tmp_path / "store"),
                           source="ER_PRS", chunk_capacity=96)
    bad = (Study(n_patients=N_PAT)
           .flatten(DCIR_SCHEMA)
           .extract(medical_acts_dcir(), name="acts")
           .filter("acts", (col("value") < 3) & (col("value") > 5),
                   name="never")
           .cohort("bad", "never"))
    with pytest.raises(PlanValidationError, match="SP003"):
        bad.run_chunked(store, device="cpu")


def test_partition_rejects_misaligned_capacity(stars, tmp_path):
    _, port_tables = stars
    for cap in (100, 0):
        with pytest.raises(ValueError, match="multiple of 32"):
            partition_star(port_tables, str(tmp_path / "s"),
                           source="ER_PRS", chunk_capacity=cap)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stores_interchangeable(stars, tmp_path, writer):
    """A store written by either package opens in the other with the same
    fingerprint, chunk sha256s and chunk contents; both writers make the
    same store."""
    ref_tables, port_tables = stars
    a = partition_star(port_tables, str(tmp_path / "a"), source="ER_PRS",
                       chunk_capacity=96)
    b = r_partition_star(ref_tables, str(tmp_path / "b"), source="ER_PRS",
                         chunk_capacity=96)
    assert a.fingerprint() == b.fingerprint()
    path = (a if writer == "port" else b).dirpath
    port, ref = ChunkStore(path, verify=True), RChunkStore(path, verify=True)
    assert port.fingerprint() == ref.fingerprint()
    assert [c.sha256 for c in port.manifest.chunks] == \
        [c.sha256 for c in ref.manifest.chunks]
    port.validate()
    for ci in range(port.n_chunks):
        p = port.chunk_table(ci, device="cpu")
        r = ref.chunk_table(ci, verify=True)
        np.testing.assert_array_equal(p.valid.numpy().view(np.uint32),
                                      np.asarray(r.valid))
        for c in r.columns:
            np.testing.assert_array_equal(p.columns[c].numpy(),
                                          np.asarray(r.columns[c]))
    assert sorted(port.resident_tables(device="cpu")) == \
        sorted(ref.resident_tables())


def test_chunk_hash_detects_corruption(stars, tmp_path):
    _, port_tables = stars
    store = partition_star(port_tables, str(tmp_path / "store"),
                           source="ER_PRS", chunk_capacity=96)
    cols, valid = store.load_chunk_arrays(0, verify=True)
    bufs = {k: np.empty_like(np.asarray(v)) for k, v in cols.items()}
    bufs["__valid__"] = np.empty(valid.shape, np.int32)
    ChunkStore(store.dirpath, verify=True).read_chunk_into(0, bufs)
    doctored = {k: np.array(v) for k, v in cols.items()}
    doctored["patient_id"] = doctored["patient_id"] + 1
    from repro_torch.data import save_columnar_arrays

    save_columnar_arrays(doctored, valid, store.chunk_path(0),
                         compressed=False)
    with pytest.raises(IOError, match="hash mismatch"):
        store.load_chunk_arrays(0, verify=True)
    with pytest.raises(IOError, match="hash mismatch"):
        ChunkStore(store.dirpath, verify=True).read_chunk_into(0, bufs)


@pytest.mark.parametrize("compressed", [False, True])
def test_columnar_files_cross_load(stars, tmp_path, compressed):
    """A columnar file written by either package loads in the other;
    ``read_columnar_into`` fills host buffers from either layout."""
    ref_tables, port_tables = stars
    p, r = str(tmp_path / "p.npz"), str(tmp_path / "r.npz")
    save_columnar(port_tables["IR_BEN"], p, compressed=compressed)
    r_save_columnar(ref_tables["IR_BEN"], r, compressed=compressed)
    for path in (p, r):
        got = load_columnar(path, device="cpu")
        want = r_load_columnar(path)
        np.testing.assert_array_equal(got.valid.numpy().view(np.uint32),
                                      np.asarray(want.valid))
        for c in want.columns:
            np.testing.assert_array_equal(got.columns[c].numpy(),
                                          np.asarray(want.columns[c]))
        cols, valid = load_columnar_arrays(path)
        assert valid.dtype == np.uint32
        bufs = {k: np.empty_like(v) for k, v in cols.items()}
        bufs["__valid__"] = np.empty(valid.shape, np.int32)
        read_columnar_into(path, bufs)
        for k, v in cols.items():
            np.testing.assert_array_equal(bufs[k], v)
        np.testing.assert_array_equal(bufs["__valid__"].view(np.uint32),
                                      valid)


def test_mmap_mode_pass_through(stars, tmp_path):
    _, port_tables = stars
    p = str(tmp_path / "t.npz")
    save_columnar(port_tables["IR_BEN"], p, compressed=False)
    cols, valid = load_columnar_arrays(p, mmap_mode="r")
    assert all(isinstance(v, np.memmap) for v in cols.values())
    assert isinstance(valid, np.memmap)
    eager_cols, eager_valid = load_columnar_arrays(p)
    assert not any(isinstance(v, np.memmap) for v in eager_cols.values())
    for k in eager_cols:
        np.testing.assert_array_equal(np.asarray(cols[k]), eager_cols[k])
    np.testing.assert_array_equal(np.asarray(valid), eager_valid)
    t = load_columnar(p, mmap_mode="r", device="cpu")
    np.testing.assert_array_equal(t.valid.numpy(),
                                  port_tables["IR_BEN"].valid.numpy())


def test_mmap_mode_compressed_fallback(stars, tmp_path):
    _, port_tables = stars
    p = str(tmp_path / "t.npz")
    save_columnar(port_tables["IR_BEN"], p, compressed=True)
    flags = {}
    with pytest.warns(RuntimeWarning, match="cannot be memory-mapped"):
        cols, _ = load_columnar_arrays(p, mmap_mode="r", mapped_sink=flags)
    assert flags and not any(flags.values())
    assert not any(isinstance(v, np.memmap) for v in cols.values())
    np.testing.assert_array_equal(
        cols["patient_id"], port_tables["IR_BEN"].columns["patient_id"].numpy())


def test_star_roundtrip_and_partition_from_dir(stars, tmp_path):
    _, port_tables = stars
    sd = str(tmp_path / "star")
    save_star(port_tables, sd, compressed=False)
    loaded = load_star(sd, mmap_mode="r", device="cpu")
    assert sorted(loaded) == sorted(port_tables)
    for k, t in port_tables.items():
        a, b = t.to_numpy(), loaded[k].to_numpy()
        for c in a:
            np.testing.assert_array_equal(a[c], b[c], err_msg=f"{k}.{c}")
    a = partition_star(port_tables, str(tmp_path / "a"), source="ER_PRS",
                       chunk_capacity=96)
    b = partition_star(sd, str(tmp_path / "b"), source="ER_PRS",
                       chunk_capacity=96)
    assert a.fingerprint() == b.fingerprint()


def test_entry_points_default_to_cuda(stars, tmp_path):
    _, port_tables = stars
    store = partition_star(port_tables, str(tmp_path / "store"),
                           source="ER_PRS", chunk_capacity=96)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ChunkedExecutor(store)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            store.chunk_table(0)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _study().check()
