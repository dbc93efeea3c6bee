"""The port's CUDA kernels on the card, each against its plain PyTorch
version, bit for bit (B6, attention, within 2e-5 in fp32 and 2e-2 in
bf16, the reference's tolerances: it sums in another order).  Marked
``cuda``: skipped where no CUDA device is present; run them on the GPU
machine with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitset as bs
from repro_torch.core.columnar import NULL_INT
from repro_torch.core import ColumnarTable
from repro_torch.core import transformers as tr
from repro_torch.kernels import bitset_ops, filter_compact, launch_counts
from repro_torch.kernels import hash_partition as hp
from repro_torch.kernels import ops
from repro_torch.kernels import predicate as pk
from repro_torch.kernels import segment_scan as ss
from repro_torch.kernels import swa_attention as swa
from repro_torch.study import col
from repro_torch.study.expr import HoistedIsIn, HoistedLit

from _bitset_programs import PROGRAM_SHAPES, random_program

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cols(n, device):
    rng = np.random.default_rng(n)
    a = rng.integers(-5, 15, n).astype(np.int32)
    a[rng.random(n) < 0.25] = NULL_INT
    x = rng.normal(size=n).astype(np.float32)
    x[rng.random(n) < 0.2] = np.nan
    cols = {"a": torch.from_numpy(a), "x": torch.from_numpy(x),
            "b": torch.from_numpy(rng.integers(-5, 15, n).astype(np.int32))}
    valid = bs.pack(torch.from_numpy(rng.random(n) < 0.85))
    return ({k: v.to(device) for k, v in cols.items()}, valid.to(device))


_PRED_EXPR = (~((col("a") < 0) | col("x").is_null())
              & (col("a").isin([3, 4, 5]) | (col("b") // 0 == -2)))
# whitelists at MAX_ISIN_VALUES (a bitmap in shared memory), past it (global
# memory) and too wide for a bitmap (searched in shared memory)
_PRED_WIDE = (col("a").isin(list(range(-510, 514)))
              & ~col("b").isin(list(range(-2, 1099)))
              | col("a").isin([-10 ** 6, 3, 10 ** 6]))


def _check_predicate(device, n, e):
    cols, valid = _cols(n, device)
    param = e.to_param()
    before = launch_counts["predicate_bitset"]
    words, cnt = pk.predicate_bitset(cols, valid, expr_param=param,
                                     capacity=n)
    assert launch_counts["predicate_bitset"] == before + 1
    prog = pk.compile_program(param, *pk._kinds(cols, param, None))
    pw, pc = pk.predicate_bitset_plain(prog, cols, valid, n)
    assert torch.equal(words, pw) and int(cnt) == int(pc)


@pytest.mark.parametrize("n", [1, 33, 100_003, pk.PRED_TILE - 1,
                               pk.PRED_TILE, pk.PRED_TILE + 1])
def test_predicate_kernel_matches_plain(device, n):
    _check_predicate(device, n, _PRED_EXPR)


@pytest.mark.parametrize("edge", ["wave-33", "wave+33", "3 waves"])
@pytest.mark.parametrize("which", ["mixed", "wide whitelists"])
def test_predicate_kernel_at_the_persistent_grid_edges(device, edge, which):
    """One full wave of the persistent grid (grid x tile rows) ± 33, and
    enough rows that every block walks at least 3 tiles."""
    e = _PRED_EXPR if which == "mixed" else _PRED_WIDE
    cols, _ = _cols(1, device)
    param = e.to_param()
    prog = pk.compile_program(param, *pk._kinds(cols, param, None))
    plan = pk.device_plan(prog, 1 << 40, device)
    wave = plan.grid * plan.tile
    n = {"wave-33": wave - 33, "wave+33": wave + 33,
         "3 waves": 3 * wave + 17}[edge]
    _check_predicate(device, n, e)


def _denormal_cols(n, device):
    """Float32 columns of denormals of both signs, zeros, least normals,
    NaN and ordinary values (ROADMAP C4), and an int column."""
    rng = np.random.default_rng(n)
    pool = np.array([1e-45, -1e-45, 1e-39, -1e-40, 3e-39, 0.0, -0.0,
                     1.1754944e-38, -1.1754942e-38, np.nan, 1.0, -2.5, 1e30],
                    np.float32)
    cols = {"d": rng.choice(pool, n), "e": rng.choice(pool, n),
            "i": rng.integers(-3, 4, n).astype(np.int32)}
    valid = bs.pack(torch.from_numpy(rng.random(n) < 0.9))
    return ({k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in cols.items()}, valid.to(device))


_DENORMAL_EXPRS = [
    col("d") > 0, col("d") == 0, col("d") * 1e30 > 0, col("d") < 0.0,
    col("e") >= 1e-40, col("d") - col("e") == 0, col("d") * col("e") != 0,
    col("d") // -1.0 < col("e"), col("d") % col("e") >= 0,
    col("i") * 1e-44 == col("d"), col("d").isin([1e-40, -2.5]),
    col("e").isin([0.0, 1e30]) | (col("d") <= -1e-45),
]


@pytest.mark.parametrize("n", [77, 100_003])
def test_predicate_kernel_flushes_denormals(device, n):
    """B1 flushes float32 denormals where XLA does, bit for bit with its
    plain version (which the CPU tests hold against the reference)."""
    cols, valid = _denormal_cols(n, device)
    for e in _DENORMAL_EXPRS:
        param = e.to_param()
        words, cnt = pk.predicate_bitset(cols, valid, expr_param=param,
                                         capacity=n)
        prog = pk.compile_program(param, *pk._kinds(cols, param, None))
        pw, pc = pk.predicate_bitset_plain(prog, cols, valid, n)
        assert torch.equal(words, pw) and int(cnt) == int(pc), repr(e)
    lits = (torch.tensor(-1e-40, device=device),
            torch.tensor(3e-39, device=device))
    vecs = (torch.tensor([1e-41, 2.0, -1e-45], device=device),)
    for e in (col("d") > HoistedLit(0), col("e") == HoistedLit(1),
              HoistedIsIn(col("d"), 0, 3, True)):
        param = e.to_param()
        words, cnt = pk.predicate_bitset(cols, valid, expr_param=param,
                                         capacity=n, params=(lits, vecs))
        prog = pk.compile_program(param, *pk._kinds(cols, param,
                                                    (lits, vecs)))
        pw, pc = pk.predicate_bitset_plain(prog, cols, valid, n,
                                           params=(lits, vecs))
        assert torch.equal(words, pw) and int(cnt) == int(pc), repr(e)


def test_chunked_run_on_the_card(device, tmp_path):
    """run_chunked on the card, with and without prefetch and after a
    kill-and-resume, equals the resident run of the same study, launching
    B1 and B2 on every chunk and B3 once per cohort expression per chunk
    plus the replay."""
    from repro_torch.core import DCIR_SCHEMA, drug_dispenses, \
        medical_acts_dcir
    from repro_torch.data import SyntheticConfig, generate_dcir, \
        partition_star
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.study import ChunkedExecutor, Study, clear_jit_cache
    from repro_torch.study.chunked import _InjectedCrash
    from repro_torch.study.executor import cohort_groups

    def study():
        return (Study(n_patients=3_000).flatten(DCIR_SCHEMA)
                .extract(drug_dispenses(), name="drugs")
                .extract(medical_acts_dcir(codes=list(range(30))),
                         name="acts")
                .patients("IR_BEN")
                .cohort("base", "extract_patients")
                .cohort("drugged", "drugs")
                .cohort("final", "drugged & base - acts")
                .flow("base", "drugged", "final"))

    star = generate_dcir(SyntheticConfig(n_patients=3_000, seed=7),
                         device=device)
    kw = {"engine": "cuda", "predicate_engine": "cuda", "device": device}
    res = study().run(dict(star), **kw)
    store = partition_star(star, str(tmp_path / "store"), source="ER_PRS",
                           chunk_capacity=4096)
    assert store.n_chunks > 3
    for prefetch in (True, False):
        clear_jit_cache()
        reset_launch_counts()
        rep = {}
        out = study().run_chunked(store, prefetch=prefetch, report_sink=rep,
                                  **kw)
        assert rep["compiles"] == 1
        groups = len(cohort_groups(out.plan))
        assert launch_counts["bitset_op"] == groups * (store.n_chunks + 1)
        assert launch_counts["predicate_bitset"] % store.n_chunks == 0
        assert launch_counts["filter_compact"] % store.n_chunks == 0
        assert launch_counts["predicate_bitset"] > 0
        _same_result(out, res)
    ck = str(tmp_path / "ckpt")
    with pytest.raises(_InjectedCrash):
        ChunkedExecutor(store, checkpoint_dir=ck, crash_after=2, **kw).run(
            study())
    ex = ChunkedExecutor(store, checkpoint_dir=ck, **kw)
    _same_result(ex.run(study()), res)
    assert ex.report.resumed == 2


def _service_study(threshold, codes):
    from repro_torch.core import DCIR_SCHEMA, drug_dispenses, \
        medical_acts_dcir
    from repro_torch.study import Study, col

    return (Study(n_patients=3_000).flatten(DCIR_SCHEMA)
            .extract(drug_dispenses(codes=codes), name="drugs")
            .extract(medical_acts_dcir(), name="acts")
            .filter("acts", col("value") >= threshold, name="acts_hi")
            .cohort("base", "drugs")
            .cohort("final", "base & acts_hi"))


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_service_on_the_card_equals_solo_runs(device, pipeline):
    """The query service under the cuda engines on the card: every ticket
    equals its solo run bit for bit (every slot), one runner for the
    shape, and B1 launches one fewer for every predicate cut served from
    the cache than the solo runs."""
    from repro_torch.data import SyntheticConfig, generate_dcir
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.study import CohortQueryService, ServiceConfig
    from repro_torch.study.fuzz import results_equal
    from repro_torch.study.plan import PREDICATE_OPS

    star = generate_dcir(SyntheticConfig(n_patients=3_000, seed=13),
                         device=device)
    kw = {"engine": "cuda", "predicate_engine": "cuda", "device": device}
    queries = [(100, list(range(100, 140))), (500, list(range(60, 100))),
               (100, list(range(100, 140)))]
    solo, solo_b1 = [], 0
    for th, codes in queries:
        reset_launch_counts()
        solo.append(_service_study(th, codes).run(dict(star), **kw))
        solo_b1 += launch_counts["predicate_bitset"]
    svc = CohortQueryService(dict(star), device=device, config=ServiceConfig(
        engine="cuda", predicate_engine="cuda", pipeline=pipeline))
    reset_launch_counts()
    tickets = [svc.submit(_service_study(th, codes), tenant=f"t{i}")
               for i, (th, codes) in enumerate(queries)]
    svc.drain()
    for t, want in zip(tickets, solo):
        assert t.status == "done", t.error
        assert results_equal(t.result, want, layout=True) is None
        assert t.result.flatten_stats == want.flatten_stats
    assert svc.stats.compile_count == 1 and svc.stats.demotions == 0
    assert tickets[2].cache_misses == 0
    hits = sum(op in PREDICATE_OPS for t in tickets for op in t.hit_ops)
    assert hits > 0
    assert launch_counts["predicate_bitset"] == solo_b1 - hits


def test_spec_differential_on_the_card(device, tmp_path):
    """The fuzzer's oracle on the card runs all three arms (torch, cuda,
    chunked), and a short corpus passes under the cuda executor engine."""
    from repro_torch.study.fuzz import run_corpus

    report = run_corpus(n=8, seed=0, n_patients=500,
                        store_dir=str(tmp_path), engine="cuda",
                        device=device)
    assert report.ok, report.summary()
    assert report.arms == ("torch", "cuda", "chunked")
    assert report.n_valid == 4 and report.n_mutated == 4


def _same_result(a, b):
    """Valid rows in order (a chunked table is the concatenation of its
    chunks' tables, so its capacity and padding differ), cohort words,
    FlatteningStats, flow and the plan entries of the OperationLog."""
    for k, t in b.events.items():
        assert int(a.events[k].count) == int(t.count), k
        ma, mb = a.events[k].valid_bool(), t.valid_bool()
        for c in t.columns:
            assert torch.equal(a.events[k].columns[c][ma].view(torch.int32),
                               t.columns[c][mb].view(torch.int32)), (k, c)
    for k, c in b.cohorts.items():
        assert torch.equal(a.cohorts[k].subjects, c.subjects), k
    assert a.flatten_stats == b.flatten_stats
    assert a.flow.flowchart() == b.flow.flowchart()

    def plan_entries(log):
        return [{k: v for k, v in e.items() if k != "ts"}
                for e in log.entries if e["op"].startswith("plan:")]

    assert plan_entries(a.log) == plan_entries(b.log)


@pytest.mark.parametrize("n", [1, 33, 100_003])
def test_filter_compact_kernel_matches_plain(device, n):
    cols, valid = _cols(n, device)
    cs = [cols["a"], cols["x"], cols["b"]]
    got, cnt = filter_compact.filter_compact_bits(cs, valid)
    want, wcnt = filter_compact.filter_compact_plain(cs, valid)
    assert int(cnt) == int(wcnt)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("op", ["and", "or", "andnot", "xor"])
def test_bitset_op_kernel_matches_plain(device, op):
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.integers(-2**31, 2**31, 10_001, dtype=np.int64)
                         .astype(np.int32)).to(device)
    b = torch.from_numpy(rng.integers(-2**31, 2**31, 10_001, dtype=np.int64)
                         .astype(np.int32)).to(device)
    got, cnt = bitset_ops.bitset_op_popcount(a, b, op)
    want, wcnt = bitset_ops.bitset_op_plain(a, b, op)
    assert torch.equal(got, want) and int(cnt) == int(wcnt)


def _expr_sizes(device):
    """Word counts at the program kernel's block edges (a block's 16-byte
    items, or its single words), one wave of its widest grid (the one-op
    kernel's) and past it."""
    t = bitset_ops.THREADS
    sms, per_sm = bitset_ops._limits(device, 1)
    wave = sms * per_sm * t * 4
    return [1, 3, 4, 5, t - 1, t + 1, 4 * t - 1, 4 * t, 4 * t + 1, 62_500,
            wave - 1, wave + 5, 3 * wave + 7]


@pytest.mark.parametrize("misaligned", [False, True])
def test_bitset_expr_kernel_matches_plain(device, misaligned):
    """Every program shape of 1-8 ops over 1-8 leaves, every op, at sizes
    straddling the block and grid edges; misaligned views take the scalar
    path."""
    rng = np.random.default_rng(11 + misaligned)
    for n in _expr_sizes(device):
        base = torch.from_numpy(rng.integers(
            -2**31, 2**31, (8, n + 1), dtype=np.int64).astype(np.int32)
        ).to(device)
        for k, (n_leaves, n_ops) in enumerate(PROGRAM_SHAPES):
            prog = random_program(rng, n_leaves, n_ops, first_op=k)
            leaves = [base[i, int(misaligned):n + int(misaligned)]
                      for i in range(n_leaves)]
            before = launch_counts["bitset_op"]
            got, cnt = bitset_ops.bitset_expr_kernel(leaves, prog)
            assert launch_counts["bitset_op"] == before + 1
            want, wcnt = bitset_ops.bitset_expr_plain(leaves, prog)
            assert torch.equal(got, want) and torch.equal(cnt, wcnt), \
                (n, prog)


def test_bitset_expr_counts_are_written_outright(device):
    """The counts and partials come from ``torch.empty``: poison the pool's
    blocks of their size with -1 and free them, so that the launch gets
    one; every count must still be exact."""
    rng = np.random.default_rng(5)
    n = 62_500
    leaves = [torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                               .astype(np.int32)).to(device) for _ in range(3)]
    prog = (("and", 0, 1), ("andnot", 3, 2))
    sms, per_sm = bitset_ops._limits(device, len(prog))
    grid = bitset_ops.expr_grid(n // 4, sms, per_sm)
    want = bitset_ops.bitset_expr_plain(leaves, prog)
    for _ in range(3):
        junk = [torch.full((2 * (1 + grid),), -1, dtype=torch.int32,
                           device=device) for _ in range(64)]
        del junk
        got = bitset_ops.bitset_expr_kernel(leaves, prog)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _cohort_study(n_patients):
    """``examples/cohort_study.py``'s plan over the port."""
    from repro_torch.core import (diagnoses, drug_dispenses, hospital_stays,
                                  medical_acts_dcir, medical_acts_pmsi)
    from repro_torch.study import Study

    end = 14_600 + 3 * 365
    return (Study(n_patients=n_patients, window=(14_600, end))
            .patients("IR_BEN")
            .extract(drug_dispenses(), name="drug_purchases")
            .extract(drug_dispenses()
                     .filtered(col("cip13").isin(range(65))
                               & col("execution_date").between(14_600, end)),
                     name="prevalent_drugs")
            .extract(medical_acts_dcir(), name="acts")
            .extract(medical_acts_pmsi(), name="hospital_acts")
            .extract(diagnoses(), name="diagnoses")
            .extract(hospital_stays(), name="stays")
            .transform("exposures", "drug_purchases", name="exposures",
                       purview_days=60)
            .concat("all_acts", "acts", "hospital_acts")
            .transform("fractures", "all_acts", "diagnoses", name="fractures",
                       fracture_act_codes=list(range(30)),
                       fracture_diag_codes=list(range(40)))
            .transform("follow_up", "extract_patients", "drug_purchases",
                       name="follow_up", study_end=end)
            .cohort("base", "extract_patients")
            .cohort("exposed", "exposures")
            .cohort("fractured", "fractures")
            .cohort("final", "(exposed & base) - fractured")
            .flow("base", "exposed", "final"))


@pytest.mark.parametrize("which", ["quickstart", "cohort study"])
def test_one_bitset_launch_per_cohort_group(device, which):
    """Each study's two-op cohort expression is one group: one launch of
    the program kernel, no other B3 launch, and the same cohort words and
    flow as the torch engine."""
    from repro_torch.core import (DCIR_SCHEMA, PMSI_MCO_SCHEMA,
                                  drug_dispenses, flatten_star,
                                  medical_acts_dcir)
    from repro_torch.data.synthetic import (SyntheticConfig, generate_dcir,
                                            generate_snds)
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.study import Study
    from repro_torch.study.executor import cohort_groups

    n = 2_000
    if which == "quickstart":
        study = (Study(n_patients=n).flatten(DCIR_SCHEMA)
                 .extract(drug_dispenses(), name="drug_purchases")
                 .extract(medical_acts_dcir(codes=list(range(30))),
                          name="acts")
                 .patients("IR_BEN")
                 .cohort("base", "extract_patients")
                 .cohort("drugged", "drug_purchases")
                 .cohort("final", "drugged & base - acts")
                 .flow("base", "drugged", "final"))
        tables = generate_dcir(SyntheticConfig(n_patients=n, seed=0),
                               device=device)
    else:
        study = _cohort_study(n)
        dcir, pmsi = generate_snds(SyntheticConfig(n_patients=n, seed=42),
                                   device=device)
        tables = {"DCIR": flatten_star(DCIR_SCHEMA, dcir)[0],
                  "PMSI_MCO": flatten_star(PMSI_MCO_SCHEMA, pmsi)[0],
                  "IR_BEN": dcir["IR_BEN"]}
    reset_launch_counts()
    got = study.run(dict(tables), engine="cuda", predicate_engine="cuda",
                    device=device)
    torch.cuda.synchronize()
    groups = cohort_groups(got.plan)
    assert [len(ms) for ms in groups.values()] == [2]
    assert launch_counts["bitset_op"] == len(groups) == 1
    want = study.run(dict(tables), engine="torch", predicate_engine="torch",
                     device=device)
    assert got.flow.flowchart() == want.flow.flowchart()
    for name, c in want.cohorts.items():
        assert torch.equal(got.cohorts[name].subjects, c.subjects), name


@pytest.mark.parametrize("fill", ["default", "exact"])
def test_segmented_scan_kernel_matches_plain(device, fill):
    rng = np.random.default_rng(3)
    n = 100_003
    flags = bs.pack(torch.from_numpy(rng.random(n) < 0.01).to(device))
    vals = torch.from_numpy(rng.choice(
        np.array([2**31 - 1, -2**31, 2_100_000_000, -2_100_000_000, 0, 9]),
        n).astype(np.int32)).to(device)
    f = ss.DEFAULT_FILL if fill == "default" else ss.EXACT_FILL
    for block in (32, 512):
        got = ss.segmented_scan_kernel(flags, vals, block, f)
        want = ss.segmented_scan_plain(flags, vals, block, f)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("flags", ["none", "sparse", "all"])
def test_segmented_scan_kernel_across_lookback_tiles(device, flags):
    """Hundreds of the kernel's look-back tiles, a run with no flag across
    all of them, extreme values, both fills and a block off the tiles."""
    rng = np.random.default_rng(5)
    n = 300 * ss.SCAN_TILE + 5
    f = {"none": np.zeros(n, bool), "sparse": rng.random(n) < 1e-5,
         "all": np.ones(n, bool)}[flags]
    words = bs.pack(torch.from_numpy(f).to(device))
    vals = torch.from_numpy(rng.choice(
        np.array([2**31 - 1, -2**31, 2_100_000_000, -2_100_000_000, 0, 9]),
        n).astype(np.int32)).to(device)
    before = launch_counts["segmented_scan"]
    for fill in (ss.DEFAULT_FILL, ss.EXACT_FILL):
        for block in (512, 4099):
            got = ss.segmented_scan_kernel(words, vals, block, fill)
            want = ss.segmented_scan_plain(words, vals, block, fill)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launch_counts["segmented_scan"] == before + 4


def test_exposures_on_cuda_launch_the_segmented_scan(device):
    """``exposures`` on CUDA data under the cuda engine folds through B4 and
    equals the torch engine's segment reductions on the same card."""
    rng = np.random.default_rng(4)
    n = 50_000
    cols = {"patient_id": rng.integers(0, 2_000, n).astype(np.int32),
            "category": np.ones(n, np.int32), "group_id": np.zeros(n, np.int32),
            "value": rng.integers(0, 20, n).astype(np.int32),
            "weight": np.ones(n, np.float32),
            "start": rng.integers(14_600, 15_700, n).astype(np.int32),
            "end": np.zeros(n, np.int32)}
    t = ColumnarTable.from_columns(cols, valid=rng.random(n) < 0.9,
                                   device=device)
    before = launch_counts["segmented_scan"]
    got = tr.exposures(t, 2_000, purview_days=60, engine="cuda")
    assert launch_counts["segmented_scan"] == before + 1
    want = tr.exposures(t, 2_000, purview_days=60, engine="torch")
    assert torch.equal(got.valid, want.valid)
    for k in want.columns:
        assert torch.equal(got.columns[k].view(torch.int32),
                           want.columns[k].view(torch.int32)), k


@pytest.mark.parametrize("block", [256, 512, 1024])
@pytest.mark.parametrize("n_dest", [1, 2, 4, 8, 15, 64])
def test_hash_partition_kernel_matches_plain(device, n_dest, block):
    rng = np.random.default_rng(n_dest)
    n = 5 * block + 77
    keys = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                            .astype(np.int32)).to(device)
    words = bs.pack(torch.from_numpy(rng.random(n) < 0.8)).to(device)
    before = launch_counts["hash_partition_plan"]
    got = hp.hash_partition_plan_kernel(keys, words, n_dest, block)
    assert launch_counts["hash_partition_plan"] == before + 1
    want = hp.hash_partition_plan_plain(keys, words, n_dest, block)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("case", ["none", "all", "ragged"])
def test_filter_compact_bool_mask_kernel_matches_plain(device, case):
    rng = np.random.default_rng(11)
    n = 100_003
    mask = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
            "ragged": rng.random(n) < 0.3}[case]
    vals = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(device)
    m = torch.from_numpy(mask).to(device)
    before = launch_counts["filter_compact_mask"]
    got, cnt = ops.filter_compact(vals, m)
    assert launch_counts["filter_compact_mask"] == before + 1
    want, wcnt = filter_compact.filter_compact_mask_plain([vals], m)
    assert int(cnt) == int(wcnt) == int(mask.sum())
    assert torch.equal(got.view(torch.int32), want[0].view(torch.int32))


TILE = filter_compact.TILE_ROWS


@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1, 2 * TILE + 17,
                               300 * TILE + 5])
@pytest.mark.parametrize("kind", ["ragged", "runs"])
def test_bool_mask_compaction_at_tile_edges(device, n, kind):
    """B2b's look-back across tile edges: ragged masks, and long all-false
    runs (so that most tiles publish an aggregate of 0 and the look-back
    crosses many aggregate-only tiles) with a few kept rows; seven columns,
    int32 and float32 with NaNs, bit-identical to the plain version."""
    rng = np.random.default_rng(n)
    if kind == "ragged":
        mask = rng.random(n) < 0.5
    else:
        mask = np.zeros(n, bool)
        mask[rng.integers(0, n, 3)] = True
        mask[-1] = True
    m = torch.from_numpy(mask).to(device)
    cols = []
    for j in range(7):
        if j % 2:
            x = rng.normal(size=n).astype(np.float32)
            x[rng.random(n) < 0.1] = np.nan
        else:
            x = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
        cols.append(torch.from_numpy(x).to(device))
    before = launch_counts["filter_compact_mask"]
    got, cnt = filter_compact.filter_compact_mask(cols, m)
    assert launch_counts["filter_compact_mask"] == before + 1
    want, wcnt = filter_compact.filter_compact_mask_plain(cols, m)
    assert int(cnt) == int(wcnt) == int(mask.sum())
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    # an unaligned view takes the element-wise loads
    got, cnt = filter_compact.filter_compact_mask([c[1:] for c in cols],
                                                  m[1:])
    want, wcnt = filter_compact.filter_compact_mask_plain(
        [c[1:] for c in cols], m[1:])
    assert int(cnt) == int(wcnt)
    assert all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


# B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len: the sweep of
# tests/test_kernels.py, decode offsets, the ring mode, every head dim
ATTN_CASES = [
    (2, 4, 2, 128, 128, 64, True, 0, None, None),
    (1, 8, 2, 256, 256, 64, True, 64, None, None),
    (2, 4, 4, 1, 384, 64, True, 0, None, None),
    (1, 4, 1, 1, 512, 128, True, 128, None, None),
    (2, 2, 2, 96, 96, 32, False, 0, None, None),
    (1, 2, 1, 80, 160, 32, True, 0, None, None),
    (2, 32, 8, 1, 300, 80, True, 64, 200, None),
    (2, 32, 8, 1, 64, 80, False, 0, 900, 17),
    (1, 4, 2, 33, 70, 16, True, 8, 20, 60),
    (1, 6, 2, 5, 40, 16, True, 0, -3, None),
    # the decode route with many splits: full rings of 4,096 / 4,097 slots,
    # ragged kv_len, a window crossing splits, 16 rows (Sq 4 x group 4),
    # kv_len = 0, every head dim
    (4, 32, 8, 1, 4096, 80, False, 0, 9000, 4096),
    (4, 32, 8, 1, 4097, 80, False, 0, 9000, 4001),
    (1, 32, 8, 1, 8192, 80, True, 4096, 5000, 8192),
    (2, 16, 4, 4, 4096, 128, True, 1000, 3000, 4096),
    (2, 8, 2, 1, 640, 64, False, 0, 9000, 0),
    (3, 8, 8, 1, 2049, 16, True, 0, 2048, None),
    (2, 8, 1, 2, 1500, 32, True, 300, 1400, 1450),
    # the decode route at gemma3-12b's head dim (16/8 heads of 240: the ring
    # with S = 3 and a full cache) and at 256
    (2, 16, 8, 3, 1024, 240, False, 0, 1500, 1024),
    (1, 16, 8, 1, 4096, 240, True, 1024, 3000, 4096),
    (2, 16, 8, 2, 2048, 256, True, 0, 2000, 2048),
]
# the bf16 prefill kernel (TMA, wgmma) at every head dim: Sq not a multiple
# of its 128 rows, kv_len not a multiple of its key tile, a window edge
# inside a tile; causal=False with a ragged kv_len; rows before the first key
ATTN_CASES += [(1, 4, 2, 300, 333, D, True, 50, None, 317)
               for D in swa.HEAD_DIMS]
ATTN_CASES += [(2, 16, 8, 257, 400, 240, False, 0, None, 200),
               (1, 2, 1, 130, 130, 256, True, 0, -8, None),
               # no key at all (every block walks no tile), a window of one
               (1, 8, 2, 40, 64, 80, False, 0, 5, 0),
               (1, 4, 4, 300, 300, 64, True, 1, None, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_kernel_matches_plain(device, case, dtype):
    B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len = case
    g = torch.Generator(device=device).manual_seed(Sq + Skv)
    q, k, v = (torch.randn(s, generator=g, device=device).to(dtype)
               for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    before = dict(launch_counts)
    got = swa.flash_swa_attention(q, k, v, **kw)
    assert launch_counts["flash_attention"] == before["flash_attention"] + 1
    # the decode route, and only it, counts its own launches
    decode = (Hq // Hkv) * Sq <= swa.DECODE_ROWS
    assert (launch_counts["flash_decode"]
            == before["flash_decode"] + int(decode))
    want = swa.flash_swa_attention_plain(q, k, v, **kw)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # a row with no visible key is exactly 0
    empty = (want == 0).all(dim=-1)
    assert torch.count_nonzero(got[empty]) == 0
    # the model's layout: transposed (B, S, H, D) views, no copies
    tq, tk, tv = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    strided = swa.flash_swa_attention(tq, tk, tv, **kw)
    assert strided.stride() == tq.stride()
    torch.testing.assert_close(strided, got, rtol=0, atol=0)


def test_flash_attention_kernel_refuses_other_head_dims(device):
    q = torch.zeros(1, 2, 4, 96, device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 96"):
        swa.flash_swa_attention(q, q, q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,S,pos", [("swa", 300, None),
                                        ("attn", 300, None),
                                        ("swa", 3, 1500)])
def test_gemma3_attention_layer_card_matches_cpu(device, kind, S, pos,
                                                 dtype):
    """One gemma3-12b attention layer at full width (16/8 heads of 240),
    prefill and a 3-query ring decode past the wrap: the card's kernels
    against the CPU's plain versions on the same weights."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(get_config("gemma3-12b"), dtype=dtype)
    dt = getattr(torch, dtype)
    p = L.attn_params(torch.Generator().manual_seed(0), cfg, dt)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, S, cfg.d_model), generator=g).to(dt)
    start = pos or 0
    positions = (start + torch.arange(S, dtype=torch.int32))[None]
    outs = {}
    for dev in ("cpu", device):
        cache = None
        if pos is not None:
            shape = (1, cfg.window, cfg.n_kv_heads, cfg.head_dim_)
            cache = tuple(torch.randn(shape, generator=torch.Generator()
                                      .manual_seed(2)).to(dt).to(dev)
                          for _ in range(2))
        outs[str(dev)] = L.attention(
            {k: v.to(dev) for k, v in p.items()}, x.to(dev), cfg, kind=kind,
            positions=positions.to(dev), cache=cache, cache_pos=pos,
            engine="cuda")[0]
    tol = 1e-3 if dtype == "float32" else 0.1
    assert float((outs[str(device)].float().cpu() - outs["cpu"].float())
                 .abs().max()) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_on_cuda_launches_b6_per_layer(device, dtype):
    """Reduced h2o-danube on the card: a prefill and a ring decode launch
    B6 once per layer, and agree with the torch engine."""
    import dataclasses

    from repro_torch.models import get_bundle
    from repro_torch.models.registry import ModelBundle

    b = ModelBundle(dataclasses.replace(
        get_bundle("h2o-danube-1.8b", reduced=True).cfg, dtype=dtype))
    params = b.init(0, device=device)
    toks = torch.randint(3, 500, (2, 40), device=device, dtype=torch.int32)
    before = dict(launch_counts)
    got = b.prefill(params, {"tokens": toks}, engine="cuda")
    assert (launch_counts["flash_attention"]
            == before["flash_attention"] + b.cfg.n_layers)
    assert launch_counts["flash_decode"] == before["flash_decode"]
    want = b.prefill(params, {"tokens": toks}, engine="torch")
    tol = 1e-4 if dtype == "float32" else 0.1
    assert float((got.float() - want.float()).abs().max()) <= tol
    caches = {e: b.init_cache(2, 32, device=device) for e in ("cuda", "torch")}
    before = launch_counts["flash_decode"]
    for t in range(24):
        out = {e: b.decode(params, caches[e], {"tokens": toks[:, t:t + 1],
                                               "pos": t}, engine=e)[0]
               for e in caches}
        assert float((out["cuda"].float() - out["torch"].float()).abs().max()
                     ) <= tol
    # every decode step's attention took the decode route
    assert launch_counts["flash_decode"] == before + 24 * b.cfg.n_layers
