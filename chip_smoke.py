#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--n-patients N] [--cohort-patients N]

Phases (any failure exits nonzero; no phase catches its own failure, and
nothing falls back to the CPU):

  1. environment: torch/CUDA versions, the card's name and power limit, and
     the build of the CUDA kernels from ``src/repro_torch/csrc``;
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, bit for bit, at edge sizes with NULLs, NaNs, an Expr battery,
     hoisted literals and ragged whitelists; the segmented scan (B4) over
     flag patterns, runs spanning many blocks and values beyond its ±2e9
     fills;
  3. quickstart: the quickstart study (synthetic DCIR star, flatten, two
     extractors, patients, cohort algebra, flow) at ``--n-patients`` on the
     card with the ``cuda`` engines; every kernel of the path must have
     launched, the no-loss audit must pass, and the ``torch`` engines must
     give the same answer; each kernel is timed at the shapes that run gave
     it, and one warm run is traced with torch.profiler: device time by
     kernel, the device's busy and idle share of the run's wall time, and a
     Chrome trace in ``chiprun_out/quickstart_trace.json``;
  4. cohort study: ``examples/cohort_study.py``'s plan (DCIR and PMSI,
     exposures, fractures, follow-up, cohort algebra, flow, the dense and
     token featurizes) at ``--cohort-patients``, checked, timed and traced
     the same way (``chiprun_out/cohort_study_trace.json``), with B4 timed at
     the shapes ``exposures`` gave it;
  5. card against CPU: both studies at 20,000 patients on the card and on
     the CPU (the plain versions) must agree bit for bit.

Each kernel's launches are counted over the two studies' first runs, with
the counts set to 0 just before each.  The last lines of standard output
are the card's name and power limit, one JSON line with the kernel records,
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# memory rate of each card, bytes/s (NVIDIA data sheets); the bound of a
# kernel is the bytes it must move over this rate
_MEM_RATE = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12))


def log(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def mem_rate(name: str) -> float:
    for key, rate in _MEM_RATE:
        if key in name:
            return rate
    fail(f"no memory rate known for card {name!r}")


def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
EDGE_SIZES = (0, 1, 31, 32, 33, 1025)
REPS = 20                 # CUDA-event timings per kernel (median reported)
CPU_PATIENTS = 20_000     # scale of the card-vs-CPU comparison


def _same(a, b) -> bool:
    """Bit-identical (NaNs included), compared on ``a``'s device."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b.to(a.device)))


def expr_battery():
    from repro_torch.study import col
    from repro_torch.study.expr import HoistedIsIn, HoistedLit

    return [
        col("a") >= 3,
        (col("a") >= 3) & (col("b") < 10),
        col("a").isin([1, 2, 9]),                  # padded 3 -> 8
        col("a").isin([]),
        col("x").isin([0, 1]),
        col("x").isin([0.5, -1.25, 2.0]),
        col("a").not_null() & col("x").not_null(),
        col("a").is_null() | col("x").is_null(),
        (col("a") + 2) % 3 == 1,
        col("b") * 2 >= col("a"),
        col("x") > 0.25,
        ~(col("x") <= 0.75),
        (col("a").is_null() | (col("a") > 4)) & (col("b") != 7),
        col("b").between(-1, 9),
        ~((col("a") < 0) | col("x").is_null())
        & (col("a").isin([3, 4, 5]) | (col("b") % 2 == 0)),
        col("a") // 0 == -2,                       # jnp: x // 0 == -2
        col("b") // col("z") <= 1,                 # mixed zero divisors
        col("b") % col("z") == 0,
        col("x") // 0.0 != col("x") // 0.0,        # NaN
        col("x") % 0.0 != col("x") % 0.0,
        col("x") // col("y") >= 1.0,
        col("x") % col("y") < 0.5,
        col("a") - col("b") * 3 < col("x"),        # int32 -> float32
        col("b") == 2.5,
        HoistedLit(0) < col("b"),
        col("x") >= HoistedLit(1),
        HoistedIsIn(col("b"), 0, 5, False),
        HoistedIsIn(col("x"), 1, 3, True) | (col("a") == HoistedLit(0)),
    ]


def kernel_battery(device) -> None:
    import numpy as np
    import torch

    from repro_torch.core import bitset as bs
    from repro_torch.core.columnar import NULL_INT
    from repro_torch.kernels import bitset_ops as bo
    from repro_torch.kernels import filter_compact as fc
    from repro_torch.kernels import predicate as pk

    exprs = expr_battery()
    params = ((np.int32(4), np.float32(-0.5)),
              (np.array([7, -3, 2, 2, 11], np.int32),
               np.array([0.25, np.nan, -1.0], np.float32)))
    checked = 0
    for n in EDGE_SIZES:
        rng = np.random.default_rng(n)
        a = rng.integers(-5, 15, n).astype(np.int32)
        a[rng.random(n) < 0.25] = NULL_INT
        x = rng.normal(size=n).astype(np.float32)
        x[rng.random(n) < 0.2] = np.nan
        y = rng.normal(size=n).astype(np.float32)
        y[rng.random(n) < 0.2] = 0.0
        cols = {"a": a, "b": rng.integers(-5, 15, n).astype(np.int32),
                "x": x, "y": y,
                "z": rng.integers(-2, 3, n).astype(np.int32)}
        cols = {k: torch.from_numpy(v).to(device) for k, v in cols.items()}
        valid = bs.pack(torch.from_numpy(rng.random(n) < 0.85).to(device))
        for e in exprs:
            param = e.to_param()
            kinds = pk._kinds(cols, param, params)
            prog = pk.compile_program(param, *kinds)
            got = pk.predicate_bitset(cols, valid, expr_param=param,
                                      capacity=n, params=params)
            want = pk.predicate_bitset_plain(prog, cols, valid, n, params) \
                if n else got
            torch.cuda.synchronize()
            if not (_same(got[0], want[0]) and int(got[1]) == int(want[1])):
                fail(f"predicate kernel != plain at n={n} for {e!r}")
            checked += 1
        # B2: int32 + float32 columns (NaNs), and > 32 columns (two launches)
        many = [cols[k] for k in ("a", "b", "x", "y", "z")] * 7
        for cs in (many[:5], many):
            got, gc = fc.filter_compact_bits(cs, valid)
            want, wc = fc.filter_compact_plain(cs, valid)
            torch.cuda.synchronize()
            if int(gc) != int(wc) or not all(_same(g, w)
                                             for g, w in zip(got, want)):
                fail(f"filter_compact kernel != plain at n={n}")
            checked += 1
        # B3: every op, aligned and misaligned views
        wa = torch.from_numpy(rng.integers(-2**31, 2**31, n + 1,
                                           dtype=np.int64).astype(np.int32))
        wb = torch.from_numpy(rng.integers(-2**31, 2**31, n + 1,
                                           dtype=np.int64).astype(np.int32))
        wa, wb = wa.to(device), wb.to(device)
        for op in bo.OPS:
            for sl in (slice(0, n), slice(1, n + 1)):
                ga, gb = wa[sl].contiguous() if sl.start == 0 else wa[sl], \
                    wb[sl]
                got, gc = bo.bitset_op_popcount(ga, gb, op)
                want, wc = bo.bitset_op_plain(ga, gb, op)
                torch.cuda.synchronize()
                if not _same(got, want) or int(gc) != int(wc):
                    fail(f"bitset_op {op} kernel != plain at n={n}")
                checked += 1
    log(f"kernels: {checked} kernel-vs-plain checks bit-identical "
        f"at n in {EDGE_SIZES}")


SCAN_SIZES = (1, 31, 511, 512, 513, 4096 + 7)
# values beyond the reference kernel's ±2e9 fills, where its clamp shows
EXTREMES = (2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1, 2_000_000_000,
            -2_000_000_000, 2_100_000_000, -2_100_000_000, 0, 7)


def segment_scan_battery(device) -> None:
    """B4 against its plain version, bit for bit: random, all and only-first
    flags, runs spanning many blocks, extreme values, both fills."""
    import numpy as np
    import torch

    from repro_torch.core import bitset as bs
    from repro_torch.kernels import segment_scan as ss

    checked = 0
    for n in SCAN_SIZES:
        rng = np.random.default_rng(n)
        flag_sets = {"random": rng.random(n) < 0.05,
                     "all": np.ones(n, bool),
                     "first": np.arange(n) == 0,
                     "none": np.zeros(n, bool),
                     "sparse": rng.random(n) < 2e-3}
        val_sets = {"dates": rng.integers(14_000, 16_000, n),
                    "extreme": rng.choice(np.array(EXTREMES, np.int64), n)}
        for fname, f in flag_sets.items():
            words = bs.pack(torch.from_numpy(f).to(device))
            for vname, v in val_sets.items():
                vals = torch.from_numpy(v.astype(np.int32)).to(device)
                for block in (32, 512):
                    for fill in (ss.DEFAULT_FILL, ss.EXACT_FILL):
                        got = ss.segmented_scan_kernel(words, vals, block, fill)
                        want = ss.segmented_scan_plain(words, vals, block, fill)
                        torch.cuda.synchronize()
                        if not all(_same(g, w) for g, w in zip(got, want)):
                            fail(f"segmented_scan kernel != plain at n={n} "
                                 f"flags={fname} values={vname} "
                                 f"block={block} fill={fill}")
                        checked += 1
    log(f"kernels: {checked} segmented_scan kernel-vs-plain checks "
        f"bit-identical at n in {SCAN_SIZES}")


# ---------------------------------------------------------------------------
# phases 3-5: the quickstart and the cohort study
# ---------------------------------------------------------------------------
STUDY_END = 14_600 + 3 * 365


def build_study(n_patients: int):
    from repro_torch.core import DCIR_SCHEMA, drug_dispenses, medical_acts_dcir
    from repro_torch.study import Study

    return (Study(n_patients=n_patients)
            .flatten(DCIR_SCHEMA)
            .extract(drug_dispenses(), name="drug_purchases")
            .extract(medical_acts_dcir(codes=list(range(30))), name="acts")
            .patients("IR_BEN")
            .cohort("base", "extract_patients")
            .cohort("drugged", "drug_purchases")
            .cohort("final", "drugged & base - acts")
            .flow("base", "drugged", "final"))


def build_cohort_study(n_patients: int):
    """``examples/cohort_study.py``'s plan, tasks (a)-(g), over the port."""
    from repro_torch.core import (diagnoses, drug_dispenses, hospital_stays,
                                  medical_acts_dcir, medical_acts_pmsi)
    from repro_torch.study import Study, col

    end = STUDY_END
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
            .flow("base", "exposed", "final")
            .featurize("X", cohort="final", kind="dense",
                       n_buckets=36, bucket_days=31, n_features=128)
            .featurize("tokens", cohort="final", kind="tokens", seq_len=256))


def snds_tables(n_patients: int, device):
    """The flat DCIR and PMSI tables plus IR_BEN, as the example feeds them."""
    from repro_torch.core import DCIR_SCHEMA, PMSI_MCO_SCHEMA, flatten_star
    from repro_torch.data.synthetic import SyntheticConfig, generate_snds

    dcir, pmsi = generate_snds(SyntheticConfig(n_patients=n_patients,
                                               seed=42), device=device)
    return {"DCIR": flatten_star(DCIR_SCHEMA, dcir)[0],
            "PMSI_MCO": flatten_star(PMSI_MCO_SCHEMA, pmsi)[0],
            "IR_BEN": dcir["IR_BEN"]}


def compare_results(a, b, what: str, full_columns: bool) -> None:
    """Events (valid rows in order; every slot when ``full_columns``),
    validity words, counts, FlatteningStats, cohort words, flow and
    features (bit for bit; feature checks equal)."""
    if sorted(a.events) != sorted(b.events):
        fail(f"{what}: different outputs")
    for name in a.events:
        ta, tb = a.events[name], b.events[name]
        na, nb = int(ta.count), int(tb.count)
        if na != nb or not _same(ta.valid, tb.valid):
            fail(f"{what}: {name} count/validity differ ({na} vs {nb})")
        for c in ta.columns:
            ca, cb = ta.columns[c], tb.columns[c]
            if not full_columns:
                ca, cb = ca[:na], cb[:nb]
            if not _same(ca, cb):
                fail(f"{what}: {name}.{c} differs")
    if a.flatten_stats != b.flatten_stats:
        fail(f"{what}: FlatteningStats differ")
    for name in a.cohorts:
        if not _same(a.cohorts[name].subjects, b.cohorts[name].subjects):
            fail(f"{what}: cohort {name} differs")
    if a.flow.flowchart() != b.flow.flowchart():
        fail(f"{what}: flow differs")
    if sorted(a.features) != sorted(b.features) \
            or a.feature_checks != b.feature_checks:
        fail(f"{what}: features or feature checks differ")
    for name, fa in a.features.items():
        fb = b.features[name]
        pairs = zip(fa, fb) if isinstance(fa, tuple) else [(fa, fb)]
        if not all(_same(x, y) for x, y in pairs):
            fail(f"{what}: feature {name} differs")


class Recorder:
    """Keeps the largest call of a kernel wrapper on the main path, so that
    the kernel can be timed at the shapes the path gave it."""

    def __init__(self, module, name, size):
        self.module, self.name, self.size = module, name, size
        self.fn = getattr(module, name)
        self.best = None

    def __call__(self, *args, **kwargs):
        s = self.size(*args, **kwargs)
        if self.best is None or s > self.best[0]:
            self.best = (s, args, kwargs)
        return self.fn(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def recorders():
    from repro_torch.kernels import (bitset_ops, filter_compact, predicate,
                                     segment_scan)

    return {"predicate_bitset": Recorder(
                predicate, "_launch", lambda prog, cols, valid, cap, p: cap),
            "filter_compact": Recorder(
                filter_compact, "filter_compact_bits",
                lambda cols, words: cols[0].shape[0] * len(cols)),
            "bitset_op": Recorder(bitset_ops, "bitset_op_popcount",
                                  lambda a, b, op: a.shape[0]),
            "segmented_scan": Recorder(
                segment_scan, "segmented_scan_kernel",
                lambda words, vals, block, fill: vals.shape[0])}


def drive(label: str, study, tables, kernels, reps: int, rate: float):
    """The main path of one study: its first run on the card with the cuda
    engines (launch counts set to 0 just before and read just after; every
    kernel in ``kernels`` must launch), a warm rerun, the torch engines, and
    the timing of each kernel at the largest shape the first run gave it."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    recs = recorders()
    torch.cuda.reset_peak_memory_stats()
    for r in recs.values():
        r.__enter__()
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        res = study.run(dict(tables), engine="cuda", predicate_engine="cuda",
                        device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(launch_counts)
    finally:
        for r in recs.values():
            r.__exit__()
    peak = torch.cuda.max_memory_allocated()
    res.assert_no_loss()
    log(f"{label}: cuda engines wall {wall:.3f} s (first run), peak device "
        f"memory {peak / 2**30:.3f} GiB, launches {launches}")
    for k in kernels:
        if launches[k] <= 0:
            fail(f"{label}: kernel {k} was never launched on the main path")
    log(f"{label}: final cohort {res.cohorts['final'].subject_count()} "
        f"subjects\n" + res.flow.render())
    # time the kernels on the recorded inputs, then let those inputs go
    timing = time_kernels({k: recs[k] for k in kernels}, reps, rate)
    del recs

    t0 = time.perf_counter()
    res2 = study.run(dict(tables), engine="cuda", predicate_engine="cuda",
                     device="cuda")
    torch.cuda.synchronize()
    log(f"{label}: cuda engines wall {time.perf_counter() - t0:.3f} s (warm)")
    compare_results(res, res2, "cuda run vs cuda rerun", full_columns=True)
    del res2
    t0 = time.perf_counter()
    ref = study.run(dict(tables), engine="torch", predicate_engine="torch",
                    device="cuda")
    torch.cuda.synchronize()
    log(f"{label}: torch engines wall {time.perf_counter() - t0:.3f} s")
    compare_results(res, ref, "cuda vs torch engines on the card",
                    full_columns=False)
    log(f"{label}: cuda engines == torch engines (valid rows, words, counts, "
        f"FlatteningStats, cohorts, flow, features)")
    return launches, timing, res


def study_phase(n_patients: int, reps: int, rate: float):
    import torch

    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir

    t0 = time.perf_counter()
    dcir = generate_dcir(SyntheticConfig(n_patients=n_patients, seed=0),
                         device="cuda")
    torch.cuda.synchronize()
    log(f"quickstart: generated DCIR for {n_patients} patients "
        f"({int(dcir['ER_PRS'].count)} ER_PRS rows) in "
        f"{time.perf_counter() - t0:.3f} s")
    study = build_study(n_patients)
    launches, timing, _ = drive(
        "quickstart", study, dcir,
        ("predicate_bitset", "filter_compact", "bitset_op"), reps, rate)
    return launches, timing, study, dcir


def cohort_phase(n_patients: int, reps: int, rate: float):
    import torch

    t0 = time.perf_counter()
    tables = snds_tables(n_patients, "cuda")
    torch.cuda.synchronize()
    rows = {k: int(t.count) for k, t in tables.items()}
    log(f"cohort: generated and flattened the SNDS star for {n_patients} "
        f"patients ({rows} rows) in {time.perf_counter() - t0:.3f} s")
    study = build_cohort_study(n_patients)
    # the design matrix alone: patients x 36 x 128 float32, once per engine
    x_bytes = n_patients * 36 * 128 * 4
    log(f"cohort: design matrix {x_bytes / 2**30:.3f} GiB per copy; the "
        f"phase holds two (cuda and torch engines)")
    launches, timing, res = drive(
        "cohort", study, tables, ("predicate_bitset", "filter_compact",
                                  "bitset_op", "segmented_scan"), reps, rate)
    X = res.features["X"]
    toks, mask = res.features["tokens"]
    if tuple(X.shape) != (n_patients, 36, 128) or not bool(
            torch.isfinite(X).all()) or float(X.sum()) <= 0:
        fail(f"cohort: design matrix {tuple(X.shape)} is not finite and "
             f"non-empty")
    if tuple(toks.shape) != (n_patients, 256) or \
            int(res.events["exposures"].count) <= 0 or \
            int(res.events["fractures"].count) <= 0:
        fail("cohort: empty exposures/fractures or a bad token shape")
    log(f"cohort: exposures {int(res.events['exposures'].count)}, fractures "
        f"{int(res.events['fractures'].count)}, design matrix "
        f"{tuple(X.shape)} sum {float(X.sum())}, tokens {tuple(toks.shape)} "
        f"(mask {int(mask.sum())} true), checks {res.feature_checks}")
    del res, X, toks, mask
    return launches, timing, study, tables


def profile_phase(label: str, run_once) -> None:
    """torch.profiler over one warm run: device time by kernel, idle share,
    and a Chrome trace in ``chiprun_out/{label}_trace.json``."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    def run():
        run_once()
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    trace = out / f"{label}_trace.json"
    prof.export_chrome_trace(str(trace))
    # device time = kernels, copies and fills on the device timeline
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name, calls = collections.Counter(), collections.Counter()
    for e in events:
        by_name[e["name"][:90]] += e["dur"]
        calls[e["name"][:90]] += 1
    busy_us = sum(by_name.values())
    log(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({len(events)} device events), idle share "
        f"{1 - busy_us / wall_us:.4f}")
    for name, us in by_name.most_common(25):
        log(f"profile {label}: {us / 1e3:9.3f} ms device {calls[name]:6d} "
            f"calls  {name}")


def time_kernels(recs, reps: int, rate: float):
    """Each recorded kernel against its plain version at the recorded shape
    (bit for bit), then timed: kernel, plain version, library call."""
    from repro_torch.core import bitset as bs
    from repro_torch.kernels import (bitset_ops, filter_compact, predicate,
                                     segment_scan)

    out = {}
    if "predicate_bitset" in recs:
        rec = recs["predicate_bitset"]
        prog, cols, valid, cap, params = rec.best[1]
        kern = lambda: rec.fn(prog, cols, valid, cap, params)  # noqa: E731
        plain = lambda: predicate.predicate_bitset_plain(  # noqa: E731
            prog, cols, valid, cap, params)
        got, want = kern(), plain()
        if not (_same(got[0], want[0]) and int(got[1]) == int(want[1])):
            fail("predicate kernel != plain at the main path's shape")
        nbytes = (4 * len(prog.columns) + 0.25) * cap
        out["predicate_bitset"] = dict(
            n=cap, columns=len(prog.columns), ms=cuda_ms(kern, reps),
            plain_ms=cuda_ms(plain, reps), library_ms=None,
            bound_ms=nbytes / rate * 1e3, max_abs_err=0.0)
    if "filter_compact" in recs:
        rec = recs["filter_compact"]
        cs, words = rec.best[1]
        n = cs[0].shape[0]
        kern = lambda: rec.fn(cs, words)  # noqa: E731
        plain = lambda: filter_compact.filter_compact_plain(cs, words)  # noqa: E731
        mask = bs.unpack(words, n)
        library = lambda: [c[mask] for c in cs]  # noqa: E731
        (g, gc), (w, wc) = kern(), plain()
        if int(gc) != int(wc) or not all(_same(x, y) for x, y in zip(g, w)):
            fail("filter_compact kernel != plain at the main path's shape")
        nbytes = (8 * len(cs) + 0.125) * n
        out["filter_compact"] = dict(
            n=n, columns=len(cs), ms=cuda_ms(kern, reps),
            plain_ms=cuda_ms(plain, reps), library_ms=cuda_ms(library, reps),
            bound_ms=nbytes / rate * 1e3, max_abs_err=0.0)
    if "bitset_op" in recs:
        rec = recs["bitset_op"]
        a, b, op = rec.best[1]
        kern = lambda: rec.fn(a, b, op)  # noqa: E731
        plain = lambda: bitset_ops.bitset_op_plain(a, b, op)  # noqa: E731
        (g, gc), (w, wc) = kern(), plain()
        if not _same(g, w) or int(gc) != int(wc):
            fail("bitset_op kernel != plain at the main path's shape")
        out["bitset_op"] = dict(
            n=a.shape[0], columns=None, ms=cuda_ms(kern, reps),
            plain_ms=cuda_ms(plain, reps), library_ms=None,
            bound_ms=12 * a.shape[0] / rate * 1e3, max_abs_err=0.0)
    if "segmented_scan" in recs:
        rec = recs["segmented_scan"]
        words, vals, block, fill = rec.best[1]
        n = vals.shape[0]
        kern = lambda: rec.fn(words, vals, block, fill)  # noqa: E731
        plain = lambda: segment_scan.segmented_scan_plain(  # noqa: E731
            words, vals, block, fill)
        if not all(_same(x, y) for x, y in zip(kern(), plain())):
            fail("segmented_scan kernel != plain at the main path's shape")
        # packed flags 1/8 B, values 4 B in; min, max, count 12 B out
        nbytes = 4 * words.shape[0] + 16 * n
        out["segmented_scan"] = dict(
            n=n, columns=None, ms=cuda_ms(kern, reps),
            plain_ms=cuda_ms(plain, reps), library_ms=None,
            bound_ms=nbytes / rate * 1e3, max_abs_err=0.0)
    for k, v in out.items():
        log(f"timing: {k} n={v['n']} columns={v['columns']} "
            f"kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, "
            f"library {v['library_ms']}, bound {v['bound_ms']:.4f} ms")
    return out


def cpu_phase(n_patients: int) -> None:
    """Both studies on the card and on the CPU, bit for bit."""
    import torch

    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir

    cfg = SyntheticConfig(n_patients=n_patients, seed=0)
    study = build_study(n_patients)
    card = study.run(generate_dcir(cfg, device="cuda"), engine="cuda",
                     predicate_engine="cuda", device="cuda")
    torch.cuda.synchronize()
    cpu = study.run(generate_dcir(cfg, device="cpu"), engine="cuda",
                    predicate_engine="cuda", device="cpu")
    compare_results(card, cpu, "quickstart card vs CPU", full_columns=True)
    log(f"cpu: quickstart at {n_patients} patients, card == CPU bit for bit "
        f"(final cohort {card.cohorts['final'].subject_count()} subjects)")
    study = build_cohort_study(n_patients)
    card = study.run(snds_tables(n_patients, "cuda"), engine="cuda",
                     predicate_engine="cuda", device="cuda")
    torch.cuda.synchronize()
    cpu = study.run(snds_tables(n_patients, "cpu"), engine="cuda",
                    predicate_engine="cuda", device="cpu")
    compare_results(card, cpu, "cohort study card vs CPU", full_columns=True)
    compare_stats(card, cpu)
    log(f"cpu: cohort study at {n_patients} patients, card == CPU bit for "
        f"bit (final cohort {card.cohorts['final'].subject_count()} "
        f"subjects, {int(card.events['exposures'].count)} exposures)")


# statistics that sum float32 values, whose order differs between devices
FLOAT_SUM_STATS = ("age_mean", "age_at_first_event", "weight_total")


def compare_stats(card, cpu) -> None:
    """The stats battery and the Supplementary-A distribution of the cohort
    study's cohorts, card against CPU: exact, except the float32 sums to a
    relative 1e-5."""
    from repro_torch.core import stats

    pc, pp = card.events["extract_patients"], cpu.events["extract_patients"]
    for name in ("exposed", "fractured", "final"):
        a = stats.compute(card.cohorts[name], pc)
        b = stats.compute(cpu.cohorts[name], pp)
        if a.keys() != b.keys():
            fail(f"stats of {name}: different statistics")
        for k in a:
            close = all(abs(a[k][f] - b[k][f]) <= 1e-5 * abs(b[k][f])
                        for f in a[k]) if k in FLOAT_SUM_STATS else False
            if a[k] != b[k] and not close:
                fail(f"stats of {name}.{k}: card {a[k]} vs CPU {b[k]}")
    for sa, sb in zip(card.flow.steps, cpu.flow.steps):
        if stats.distribution_by_gender_age_bucket(sa, pc) != \
                stats.distribution_by_gender_age_bucket(sb, pp):
            fail(f"gender x age distribution of {sa.name} differs")
    log(f"cpu: stats of exposed/fractured/final and the flow's gender x age "
        f"distributions, card == CPU ({len(stats.STATISTICS)} statistics)")


KERNELS = {
    "predicate_bitset": ("src/repro_torch/csrc/predicate.cu",
                         "src/repro/kernels/predicate.py:358"),
    "filter_compact": ("src/repro_torch/csrc/filter_compact.cu",
                       "src/repro/kernels/filter_compact.py:72"),
    "bitset_op": ("src/repro_torch/csrc/bitset_ops.cu",
                  "src/repro/kernels/bitset_ops.py:42"),
    "segmented_scan": ("src/repro_torch/csrc/segment_scan.cu",
                       "src/repro/kernels/segment_scan.py:89"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-patients", type=int, default=2_000_000)
    # the reference's design-matrix index is int32 and wraps above 466,033
    # patients at (36, 128) (ROADMAP C7); 400,000 stays below it
    ap.add_argument("--cohort-patients", type=int, default=400_000)
    args = ap.parse_args()

    if not (REPO / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: the repository's src/repro_torch is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    # phase 1: environment + kernel build
    t_all = time.perf_counter()
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, card {name}, {smi}")
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    info = build.build_info()
    log(f"env: kernel library {info['path']} ready in "
        f"{time.perf_counter() - t0:.3f} s (nvcc {info['seconds']:.3f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas: " + line.strip())
    rate = mem_rate(name)
    seconds = {"build": time.perf_counter() - t_all}

    def timed(phase, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[phase] = time.perf_counter() - t
        log(f"phase {phase}: {seconds[phase]:.3f} s")
        return out

    timed("kernels", kernel_battery, torch.device("cuda"))
    timed("segmented_scan", segment_scan_battery, torch.device("cuda"))
    q_launches, timing, study, dcir = timed(
        "quickstart", study_phase, args.n_patients, REPS, rate)
    timed("quickstart_profile", profile_phase, "quickstart",
          lambda: study.run(dict(dcir), engine="cuda",
                            predicate_engine="cuda", device="cuda"))
    del study, dcir
    torch.cuda.empty_cache()
    c_launches, c_timing, cstudy, ctables = timed(
        "cohort", cohort_phase, args.cohort_patients, REPS, rate)
    timed("cohort_profile", profile_phase, "cohort_study",
          lambda: cstudy.run(dict(ctables), engine="cuda",
                             predicate_engine="cuda", device="cuda"))
    del cstudy, ctables
    torch.cuda.empty_cache()
    timed("cpu", cpu_phase, CPU_PATIENTS)
    # B1-B3 are timed at the quickstart's (larger) shapes, B4 at the cohort
    # study's; launches are summed over both studies' first runs
    timing.update({"segmented_scan": c_timing["segmented_scan"]})
    log(f"launches: quickstart {q_launches}, cohort study {c_launches}")
    log(f"phases: {json.dumps({k: round(v, 3) for k, v in seconds.items()})}"
        f", total {time.perf_counter() - t_all:.3f} s")

    records = []
    for k, (source, replaces) in KERNELS.items():
        t = timing[k]
        records.append({"name": k, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": q_launches[k] + c_launches[k],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": "bytes", "library_ms": t["library_ms"]})
    log(smi)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
