#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--n-patients N] [--cohort-patients N]
                          [--sharded-patients N] [--chunked-patients N]

Phases (any failure exits nonzero; no phase catches its own failure, and
nothing falls back to the CPU):

  1. environment: torch/CUDA versions, the card's name and power limit, and
     the build of the CUDA kernels from ``src/repro_torch/csrc`` (ptxas must
     report no stack frame and no spill for both of B1's kernels);
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, bit for bit, at edge sizes with NULLs, NaNs, an Expr battery,
     hoisted literals and ragged whitelists (up to eight of 1,024 values,
     bitmaps, shared- and global-memory searches, 15 register-file slots);
     the battery again over float32 denormals of both signs in columns,
     literals and whitelists (flushed as XLA flushes them, ROADMAP C4);
     B1's whole battery again at its tile edges (tile ± 1 row), one wave of
     its persistent grid ± 33 rows and three waves; the segmented scan (B4)
     over flag patterns, runs spanning many blocks and up to a thousand of
     its look-back tiles (with no flag at all), block sizes on and off its
     tiles, and values beyond its ±2e9 fills; B3's program kernel over
     programs of 1-8 ops on 1-8 leaves (every op), aligned and misaligned
     views, sizes at its block and grid edges up to 2,062,500 words (the
     SNDS universe), with its count buffers' pool blocks poisoned first;
  3. quickstart: the quickstart study (synthetic DCIR star, flatten, two
     extractors, patients, cohort algebra, flow) at ``--n-patients`` on the
     card with the ``cuda`` engines; every kernel of the path must have
     launched (B3 once for each cohort expression), the no-loss audit must
     pass, and the ``torch`` engines must give the same answer; each kernel
     is timed at the shapes that run gave it (B1 also at the longest
     program with a whitelist that the run launched; B3 also over 2,062,500
     words with L2 cleared, beside an empty kernel's launch; B1, B3 and B4
     as the middle of 3 medians of 20 with their min-max), and one warm run
     is traced with torch.profiler: device time by
     kernel, the device's busy and idle share of the run's wall time, and a
     Chrome trace in ``chiprun_out/quickstart_trace.json``;
  4. chunked: the quickstart's star (at ``--chunked-patients``, default
     the quickstart's 2,000,000: the same star and resident cuda result)
     partitioned into chunks of 8,388,608 ER_PRS rows under
     ``.chunk_store/`` (removed after); ``Study.check`` must equal
     ``tests/goldens/quickstart_diag.json`` (code, severity, node); the
     normalized plan (``normalize``, ``device_params``) must equal the
     plan's own run on the card, B1 launching as often with hoisted
     operands and nothing demoted; ``run_chunked`` under the cuda engines
     with and without prefetch must equal the resident run bit for bit
     (valid rows in order, cohort words and counts, flow, FlatteningStats,
     the OperationLog's plan entries), build one runner, and launch B1 and
     B2 as the resident run does on every chunk and B3 once per cohort
     expression per chunk plus the replay; a kill-and-resume (``crash_after
     =2``) at 200,000 patients must equal its resident run with 2 chunks
     resumed; the chunk count, each run's ``load_s``/``exec_s``/
     ``wall_s``/``overlap_saved_s`` and peak device memory beside the
     resident run's are printed, and one warm chunked run is traced
     (``chiprun_out/chunked_trace.json``);
  5. spec: ``spec_from_study`` of the quickstart and cohort-study plans
     must equal ``tests/goldens/*_spec.json``, and ``compile_spec`` of each
     golden, run on the card under the cuda engines, must equal the
     builder-made study bit for bit (every slot, words, stats, cohorts,
     flow, features, the plan's log entries); then the fuzzer's corpus
     (``study.fuzz.run_corpus``, 48 specs from seed 0 over a 200,000-patient
     star, executor engine ``cuda``): 24 valid specs each run under the
     torch and cuda predicate engines (raw columns and words equal) and
     chunked over a store under ``.chunk_store/spec`` (valid rows equal;
     SP003 plans refused by its preflight), 24 mutations each rejected with
     their ``SPEC-nnn`` code; B1-B3 must have launched;
  6. service: the cohort-query service on the quickstart's resident star
     (``--n-patients``) under the cuda engines, 8 slots, a 16 GiB cache:
     ``benchmarks/serving_bench.py``'s mix re-expressed with the port (32
     queries of 4 tenants over its three shapes, literals of their own,
     after one warm-up query a shape), each result taken and let go as the
     drain resolves it; the naive path (one solo run a query), the service
     synchronous and pipelined (walls, submit_s, realize_s, overlap_s,
     latency p50/p95, hits, misses, evictions, bytes cached, peak memory):
     3 runners built, 0 demotions, and B1/B2/B3 launches equal to what the
     solo runs and the hit counts predict; both modes again on fresh
     services with every ticket checked against its solo run (every slot,
     words, counts, FlatteningStats, cohorts, flow, plan log), hits and
     misses equal to the timed serves'; a wire spec of shape full equal to
     its Study twin and a malformed spec ``invalid`` with SPEC-012; one
     warm pipelined serve traced (``chiprun_out/service_trace.json``);
  7. cohort study: ``examples/cohort_study.py``'s plan (DCIR and PMSI,
     exposures, fractures, follow-up, cohort algebra, flow, the dense and
     token featurizes) at ``--cohort-patients``, checked, timed and traced
     the same way (``chiprun_out/cohort_study_trace.json``), with B4 timed at
     the shapes ``exposures`` gave it;
  8. card against CPU: both studies at 20,000 patients on the card and on
     the CPU (the plain versions) must agree bit for bit;
  9. attention: B6 (flash attention) against its plain version on the card
     over the reference's test sweep, h2o-danube-1.8b's shapes (prefill
     to 8,192 tokens with window 4,096, full-cache decode offsets, the
     ring-buffer mode, ragged shapes) and gemma3-12b's (16/8 heads of 240:
     local and global prefill to 8,192, decode offsets, the ring with 1 and
     3 queries), head dim 256, and every head dim on the bf16 prefill kernel
     with ragged Sq and kv_len and a window edge inside a tile, fp32 within
     2e-5 and bf16 within 2e-2; every call of at most 16 rows per KV head
     (group x Sq) must take the decode route (split-KV flash-decoding,
     ``csrc/swa_decode.cu``), every other call the prefill kernel (bf16:
     ``csrc/swa_prefill.cu``, TMA and wgmma; fp32:
     ``csrc/swa_attention.cu``), which must have run at every head dim;
  10. serving: h2o-danube-1.8b at full width (24 layers, bf16, random weights
     from a seeded generator on the card): a 2 x 8,192-token prefill under
     the cuda and torch attention engines (B6 launched once per layer, the
     last-token logits within 0.1; the decode route never taken), the
     continuous batcher (4 slots, every cache a 4,096-slot ring, 8 requests
     of 16-256 prompt tokens, 32 new each: all finish; every attention call
     takes the decode route), a teacher-forced decode past position 4,096
     (the ring wraps; its wall before and after the wrap) under both
     engines in fp32 (within 1e-3) and bf16 (within 0.1), cut to 4 layers
     at full width, and the reduced config on the card against the CPU
     (within 1e-5); B6 is timed at the prefill's shape and its decode route
     at the batcher's shape over a full ring (the L2 cache cleared before
     every rep: one layer's 42 MB of K/V would fit in it), beside its plain
     version, torch's scaled_dot_product_attention with a boolean mask (a
     yardstick the port never calls) and its bound, each time the middle
     of 3 separate medians of 20 reps with their min-max, and one prefill,
     one warm batcher step and one decode pass over full rings are traced
     (``chiprun_out/serving_*_trace.json``).
  11. gemma3: one gemma3-12b local layer at full width over its 1,024-slot
     ring with 3 queries a call, before and after the wrap, cuda engine
     against torch engine (fp32 within 1e-3, bf16 within 0.1); then the
     whole model at full width (48 layers, bf16, seeded random weights on
     the card, after the danube model is freed): a 1 x 4,096-token prefill
     under both engines (B6's prefill kernel once per layer at head dim
     240, its decode route never), then the same weights in fp32 under
     both (last-token logits within 1e-3; in bf16 the cuda engine no more
     than 0.1 further from the fp32 model than the torch engine), and B6
     timed at the model's global (causal) and local (window 1,024) prefill
     shapes as in phase 10.
  12. partition: B5 (the shuffle's plan) against its plain version, bit for
     bit, over 1-64 destinations, blocks 256/512/1024, ragged lengths,
     invalid rows, NULL and negative keys; B2b (compaction by a bool mask,
     a single pass with decoupled look-back) through ``ops.filter_compact``
     against its plain version at the edges of its 4,096-row tiles and up to
     48M rows, once with 7 columns, and timed there;
  13. sharded: the quickstart through ``Study.run(mesh=group)`` on 4 gloo
     ranks of one process group, all on the one card, at
     ``--sharded-patients`` (2,000,000 by default): every rank launches B5
     once per exchange (5) and B3 once, no exchange overflows, no rank
     holds more of a table output than its own block (the blocks' counts
     add up to the global count), the cuda engines equal the torch engines
     (each rank's block words, the valid rows of every block, gathered),
     the sharded result equals the single-card run of the same seed (event
     rows as multisets, cohort words, flow, join stats), each rank's output
     capacities, peak memory, staged bytes and collectives are printed,
     and at 20,000 patients
     the quickstart, ``distributed_flatten`` and ``exposures_sharded`` on
     the card equal the same 4 ranks on the CPU (through the package's
     rank functions in ``distributed.launch``); B5 is timed at rank 0's
     largest exchange beside its plain version, its bound and the torch
     engine's ``hash_partition`` (the argsort route, a yardstick).

Each kernel's launches are counted over the two studies' first runs, the
first chunked run (with prefetch), the spec corpus, the timed pipelined
service serve, the serving path (prefill and batcher), gemma3-12b's
prefill and the sharded run's first cuda run (summed over ranks), with
the counts set to 0 just before each.  B6's
``flash_attention`` count takes one per call on either route; its record's
launches are those calls less the decode route's (``flash_decode``), which
has a record of its own.  B2b runs on none of these paths (no caller
compacts by a bool mask): its count is 0.  The last lines of standard output
are the card's name and power limit, one JSON line with the kernel records,
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# memory rate of each card, bytes/s (NVIDIA data sheets); the bound of a
# kernel is the bytes it must move over this rate
_MEM_RATE = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12))


LOG = {"file": None}       # main() also writes every line to a log file


def log(*a) -> None:
    print(*a, flush=True)
    if LOG["file"] is not None:
        print(*a, file=LOG["file"], flush=True)


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


L2_FLUSH = {"buf": None}    # 256 MiB read before a cold rep: 5x the L2
SPIN_CYCLES = 2_000_000     # ~1 ms of device spin ahead of every timed rep


def cuda_ms(fn, reps: int, cold: bool = False) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after one warm-up).
    Each rep starts behind a spin kernel of ~1 ms, so that the host has
    queued all of ``fn``'s launches before the card reaches the first
    event: the time is the card's, not the host's.  ``cold``: the L2 cache
    is cleared before each rep, outside the timed window, by reading a
    256 MiB buffer (a read leaves no dirty lines to write back)."""
    import torch

    if cold and L2_FLUSH["buf"] is None:
        L2_FLUSH["buf"] = torch.zeros(32 << 20, dtype=torch.int64,
                                      device="cuda")
    fn()
    times = []
    for _ in range(reps):
        if cold:
            L2_FLUSH["buf"].sum()
        torch.cuda._sleep(SPIN_CYCLES)
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
SNDS_WORDS = 2_062_500    # B3 at the SNDS universe, 66M patients
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
        # whitelists of the full MAX_ISIN_VALUES (staged in shared memory,
        # the int ones as bitmaps), one past it (searched in global memory),
        # eight at once (every table slot), and a hoisted one of 1,024
        # values
        col("a").isin(list(range(-509, 515))),
        col("x").isin([float(v) / 8 for v in range(-512, 512)]),
        col("b").isin(list(range(-3, 1098))),
        # int whitelists too wide for a bitmap (searched in shared memory),
        # one holding the NULL sentinel
        col("a").isin([-10 ** 6, 3, 4, 10 ** 6]),
        col("a").isin([-2 ** 31 + 1, 4]) | col("b").isin([2 ** 31 - 1, -2]),
        _any_isin([col(c) for c in "abzabzab"], 1024),
        HoistedIsIn(col("a") + col("b"), 2, 1024, False),
        # 16 live registers: 15 register-file slots, the 8-row kernel
        _nested_sum("abzab" * 3 + "z") > 0,
        # a balanced tree: many live registers (register-file slots)
        (((col("a") < 3) | (col("b") > 2)) & ((col("x") < 0.5)
                                              | (col("y") > -0.5)))
        & (((col("z") != 0) | (col("a") + col("b") < col("z") * 4))
           & ((col("x") * col("y") < 0.25) | col("a").is_null())),
    ]


def _nested_sum(names: str):
    """``c0 + (c1 + (... + c_last))`` over the columns ``names``: each
    left operand stays live until the innermost sum is done."""
    from repro_torch.study import col

    e = col(names[-1])
    for c in reversed(names[:-1]):
        e = col(c) + e
    return e


def _any_isin(operands, size: int):
    """``operand_k in W_k`` OR'd over k: one whitelist of ``size`` values
    (shifted by 3 k) for each operand."""
    e = None
    for k, x in enumerate(operands):
        term = x.isin(list(range(3 * k - size // 2, 3 * k + size - size // 2)))
        e = term if e is None else e | term
    return e


def battery_params():
    """The bound (literals, whitelists) behind the battery's hoisted slots."""
    import numpy as np

    return ((np.int32(4), np.float32(-0.5)),
            (np.array([7, -3, 2, 2, 11], np.int32),
             np.array([0.25, np.nan, -1.0], np.float32),
             np.arange(-700, 2 * 1024 - 700, 2, dtype=np.int32)))


def denormal_battery():
    """C4: float32 denormals of both signs in columns, literals and
    whitelists, under arithmetic and compares (the battery's ``x`` and
    ``y`` columns draw from ``DENORMALS``); with ``denormal_params``."""
    from repro_torch.study import col
    from repro_torch.study.expr import HoistedIsIn, HoistedLit

    return [col("x") > 0, col("x") == 0, col("x") * 1e30 > 0,
            col("x") < 0.0, col("y") >= 1e-40, col("x") - col("y") == 0,
            col("x") * col("y") != 0, col("x") // -1.0 < col("y"),
            col("x") % col("y") >= 0, col("b") * 1e-44 == col("x"),
            col("x").isin([1e-40, -2.5]), col("y").isin([0.0, 1e30]),
            col("x") > HoistedLit(1), col("y") == HoistedLit(1),
            HoistedIsIn(col("x"), 1, 3, True)]


# denormals of both signs, signed zeros, the least normals, NaN and others
DENORMALS = (1e-45, -1e-45, 1e-39, -1e-40, 3e-39, 0.0, -0.0, 1.1754944e-38,
             -1.1754942e-38, float("nan"), 1.0, -2.5, 1e30)


def denormal_params():
    import numpy as np

    lits, vecs = battery_params()
    return ((lits[0], np.float32(-1e-40)),
            (vecs[0], np.array([1e-41, 2.0, -1e-45], np.float32), vecs[2]))


def battery_columns(n: int, device, denormal: bool = False):
    """The battery's columns and validity words over ``n`` rows: NULLs,
    NaNs and zero divisors, from a seed of ``n``; with ``denormal``, the
    float columns drawn from ``DENORMALS``."""
    import numpy as np
    import torch

    from repro_torch.core import bitset as bs
    from repro_torch.core.columnar import NULL_INT

    rng = np.random.default_rng(n)
    a = rng.integers(-5, 15, n).astype(np.int32)
    a[rng.random(n) < 0.25] = NULL_INT
    x = rng.normal(size=n).astype(np.float32)
    x[rng.random(n) < 0.2] = np.nan
    y = rng.normal(size=n).astype(np.float32)
    y[rng.random(n) < 0.2] = 0.0
    if denormal:
        pool = np.array(DENORMALS, np.float32)
        x, y = rng.choice(pool, n), rng.choice(pool, n)
    cols = {"a": a, "b": rng.integers(-5, 15, n).astype(np.int32),
            "x": x, "y": y,
            "z": rng.integers(-2, 3, n).astype(np.int32)}
    cols = {k: torch.from_numpy(v).to(device) for k, v in cols.items()}
    valid = bs.pack(torch.from_numpy(rng.random(n) < 0.85).to(device))
    return cols, valid, rng


def check_predicates(exprs, cols, valid, n: int, params) -> int:
    """Each expression through the kernel against its plain version, bit
    for bit; returns the number checked."""
    import torch

    from repro_torch.kernels import predicate as pk

    for e in exprs:
        param = e.to_param()
        prog = pk.compile_program(param, *pk._kinds(cols, param, params))
        got = pk.predicate_bitset(cols, valid, expr_param=param, capacity=n,
                                  params=params)
        want = pk.predicate_bitset_plain(prog, cols, valid, n, params) \
            if n else got
        torch.cuda.synchronize()
        if not (_same(got[0], want[0]) and int(got[1]) == int(want[1])):
            fail(f"predicate kernel != plain at n={n} for {e!r}")
    return len(exprs)


def kernel_battery(device) -> None:
    import torch

    from repro_torch.kernels import filter_compact as fc

    exprs = expr_battery()
    params = battery_params()
    checked = 0
    for n in EDGE_SIZES:
        cols, valid, _ = battery_columns(n, device)
        checked += check_predicates(exprs, cols, valid, n, params)
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
    # C4: denormals in columns, literals and whitelists (flushed as XLA does)
    for n in (1025, 100_003):
        cols, valid, _ = battery_columns(n, device, denormal=True)
        checked += check_predicates(exprs + denormal_battery(), cols, valid,
                                    n, denormal_params())
    log(f"kernels: {checked} kernel-vs-plain checks bit-identical "
        f"at n in {EDGE_SIZES}, and with float32 denormals at 1025 and "
        f"100003 rows")
    predicate_edges(device, exprs, params)
    bitset_battery(device)


def random_program(rng, n_leaves: int, n_ops: int, first_op: int = 0):
    """A seeded B3 program: op ``j`` is ``OPS[(first_op + j) % 4]``, each
    operand a leaf or, half the time where there is one, an earlier op."""
    from repro_torch.kernels import bitset_ops as bo

    ops = list(bo.OPS)
    return tuple(
        (ops[(first_op + j) % 4],
         *[int(rng.integers(n_leaves, n_leaves + j)) if j
           and rng.random() < 0.5 else int(rng.integers(0, n_leaves))
           for _ in range(2)])
        for j in range(n_ops))


def bitset_battery(device) -> None:
    """B3's program kernel against its plain version, bit for bit: programs
    of 1-8 ops over 1-8 leaves covering every op, aligned and misaligned
    (scalar path) views, sizes at its block and grid edges up to 2,062,500
    words, with the pool's blocks of its count buffers poisoned (-1) and
    freed before every launch."""
    import numpy as np
    import torch

    from repro_torch.kernels import bitset_ops as bo

    t = bo.THREADS
    sms, per_sm = bo._limits(device, 1)
    wave = sms * per_sm * t * 4     # the widest grid's
    sizes = sorted({0, 1, 3, 4, 5, t - 1, t + 1, 4 * t - 1, 4 * t,
                    4 * t + 1, 62_500, wave - 1, wave + 5, SNDS_WORDS})
    rng = np.random.default_rng(17)
    checked = 0
    for n in sizes:
        base = torch.randint(-2**31, 2**31 - 1, (8, n + 1),
                             dtype=torch.int32, device=device)
        for k, (n_leaves, n_ops) in enumerate(
                [(i + 1, 8 - i) for i in range(8)]):
            prog = random_program(rng, n_leaves, n_ops, first_op=k)
            for off in (0, 1):
                leaves = [base[i, off:n + off] for i in range(n_leaves)]
                grid = bo.expr_grid(n if off else n // 4 + n % 4,
                                    *bo._limits(device, n_ops))
                junk = [torch.full((n_ops * (1 + grid),), -1,
                                   dtype=torch.int32, device=device)
                        for _ in range(8)]
                del junk
                got, gc = bo.bitset_expr_kernel(leaves, prog)
                want, wc = bo.bitset_expr_plain(leaves, prog)
                torch.cuda.synchronize()
                if not (_same(got, want) and _same(gc, wc)):
                    fail(f"bitset_expr kernel != plain at n={n} "
                         f"offset={off} program={prog}")
                checked += 1
    log(f"kernels: {checked} bitset_expr (B3) kernel-vs-plain checks "
        f"bit-identical (1-8 ops over 1-8 leaves, every op, offsets 0/1, "
        f"poisoned counts) at n in {sizes}; its grid: {sms} SMs x "
        f"{[bo._limits(device, k)[1] for k in range(1, 9)]} blocks of "
        f"{bo.THREADS} for 1-8 ops")


def predicate_sizes(exprs, params, device):
    """B1's sizes at the edges of its design: one tile (± 1 row), one full
    wave of the persistent grid (grid x tile ± 33, for each grid and tile
    the battery's programs get) and one where every block walks at least 3
    tiles; and those (grid, tile) pairs."""
    from repro_torch.kernels import predicate as pk

    cols, _, _ = battery_columns(1, device)
    sizes, waves = set(), set()
    for e in exprs:
        param = e.to_param()
        prog = pk.compile_program(param, *pk._kinds(cols, param, params))
        plan = pk.device_plan(prog, 1 << 40, device, params)
        sizes |= {plan.tile - 1, plan.tile, plan.tile + 1}
        waves.add((plan.grid, plan.tile))
    for g, tile in waves:
        sizes |= {g * tile - 33, g * tile + 33}
    sizes.add(3 * max(g * tile for g, tile in waves) + 17)
    return sorted(sizes), sorted(waves)


def predicate_edges(device, exprs, params) -> None:
    """The whole expression battery at B1's tile and wave edges."""
    import torch

    sizes, waves = predicate_sizes(exprs, params, device)
    checked = 0
    for n in sizes:
        cols, valid, _ = battery_columns(n, device)
        checked += check_predicates(exprs, cols, valid, n, params)
        del cols, valid
    torch.cuda.empty_cache()
    log(f"kernels: {checked} predicate kernel-vs-plain checks bit-identical "
        f"at B1's tile and wave edges, n in {sizes} (persistent grids, "
        f"tiles: {waves})")


# to 4,103 rows: the 512-row blocks' edges; then hundreds of the kernel's
# 4,096-row look-back tiles
SCAN_SIZES = (1, 31, 511, 512, 513, 4096 + 7, 300 * 4096 + 5,
              1000 * 4096 - 1)
SCAN_BLOCKS = (32, 512, 4099)   # 4,099: block edges off the tile grid
# values beyond the reference kernel's ±2e9 fills, where its clamp shows
EXTREMES = (2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1, 2_000_000_000,
            -2_000_000_000, 2_100_000_000, -2_100_000_000, 0, 7)


def segment_scan_battery(device) -> None:
    """B4 against its plain version, bit for bit: random, all and only-first
    flags, runs spanning many blocks (and, with no flag, every look-back
    tile), extreme values, both fills."""
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
                for block in SCAN_BLOCKS:
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
        f"bit-identical at n in {SCAN_SIZES}, blocks {SCAN_BLOCKS}")


# ---------------------------------------------------------------------------
# phases 3, 7 and 8: the quickstart, the cohort study, card against CPU
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
    if (a.flow is None) != (b.flow is None) or (
            a.flow is not None and a.flow.flowchart() != b.flow.flowchart()):
        fail(f"{what}: flow differs")
    if sorted(a.features) != sorted(b.features) \
            or a.feature_checks != b.feature_checks:
        fail(f"{what}: features or feature checks differ")
    for name, fa in a.features.items():
        fb = b.features[name]
        pairs = zip(fa, fb) if isinstance(fa, tuple) else [(fa, fb)]
        if not all(_same(x, y) for x, y in pairs):
            fail(f"{what}: feature {name} differs")


PEAKS = {}        # label -> (peak, held) device bytes of drive()'s first run


class Recorder:
    """Keeps the largest call of a kernel wrapper on the main path, so that
    the kernel can be timed at the shapes the path gave it; with ``second``,
    also the call that ranks highest by that key."""

    def __init__(self, module, name, size, second=None):
        self.module, self.name, self.size = module, name, size
        self.second = second
        self.fn = getattr(module, name)
        self.best = None
        self.other = None

    def __call__(self, *args, **kwargs):
        s = self.size(*args, **kwargs)
        if self.best is None or s > self.best[0]:
            self.best = (s, args, kwargs)
        if self.second is not None:
            k = self.second(*args, **kwargs)
            if self.other is None or k > self.other[0]:
                self.other = (k, args, kwargs)
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
                predicate, "_launch", lambda prog, cols, valid, cap, p: cap,
                second=longest_program),
            "filter_compact": Recorder(
                filter_compact, "filter_compact_bits",
                lambda cols, words: cols[0].shape[0] * len(cols)),
            "bitset_op": Recorder(bitset_ops, "bitset_expr_kernel",
                                  lambda leaves, prog: leaves[0].shape[0]),
            "segmented_scan": Recorder(
                segment_scan, "segmented_scan_kernel",
                lambda words, vals, block, fill: vals.shape[0])}


def longest_program(prog, cols, valid, cap, params):
    """B1's second timed program: the one with a whitelist, then the most
    instructions, then the most rows."""
    isin = any(i[0].startswith("ISIN") for i in prog.instrs)
    return (isin, len(prog.instrs), cap)


def drive(label: str, study, tables, kernels, reps: int, rate: float):
    """The main path of one study: its first run on the card with the cuda
    engines (launch counts set to 0 just before and read just after; every
    kernel in ``kernels`` must launch), a warm rerun, the torch engines, and
    the timing of each kernel at the largest shape the first run gave it."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    recs = recorders()
    held = torch.cuda.memory_allocated()
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
    PEAKS[label] = (peak, held)
    res.assert_no_loss()
    log(f"{label}: cuda engines wall {wall:.3f} s (first run), peak device "
        f"memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB of it held "
        f"before the run), launches {launches}")
    for k in kernels:
        if launches[k] <= 0:
            fail(f"{label}: kernel {k} was never launched on the main path")
    from repro_torch.study.executor import cohort_groups

    if launches["bitset_op"] != len(cohort_groups(res.plan)):
        fail(f"{label}: {launches['bitset_op']} B3 launches for "
             f"{len(cohort_groups(res.plan))} cohort expressions")
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
    launches, timing, res = drive(
        "quickstart", study, dcir,
        ("predicate_bitset", "filter_compact", "bitset_op"), reps, rate)
    return launches, timing, study, dcir, res


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
    import torch

    def run():
        run_once()
        torch.cuda.synchronize()

    run()
    with profiled() as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    for line in trace_report(label, prof, wall_us):
        log(line)


def profiled():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def trace_report(label: str, prof, wall_us: float) -> list:
    """The trace as ``{label}_trace.json`` beside the log, and lines with the
    device's busy time and idle share of ``wall_us`` and the device time of
    the 25 largest kernels, copies and fills."""
    import collections

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
    lines = [f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
             f"{busy_us / 1e3:.3f} ms ({len(events)} device events), idle "
             f"share {1 - busy_us / wall_us:.4f}"]
    for name, us in by_name.most_common(25):
        lines.append(f"profile {label}: {us / 1e3:9.3f} ms device "
                     f"{calls[name]:6d} calls  {name}")
    return lines


def time_kernels(recs, reps: int, rate: float):
    """Each recorded kernel against its plain version at the recorded shape
    (bit for bit), then timed: kernel, plain version, library call."""
    from repro_torch.core import bitset as bs
    from repro_torch.kernels import filter_compact, segment_scan

    out = {}
    if "predicate_bitset" in recs:
        rec = recs["predicate_bitset"]
        out["predicate_bitset"] = time_predicate(rec.fn, rec.best[1], reps,
                                                 rate)
        other = time_predicate(rec.fn, rec.other[1], reps, rate)
        out["predicate_bitset"]["longest"] = other
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
        t = dict(n=n, columns=None, library_ms=None,
                 bound_ms=nbytes / rate * 1e3, max_abs_err=0.0)
        for key, fn in (("ms", kern), ("plain_ms", plain)):
            t[key], lo, hi = spread_ms(fn, reps)
            t[key + "_range"] = (lo, hi)
        out["segmented_scan"] = t
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
        out["bitset_op"] = time_bitset(recs["bitset_op"], reps, rate)
    for k, v in out.items():
        for label, t in [(k, v)] + [(f"{k} ({sub})", v[sub])
                                    for sub in ("longest", "snds")
                                    if sub in v]:
            spread = "" if "ms_range" not in t else (
                f" [{t['ms_range'][0]:.4f}-{t['ms_range'][1]:.4f}], middle "
                f"of {TIMING_CALLS} medians of {reps}")
            log(f"timing: {label} n={t['n']} columns={t['columns']} "
                f"{t.get('program', '')}kernel {t['ms']:.4f} ms{spread}, "
                f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']}, "
                f"bound {t['bound_ms']:.4f} ms "
                f"({100 * t['bound_ms'] / t['ms']:.1f} % reached)")
    return out


EMPTY_KERNEL = r"""
__global__ void empty_kernel() {}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def empty_launch_ms(reps: int):
    """The card's floor for one launch: an empty kernel, built alone (it
    is no kernel of the port), timed as the kernels are (middle, min, max
    of ``TIMING_CALLS`` medians)."""
    import ctypes
    import tempfile

    import torch

    from repro_torch.kernels import build

    with tempfile.TemporaryDirectory() as tmp:
        src, so = Path(tmp) / "empty.cu", Path(tmp) / "empty.so"
        src.write_text(EMPTY_KERNEL)
        r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                            "-o", str(so), str(src)], capture_output=True,
                           text=True)
        if r.returncode != 0:
            fail(f"nvcc failed on the empty kernel:\n{r.stdout}{r.stderr}")
        lib = ctypes.CDLL(str(so))
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    launch = lambda: build.check(lib.empty_launch(  # noqa: E731
        torch.cuda.current_stream().cuda_stream), "empty launch")
    return spread_ms(launch, reps)


def time_bitset(rec, reps: int, rate: float) -> dict:
    """B3 on the recorded call (the study's cohort expression: one launch)
    and on the same program over the SNDS universe (``SNDS_WORDS``, seeded
    leaves, L2 cleared before each rep: its 41 MB would fit in L2), each
    against its plain version bit for bit, then kernel and plain version as
    the middle of ``TIMING_CALLS`` medians with their min-max, beside the
    empty-launch floor.  Bound: ``4 B x (leaves + ops)`` a word."""
    import torch

    from repro_torch.kernels import bitset_ops

    leaves, prog = rec.best[1]
    n = leaves[0].shape[0]
    big = [torch.randint(-2**31, 2**31 - 1, (SNDS_WORDS,), dtype=torch.int32,
                         device=leaves[0].device) for _ in leaves]
    out = {}
    for label, ls, cold in (("study", leaves, False),
                            ("snds", big, True)):
        kern = lambda ls=ls: rec.fn(ls, prog)  # noqa: E731
        plain = lambda ls=ls: bitset_ops.bitset_expr_plain(  # noqa: E731
            ls, prog)
        (g, gc), (w, wc) = kern(), plain()
        if not (_same(g, w) and _same(gc, wc)):
            fail(f"bitset_expr kernel != plain at the {label} shape")
        m = ls[0].shape[0]
        t = dict(n=m, columns=None, library_ms=None, max_abs_err=0.0,
                 bound_ms=4 * (len(ls) + len(prog)) * m / rate * 1e3,
                 program=f"({len(prog)} ops over {len(ls)} leaves "
                         f"{list(prog)}{', L2 cleared' if cold else ''}) ")
        for key, fn in (("ms", kern), ("plain_ms", plain)):
            t[key], lo, hi = spread_ms(fn, reps, cold)
            t[key + "_range"] = (lo, hi)
        out[label] = t
    floor, lo, hi = empty_launch_ms(reps)
    res = dict(out["study"], snds=out["snds"], floor_ms=floor,
               floor_range=(lo, hi))
    log(f"timing: empty launch (the card's floor for one launch) "
        f"{floor:.4f} ms [{lo:.4f}-{hi:.4f}]; B3 over {n} words "
        f"{res['ms']:.4f} ms and {out['snds']['ms']:.4f} ms over "
        f"{SNDS_WORDS} (bounds {res['bound_ms']:.4f} and "
        f"{out['snds']['bound_ms']:.4f} ms)")
    return res


def time_predicate(fn, args, reps: int, rate: float) -> dict:
    """B1 on one recorded call: against its plain version bit for bit, then
    kernel and plain version as the middle of ``TIMING_CALLS`` medians."""
    from repro_torch.kernels import predicate

    prog, cols, valid, cap, params = args
    kern = lambda: fn(prog, cols, valid, cap, params)  # noqa: E731
    plain = lambda: predicate.predicate_bitset_plain(  # noqa: E731
        prog, cols, valid, cap, params)
    got, want = kern(), plain()
    if not (_same(got[0], want[0]) and int(got[1]) == int(want[1])):
        fail("predicate kernel != plain at the main path's shape")
    plan = predicate.device_plan(prog, cap, valid.device, params)
    nbytes = (4 * len(prog.columns) + 0.25) * cap
    out = dict(n=cap, columns=len(prog.columns), library_ms=None,
               bound_ms=nbytes / rate * 1e3, max_abs_err=0.0,
               program=f"({len(prog.instrs)} instructions "
                       f"{[i[0] for i in prog.instrs]}, {plan.n_slots} "
                       f"register-file slots, grid {plan.grid}, "
                       f"{plan.smem_bytes} B shared memory) ")
    for key, f in (("ms", kern), ("plain_ms", plain)):
        out[key], lo, hi = spread_ms(f, reps)
        out[key + "_range"] = (lo, hi)
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


# ---------------------------------------------------------------------------
# phase 4: the quickstart out of core (chunked), checked and normalized
# ---------------------------------------------------------------------------
CHUNK_CAPACITY = 1 << 23     # ER_PRS rows a chunk: 6 chunks at 2,000,000
RESUME_PATIENTS = 200_000    # the kill-and-resume store (5 chunks)
RESUME_CAPACITY = 1 << 20


def plan_entries(log_) -> list:
    """The ``record_plan`` entries of an OperationLog, without ``ts``."""
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in log_.entries if e["op"].startswith("plan:")]


def chunk_digest(res) -> dict:
    """What the chunked phase compares of a result, on the host: each event
    table's count and valid rows in order (a chunked table is its chunks'
    tables concatenated, so its capacity and padding differ), cohort words
    and counts, flow, FlatteningStats (uint32 checksums included) and the
    plan entries of the OperationLog."""
    events = {}
    for name, t in res.events.items():
        keep = t.valid_bool()
        events[name] = (int(t.count),
                        {c: v[keep].cpu() for c, v in t.columns.items()})
    return dict(events=events, stats=res.flatten_stats,
                cohorts={k: (c.subjects.cpu(), c.subject_count())
                         for k, c in res.cohorts.items()},
                flow=res.flow.flowchart(), log=plan_entries(res.log))


def compare_chunked(a: dict, b: dict, what: str) -> None:
    if sorted(a["events"]) != sorted(b["events"]):
        fail(f"{what}: different outputs")
    for name, (na, ca) in a["events"].items():
        nb, cb = b["events"][name]
        if na != nb or sorted(ca) != sorted(cb) or not all(
                _same(ca[c], cb[c]) for c in ca):
            fail(f"{what}: {name} valid rows differ ({na} vs {nb} rows)")
    if sorted(a["cohorts"]) != sorted(b["cohorts"]) or not all(
            _same(w, b["cohorts"][k][0]) and n == b["cohorts"][k][1]
            for k, (w, n) in a["cohorts"].items()):
        fail(f"{what}: cohort words or counts differ")
    if a["stats"] != b["stats"]:
        fail(f"{what}: FlatteningStats differ")
    if a["flow"] != b["flow"]:
        fail(f"{what}: flow differs")
    if a["log"] != b["log"]:
        fail(f"{what}: the OperationLog's plan entries differ")


def chunked_prepare(study, dcir, res, store_dir, peak,
                    normalized: bool = True) -> dict:
    """With the quickstart's star and its resident cuda result still on the
    card: the store, the resident result's digest, ``Study.check`` against
    the diag golden, and (``normalized``) the normalized plan on the card.
    ``peak`` is the resident run's ``(peak, held)`` device bytes."""
    import torch

    from repro_torch.data import partition_star

    t0 = time.perf_counter()
    store = partition_star(dcir, str(store_dir), source="ER_PRS",
                           chunk_capacity=CHUNK_CAPACITY)
    size = sum(p.stat().st_size for p in Path(store_dir).rglob("*.npz"))
    log(f"chunked: partitioned ER_PRS ({store.manifest.total_rows} rows) "
        f"into {store.n_chunks} chunks of {CHUNK_CAPACITY} rows, "
        f"{size / 2**30:.3f} GiB on disk, in "
        f"{time.perf_counter() - t0:.3f} s")
    if store.n_chunks < 3:
        fail(f"chunked: only {store.n_chunks} chunks")

    diags = study.check(predicate_engine="cuda", engine="cuda", device="cuda")
    want = json.loads((REPO / "tests" / "goldens" / "quickstart_diag.json")
                      .read_text())
    got = [(d.code, d.severity, d.node) for d in diags]
    if got != [(d["code"], d["severity"], d["node"]) for d in want]:
        fail(f"chunked: Study.check gave {got}, not the diag golden's")
    log(f"chunked: Study.check == tests/goldens/quickstart_diag.json {got}")

    if normalized:
        normalized_check(study, dcir, res)
    torch.cuda.synchronize()
    return dict(store=store, want=chunk_digest(res), peak=peak,
                n_patients=study.n_patients)


def resident_run(n_patients: int):
    """A star at ``n_patients`` on the card and the quickstart's resident
    run under the cuda engines: ``(study, star, result, launches, (peak,
    held))``, the counts at 0 just before the run."""
    import torch

    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir
    from repro_torch.kernels import launch_counts, reset_launch_counts

    dcir = generate_dcir(SyntheticConfig(n_patients=n_patients, seed=0),
                         device="cuda")
    study = build_study(n_patients)
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = study.run(dict(dcir), engine="cuda", predicate_engine="cuda",
                    device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"chunked: resident quickstart at {n_patients} patients "
        f"({int(dcir['ER_PRS'].count)} ER_PRS rows): wall {wall:.3f} s, "
        f"peak device memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} "
        f"GiB of it the star)")
    return study, dcir, res, dict(launch_counts), (peak, held)


def normalized_check(study, dcir, res) -> None:
    """normalize -> execute(expr_params=device_params(...)) on the card
    equals the plan's own run, node for node; B1 launches as often, with
    hoisted operands, and nothing is demoted."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import predicate as pk
    from repro_torch.study import device_params, normalize
    from repro_torch.study.executor import execute

    plan = res.plan
    nplan = normalize(plan)
    if nplan.demoted:
        fail(f"normalize demoted nodes {nplan.demoted}")
    hoisted = []
    launch = pk._launch

    def spy(prog, *a):
        hoisted.append(len(prog.lits)
                       + sum(t[0] == "vec" for t in prog.tables))
        return launch(prog, *a)

    kw = dict(n_patients=study.n_patients, engine="cuda",
              predicate_engine="cuda")
    reset_launch_counts()
    want = execute(plan, dict(dcir), **kw)
    b1 = launch_counts["predicate_bitset"]
    pk._launch = spy
    try:
        reset_launch_counts()
        got = execute(nplan.plan, dict(dcir),
                      expr_params=device_params(nplan, device="cuda"), **kw)
    finally:
        pk._launch = launch
    if launch_counts["predicate_bitset"] != b1 or not max(hoisted, default=0):
        fail(f"normalized plan: {launch_counts['predicate_bitset']} B1 "
             f"launches (plan: {b1}), hoisted operands {hoisted}")
    outs, ids = dict(nplan.out_map), dict(nplan.plan.outputs)
    for name, i in plan.outputs:
        if i not in want:
            continue
        a, b = want[i], got[ids[outs[name]]]
        if hasattr(a, "columns"):
            same = (int(a.count) == int(b.count) and _same(a.valid, b.valid)
                    and all(_same(a.columns[c], b.columns[c])
                            for c in a.columns))
        else:
            same = _same(a, b)
        if not same:
            fail(f"normalized plan: output {name} differs")
    log(f"chunked: normalized quickstart on the card == its plan "
        f"({len(nplan.lits)} literals, {len(nplan.vecs)} whitelists "
        f"hoisted; B1 {b1} launches with {max(hoisted)} hoisted operands, "
        f"none demoted)")


def chunked_run(study, store, what: str, **kw):
    """One chunked run under the cuda engines with the counts at 0 just
    before and the runner cache cleared; returns the result, the report,
    the launches and the peak device memory above what was held before."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.study import clear_jit_cache

    clear_jit_cache()
    gc.collect()                 # a dropped result lives in cycles until now
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    rep = {}
    t0 = time.perf_counter()
    res = study.run_chunked(store, engine="cuda", predicate_engine="cuda",
                            device="cuda", report_sink=rep, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated() - held
    log(f"chunked: {what}: {rep['n_chunks']} chunks, wall {wall:.3f} s "
        f"(the call), load_s {rep['load_s']:.6f}, exec_s "
        f"{rep['exec_s']:.6f}, wall_s {rep['wall_s']:.6f}, serial_s "
        f"{rep['serial_s']:.6f}, overlap_saved_s "
        f"{rep['overlap_saved_s']:.6f}, compiles {rep['compiles']}, peak "
        f"device memory {peak / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held before, launches {launches}")
    if rep["compiles"] != 1:
        fail(f"chunked: {what}: {rep['compiles']} runners built, not 1")
    return res, rep, launches, peak


def check_chunk_launches(launches, resident, n_chunks: int, groups: int,
                         what: str) -> None:
    """B1 and B2 launch once per node per chunk (the resident run's count
    on every chunk); B3 once per cohort expression per chunk, plus the
    replay over the merged words."""
    for k in ("predicate_bitset", "filter_compact"):
        if launches[k] != resident[k] * n_chunks:
            fail(f"chunked: {what}: {launches[k]} {k} launches, not "
                 f"{resident[k]} x {n_chunks} chunks")
    if launches["bitset_op"] != groups * (n_chunks + 1):
        fail(f"chunked: {what}: {launches['bitset_op']} B3 launches, not "
             f"{groups} expressions x ({n_chunks} chunks + the replay)")


def chunked_phase(prep: dict, resident_launches: dict, store_dir) -> dict:
    """The quickstart over the store with and without prefetch, bit for bit
    the resident run; a kill-and-resume; a traced run.  Returns the
    prefetching run's launches (the main path's)."""
    import shutil

    import torch

    from repro_torch.data import partition_star
    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir
    from repro_torch.study import ChunkedExecutor
    from repro_torch.study.chunked import _InjectedCrash
    from repro_torch.study.executor import cohort_groups

    store, want, n = prep["store"], prep["want"], prep["n_patients"]
    study = build_study(n)
    peak_res, held_res = prep["peak"]
    main = None
    for prefetch in (True, False):
        what = f"prefetch={prefetch}"
        res, rep, launches, peak = chunked_run(study, store, what,
                                               prefetch=prefetch)
        check_chunk_launches(launches, resident_launches, store.n_chunks,
                             len(cohort_groups(res.plan)), what)
        compare_chunked(chunk_digest(res), want,
                        f"chunked ({what}) vs resident")
        del res
        log(f"chunked: {what} == resident cuda run (valid rows in order, "
            f"cohort words and counts, flow, FlatteningStats, plan log); "
            f"peak {peak / 2**30:.3f} GiB vs the resident run's "
            f"{(peak_res - held_res) / 2**30:.3f} GiB above its star "
            f"({peak_res / 2**30:.3f} GiB with it)")
        if main is None:
            main = launches
    torch.cuda.empty_cache()

    small = generate_dcir(SyntheticConfig(n_patients=RESUME_PATIENTS,
                                          seed=1), device="cuda")
    sstudy = build_study(RESUME_PATIENTS)
    swant = chunk_digest(sstudy.run(dict(small), engine="cuda",
                                    predicate_engine="cuda", device="cuda"))
    sstore = partition_star(small, str(store_dir / "resume"),
                            source="ER_PRS", chunk_capacity=RESUME_CAPACITY)
    del small
    kw = dict(engine="cuda", predicate_engine="cuda", device="cuda",
              checkpoint_dir=str(store_dir / "ckpt"))
    ex = ChunkedExecutor(sstore, crash_after=2, **kw)
    try:
        ex.run(build_study(RESUME_PATIENTS))
        fail("chunked: crash_after=2 did not stop the run")
    except _InjectedCrash:
        pass
    ex = ChunkedExecutor(sstore, **kw)
    got = ex.run(build_study(RESUME_PATIENTS))
    if ex.report.resumed != 2 or ex.report.executed != sstore.n_chunks - 2:
        fail(f"chunked: resume restored {ex.report.resumed} and ran "
             f"{ex.report.executed} of {sstore.n_chunks} chunks")
    compare_chunked(chunk_digest(got), swant, "resumed vs resident")
    del got
    log(f"chunked: killed after 2 of {sstore.n_chunks} chunks at "
        f"{RESUME_PATIENTS} patients, resumed 2 and ran "
        f"{ex.report.executed}: == resident cuda run")
    shutil.rmtree(store_dir / "resume")
    shutil.rmtree(store_dir / "ckpt")

    profile_phase("chunked", lambda: study.run_chunked(
        store, engine="cuda", predicate_engine="cuda", device="cuda"))
    return main


# ---------------------------------------------------------------------------
# phase 5: the declarative front end (spec) and the differential fuzzer
# ---------------------------------------------------------------------------
FUZZ_N = 48                  # 24 valid specs, 24 mutations
FUZZ_PATIENTS = 200_000      # the star the fuzzed specs run over
KERNELS_B1_B3 = ("predicate_bitset", "filter_compact", "bitset_op")


def spec_phase(store_dir) -> dict:
    """The golden studies as wire specs, compiled specs on the card against
    their builder-made twins, and the fuzzer's corpus under the torch, cuda
    and chunked arms; returns the corpus run's launches."""
    import torch

    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.study import compile_spec, spec_from_study
    from repro_torch.study.defects import golden_studies
    from repro_torch.study.fuzz import run_corpus

    goldens = golden_studies()
    for name, study in goldens.items():
        want = json.loads((REPO / "tests" / "goldens" / f"{name}_spec.json")
                          .read_text())
        if json.loads(json.dumps(spec_from_study(study))) != want:
            fail(f"spec: spec_from_study({name}) != tests/goldens/"
                 f"{name}_spec.json")
        n = study.n_patients
        tables = (generate_dcir(SyntheticConfig(n_patients=n, seed=0),
                                device="cuda") if name == "quickstart"
                  else snds_tables(n, "cuda"))
        kw = dict(engine="cuda", predicate_engine="cuda", device="cuda")
        a = study.run(dict(tables), **kw)
        b = compile_spec(want).run(dict(tables), **kw)
        compare_results(a, b, f"spec: compiled {name} vs its builder",
                        full_columns=True)
        if plan_entries(a.log) != plan_entries(b.log):
            fail(f"spec: compiled {name}: the plan's log entries differ")
        log(f"spec: spec_from_study({name}) == tests/goldens/{name}_spec"
            f".json; compile_spec of it on the card == the builder's study "
            f"({n} patients, every slot, words, stats, cohorts, flow, "
            f"features, plan log)")
        del a, b, tables
    torch.cuda.empty_cache()

    gc.collect()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    report = run_corpus(n=FUZZ_N, seed=0, n_patients=FUZZ_PATIENTS,
                        store_dir=str(store_dir), engine="cuda",
                        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    for line in report.summary().splitlines():
        log(f"spec: {line}")
    log(f"spec: corpus of {FUZZ_N} at {FUZZ_PATIENTS} patients in "
        f"{wall:.3f} s, launches {launches}")
    if not report.ok:
        fail(f"spec: the fuzz corpus failed: {report.failures[:3]}")
    if report.arms != ("torch", "cuda", "chunked") \
            or report.n_valid != FUZZ_N - FUZZ_N // 2 \
            or report.n_mutated != FUZZ_N // 2:
        fail(f"spec: arms {report.arms}, {report.n_valid} valid and "
             f"{report.n_mutated} mutated specs checked")
    for k in KERNELS_B1_B3:
        if launches[k] <= 0:
            fail(f"spec: kernel {k} was never launched by the corpus")
    return launches


# ---------------------------------------------------------------------------
# phase 6: the cohort-query service over the quickstart's resident star
# ---------------------------------------------------------------------------
SERVICE_QUERIES = 32         # benchmarks/serving_bench.py's mix
SERVICE_TENANTS = 4
SERVICE_SLOTS = 8
SERVICE_CACHE = 16 << 30     # holds the shared flatten prefix at 2,000,000


def service_study(q: int, n_patients: int):
    """Query ``q`` of ``benchmarks/serving_bench.py``'s mix, re-expressed
    with the port: its three plan shapes in turn (``_shape_full``,
    ``_shape_drugs``, ``_shape_acts``), threshold ``40 + q`` and codes
    ``60 + q .. 119 + q``, so no two queries share their literals."""
    from repro_torch.core import (DCIR_SCHEMA, drug_dispenses,
                                  medical_acts_dcir)
    from repro_torch.study import Study, col

    threshold, codes = 40 + q, list(range(60 + q, 120 + q))
    s = Study(n_patients=n_patients).flatten(DCIR_SCHEMA)
    shape = q % 3
    if shape == 0:
        s.extract(drug_dispenses(codes=codes), name="drugs")
        s.extract(medical_acts_dcir(), name="acts")
        s.filter("acts", col("value") >= threshold, name="acts_hi")
        s.cohort("base", "drugs")
        s.cohort("final", "base & acts_hi")
    elif shape == 1:
        s.extract(drug_dispenses(codes=codes), name="drugs")
        s.cohort("exposed", "drugs")
    else:
        s.extract(medical_acts_dcir(codes=codes), name="acts")
        s.filter("acts", (col("value") >= threshold)
                 & (col("value") < threshold + 400), name="band")
        s.cohort("banded", "band")
    return s


def check_served(solo, got, what: str) -> None:
    """A served result against its solo run, bit for bit."""
    compare_results(solo, got, what, full_columns=True)
    if plan_entries(solo.log) != plan_entries(got.log):
        fail(f"{what}: the OperationLog's plan entries differ")


def new_service(dcir, pipeline: bool):
    from repro_torch.study import CohortQueryService, ServiceConfig

    return CohortQueryService(dict(dcir), device="cuda", config=ServiceConfig(
        n_slots=SERVICE_SLOTS, engine="cuda", predicate_engine="cuda",
        cache_budget_bytes=SERVICE_CACHE, pipeline=pipeline))


def serve(svc, n_patients: int, on_done) -> tuple:
    """The 32 queries of 4 tenants through ``svc``, each ticket handed to
    ``on_done`` as the drain resolves it; returns the tickets, the wall
    (to a synchronization) and the submit/realize stage times."""
    import torch

    sub0, rea0 = svc.stats.submit_s, svc.stats.realize_s
    t0 = time.perf_counter()
    tickets = [svc.submit(service_study(q, n_patients),
                          tenant=f"tenant{q % SERVICE_TENANTS}")
               for q in range(SERVICE_QUERIES)]
    svc.drain(on_done=on_done)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return tickets, wall, (svc.stats.submit_s - sub0,
                           svc.stats.realize_s - rea0)


def warm_up(svc, n_patients: int, on_done) -> None:
    """One query of each shape, with literals of its own, pays the
    service's three runner builds."""
    for i in range(3):
        svc.submit(service_study(SERVICE_QUERIES + i, n_patients),
                   tenant="warmup")
    svc.drain(on_done=on_done)


def require_done(ticket) -> None:
    if ticket.status != "done":
        fail(f"service: ticket {ticket.seq} of {ticket.tenant} is "
             f"{ticket.status}: {ticket.error!r}")


def take(ticket) -> None:
    """A tenant that takes its answer and lets the result go."""
    require_done(ticket)
    ticket.result = None


def predicted_launches(tickets, solo: dict) -> dict:
    """What the hit and miss counts predict: each query launches what its
    solo run launches, less one B1 launch for every predicate cut served
    from the cache (a hit node does not run; B2 and B3 never sit on a
    cut)."""
    from repro_torch.study.plan import PREDICATE_OPS

    out = {k: sum(solo[q][k] for q in range(SERVICE_QUERIES))
           for k in KERNELS_B1_B3}
    out["predicate_bitset"] -= sum(op in PREDICATE_OPS
                                   for t in tickets for op in t.hit_ops)
    return out


def service_phase(dcir, n_patients: int) -> dict:
    """The naive path (one solo run per query), the service synchronous and
    pipelined (timed), both again with every ticket checked against its
    solo run, the wire path, and a traced warm serve.  Returns the timed
    pipelined serve's launches."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.study import clear_jit_cache, jit_cache_info

    # the naive path: every query a solo run, literals in the plan
    clear_jit_cache()
    gc.collect()
    solo, naive_lat = {}, []
    t_all = time.perf_counter()
    for q in range(SERVICE_QUERIES):
        reset_launch_counts()
        t0 = time.perf_counter()
        res = service_study(q, n_patients).run(
            dict(dcir), engine="cuda", predicate_engine="cuda",
            device="cuda")
        torch.cuda.synchronize()
        naive_lat.append(time.perf_counter() - t0)
        solo[q] = dict(launch_counts)
        del res
    naive_wall = time.perf_counter() - t_all
    naive_compiles = jit_cache_info()["compiles"]
    if naive_compiles != SERVICE_QUERIES:
        fail(f"service: the naive path built {naive_compiles} runners for "
             f"{SERVICE_QUERIES} distinct queries")
    log(f"service: naive path, {SERVICE_QUERIES} solo runs: wall "
        f"{naive_wall:.6f} s, {naive_compiles} runners built, latency p50 "
        f"{np.percentile(naive_lat, 50):.6f} s p95 "
        f"{np.percentile(naive_lat, 95):.6f} s")

    timed = {}
    for pipeline in (False, True):
        mode = "pipelined" if pipeline else "sync"
        svc = new_service(dcir, pipeline)
        warm_up(svc, n_patients, take)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        tickets, wall, (sub, rea) = serve(svc, n_patients, take)
        launches = dict(launch_counts)
        peak = torch.cuda.max_memory_allocated()
        st = svc.stats
        lat = [t.latency_s for t in tickets]
        flat_hits = [t.latency_s for t in tickets
                     if "lookup_join" in t.hit_ops]
        want = predicted_launches(tickets, solo)
        log(f"service: {mode}: serve wall {wall:.6f} s for "
            f"{SERVICE_QUERIES} queries (after {st.compile_count} warm-up "
            f"runner builds), submit_s {sub:.6f}, realize_s {rea:.6f}, "
            f"overlap_s {max(0.0, sub + rea - wall):.6f}; latency p50 "
            f"{np.percentile(lat, 50):.6f} s p95 "
            f"{np.percentile(lat, 95):.6f} s; flatten-cut hits "
            f"{len(flat_hits)}, their latency p50 "
            f"{np.percentile(flat_hits, 50) if flat_hits else 0:.6f} s")
        log(f"service: {mode}: compiles {st.compile_count}, hits "
            f"{st.cache_hits}, misses {st.cache_misses}, evictions "
            f"{st.cache_evictions}, entries {st.cache_entries}, bytes "
            f"cached {st.cache_bytes} ({st.cache_bytes / 2**30:.3f} GiB "
            f"accounted), demotions {st.demotions}, peak device memory "
            f"{peak / 2**30:.3f} GiB; launches "
            f"{ {k: launches[k] for k in KERNELS_B1_B3} } against "
            f"{want} predicted from the hits")
        if st.compile_count != 3 or st.demotions:
            fail(f"service: {mode}: {st.compile_count} runners built "
                 f"(3 shapes), {st.demotions} demotions")
        if any(launches[k] != want[k] for k in KERNELS_B1_B3):
            fail(f"service: {mode}: launches differ from the prediction")
        timed[mode] = dict(svc=svc if pipeline else None, wall=wall,
                           launches=launches,
                           counts=[(t.cache_hits, t.cache_misses,
                                    t.compiled) for t in tickets])
        del svc, tickets
    if timed["sync"]["counts"] != timed["pipelined"]["counts"]:
        fail("service: per-ticket hits and misses differ between modes")
    log(f"service: walls: naive {naive_wall:.6f} s, sync serve "
        f"{timed['sync']['wall']:.6f} s, pipelined serve "
        f"{timed['pipelined']['wall']:.6f} s")

    # every ticket against its solo run, in both modes, on fresh services
    # (the checks' solo runs would disturb the timed walls)
    for pipeline in (False, True):
        mode = "pipelined" if pipeline else "sync"
        svc = new_service(dcir, pipeline)
        checked = []

        def check(t, mode=mode, checked=checked):
            require_done(t)
            s = solo_run(t.study, dcir)
            check_served(s, t.result, f"service ({mode}): ticket {t.seq}")
            checked.append(t.seq)
            t.result = None

        warm_up(svc, n_patients, check)
        tickets, _, _ = serve(svc, n_patients, check)
        counts = [(t.cache_hits, t.cache_misses, t.compiled)
                  for t in tickets]
        if counts != timed[mode]["counts"] or len(checked) != \
                SERVICE_QUERIES + 3:
            fail(f"service: {mode}: the checked serve's hits and misses "
                 f"differ from the timed serve's")
        if pipeline:
            wire_checks(svc, dcir, n_patients)
        log(f"service: {mode}: all {len(checked)} tickets (3 warm-up) == "
            f"their solo runs (every slot, words, counts, FlatteningStats, "
            f"cohorts, flow, plan log), hits and misses == the timed "
            f"serve's")
        del svc, tickets
    torch.cuda.empty_cache()

    svc = timed["pipelined"]["svc"]
    profile_phase("service", lambda: serve(svc, n_patients, take))
    return timed["pipelined"]["launches"]


def solo_run(study, dcir):
    import torch

    res = study.run(dict(dcir), engine="cuda", predicate_engine="cuda",
                    device="cuda")
    torch.cuda.synchronize()
    return res


def wire_checks(svc, dcir, n_patients: int) -> None:
    """A wire spec of shape full equals its Study twin; a malformed spec
    comes back ``invalid`` with its code."""
    import copy

    from repro_torch.study import spec_from_study

    twin = service_study(0, n_patients)
    spec = json.loads(json.dumps(spec_from_study(twin)))
    got = []
    t = svc.submit_spec(spec, tenant="wire")
    svc.drain(on_done=got.append)
    if t.status != "done" or got != [t]:
        fail(f"service: the wire spec is {t.status}: {t.error!r}")
    check_served(solo_run(twin, dcir), t.result, "service: wire spec")
    payload = t.wire_payload()
    t.result = None
    bad = copy.deepcopy(spec)
    bad["cohorts"]["broken"] = "base & ("
    b = svc.submit_spec(bad, tenant="wire")
    codes = {e["code"] for e in b.wire_payload()["errors"]}
    if b.status != "invalid" or "SPEC-012" not in codes:
        fail(f"service: the malformed spec came back {b.status} {codes}")
    log(f"service: wire spec of shape full == its Study twin (payload "
        f"{json.dumps(payload)}); malformed spec -> {b.status} {sorted(codes)}")


# ---------------------------------------------------------------------------
# phases 9-10: attention (B6) and the serving path
# ---------------------------------------------------------------------------
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the reference's own bounds
# and each row's max abs error over that row's largest |output|: with randn
# inputs a row that sees 4,096 keys has outputs of ~0.03, where 2e-2 of
# absolute error would pass a kernel off by tens of percent.  In bf16 the
# output's rounding flips at most one ulp, under 2**-7 of the row's largest;
# B6's bf16 rounding of the probabilities for P V moves the fp32 result far
# less than an ulp.
ATTN_ROW_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# peak rates of the H100 SXM (data sheet): bf16 on the tensor cores, fp32 on
# the CUDA cores (B6's fp32 path uses no TF32)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
DANUBE = "h2o-danube-1.8b"
SERVE_GATE = {"float32": 1e-3, "bfloat16": 0.1}  # cuda vs torch engines
TF_LAYERS = 4              # teacher-forced decode depth, at full width
TF_STEPS = 4096 + 64       # past the 4,096-slot ring, so that it wraps
CPU_GATE = 1e-5            # reduced config, card against CPU, fp32

# (B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len)
ATTN_SWEEP = [             # tests/test_kernels.py's sweep
    (2, 4, 2, 128, 128, 64, True, 0, None, None),
    (1, 8, 2, 256, 256, 64, True, 64, None, None),
    (2, 4, 4, 1, 384, 64, True, 0, None, None),
    (1, 4, 1, 1, 512, 128, True, 128, None, None),
    (2, 2, 2, 96, 96, 32, False, 0, None, None),
    (1, 2, 1, 80, 160, 32, True, 0, None, None),
    # the decode route at every head dim: many splits, 16 rows (Sq 4 x
    # group 4), kv_len 0, a window crossing splits
    (2, 16, 4, 4, 4096, 128, True, 1000, 3000, None),
    (3, 8, 8, 1, 2049, 16, True, 0, 2048, None),
    (2, 8, 1, 2, 1500, 32, True, 300, 1400, 1450),
    (2, 8, 2, 1, 640, 64, False, 0, 9000, 0),
]
ATTN_DANUBE = (            # h2o-danube-1.8b: Hq 32, Hkv 8, D 80, window 4096
    [(1, 32, 8, s, s, 80, True, 4096, None, None)             # prefill
     for s in (1, 63, 4097, 8192)]
    + [(1, 32, 8, 1, 8192, 80, True, 4096, off, 8192)          # full cache
       for off in (0, 4095, 4096, 8191)]
    + [(4, 32, 8, 1, 4096, 80, False, 0, 9000, kv)             # ring
       for kv in (0, 1, 17, 4001, 4096)]
    + [(4, 32, 8, 1, 4097, 80, False, 0, 9000, 4097),          # ragged ring
       (1, 32, 8, 1, 8192, 80, True, 4096, 5000, 8192)]        # window edge
    + [(2, 32, 8, 100, 300, 80, True, 50, 200, None),          # ragged
       (1, 32, 8, 77, 4099, 80, True, 4096, 4022, None),
       (3, 32, 8, 5, 33, 80, True, 0, -2, None)])


# gemma3-12b: Hq 16, Hkv 8, D 240, window 1,024 (five local layers to one
# global), and head dim 256: local and global prefill to 8,192 tokens, decode
# offsets into a full cache, the ring with S = 1 and S = 3 (and a ring call of
# 130 queries, which takes the prefill kernel with causal=False); then every
# head dim on the bf16 prefill kernel with Sq not a multiple of its 128 rows,
# kv_len not a multiple of its key tile and a window edge inside a tile
ATTN_WIDE = (
    [(1, 16, 8, s, s, 240, True, w, None, None)
     for s in (300, 8192) for w in (1024, 0)]
    + [(1, 16, 8, 1, 8192, 240, True, w, off, 8192)
       for w, off in ((1024, 5000), (0, 8191), (0, 77))]
    + [(2, 16, 8, S, 1024, 240, False, 0, 9000, kv)
       for S in (1, 3) for kv in (1, 700, 1024)]
    + [(1, 16, 8, 130, 1024, 240, False, 0, 9000, 1000),
       (2, 8, 4, 200, 500, 256, True, 0, 300, None),
       (1, 8, 8, 3, 2048, 256, False, 0, 5000, 2000)]
    + [(1, 4, 2, 300, 333, D, True, 50, None, 317)
       for D in (16, 32, 64, 80, 128, 240, 256)])


def _attn_kwargs(case):
    causal, window, q_offset, kv_len = case[6:]
    return dict(causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len)


def check_attention(got, want, what: str):
    """(max abs error, worst row error): fails past ATTN_TOL or
    ATTN_ROW_TOL.  A row with no visible key must come out exactly 0."""
    import torch

    d = (got.float() - want.float()).abs().amax(dim=-1)
    s = want.float().abs().amax(dim=-1)
    row = torch.where(s > 0, d / s.clamp_min(1e-30),
                      torch.where(d > 0, float("inf"), 0.0))
    err, row = float(d.max()), float(row.max())
    dname = str(want.dtype).replace("torch.", "")
    if not (err <= ATTN_TOL[dname] and row <= ATTN_ROW_TOL[dname]):
        fail(f"flash_attention kernel != plain ({dname}, {what}): max abs "
             f"error {err} (gate {ATTN_TOL[dname]}), worst row error {row} "
             f"(gate {ATTN_ROW_TOL[dname]})")
    return err, row


def attention_battery(device) -> None:
    """B6 against its plain version on the card (allow_tf32 is off, so the
    plain version's products are full fp32), in fp32 and bf16; also through
    transposed (B, S, H, D) views, as the model passes them."""
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import swa_attention as swa

    worst = {}
    n_decode = 0
    prefill_dims = set()       # head dims that reached the bf16 prefill kernel
    for i, case in enumerate(ATTN_SWEEP + ATTN_DANUBE + ATTN_WIDE):
        errs = []
        for dname in ATTN_TOL:
            dt = getattr(torch, dname)
            B, Hq, Hkv, Sq, Skv, D = case[:6]
            g = torch.Generator(device=device).manual_seed(i)
            q, k, v = (torch.randn(sh, generator=g, device=device).to(dt)
                       for sh in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                                  (B, Hkv, Skv, D)))
            if i % 2:
                q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                           for x in (q, k, v))
            kw = _attn_kwargs(case)
            before = launch_counts["flash_decode"]
            got = swa.flash_swa_attention(q, k, v, **kw)
            decode = (Hq // Hkv) * Sq <= swa.DECODE_ROWS
            if launch_counts["flash_decode"] != before + int(decode):
                fail(f"flash_attention {case}: the decode route was "
                     f"{'not ' if decode else ''}taken")
            n_decode += int(decode)
            if dt == torch.bfloat16 and not decode:
                prefill_dims.add(D)
            want = swa.flash_swa_attention_plain(q, k, v, **kw)
            err = check_attention(got, want, str(case))
            w = worst.get(dname, (0.0, 0.0))
            worst[dname] = (max(w[0], err[0]), max(w[1], err[1]))
            errs.append(f"{dname} {err[0]:.3g} / {err[1]:.3g}")
            del q, k, v, got, want
        log(f"attention: {case}: max abs / worst row error {', '.join(errs)}")
    if prefill_dims != set(swa.HEAD_DIMS):
        fail(f"attention: the bf16 prefill kernel ran at head dims "
             f"{sorted(prefill_dims)}, not at every one of {swa.HEAD_DIMS}")
    n = len(ATTN_SWEEP) + len(ATTN_DANUBE) + len(ATTN_WIDE)
    log(f"attention: {2 * n} flash_attention kernel-vs-plain checks "
        f"({n_decode} on the decode route), max abs "
        f"/ worst row error fp32 {worst['float32'][0]} / "
        f"{worst['float32'][1]} (gates {ATTN_TOL['float32']} / "
        f"{ATTN_ROW_TOL['float32']}), bf16 {worst['bfloat16'][0]} / "
        f"{worst['bfloat16'][1]} (gates {ATTN_TOL['bfloat16']} / "
        f"{ATTN_ROW_TOL['bfloat16']})")


def attention_bound(q, k, kw, rate):
    """(bound ms, 'bytes' or 'operations', visible pairs): the larger of the
    bytes B6 must move (q and o once, the K/V rows some query can see once)
    over the memory rate, and 4 D flops per visible (query, key) pair and
    query head over the peak rate of the type."""
    import numpy as np

    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kv_len = Skv if kw["kv_len"] is None else kw["kv_len"]
    q_off = kv_len - Sq if kw["q_offset"] is None else kw["q_offset"]
    qpos = q_off + np.arange(Sq, dtype=np.int64)
    lo = np.maximum(0, qpos - kw["window"] + 1) if kw["window"] > 0 \
        else np.zeros(Sq, np.int64)
    hi = np.minimum(kv_len - 1, qpos) if kw["causal"] \
        else np.full(Sq, kv_len - 1)
    n = np.maximum(0, hi - lo + 1)
    pairs = int(n.sum())
    keys = int(hi.max() - lo.min() + 1) if pairs else 0
    esize = q.element_size()
    nbytes = esize * (2 * B * Hq * Sq * D + 2 * B * Hkv * keys * D)
    flops = 4 * D * pairs * B * Hq
    dname = str(q.dtype).replace("torch.", "")
    t_bytes, t_ops = nbytes / rate, flops / PEAK_FLOPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", pairs * B * Hq)


TIMING_CALLS = 3            # separate cuda_ms calls behind each B6 time


def spread_ms(fn, reps: int, cold: bool = False):
    """(middle, min, max) of the medians of ``TIMING_CALLS`` separate
    ``cuda_ms`` calls."""
    m = sorted(cuda_ms(fn, reps, cold) for _ in range(TIMING_CALLS))
    return m[len(m) // 2], m[0], m[-1]


def time_attention(label, q, k, v, kw, reps, rate, cold=False) -> dict:
    """B6 at one shape: kernel, plain version, and torch's
    scaled_dot_product_attention with an explicit boolean mask (on
    contiguous copies, K/V repeated over the group; a yardstick only), each
    the middle of ``TIMING_CALLS`` medians of ``reps`` reps, with their
    min-max; ``cold``: the L2 cache is cleared before every rep of all
    three."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import swa_attention as swa

    kern = lambda: swa.flash_swa_attention(q, k, v, **kw)  # noqa: E731
    plain = lambda: swa.flash_swa_attention_plain(q, k, v, **kw)  # noqa: E731
    err, row = check_attention(kern(), plain(), label)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kv_len = Skv if kw["kv_len"] is None else kw["kv_len"]
    q_off = kv_len - Sq if kw["q_offset"] is None else kw["q_offset"]
    qpos = q_off + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = (kpos < kv_len).expand(Sq, Skv)
    if kw["causal"]:
        mask = mask & (kpos <= qpos)
    if kw["window"] > 0:
        mask = mask & (kpos > qpos - kw["window"])
    qc = q.contiguous()
    kr = k.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    vr = v.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qc, kr, vr, attn_mask=mask, scale=D ** -0.5)
    lib_err = float((lib().float() - plain().float()).abs().max())
    bound_ms, bound_by, pairs = attention_bound(q, k, kw, rate)
    out = dict(shape=(B, Hq, Hkv, Sq, Skv, D), kv_len=kv_len, pairs=pairs,
               bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
               row_err=row, l2_cleared=cold)
    for key, fn in (("ms", kern), ("plain_ms", plain), ("library_ms", lib)):
        out[key], lo, hi = spread_ms(fn, reps, cold)
        out[key + "_range"] = (lo, hi)
    log(f"timing: flash_attention {label} {out['shape']} kv_len {kv_len} "
        f"{q.dtype} causal {kw['causal']} window {kw['window']} "
        f"({'L2 cleared before each rep' if cold else 'warm L2'}) "
        f"({pairs} visible pairs x heads); middle of {TIMING_CALLS} medians "
        f"of {reps} reps [min-max of the medians]: kernel {out['ms']:.4f} ms "
        f"[{out['ms_range'][0]:.4f}-{out['ms_range'][1]:.4f}], plain "
        f"{out['plain_ms']:.4f} ms [{out['plain_ms_range'][0]:.4f}-"
        f"{out['plain_ms_range'][1]:.4f}], sdpa+mask "
        f"{out['library_ms']:.4f} ms [{out['library_ms_range'][0]:.4f}-"
        f"{out['library_ms_range'][1]:.4f}] (its max abs error {lib_err}), "
        f"bound {bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / out['ms']:.1f}"
        f" % reached), kernel-vs-plain max abs error {err}, worst row error "
        f"{row}")
    return out


def teacher_forced(cfg, toks) -> float:
    """Decode ``toks`` one by one from position 0 under the cuda and the
    torch engines (a ring cache: kv_len 8,192 > window); the max abs logit
    difference over every step."""
    import torch

    from repro_torch.models.registry import ModelBundle

    b = ModelBundle(cfg)
    params = b.init(1, device="cuda")
    caches = {e: b.init_cache(1, 8192, device="cuda")
              for e in ("cuda", "torch")}
    if caches["cuda"][0][0].shape[1] != cfg.window:
        fail("teacher-forced decode: the cache is not a ring")
    worst = torch.zeros((), device="cuda")
    walls = []                 # before and after the ring's wrap
    t0 = time.perf_counter()
    for t in range(toks.shape[1]):
        if t == cfg.window:
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
        batch = {"tokens": toks[:, t:t + 1], "pos": t}
        lc, _ = b.decode(params, caches["cuda"], batch, engine="cuda")
        lt, _ = b.decode(params, caches["torch"], batch, engine="torch")
        worst = torch.maximum(worst, (lc.float() - lt.float()).abs().max())
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    err = float(worst)
    if err != err:
        fail(f"teacher-forced decode ({cfg.dtype}): NaN logits")
    n = toks.shape[1]
    log(f"serving: teacher-forced decode, {cfg.n_layers} layers at full "
        f"width, {cfg.dtype}, {n} steps per engine: {walls[0]:.3f} s for "
        f"the {cfg.window} steps before the ring wraps "
        f"({1e3 * walls[0] / cfg.window:.3f} ms a step, both engines), "
        f"{walls[1]:.3f} s for the {n - cfg.window} after "
        f"({1e3 * walls[1] / (n - cfg.window):.3f} ms a step); max abs logit "
        f"difference cuda vs torch engines {err} (gate "
        f"{SERVE_GATE[cfg.dtype]})")
    return err


def serving_phase(reps: int, rate: float):
    """h2o-danube-1.8b at full width: prefill, the batcher, the
    teacher-forced decode, card against CPU, B6's timings and two traces.
    Returns B6's launches on the main path (prefill + batcher) and its
    timing at the prefill's shape."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.interop import tree_map
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import swa_attention as swa
    from repro_torch.models import get_bundle
    from repro_torch.models.registry import ModelBundle
    from repro_torch.serving import ContinuousBatcher, Request

    bundle = get_bundle(DANUBE)
    cfg = bundle.cfg
    t0 = time.perf_counter()
    params = bundle.init(0, device="cuda")
    torch.cuda.synchronize()
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    log(f"serving: {cfg.name} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
        f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, window "
        f"{cfg.window}), {sum(sizes)} {cfg.dtype} parameters drawn on "
        f"the card in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(0)
    V = cfg.vocab_size

    # prefill, B = 2, S = 8,192: the main path's first part
    toks = torch.from_numpy(rng.integers(3, V, (2, 8192)).astype(np.int32)
                            ).cuda()
    rec = Recorder(swa, "flash_swa_attention",
                   lambda q, k, v, **kw: q.numel())
    with rec:
        reset_launch_counts()
        t0 = time.perf_counter()
        got = bundle.prefill(params, {"tokens": toks}, engine="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(launch_counts)
    if launches["flash_attention"] != cfg.n_layers or launches["flash_decode"]:
        fail(f"prefill called B6 {launches['flash_attention']} times, not "
             f"once per layer ({cfg.n_layers}), or took the decode route "
             f"({launches['flash_decode']})")
    t0 = time.perf_counter()
    want = bundle.prefill(params, {"tokens": toks}, engine="torch")
    torch.cuda.synchronize()
    twall = time.perf_counter() - t0
    err = float((got.float() - want.float()).abs().max())
    if not bool(torch.isfinite(got).all()) or got.shape != (2, 1,
                                                            cfg.padded_vocab):
        fail(f"prefill logits {tuple(got.shape)} not finite")
    # how far bf16 itself moves these logits: the same weights in fp32
    b32 = ModelBundle(dataclasses.replace(cfg, dtype="float32"))
    p32 = tree_map(lambda t: t.float(), params)
    l32 = b32.prefill(p32, {"tokens": toks}, engine="cuda")
    spread = float((want.float() - l32).abs().max())
    del p32, l32
    torch.cuda.empty_cache()
    log(f"serving: prefill 2 x 8192 wall {wall:.3f} s (cuda engine, first "
        f"call), {twall:.3f} s (torch engine); B6 launches {launches['flash_attention']}"
        f"; last-token logits max |cuda - torch| {err} (gate "
        f"{SERVE_GATE['bfloat16']}), max |logit| {float(want.abs().max())}, "
        f"bf16 torch engine vs the fp32 model {spread}")
    if not err <= SERVE_GATE["bfloat16"]:
        fail(f"prefill: cuda vs torch engines differ by {err}")

    # the continuous batcher: 4 slots, every cache a 4,096-slot ring
    engine = ContinuousBatcher(bundle, params, n_slots=4, kv_len=8192)
    if engine.cache[0][0].shape[1] != cfg.window:
        fail("batcher: the caches are not rings")
    reqs = [Request(rid=i, prompt=[1] + rng.integers(
        8, V, size=rng.integers(16, 256)).tolist(), max_new=32)
        for i in range(8)]
    for r in reqs:
        engine.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    steps = 0
    while any(not r.done for r in reqs) and steps < 10_000:
        engine.step()
        steps += 1
    torch.cuda.synchronize()
    bwall = time.perf_counter() - t0
    blaunch = dict(launch_counts)
    n_tok = sum(len(r.out) for r in reqs)
    if not all(r.done and 1 <= len(r.out) <= 32 for r in reqs):
        fail("batcher: not every request finished")
    if blaunch["flash_attention"] <= 0:
        fail("batcher: B6 was never launched")
    if blaunch["flash_decode"] != blaunch["flash_attention"]:
        fail(f"batcher: {blaunch['flash_attention']} decode attention calls "
             f"but {blaunch['flash_decode']} launches of the decode route")
    for k in launches:
        launches[k] += blaunch[k]
    passes = blaunch["flash_attention"] // cfg.n_layers
    log(f"serving: batcher {len(reqs)} requests "
        f"({sum(len(r.prompt) for r in reqs)} prompt tokens), {n_tok} tokens "
        f"in {bwall:.3f} s ({n_tok / bwall:.1f} tok/s, {steps} engine steps, "
        f"{passes} forward passes of 4 slots, {1e3 * bwall / passes:.3f} ms "
        f"each), B6 calls {blaunch['flash_attention']}, decode-route "
        f"launches {blaunch['flash_decode']}")

    # teacher-forced decode past the ring's wrap, both engines
    tf_toks = torch.from_numpy(rng.integers(3, V, (1, TF_STEPS)).astype(
        np.int32)).cuda()
    tf = {}
    for dname in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dname, n_layers=TF_LAYERS)
        tf[dname] = teacher_forced(c, tf_toks)
        if not tf[dname] <= SERVE_GATE[dname]:
            fail(f"teacher-forced decode ({dname}): cuda vs torch engines "
                 f"differ by {tf[dname]}")

    # card against CPU: the reduced config in fp32 (the CPU runs B6's plain
    # version through the same cuda engine)
    rb = ModelBundle(dataclasses.replace(get_bundle(DANUBE, reduced=True).cfg,
                                         dtype="float32"))
    pc = rb.init(0, device="cpu")
    pg = tree_map(lambda t: t.cuda(), pc)
    ct = torch.from_numpy(rng.integers(3, rb.cfg.vocab_size, (2, 40)).astype(
        np.int32))
    gt = ct.cuda()
    cerr = float((rb.prefill(pg, {"tokens": gt}, engine="cuda").cpu()
                  - rb.prefill(pc, {"tokens": ct}, engine="cuda")).abs().max())
    caches = (rb.init_cache(2, 32, device="cuda"),
              rb.init_cache(2, 32, device="cpu"))
    for t in range(24):
        lg, _ = rb.decode(pg, caches[0], {"tokens": gt[:, t:t + 1], "pos": t},
                          engine="cuda")
        lc, _ = rb.decode(pc, caches[1], {"tokens": ct[:, t:t + 1], "pos": t},
                          engine="cuda")
        cerr = max(cerr, float((lg.cpu() - lc).abs().max()))
    log(f"cpu: reduced {DANUBE} fp32, prefill + 24 decode steps (ring of "
        f"{rb.cfg.window} wraps): max abs logit difference card vs CPU {cerr}"
        f" (gate {CPU_GATE})")
    if not cerr <= CPU_GATE:
        fail(f"serving card vs CPU: logits differ by {cerr}")

    # B6 at the prefill's shape (the recorded call) and at the batcher's
    # decode shape over a full ring (its layer-0 cache, 4 slots)
    (q, k, v), kw = rec.best[1], rec.best[2]
    timing = time_attention("prefill", q, k, v, kw, reps, rate)
    del rec, q, k, v
    kc, vc = engine.cache[0]
    g = torch.Generator(device="cuda").manual_seed(5)
    dq = torch.randn((4, 1, cfg.n_heads, cfg.head_dim_), generator=g,
                     device="cuda").to(kc.dtype).transpose(1, 2)
    # one layer's K/V (42 MB) fits in the 50 MB L2, while a pass streams
    # 24 layers' caches from device memory: time it with L2 cleared
    decode = time_attention(
        "decode (batcher, full ring)", dq, kc.transpose(1, 2),
        vc.transpose(1, 2), dict(causal=False, window=0, q_offset=8191,
                                 kv_len=cfg.window), reps, rate, cold=True)
    # a yardstick: one torch pass reading the same 42 MB once (a sum over a
    # copy of both caches), L2 cleared alike
    both = torch.cat([kc.reshape(-1), vc.reshape(-1)]).view(torch.int64)
    decode["read_floor_ms"] = cuda_ms(lambda: both.sum(), reps, cold=True)
    log(f"timing: reading the decode shape's {both.numel() * 8} bytes of K/V "
        f"once (one torch sum, L2 cleared) {decode['read_floor_ms']:.4f} ms")
    del both

    # traces: one prefill, one warm batcher step (4 live slots)
    profile_phase("serving_prefill",
                  lambda: bundle.prefill(params, {"tokens": toks},
                                         engine="cuda"))
    for i in range(4):
        engine.submit(Request(rid=100 + i, prompt=[1] + rng.integers(
            8, V, size=16).tolist(), max_new=32))
    engine.step()
    profile_phase("serving_decode", engine.step)
    # one decode pass of the 4 slots over full rings (position 8,191): the
    # device time of every layer's attention reading all 4,096 slots
    tok = torch.from_numpy(rng.integers(3, V, (4, 1)).astype(np.int32)).cuda()
    profile_phase("serving_decode_full_ring", lambda: bundle.decode(
        params, engine.cache, {"tokens": tok, "pos": 8191}, engine="cuda"))
    return launches, timing, decode, tf, err, cerr


# ---------------------------------------------------------------------------
# phase 11: gemma3-12b at full width (head dim 240)
# ---------------------------------------------------------------------------
GEMMA = "gemma3-12b"
GEMMA_PREFILL = 4096       # one 1 x 4,096-token prefill
RING_POS = (500, 1021, 1500, 4097)   # before the wrap, a clamped write, after


def ring_decode_check() -> dict:
    """ROADMAP C11(b) on the card: one gemma3-12b local layer at full width
    over its 1,024-slot ring, three queries a call at positions before and
    after the wrap, the cuda engine (B6's decode route: group 2 x 3 rows)
    against the torch engine (the reference's ``_ring_sdpa``)."""
    import dataclasses

    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.models import get_bundle
    from repro_torch.models import layers as L

    base = get_bundle(GEMMA).cfg
    worst = {}
    for dname in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dname)
        dt = getattr(torch, dname)
        g = torch.Generator(device="cuda").manual_seed(3)
        p = L.attn_params(g, cfg, dt)
        shape = (1, cfg.window, cfg.n_kv_heads, cfg.head_dim_)
        worst[dname] = 0.0
        for pos in RING_POS:
            x = torch.randn((1, 3, cfg.d_model), generator=g,
                            device="cuda").to(dt)
            kc, vc = (torch.randn(shape, generator=g, device="cuda").to(dt)
                      for _ in range(2))
            positions = (pos + torch.arange(3, dtype=torch.int32,
                                            device="cuda"))[None]
            outs = {}
            for engine in ("cuda", "torch"):
                before = launch_counts["flash_decode"]
                outs[engine], _ = L.attention(
                    p, x, cfg, kind="swa", positions=positions,
                    cache=(kc.clone(), vc.clone()), cache_pos=pos,
                    engine=engine)
                if (launch_counts["flash_decode"] - before) != int(
                        engine == "cuda"):
                    fail(f"ring decode S = 3 at pos {pos}: the cuda engine "
                         f"did not take B6's decode route")
            err = float((outs["cuda"].float() - outs["torch"].float())
                        .abs().max())
            if not err <= SERVE_GATE[dname]:
                fail(f"ring decode S = 3 at pos {pos} ({dname}): cuda vs "
                     f"torch engines differ by {err}")
            worst[dname] = max(worst[dname], err)
    log(f"gemma3: ring decode, one local layer at full width (1,024-slot "
        f"ring, S = 3, pos {RING_POS}): max |cuda - torch| engines fp32 "
        f"{worst['float32']} (gate {SERVE_GATE['float32']}), bf16 "
        f"{worst['bfloat16']} (gate {SERVE_GATE['bfloat16']})")
    return worst


def ptxas_report(log_text: str, tag: str) -> str:
    """The ptxas lines (stack frame and spills, registers) of the kernel
    whose mangled name holds ``tag``."""
    lines = log_text.splitlines()
    for i, line in enumerate(lines):
        if "Function properties" in line and tag in line:
            return " | ".join(x.strip() for x in lines[i + 1:i + 3])
    fail(f"no ptxas report for {tag}")


def kernel_registers(log_text: str, kernel: str, D: int) -> str:
    """The ptxas lines (registers at launch, spills) of ``kernel<D>``."""
    return ptxas_report(log_text, f"{kernel}ILi{D}E")


def gemma3_phase(reps: int, rate: float):
    """gemma3-12b at full width, bf16, seeded random weights on the card:
    the C11(b) ring check, one 1 x 4,096 prefill under both engines (B6's
    prefill kernel once per layer at D = 240, its decode route never) and
    B6 timed at the model's global and local prefill shapes.  Returns the
    prefill's launches, the two timings, the logit gate and the ring's."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.interop import tree_map
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import get_bundle
    from repro_torch.models.registry import ModelBundle

    ring = ring_decode_check()
    bundle = get_bundle(GEMMA)
    cfg = bundle.cfg
    t0 = time.perf_counter()
    params = bundle.init(0, device="cuda")
    torch.cuda.synchronize()
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    log(f"gemma3: {cfg.name} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
        f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, window "
        f"{cfg.window}, pattern {cfg.pattern}), {sum(sizes)} {cfg.dtype} "
        f"parameters drawn on the card in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (
        1, GEMMA_PREFILL)).astype(np.int32)).cuda()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = bundle.prefill(params, {"tokens": toks}, engine="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    if launches["flash_attention"] != cfg.n_layers or launches["flash_decode"]:
        fail(f"gemma3 prefill called B6 {launches['flash_attention']} times, "
             f"not once per layer ({cfg.n_layers}), or took the decode route "
             f"({launches['flash_decode']})")
    t0 = time.perf_counter()
    bundle.prefill(params, {"tokens": toks}, engine="cuda")
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = bundle.prefill(params, {"tokens": toks}, engine="torch")
    torch.cuda.synchronize()
    twall = time.perf_counter() - t0
    if not bool(torch.isfinite(got).all()) or got.shape != (
            1, 1, cfg.padded_vocab):
        fail(f"gemma3 prefill logits {tuple(got.shape)} not finite")
    err = float((got.float() - want.float()).abs().max())
    # The same bf16 weights in fp32, under both engines.  Over 48 layers and
    # 262,144 logits bf16 alone moves the largest logit past 0.1 under
    # either engine (each 0.1255 from the fp32 model, while the fp32 engines
    # agree to 2.4e-5: PERF.md), so the bf16 gate holds each engine
    # against the fp32 model: the cuda engine may stray from it by at most
    # SERVE_GATE more than the torch engine does.
    p32 = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    b32 = ModelBundle(dataclasses.replace(cfg, dtype="float32"))
    l32 = {e: b32.prefill(p32, {"tokens": toks}, engine=e).float()
           for e in ("cuda", "torch")}
    del p32
    torch.cuda.empty_cache()
    err32 = float((l32["cuda"] - l32["torch"]).abs().max())
    spread = {e: float((x.float() - l32["torch"]).abs().max())
              for e, x in (("cuda", got), ("torch", want))}
    log(f"gemma3: prefill 1 x {GEMMA_PREFILL} wall {wall:.3f} s (cuda "
        f"engine, first call), {warm:.3f} s (cuda, warm), {twall:.3f} s "
        f"(torch engine); B6 prefill-kernel launches "
        f"{launches['flash_attention']}, decode-route launches "
        f"{launches['flash_decode']}; last-token logits: bf16 max |cuda - "
        f"torch| {err}, max |logit| {float(want.abs().max())}; the same "
        f"weights in fp32: max |cuda - torch| {err32} (gate "
        f"{SERVE_GATE['float32']}); bf16 against the fp32 model (torch "
        f"engine): cuda {spread['cuda']}, torch {spread['torch']} (gate: "
        f"cuda <= torch + {SERVE_GATE['bfloat16']})")
    if not err32 <= SERVE_GATE["float32"]:
        fail(f"gemma3 prefill (fp32): cuda vs torch engines differ by "
             f"{err32}")
    if not spread["cuda"] <= spread["torch"] + SERVE_GATE["bfloat16"]:
        fail(f"gemma3 prefill (bf16): the cuda engine is {spread['cuda']} "
             f"from the fp32 model, the torch engine {spread['torch']}")
    del got, want, l32
    torch.cuda.empty_cache()

    # B6 at the model's prefill shapes, in its (B, S, H, D) layout
    timings = {}
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn((1, GEMMA_PREFILL, h, cfg.head_dim_), generator=g,
                           device="cuda").to(torch.bfloat16).transpose(1, 2)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    for label, window in (("gemma3 global", 0), ("gemma3 local", cfg.window)):
        timings[label] = time_attention(
            label, q, k, v, dict(causal=True, window=window, q_offset=None,
                                 kv_len=None), reps, rate)
    return launches, timings, dict(bf16=err, fp32=err32, **{
        f"bf16_{e}_vs_fp32": v for e, v in spread.items()}), ring


# ---------------------------------------------------------------------------
# phases 12-13: B5 and B2b, and the sharded quickstart
# ---------------------------------------------------------------------------
HP_DESTS = (1, 2, 4, 8, 15, 64)
HP_BLOCKS = (256, 512, 1024)
# B2b: ragged sizes, the edges of its 4,096-row tiles, many tiles
MASK_SIZES = (0, 1, 31, 33, 1025, 4095, 4096, 4097, 100_003,
              300 * 4096 + 5, 48_000_000)
SHARDS = 4                 # ranks of the sharded phase, all on the one card
SHARDED_TIMEOUT = 600.0    # seconds for the sharded phase's ranks
EXPOSURE_KW = {"purview_days": 60}   # exposures_sharded in the small runs


def partition_battery(device, reps: int, rate: float) -> dict:
    """B5 against its plain version, bit for bit: every destination count
    of HP_DESTS at blocks 256/512/1024, ragged lengths, invalid rows, NULL
    and negative keys.  B2b against its plain version through
    ``ops.filter_compact`` with bool masks (all-false, all-true, ragged, and
    long all-false runs with a few kept rows, so that the look-back crosses
    many tiles that publish an aggregate of 0) up to 48M rows, and once
    with 7 columns; B2b timed at 48M rows with a ragged mask."""
    import numpy as np
    import torch

    from repro_torch.core import bitset as bs
    from repro_torch.core.columnar import NULL_INT
    from repro_torch.kernels import filter_compact as fc
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import ops

    checked = 0
    for n_dest in HP_DESTS:
        for block in HP_BLOCKS:
            for n in (1, 31, block - 1, block + 1, 5 * block + 77, 1_000_003):
                rng = np.random.default_rng(n * 131 + n_dest)
                keys = rng.integers(-2 ** 31, 2 ** 31, n,
                                    dtype=np.int64).astype(np.int32)
                keys[rng.random(n) < 0.05] = NULL_INT
                k = torch.from_numpy(keys).to(device)
                w = bs.pack(torch.from_numpy(rng.random(n) < 0.8).to(device))
                got = hp.hash_partition_plan_kernel(k, w, n_dest, block)
                want = hp.hash_partition_plan_plain(k, w, n_dest, block)
                torch.cuda.synchronize()
                if not all(_same(g, x) for g, x in zip(got, want)):
                    fail(f"hash_partition kernel != plain at n={n} "
                         f"n_dest={n_dest} block={block}")
                checked += 1
    log(f"kernels: {checked} hash_partition_plan kernel-vs-plain checks "
        f"bit-identical (n_dest in {HP_DESTS}, blocks {HP_BLOCKS})")
    checked = 0
    g = torch.Generator(device=device).manual_seed(3)
    for n in MASK_SIZES:
        for kind in ("none", "all", "ragged", "runs"):
            for dtype in (torch.int32, torch.float32):
                if dtype == torch.int32:
                    vals = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,),
                                         generator=g, device=device,
                                         dtype=torch.int32)
                else:
                    vals = torch.randn((n,), generator=g, device=device)
                    vals[torch.rand((n,), generator=g, device=device)
                         < 0.1] = float("nan")
                mask = {"none": torch.zeros(n, dtype=torch.bool,
                                            device=device),
                        "all": torch.ones(n, dtype=torch.bool, device=device),
                        "ragged": torch.rand((n,), generator=g, device=device)
                        < 0.5,
                        "runs": torch.rand((n,), generator=g, device=device)
                        < 1e-5}[kind]
                got, gc = ops.filter_compact(vals, mask)
                want, wc = fc.filter_compact_mask_plain([vals], mask)
                torch.cuda.synchronize()
                if int(gc) != int(wc) or not _same(got, want[0]):
                    fail(f"filter_compact (bool mask) kernel != plain at "
                         f"n={n} mask={kind} {dtype}")
                checked += 1
    n = MASK_SIZES[-1]
    cols = [torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g,
                          device=device, dtype=torch.int32) if j % 2 else
            torch.randn((n,), generator=g, device=device) for j in range(7)]
    for c in cols[::2]:
        c[torch.rand((n,), generator=g, device=device) < 0.1] = float("nan")
    mask = torch.rand((n,), generator=g, device=device) < 0.5
    (got, gc), (want, wc) = (fc.filter_compact_mask(cols, mask),
                             fc.filter_compact_mask_plain(cols, mask))
    if int(gc) != int(wc) or not all(_same(a, b) for a, b in zip(got, want)):
        fail(f"filter_compact_mask kernel != plain at n={n}, 7 columns")
    checked += 1
    del cols, got, want
    log(f"kernels: {checked} bool-mask filter_compact kernel-vs-plain "
        f"checks bit-identical at n in {MASK_SIZES} (one with 7 columns)")
    vals = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g,
                         device=device, dtype=torch.int32)
    mask = torch.rand((n,), generator=g, device=device) < 0.5
    kern = lambda: fc.filter_compact_mask([vals], mask)  # noqa: E731
    plain = lambda: fc.filter_compact_mask_plain([vals], mask)  # noqa: E731
    library = lambda: vals[mask]  # noqa: E731
    # the byte mask once, the column read once and written once
    nbytes = 9 * n
    out = dict(n=n, columns=1, ms=cuda_ms(kern, reps),
               plain_ms=cuda_ms(plain, reps), library_ms=cuda_ms(library, reps),
               bound_ms=nbytes / rate * 1e3, max_abs_err=0.0)
    log(f"timing: filter_compact_mask n={n} columns=1 kernel "
        f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, library "
        f"(vals[mask]) {out['library_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms")
    return out


def gathered_rows(t) -> dict:
    """The valid rows of a ``ShardedTable``, every rank's in rank order (the
    whole table's valid rows in order), on every rank: each rank compacts
    its block and the blocks' valid rows are gathered (one explicit gather
    a column, of the largest block's valid rows, not of its capacity)."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import comm

    b, group = t.block, t.group
    counts = comm.all_gather_cat(b.count.reshape(1).to(torch.int64),
                                 group).tolist()
    width = max(counts)
    keep = b.valid_bool()
    out = {}
    for c, v in b.columns.items():
        local = torch.zeros((width,), dtype=v.dtype, device=v.device)
        local[:counts[dist.get_rank(group)]] = v[keep]
        rows = comm.all_gather_cat(local, group).view(len(counts), width)
        out[c] = torch.cat([rows[r, :k] for r, k in enumerate(counts)])
    return out


def digest(res) -> dict:
    """What the sharded phase compares of one result, small enough to keep
    while the next run holds the card: per event table its validity words
    and count and its valid rows in order, the cohort words, the flow and
    the stats.  Of a sharded result (``ShardedTable`` events), the words
    are the rank's block's, the count the global one and the valid rows
    every rank's (``gathered_rows``)."""
    from repro_torch.distributed import ShardedTable

    events = {}
    for name, t in res.events.items():
        if isinstance(t, ShardedTable):
            events[name] = (t.block.valid, t.count, gathered_rows(t))
        else:
            keep = t.valid_bool()
            events[name] = (t.valid, int(t.count),
                            {c: v[keep] for c, v in t.columns.items()})
    return dict(events=events, stats=res.flatten_stats,
                cohorts={k: c.subjects for k, c in res.cohorts.items()},
                flow=res.flow.flowchart())


def compare_digests(a: dict, b: dict, what: str) -> None:
    """Valid rows in order, validity words, counts, FlatteningStats, cohort
    words and flow, bit for bit."""
    if sorted(a["events"]) != sorted(b["events"]):
        fail(f"{what}: different outputs")
    for name, (wa, na, ca) in a["events"].items():
        wb, nb, cb = b["events"][name]
        if na != nb or not _same(wa, wb) or not all(
                _same(ca[c], cb[c]) for c in ca):
            fail(f"{what}: {name} differs")
    if a["stats"] != b["stats"] or a["flow"] != b["flow"] or not all(
            _same(w, b["cohorts"][k]) for k, w in a["cohorts"].items()):
        fail(f"{what}: FlatteningStats, cohorts or flow differ")


def compare_multisets(sharded: dict, single: dict, what: str) -> None:
    """Digests of the sharded and the single-card result of one study:
    event rows as multisets, cohort words, flow, and the joins'
    FlatteningStats (the sharded plan adds its exchanges)."""
    import torch

    for name, (_, n, cols) in single["events"].items():
        rows = []
        for cs in (cols, sharded["events"][name][2]):
            cs = [cs[c].view(torch.int32) for c in sorted(cs)]
            idx = torch.arange(cs[0].shape[0], device=cs[0].device)
            for c in reversed(cs):                   # lexicographic sort
                idx = idx[torch.argsort(c[idx], stable=True)]
            rows.append(torch.stack([c[idx] for c in cs]))
        if rows[0].shape != rows[1].shape or not torch.equal(*rows):
            fail(f"{what}: {name} rows differ as multisets")
    if sharded["flow"] != single["flow"] or not all(
            _same(sharded["cohorts"][k], w)
            for k, w in single["cohorts"].items()):
        fail(f"{what}: cohorts or flow differ")
    joins = [d for _, d in sorted(sharded["stats"].items())
             if not d["stage"].startswith("exchange")]
    if joins != [d for _, d in sorted(single["stats"].items())]:
        fail(f"{what}: join FlatteningStats differ")


def time_partition(rec, reps: int, rate: float) -> dict:
    """B5 at the largest exchange the recorded rank ran, beside its plain
    version and its bound; and the whole ``hash_partition`` at that shape
    under the torch engine (the reference's argsort route, a yardstick) and
    the cuda engine (B5, the offsets and the scatter)."""
    import torch

    from repro_torch.kernels import hash_partition as hp

    (table, key, n_dest, per), _ = rec.best[1], rec.best[2]
    keys, words = table.columns[key], table.valid
    kern = lambda: hp.hash_partition_plan_kernel(  # noqa: E731
        keys, words, n_dest, hp.DEFAULT_BLOCK)
    plain = lambda: hp.hash_partition_plan_plain(  # noqa: E731
        keys, words, n_dest, hp.DEFAULT_BLOCK)
    if not all(_same(g, w) for g, w in zip(kern(), plain())):
        fail("hash_partition kernel != plain at the sharded path's shape")
    route = {e: (lambda e=e: rec.fn(table, key, n_dest, per, engine=e))
             for e in ("torch", "cuda")}
    (ct, vt, ot), (cc, vc, oc) = route["torch"](), route["cuda"]()
    if int(ot) != int(oc) or not torch.equal(vt, vc) or not all(
            _same(ct[k], cc[k]) for k in ct):
        fail("hash_partition torch and cuda routes differ")
    cap = table.capacity
    n_blocks = -(-cap // hp.DEFAULT_BLOCK)
    # keys 4 B + validity 1/8 B in, dest and rank 8 B out per row; one
    # histogram row of n_dest ints per block
    nbytes = (12 + 1 / 8) * cap + 4 * n_dest * n_blocks
    return dict(n=cap, n_dest=n_dest, per_dest=per,
                ms=cuda_ms(kern, reps), plain_ms=cuda_ms(plain, reps),
                torch_route_ms=cuda_ms(route["torch"], reps),
                cuda_route_ms=cuda_ms(route["cuda"], reps), library_ms=None,
                bound_ms=nbytes / rate * 1e3, max_abs_err=0.0)


def small_sharded(group, device, star: dict, n_patients: int,
                  drugs=None) -> list:
    """The sharded entry points on a small numpy ``star`` through the
    package's rank functions (``distributed.launch``), all under the cuda
    engines: the quickstart, ``distributed_flatten``, and
    ``exposures_sharded`` of ``drugs`` (by default the quickstart's drug
    events, which its exchanges left patient-partitioned)."""
    from repro_torch.core import DCIR_SCHEMA
    from repro_torch.distributed import launch

    out = launch.tasks_rank(group, device, [
        (launch.study_rank, (build_study(n_patients), star,
                             [("cuda", "cuda")])),
        (launch.flatten_rank, (DCIR_SCHEMA, star, "cuda"))])
    if drugs is None:
        drugs = out[0][0]["events"]["drug_purchases"]
    out.append(launch.exposures_rank(group, device, drugs, n_patients,
                                     dict(EXPOSURE_KW, engine="cuda")))
    return out


def same_host(a, b) -> bool:
    """Host data (dicts, sequences, numpy arrays, scalars) equal bit for
    bit."""
    import numpy as np

    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_host(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            map(same_host, a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    return a == b


def comparable(small: list) -> list:
    """``small_sharded``'s results without what differs between devices by
    design (launch counts, collectives, seconds); the plan as its nodes."""
    study = [{k: v for k, v in r.items()
              if k not in ("launches", "comm", "seconds", "plan")}
             | {"plan": [(n.op, n.inputs, n.params) for n in r["plan"].nodes]}
             for r in small[0]]
    return [study] + small[1:]


def sharded_rank(group, device, n_patients: int, star: dict,
                 cpu_patients: int, reps: int, rate: float) -> dict:
    """One rank of the sharded phase (run by ``distributed.launch.spawn``):
    the quickstart through ``Study.run(mesh=group)`` at ``n_patients``
    under the cuda engines (launch counts set to 0 just before, read just
    after: B5 once per exchange), a warm rerun, the torch engines (equal
    bit for bit), on rank 0 the single-card run of the same seed (equal as
    multisets) and B5's timing, then ``small_sharded`` of the
    ``cpu_patients`` star on the card (the parent holds it against the
    same ranks on the CPU).  Returns host data and its log lines."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import flattening as pfl
    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir
    from repro_torch.distributed import comm
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.study.executor import cohort_groups

    me = dist.get_rank(group)
    lines = []
    t0 = time.perf_counter()
    dcir = generate_dcir(SyntheticConfig(n_patients=n_patients, seed=0),
                         device=device)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    study = build_study(n_patients)
    rec = Recorder(pfl, "hash_partition",
                   lambda table, key, n, per, engine="torch": table.capacity)

    def run(study, tables, engine):
        comm.reset_stats()
        dist.barrier(group)
        t = time.perf_counter()
        res = study.run(dict(tables), engine=engine, predicate_engine=engine,
                        mesh=group, device=device)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t, dict(comm.stats)

    torch.cuda.reset_peak_memory_stats()
    if me == 0:
        rec.__enter__()
    try:
        reset_launch_counts()
        res, wall, staging = run(study, dcir, "cuda")
        launches = dict(launch_counts)
    finally:
        if me == 0:
            rec.__exit__()
    peak = torch.cuda.max_memory_allocated()
    res.assert_no_loss()
    # each rank holds its own block of every table output and nothing more
    caps, held = {}, {}
    for k, t in res.events.items():
        caps[k] = t.block.capacity
        held[k] = max(x.untyped_storage().nbytes() // x.element_size()
                      for x in (t.block.valid, *t.block.columns.values()))
        if held[k] > caps[k]:
            fail(f"rank {me}: {k} holds {held[k]} slots behind a block of "
                 f"{caps[k]}")
    block_counts = {k: int(t.block.count) for k, t in res.events.items()}
    global_counts = {k: t.count for k, t in res.events.items()}
    n_ex = sum(n.op == "exchange" for n in res.plan.nodes)
    ex_stats = [d for d in res.flatten_stats.values()
                if d["stage"].startswith("exchange")]
    if n_ex != 5 or launches["hash_partition_plan"] != n_ex:
        fail(f"rank {me}: {n_ex} exchanges, B5 launched "
             f"{launches['hash_partition_plan']} times")
    if any(d["overflow"] for d in ex_stats):
        fail(f"rank {me}: an exchange overflowed")
    for k in ("predicate_bitset", "filter_compact", "bitset_op"):
        if launches[k] <= 0:
            fail(f"rank {me}: kernel {k} was never launched")
    if launches["bitset_op"] != len(cohort_groups(res.plan)):
        fail(f"rank {me}: {launches['bitset_op']} B3 launches for "
             f"{len(cohort_groups(res.plan))} cohort expressions")
    final = res.cohorts["final"].subject_count()
    flow = res.flow.render()
    first = digest(res)
    del res                          # the next run needs the card's memory
    torch.cuda.empty_cache()
    rows = int(dcir["ER_PRS"].count)
    lines.append(
        f"rank {me}: generated DCIR ({rows} ER_PRS rows, {rows // SHARDS} "
        f"a shard) in {gen_s:.3f} s; cuda engines wall {wall:.3f} s (first "
        f"run), peak device memory {peak / 2**30:.3f} GiB (PR 14: 8.253 at "
        f"1,000,000 patients, every output gathered), {n_ex} exchanges, "
        f"output capacities a rank {caps} (the largest storage behind each "
        f"{held}), block counts {block_counts} of {global_counts}, launches "
        f"{launches}, collectives {staging['collectives']} "
        f"({staging['all_to_all']} all-to-all, {staging['all_reduce']} "
        f"sums, {staging['all_gather']} gathers; PR 14: 41), host staging "
        f"{staging['staged_bytes'] / 2**30:.3f} GiB (PR 14: 7.701) in "
        f"{staging['staging_s']:.3f} s")
    res, warm, staging2 = run(study, dcir, "cuda")
    compare_digests(first, digest(res), f"rank {me}: sharded cuda run vs "
                    f"rerun")
    del res
    torch.cuda.empty_cache()
    res, twall, _ = run(study, dcir, "torch")
    compare_digests(first, digest(res), f"rank {me}: sharded cuda vs torch "
                    f"engines")
    del res
    torch.cuda.empty_cache()
    # one more warm cuda run, traced on rank 0
    if me == 0:
        with profiled() as prof:
            res, pwall, _ = run(study, dcir, "cuda")
        lines += trace_report("sharded_rank0", prof, pwall * 1e6)
    else:
        res, _, _ = run(study, dcir, "cuda")
    del res
    torch.cuda.empty_cache()
    lines.append(
        f"rank {me}: cuda engines wall {warm:.3f} s (warm; host staging "
        f"{staging2['staging_s']:.3f} s), torch engines wall {twall:.3f} s; "
        f"cuda == torch engines (valid rows, words, counts, FlatteningStats, "
        f"cohorts, flow)")
    timing = None
    if me == 0:
        t = time.perf_counter()
        single = study.run(dict(dcir), engine="cuda", predicate_engine="cuda",
                           device=device)
        torch.cuda.synchronize()
        swall = time.perf_counter() - t
        single = digest(single)
        compare_multisets(first, single, "sharded vs single card")
        lines.append(
            f"rank {me}: single-card run {swall:.3f} s; sharded == single "
            f"card (event rows as multisets, cohort words, flow, join "
            f"FlatteningStats); final cohort {final} subjects\n" + flow)
        del single
        timing = time_partition(rec, reps, rate)
    del rec, first, dcir
    torch.cuda.empty_cache()
    dist.barrier(group)
    small = small_sharded(group, device, star, cpu_patients)
    return dict(lines=lines, launches=launches, wall=wall, warm=warm,
                staging=staging, staging_warm=staging2, timing=timing,
                small=small, peak=peak, caps=caps,
                block_counts=block_counts, global_counts=global_counts)


def sharded_phase(n_patients: int, cpu_patients: int, reps: int,
                  rate: float):
    """The quickstart sharded over SHARDS ranks of one gloo process group,
    all on the one card (``sharded_rank``); the ranks load the kernel
    library this process built.  Then ``small_sharded`` on the same number
    of CPU ranks, held against the card's.  Returns the launches summed
    over ranks and B5's timing on rank 0."""
    import torch

    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir
    from repro_torch.distributed import launch
    from repro_torch.interop import tables_to_numpy

    torch.cuda.empty_cache()
    star = tables_to_numpy(generate_dcir(
        SyntheticConfig(n_patients=cpu_patients, seed=0), device="cpu"))
    t0 = time.perf_counter()
    ranks = launch.spawn(sharded_rank, SHARDS,
                         (n_patients, star, cpu_patients, reps, rate),
                         device="cuda", timeout=SHARDED_TIMEOUT)
    log(f"sharded: {SHARDS} ranks on one card, quickstart at {n_patients} "
        f"patients, {time.perf_counter() - t0:.3f} s with the ranks' start")
    for r in ranks:
        for line in r["lines"]:
            log("sharded: " + line)
    # card against CPU: the same small runs on the same ranks on the CPU
    t0 = time.perf_counter()
    drugs = ranks[0]["small"][0][0]["events"]["drug_purchases"]
    cpu = launch.spawn(small_sharded, SHARDS, (star, cpu_patients, drugs),
                       device="cpu", timeout=SHARDED_TIMEOUT)
    for me, (r, c) in enumerate(zip(ranks, cpu)):
        card_b5 = r["small"][0][0]["launches"]["hash_partition_plan"]
        if card_b5 != 5 or c[0][0]["launches"]["hash_partition_plan"]:
            fail(f"rank {me}: B5 launched {card_b5} times in the small "
                 f"sharded run on the card (5 expected, none on the CPU)")
        if not same_host(comparable(r["small"]), comparable(c)):
            fail(f"rank {me}: sharded quickstart, distributed_flatten or "
                 f"exposures_sharded at {cpu_patients} patients differ "
                 f"between the card and the CPU")
    small = ranks[0]["small"]
    log(f"sharded: at {cpu_patients} patients the card equals the same "
        f"{SHARDS} ranks on the CPU bit for bit (quickstart: events, "
        f"cohorts, flow, FlatteningStats, log, plan; distributed_flatten "
        f"{small[1]['flat']['count']} rows; exposures_sharded "
        f"{small[2]['count']} rows; final cohort "
        f"{small[0][0]['cohorts']['final']['count']} subjects), "
        f"{time.perf_counter() - t0:.3f} s for the CPU ranks")
    for k, n in ranks[0]["global_counts"].items():
        if sum(r["block_counts"][k] for r in ranks) != n:
            fail(f"sharded: the blocks of {k} do not add up to its count")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    timing = ranks[0]["timing"]
    log(f"sharded: at {n_patients} patients per rank: output capacities "
        f"{[r['caps'] for r in ranks]}, peak device memory "
        f"{[round(r['peak'] / 2**30, 3) for r in ranks]} GiB, host staging "
        f"{[round(r['staging']['staged_bytes'] / 2**30, 3) for r in ranks]}"
        f" GiB (first), "
        f"{[round(r['staging_warm']['staged_bytes'] / 2**30, 3) for r in ranks]}"
        f" GiB (warm), collectives "
        f"{[r['staging']['collectives'] for r in ranks]}, warm wall "
        f"{[round(r['warm'], 3) for r in ranks]} s; PR 14 at 1,000,000: "
        f"96,000,000 slots, 8.253 GiB, 7.701 GiB, 41, 7.002 s")
    log(f"sharded: launches summed over ranks {launches}; wall per rank "
        f"{[round(r['wall'], 3) for r in ranks]} s (first), "
        f"{[round(r['warm'], 3) for r in ranks]} s (warm), host staging per "
        f"rank {[round(r['staging']['staging_s'], 3) for r in ranks]} s "
        f"(first), {[round(r['staging_warm']['staging_s'], 3) for r in ranks]}"
        f" s (warm)")
    log(f"timing: hash_partition_plan n={timing['n']} n_dest="
        f"{timing['n_dest']} kernel {timing['ms']:.4f} ms, plain "
        f"{timing['plain_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms; "
        f"hash_partition per_dest={timing['per_dest']}: torch route "
        f"(argsort) {timing['torch_route_ms']:.4f} ms, cuda route (B5) "
        f"{timing['cuda_route_ms']:.4f} ms")
    return launches, timing


KERNELS = {
    "predicate_bitset": ("src/repro_torch/csrc/predicate.cu",
                         "src/repro/kernels/predicate.py:358"),
    "filter_compact": ("src/repro_torch/csrc/filter_compact.cu",
                       "src/repro/kernels/filter_compact.py:72"),
    "bitset_op": ("src/repro_torch/csrc/bitset_ops.cu",
                  "src/repro/kernels/bitset_ops.py:42"),
    "segmented_scan": ("src/repro_torch/csrc/segment_scan.cu",
                       "src/repro/kernels/segment_scan.py:89"),
    "flash_attention": ("src/repro_torch/csrc/swa_prefill.cu",
                        "src/repro/kernels/swa_attention.py:98"),
    "flash_decode": ("src/repro_torch/csrc/swa_decode.cu",
                     "src/repro/kernels/swa_attention.py:98"),
    "hash_partition_plan": ("src/repro_torch/csrc/hash_partition.cu",
                            "src/repro/kernels/hash_partition.py:44"),
    "filter_compact_mask": ("src/repro_torch/csrc/filter_compact.cu",
                            "src/repro/kernels/filter_compact.py:113"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-patients", type=int, default=2_000_000)
    # the reference's design-matrix index is int32 and wraps above 466,033
    # patients at (36, 128) (ROADMAP C7); 400,000 stays below it
    ap.add_argument("--cohort-patients", type=int, default=400_000)
    # four ranks share the card, each keeping its own block of every output
    ap.add_argument("--sharded-patients", type=int, default=2_000_000)
    # the chunked phase reuses the quickstart's star at the same scale
    ap.add_argument("--chunked-patients", type=int, default=2_000_000)
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
    # the whole log, for runners that keep only the tail of the output
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    LOG["file"] = open(out / "chip_smoke.log", "w")
    # full fp32 products for every plain version and the torch engines
    # (the default, stated): TF32 would keep about three decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
        if "registers" in line or "spill" in line or "serialized" in line:
            log("ptxas: " + line.strip())
    # the bf16 prefill kernel: the count at launch is 384 threads' share;
    # setmaxnreg then gives the producer 24 and each consumer thread 240
    for D in (80, 240):
        log(f"ptxas: B6 bf16 prefill flash_wgmma<{D}>: "
            f"{kernel_registers(info['log'], 'flash_wgmma', D)}")
    # B1 must keep its whole state in registers and shared memory
    for rows in (16, 8):
        b1 = ptxas_report(info["log"], f"predicate_kernelILi{rows}E")
        log(f"ptxas: B1 predicate_kernel<{rows}>: {b1}")
        if not b1.startswith("0 bytes stack frame, 0 bytes spill stores, "
                             "0 bytes spill loads"):
            fail(f"B1's kernel uses local memory: {b1}")
    log(f"ptxas: B4 seg_scan_kernel: "
        f"{ptxas_report(info['log'], 'seg_scan_kernel')}")
    # B3 keeps every op's result and count in registers, at every length
    for k in range(1, 9):
        b3 = ptxas_report(info["log"], f"bitset_expr_kernelILi{k}E")
        log(f"ptxas: B3 bitset_expr_kernel<{k}>: {b3}")
        if not b3.startswith("0 bytes stack frame, 0 bytes spill stores, "
                             "0 bytes spill loads"):
            fail(f"B3's {k}-op kernel uses local memory: {b3}")
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
    q_launches, timing, study, dcir, qres = timed(
        "quickstart", study_phase, args.n_patients, REPS, rate)
    qstar = dcir            # the service phase serves the quickstart's star
    timed("quickstart_profile", profile_phase, "quickstart",
          lambda: study.run(dict(dcir), engine="cuda",
                            predicate_engine="cuda", device="cuda"))
    store_dir = REPO / ".chunk_store"
    try:
        chunk_resident, peak = q_launches, PEAKS["quickstart"]
        if args.chunked_patients != args.n_patients:
            del study, dcir, qres
            torch.cuda.empty_cache()
            study, dcir, qres, chunk_resident, peak = timed(
                "chunked_resident", resident_run, args.chunked_patients)
        prep = timed("chunked_prepare", chunked_prepare, study, dcir, qres,
                     store_dir, peak)
        del study, dcir, qres
        torch.cuda.empty_cache()
        k_launches = timed("chunked", chunked_phase, prep, chunk_resident,
                           store_dir)
        del prep
        torch.cuda.empty_cache()
        f_launches = timed("spec", spec_phase, store_dir / "spec")
    finally:
        import shutil

        shutil.rmtree(store_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    v_launches = timed("service", service_phase, qstar, args.n_patients)
    del qstar
    gc.collect()
    torch.cuda.empty_cache()
    c_launches, c_timing, cstudy, ctables = timed(
        "cohort", cohort_phase, args.cohort_patients, REPS, rate)
    timed("cohort_profile", profile_phase, "cohort_study",
          lambda: cstudy.run(dict(ctables), engine="cuda",
                             predicate_engine="cuda", device="cuda"))
    del cstudy, ctables
    torch.cuda.empty_cache()
    timed("cpu", cpu_phase, CPU_PATIENTS)
    timed("attention", attention_battery, torch.device("cuda"))
    s_launches, s_timing, decode, tf, prefill_err, cpu_err = timed(
        "serving", serving_phase, REPS, rate)
    torch.cuda.empty_cache()
    g_launches, g_timing, gemma_err, ring_err = timed(
        "gemma3", gemma3_phase, REPS, rate)
    torch.cuda.empty_cache()
    mask_timing = timed("partition", partition_battery, torch.device("cuda"),
                        REPS, rate)
    h_launches, h_timing = timed("sharded", sharded_phase,
                                 args.sharded_patients, CPU_PATIENTS, REPS,
                                 rate)
    # B1-B3 are timed at the quickstart's (larger) shapes, B4 at the cohort
    # study's, B6's prefill kernel at the prefill's and its decode route at
    # the batcher's full-ring shape (L2 cleared); launches are summed over
    # both studies' first runs, the serving path (prefill + batcher) and the
    # sharded run
    timing.update({"segmented_scan": c_timing["segmented_scan"],
                   "flash_attention": s_timing, "flash_decode": decode,
                   "hash_partition_plan": h_timing,
                   "filter_compact_mask": mask_timing})
    log(f"launches: quickstart {q_launches}, chunked {k_launches}, spec "
        f"corpus {f_launches}, service {v_launches}, cohort study "
        f"{c_launches}, serving {s_launches}, gemma3 prefill "
        f"{g_launches}, sharded (summed over ranks) {h_launches}")
    log(f"serving: B6 at the batcher's decode shape {json.dumps(decode)}")
    log(f"serving: B6 prefill at danube's shape {json.dumps(s_timing)}")
    for label, t in g_timing.items():
        log(f"gemma3: B6 prefill at {label}'s shape {json.dumps(t)}")
    log(f"serving: gates prefill {prefill_err}, teacher-forced "
        f"{json.dumps(tf)}, card vs CPU {cpu_err}; gemma3 prefill "
        f"{json.dumps(gemma_err)}, ring decode {json.dumps(ring_err)}")
    log(f"phases: {json.dumps({k: round(v, 3) for k, v in seconds.items()})}"
        f", total {time.perf_counter() - t_all:.3f} s")

    launches = {k: q_launches[k] + k_launches[k] + f_launches[k]
                + v_launches[k] + c_launches[k] + s_launches[k]
                + g_launches[k] + h_launches[k] for k in KERNELS}
    # the flash_attention count takes one per call on both of B6's routes:
    # its prefill kernel launched on the calls the decode route did not take
    launches["flash_attention"] -= launches["flash_decode"]
    records = []
    for k, (source, replaces) in KERNELS.items():
        t = timing[k]
        records.append({"name": k, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[k],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t.get("bound_by", "bytes"),
                        "library_ms": t["library_ms"]})
    log(smi)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    LOG["file"].close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
