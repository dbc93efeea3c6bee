"""Differential spec fuzzer: random wire specs vs. the three engines.

The port of ``repro.study.fuzz``: the generator, its tables and the
mutation catalog are copies, so one seed gives the reference's specs.  The
three executions are ``predicate_engine="torch"``, ``"cuda"`` (B1) and
``run_chunked`` over ``partition_star``, all on ``device`` (None = CUDA)
under one executor ``engine``.  The ``cuda`` arm needs the card: on the CPU
(``device="cpu"``) the oracle runs the torch and chunked arms only, and the
report names the arms that ran (``FuzzReport.arms``).

Two generators share one seeded ``random.Random``:

  * ``gen_valid_spec`` — specs that are valid **by construction**: a DCIR
    flatten, 1-3 extractors with random code whitelists / ``where``
    predicate trees, optional filters, random cohort algebra (with
    parentheses), optional flow and feature exports.  Every generated spec
    avoids chunk-unsafe ops (transforms, distinct extractors) so the same
    spec can execute resident AND out-of-core.
  * ``MUTATIONS`` — one targeted corruption per ``SPEC-nnn`` validation
    code; each asserts the validator rejects with that code (never a
    traceback) and that ``compile_spec`` refuses to build a plan.

``run_spec_differential`` is the oracle: one spec, three executions —
``predicate_engine="torch"``, ``predicate_engine="cuda"``, and chunked over
a partitioned store — must agree bit-identically (the resident pair down to
raw column/validity-word layout; the chunked run on valid-row contents,
masks and features, the same contract ``tests/test_chunked.py`` pins).  The
static analyzer is cross-checked against reality on every run: an ``SP014``
("output provably empty") verdict must coincide with an executed count of
zero, and a plan carrying an ``SP003`` contradiction must be *refused* by
the chunked executor's analyzer preflight.

``run_corpus`` drives n specs (half valid+executed, half mutated+rejected)
and returns a ``FuzzReport``; ``tools/port_diff.py`` holds the port's
results against the reference's over the reference's corpus.
"""
from __future__ import annotations

import copy
import dataclasses
import random
import tempfile
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from repro_torch.core.columnar import resolve_device
from repro_torch.data import SyntheticConfig, generate_dcir, partition_star
from repro_torch.study.analyze import PlanValidationError, analyze
from repro_torch.study.spec import (SpecValidationError, compile_spec,
                                    validate_spec)

__all__ = [
    "FuzzFailure", "FuzzReport", "MUTATIONS",
    "gen_valid_spec", "mutate_spec", "results_equal",
    "run_spec_differential", "run_corpus",
]

# column -> (lo, hi) sampling ranges matching data.synthetic's generator, so
# random predicates are sometimes-true/sometimes-false instead of degenerate
_FLAT_COLUMNS: Dict[str, Tuple[int, int]] = {
    "prestation_code": (1000, 1100),
    "execution_date": (14_600, 14_600 + 3 * 365),
    "cip13": (0, 600),
    "atc_class": (0, 65),
    "quantity": (1, 4),
    "ccam_code": (0, 300),
    "gender": (1, 3),
}

# conformed-events layout (post conform_events) for filter predicates
_EVENT_COLUMNS: Dict[str, Tuple[int, int]] = {
    "patient_id": (0, 200),
    "start": (14_600, 14_600 + 3 * 365),
    "value": (0, 300),
}

_CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")


# ---------------------------------------------------------------------------
# valid-by-construction generator
# ---------------------------------------------------------------------------
def _gen_leaf(rng: random.Random, cols: Mapping[str, Tuple[int, int]],
              contradiction: bool = False) -> Dict[str, Any]:
    """One predicate leaf; ``contradiction`` forces a provably-false
    conjunction ((c < lo) & (c > hi), hi > lo) to give SP003/SP014 teeth."""
    name = rng.choice(sorted(cols))
    lo, hi = cols[name]
    col = {"op": "col", "name": name}
    if contradiction:
        a, b = sorted((rng.randrange(lo, hi), rng.randrange(lo, hi + 10)))
        return {"op": "and",
                "lhs": {"op": "cmp", "cmp": "<", "lhs": col,
                        "rhs": {"op": "lit", "value": a}},
                "rhs": {"op": "cmp", "cmp": ">", "lhs": col,
                        "rhs": {"op": "lit", "value": b + 1}}}
    if rng.random() < 0.25:
        k = rng.randrange(1, 6)
        return {"op": "isin", "x": col,
                "values": sorted(rng.sample(range(lo, hi), min(k, hi - lo)))}
    return {"op": "cmp", "cmp": rng.choice(_CMP_OPS), "lhs": col,
            "rhs": {"op": "lit", "value": rng.randrange(lo, hi)}}


def _gen_expr(rng: random.Random, cols: Mapping[str, Tuple[int, int]],
              depth: int = 2, contradiction: bool = False) -> Dict[str, Any]:
    if contradiction:
        return _gen_leaf(rng, cols, contradiction=True)
    if depth <= 0 or rng.random() < 0.45:
        return _gen_leaf(rng, cols)
    if rng.random() < 0.15:
        return {"op": "not", "x": _gen_expr(rng, cols, depth - 1)}
    return {"op": rng.choice(("and", "or")),
            "lhs": _gen_expr(rng, cols, depth - 1),
            "rhs": _gen_expr(rng, cols, depth - 1)}


_EXTRACT_TEMPLATES = (
    # (value_col, category, null_cols) — DRUG_DISPENSE / MEDICAL_ACT lineages
    ("cip13", 1, ("cip13",)),
    ("atc_class", 1, ("cip13",)),
    ("ccam_code", 2, ("ccam_code",)),
)


def _gen_extractor(rng: random.Random, name: str, flat: str,
                   contradiction: bool) -> Dict[str, Any]:
    value_col, category, null_cols = rng.choice(_EXTRACT_TEMPLATES)
    d: Dict[str, Any] = {
        "name": name, "source": flat, "category": category,
        "value_col": value_col, "start_col": "execution_date",
        "null_cols": list(null_cols),
    }
    if rng.random() < 0.5:
        lo, hi = _FLAT_COLUMNS[value_col]
        d["codes"] = sorted(rng.sample(range(lo, hi), rng.randrange(2, 12)))
    if contradiction or rng.random() < 0.4:
        d["where"] = _gen_expr(rng, _FLAT_COLUMNS, contradiction=contradiction)
    return d


def _gen_algebra(rng: random.Random, first_pool: Sequence[str],
                 rest_pool: Sequence[str]) -> str:
    """Random cohort algebra with parentheses.  The leftmost leaf comes
    from ``first_pool``: cohort combination keeps the *left* operand's
    events (``core.cohort._combine``), so algebra rooted at an
    events-derived cohort stays featurizable."""
    expr = rng.choice(list(first_pool))
    for _ in range(rng.randrange(0, min(2, len(rest_pool)) + 1)):
        op = rng.choice(("&", "|", "-"))
        t = rng.choice(list(rest_pool))
        expr = (f"({expr}) {op} {t}" if rng.random() < 0.4
                else f"{expr} {op} {t}")
    return expr


def gen_valid_spec(rng: random.Random, n_patients: int = 200) -> Dict[str, Any]:
    """One random wire spec, valid by construction and chunk-safe.

    ~10% of specs carry a provably-false predicate so the corpus exercises
    the SP003/SP014 emptiness verdicts, not just the happy path.  No
    transforms, no distinct extractors: everything generated must also run
    out-of-core (see ``chunked.chunk_unsafe_ops``).
    """
    spec: Dict[str, Any] = {"spec_version": 1, "n_patients": n_patients}
    if rng.random() < 0.3:
        t0 = 14_600 + rng.randrange(0, 200)
        spec["window"] = [t0, t0 + rng.randrange(365, 3 * 365)]
    flat = rng.choice(("DCIR", "flat"))
    directive: Dict[str, Any] = {"star": "DCIR"}
    if flat != "DCIR":
        directive["name"] = flat
    spec["schema"] = [directive]

    contradiction_at = (rng.randrange(3) if rng.random() < 0.1 else None)
    concepts: List[Dict[str, Any]] = []
    event_names: List[str] = []
    for i in range(rng.randrange(1, 4)):
        nm = f"ev{i}"
        concepts.append({"kind": "extract",
                         "extractor": _gen_extractor(
                             rng, nm, flat, contradiction=(
                                 contradiction_at == i))})
        event_names.append(nm)
    concepts.append({"kind": "patients"})
    if rng.random() < 0.3:
        src = rng.choice(event_names)
        concepts.append({"kind": "filter", "source": src,
                         "where": _gen_expr(rng, _EVENT_COLUMNS, depth=1),
                         "name": f"{src}_narrow"})
        event_names.append(f"{src}_narrow")
    if len(event_names) >= 2 and rng.random() < 0.25:
        concepts.append({"kind": "concat", "name": "both",
                         "inputs": rng.sample(event_names, 2)})
        event_names.append("both")
    spec["concepts"] = concepts

    cohorts: Dict[str, str] = {"base": "extract_patients"}
    event_pool: List[str] = []          # events-rooted => featurizable
    for k, nm in enumerate(event_names):
        if k == 0 or rng.random() < 0.8:
            cohorts[f"c_{nm}"] = nm
            event_pool.append(f"c_{nm}")
    pool = list(cohorts)
    for j in range(rng.randrange(1, 3)):
        cohorts[f"mix{j}"] = _gen_algebra(rng, event_pool, pool)
        event_pool.append(f"mix{j}")
        pool.append(f"mix{j}")
    spec["cohorts"] = cohorts

    if rng.random() < 0.5:
        spec["flow"] = rng.sample(pool, min(len(pool), rng.randrange(2, 4)))
    if rng.random() < 0.25:
        fk = rng.choice(("dense", "tokens"))
        spec["outputs"] = [{"kind": "featurize", "name": "X",
                            "cohort": rng.choice(event_pool),
                            "feature_kind": fk,
                            "kwargs": ({"seq_len": 64} if fk == "tokens"
                                       else {"n_buckets": 12,
                                             "bucket_days": 31,
                                             "n_features": 64})}]
    return spec


# ---------------------------------------------------------------------------
# mutation catalog: one corruption per SPEC validation code
# ---------------------------------------------------------------------------
def _first_extractor(spec: Dict[str, Any]) -> Dict[str, Any]:
    for c in spec["concepts"]:
        if c.get("kind") == "extract":
            return c["extractor"]
    raise AssertionError("generated spec always has an extractor")


def _mut_root(spec, rng):
    return [spec]                                        # list, not object


def _mut_version(spec, rng):
    spec["spec_version"] = 99
    return spec


def _mut_unknown_field(spec, rng):
    spec["frobnicate"] = True
    return spec


def _mut_missing_required(spec, rng):
    del spec["n_patients"]
    return spec


def _mut_bad_type(spec, rng):
    spec["n_patients"] = -3
    return spec


def _mut_unknown_star(spec, rng):
    spec["schema"][0]["star"] = "SNIIRAM_CLASSIC"
    return spec


def _mut_unknown_transform(spec, rng):
    spec["concepts"].append({"kind": "transform", "fn": "no_such_fn",
                             "inputs": ["ev0"], "name": "zz"})
    return spec


def _mut_duplicate_name(spec, rng):
    spec["concepts"].append({"kind": "concat", "name": "ev0",
                             "inputs": ["ev0"]})
    return spec


def _mut_undefined_ref(spec, rng):
    spec["cohorts"]["mutant"] = "no_such_output"
    return spec


def _mut_malformed_expr(spec, rng):
    _first_extractor(spec)["where"] = {"op": "frobnicate"}
    return spec


def _mut_bad_literal(spec, rng):
    _first_extractor(spec)["where"] = {"op": "lit", "value": "a string"}
    return spec


def _mut_cohort_syntax(spec, rng):
    spec["cohorts"]["mutant"] = "base & ( base"
    return spec


def _mut_bad_enum(spec, rng):
    spec["concepts"][0] = dict(spec["concepts"][0], kind="explode")
    return spec


def _mut_bad_time_slice(spec, rng):
    spec["schema"][0]["time_slices"] = 4                 # no time_column/t0/t1
    return spec


# (code, mutation) — every SPEC validation code has a dedicated corruption;
# the fuzzer asserts the validator reports *that* code on the mutated spec.
MUTATIONS: Tuple[Tuple[str, Callable], ...] = (
    ("SPEC-001", _mut_root),
    ("SPEC-002", _mut_version),
    ("SPEC-003", _mut_unknown_field),
    ("SPEC-004", _mut_missing_required),
    ("SPEC-005", _mut_bad_type),
    ("SPEC-006", _mut_unknown_star),
    ("SPEC-007", _mut_unknown_transform),
    ("SPEC-008", _mut_duplicate_name),
    ("SPEC-009", _mut_undefined_ref),
    ("SPEC-010", _mut_malformed_expr),
    ("SPEC-011", _mut_bad_literal),
    ("SPEC-012", _mut_cohort_syntax),
    ("SPEC-013", _mut_bad_enum),
    ("SPEC-014", _mut_bad_time_slice),
)


def mutate_spec(spec: Dict[str, Any], index: int,
                rng: random.Random) -> Tuple[str, Any]:
    """Apply the ``index``-th catalog corruption to a deep copy of ``spec``;
    returns (expected SPEC code, mutated spec)."""
    code, fn = MUTATIONS[index % len(MUTATIONS)]
    return code, fn(copy.deepcopy(spec), rng)


# ---------------------------------------------------------------------------
# differential oracle
# ---------------------------------------------------------------------------
def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _same(a, b) -> bool:
    """Bit for bit: 4-byte words compare as uint32, so int32 validity words
    equal the reference's uint32 ones and float columns compare by bits."""
    a, b = _host(a), _host(b)
    if a.shape != b.shape:
        return False
    if a.dtype.itemsize == 4 and b.dtype.itemsize == 4 \
            and a.dtype.kind in "iuf" and b.dtype.kind in "iuf":
        a, b = a.view(np.uint32), b.view(np.uint32)
    return bool(np.array_equal(a, b))


def _table_delta(name: str, a, b, layout: bool) -> Optional[str]:
    if int(a.count) != int(b.count):
        return f"{name}: count {int(a.count)} != {int(b.count)}"
    if sorted(a.columns) != sorted(b.columns):
        return f"{name}: columns {sorted(a.columns)} != {sorted(b.columns)}"
    if layout:
        if not _same(a.valid, b.valid):
            return f"{name}: validity words differ"
        for c in a.columns:
            if not _same(a.columns[c], b.columns[c]):
                return f"{name}.{c}: values differ"
    else:
        av, bv = a.to_numpy(), b.to_numpy()
        for c in av:
            if not _same(av[c], bv[c]):
                return f"{name}.{c}: valid-row values differ"
    return None


def _feature_delta(name: str, a, b) -> Optional[str]:
    if isinstance(a, dict) and isinstance(b, dict):
        if sorted(a) != sorted(b):
            return f"{name}: keys differ"
        for k in a:
            d = _feature_delta(f"{name}.{k}", a[k], b[k])
            if d:
                return d
        return None
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        if len(a) != len(b):
            return f"{name}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            d = _feature_delta(f"{name}[{i}]", x, y)
            if d:
                return d
        return None
    if hasattr(a, "shape") or hasattr(b, "shape"):
        if not _same(a, b):
            return f"{name}: arrays differ"
        return None
    return None if a == b else f"{name}: {a!r} != {b!r}"


def results_equal(a, b, layout: bool = True) -> Optional[str]:
    """None when two StudyResults agree bit-for-bit; else a one-line delta.

    ``layout=True`` also compares raw column arrays and packed validity
    words (same-engine-family runs); ``layout=False`` compares valid-row
    contents (the resident-vs-chunked contract: identical rows, possibly
    different padding capacity).  Arrays are compared on the host by their
    bits (tensors on any device, or numpy arrays), so a port result can be
    held against a reference result too."""
    if sorted(a.events) != sorted(b.events):
        return f"event outputs {sorted(a.events)} != {sorted(b.events)}"
    for nm in a.events:
        d = _table_delta(f"events.{nm}", a.events[nm], b.events[nm], layout)
        if d:
            return d
    if sorted(a.cohorts) != sorted(b.cohorts):
        return f"cohorts {sorted(a.cohorts)} != {sorted(b.cohorts)}"
    for nm in a.cohorts:
        ca, cb = a.cohorts[nm], b.cohorts[nm]
        if ca.subject_count() != cb.subject_count():
            return (f"cohort {nm}: {ca.subject_count()} != "
                    f"{cb.subject_count()} subjects")
        if not _same(ca.subjects, cb.subjects):
            return f"cohort {nm}: subject bitsets differ"
    if (a.flow is None) != (b.flow is None):
        return "flow presence differs"
    if a.flow is not None:
        fa = [r["subjects"] for r in a.flow.flowchart()]
        fb = [r["subjects"] for r in b.flow.flowchart()]
        if fa != fb:
            return f"flow counts {fa} != {fb}"
    if sorted(a.features) != sorted(b.features):
        return f"features {sorted(a.features)} != {sorted(b.features)}"
    for nm in a.features:
        d = _feature_delta(f"features.{nm}", a.features[nm], b.features[nm])
        if d:
            return d
    return None


@dataclasses.dataclass
class DifferentialStats:
    sp003: int = 0                 # always-false predicate verdicts
    sp014: int = 0                 # provably-empty output verdicts
    chunk_gated: bool = False      # chunked preflight refused (SP003 plan)
    arms: Tuple[str, ...] = ()     # the executions that ran


def differential_arms(device) -> Tuple[str, ...]:
    """The oracle's executions on ``device``: the ``cuda`` predicate arm
    (B1) only where the data lies on the card."""
    dev = resolve_device(device)
    return (("torch", "cuda", "chunked") if dev.type == "cuda"
            else ("torch", "chunked"))


def _emptiness_delta(result, diags) -> Optional[str]:
    """SP014 ("named output is provably empty") must imply an executed count
    of exactly zero — the analyzer is sound, so a non-zero count means the
    abstract interpretation lost touch with the engines."""
    by_node: Dict[int, List[str]] = {}
    for nm, i in result.plan.outputs:
        by_node.setdefault(i, []).append(nm)
    for d in diags:
        if d.code != "SP014":
            continue
        for nm in by_node.get(d.node, ()):
            if nm in result.events:
                got = int(result.events[nm].count)
            elif nm in result.cohorts:
                got = result.cohorts[nm].subject_count()
            else:
                continue
            if got != 0:
                return (f"SP014 claims {nm!r} empty but executed count "
                        f"is {got}")
    return None


def run_spec_differential(spec: Dict[str, Any], tables, store,
                          n_patients: int, engine: str = "torch",
                          device=None
                          ) -> Tuple[Optional[str], DifferentialStats]:
    """One spec, up to three engines on ``device`` (None = CUDA); returns
    (first delta or None, stats).

    Each execution compiles the spec **fresh** — independent Studies and
    plans — so agreement also certifies compile determinism, not just
    executor parity.  ``engine`` is the executor engine of every arm (the
    reference's default ``xla`` is ``torch``; ``cuda`` runs B2 and B3
    too).  Plans the analyzer proves contradictory (SP003) still execute
    resident (zero rows); the chunked executor's preflight must *refuse*
    them, which this harness asserts instead of the chunked run.  On the
    CPU the ``cuda`` arm does not run (``stats.arms``)."""
    dev = resolve_device(device)
    stats = DifferentialStats(arms=differential_arms(dev))
    kw = dict(engine=engine, device=dev)
    torch_res = compile_spec(spec).run(tables, predicate_engine="torch",
                                       **kw)
    if "cuda" in stats.arms:
        cuda_res = compile_spec(spec).run(tables, predicate_engine="cuda",
                                          **kw)
        d = results_equal(torch_res, cuda_res, layout=True)
        del cuda_res
        if d:
            return f"torch vs cuda: {d}", stats

    diags = analyze(torch_res.plan, tables=tables, n_patients=n_patients)
    stats.sp003 = sum(1 for g in diags if g.code == "SP003")
    stats.sp014 = sum(1 for g in diags if g.code == "SP014")
    d = _emptiness_delta(torch_res, diags)
    if d:
        return d, stats

    if stats.sp003:
        stats.chunk_gated = True
        try:
            compile_spec(spec).run_chunked(store, **kw)
        except PlanValidationError as e:
            if not any(g.code == "SP003" for g in e.diagnostics):
                return ("chunked preflight rejected an SP003 plan without "
                        "reporting SP003", stats)
        else:
            return ("chunked preflight executed a plan the analyzer "
                    "proves contradictory (SP003)", stats)
        return None, stats

    chunk_res = compile_spec(spec).run_chunked(store, **kw)
    d = results_equal(torch_res, chunk_res, layout=False)
    if d:
        return f"resident vs chunked: {d}", stats
    return None, stats


# ---------------------------------------------------------------------------
# corpus driver
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FuzzFailure:
    kind: str                  # "differential" | "rejection" | "crash"
    seed_index: int
    detail: str
    spec: Any


@dataclasses.dataclass
class FuzzReport:
    n: int
    seed: int
    arms: Tuple[str, ...] = ()     # the differential executions that ran
    n_valid: int = 0
    n_mutated: int = 0
    n_sp003: int = 0
    n_sp014: int = 0
    n_chunk_gated: int = 0
    failures: List[FuzzFailure] = dataclasses.field(default_factory=list)
    rejected_by_code: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.failures

    def to_json(self) -> Dict[str, Any]:
        return {"n": self.n, "seed": self.seed, "ok": self.ok,
                "arms": list(self.arms), "n_valid": self.n_valid, "n_mutated": self.n_mutated,
                "n_sp003": self.n_sp003, "n_sp014": self.n_sp014,
                "n_chunk_gated": self.n_chunk_gated,
                "rejected_by_code": dict(self.rejected_by_code),
                "failures": [{"kind": f.kind, "spec": f.seed_index,
                              "detail": f.detail} for f in self.failures]}

    def summary(self) -> str:
        lines = [
            f"spec fuzz: {self.n} specs (seed={self.seed}) — "
            f"{self.n_valid} valid executed differentially, "
            f"{self.n_mutated} mutated rejected",
            f"  arms: {', '.join(self.arms) or '(none: not executed)'}"
            + ("" if "cuda" in self.arms or not self.arms else
               " (the cuda arm needs a CUDA device)"),
            f"  emptiness verdicts: {self.n_sp003} SP003, "
            f"{self.n_sp014} SP014 cross-checked; "
            f"{self.n_chunk_gated} plans gated at chunked preflight",
            f"  rejections by code: "
            + (", ".join(f"{c}×{k}" for c, k in
                         sorted(self.rejected_by_code.items())) or "(none)"),
        ]
        for f in self.failures[:10]:
            lines.append(f"  FAIL [{f.kind}] spec #{f.seed_index}: {f.detail}")
        if len(self.failures) > 10:
            lines.append(f"  ... and {len(self.failures) - 10} more failures")
        lines.append("PASS" if self.ok else
                     f"FAIL ({len(self.failures)} failures)")
        return "\n".join(lines)


def run_corpus(n: int = 200, seed: int = 0, n_patients: int = 200,
               store_dir: Optional[str] = None,
               execute: bool = True, engine: str = "torch",
               device=None) -> FuzzReport:
    """Drive the fuzzer: ``n - n//2`` valid specs (each executed
    differentially on ``device`` (None = CUDA) and emptiness-cross-checked)
    plus ``n//2`` mutated specs (each asserted to be rejected with its
    catalog code).  ``execute=False`` restricts the valid half to
    validate+compile+plan (fast structural smoke, no engine runs)."""
    rng = random.Random(seed)
    report = FuzzReport(n=n, seed=seed)
    n_mut = n // 2
    n_ok = n - n_mut

    tables = store = tmp = None
    if execute:
        dev = resolve_device(device)
        report.arms = differential_arms(dev)
        tables = generate_dcir(SyntheticConfig(n_patients=n_patients,
                                               seed=seed), device=dev)
        n_flows = int(tables["ER_PRS"].count)
        cap = max(32, ((n_flows // 3) // 32 + 1) * 32)
        if store_dir is None:
            tmp = tempfile.TemporaryDirectory(prefix="spec_fuzz_")
            store_dir = tmp.name
        store = partition_star(tables, f"{store_dir}/store", source="ER_PRS",
                               chunk_capacity=cap)
    try:
        for i in range(n_ok):
            spec = gen_valid_spec(rng, n_patients=n_patients)
            issues = validate_spec(spec)
            if issues:
                report.failures.append(FuzzFailure(
                    "rejection", i,
                    f"valid-by-construction spec rejected: {issues[0]}",
                    spec))
                continue
            try:
                if execute:
                    delta, st = run_spec_differential(
                        spec, tables, store, n_patients, engine=engine,
                        device=dev)
                    report.n_sp003 += st.sp003
                    report.n_sp014 += st.sp014
                    report.n_chunk_gated += int(st.chunk_gated)
                    if delta:
                        report.failures.append(FuzzFailure(
                            "differential", i, delta, spec))
                        continue
                else:
                    compile_spec(spec).plan()
            except Exception as e:               # any traceback is a finding
                report.failures.append(FuzzFailure(
                    "crash", i, f"{type(e).__name__}: {e}", spec))
                continue
            report.n_valid += 1

        for j in range(n_mut):
            base = gen_valid_spec(rng, n_patients=n_patients)
            code, mutated = mutate_spec(base, j, rng)
            idx = n_ok + j
            try:
                issues = validate_spec(mutated)
            except Exception as e:               # validator must never raise
                report.failures.append(FuzzFailure(
                    "crash", idx,
                    f"validator raised {type(e).__name__}: {e}", mutated))
                continue
            if not any(i.code == code for i in issues):
                report.failures.append(FuzzFailure(
                    "rejection", idx,
                    f"expected {code}, got "
                    f"{sorted({i.code for i in issues}) or 'no issues'}",
                    mutated))
                continue
            try:
                compile_spec(mutated)
            except SpecValidationError:
                report.n_mutated += 1
                report.rejected_by_code[code] = \
                    report.rejected_by_code.get(code, 0) + 1
            except Exception as e:
                report.failures.append(FuzzFailure(
                    "crash", idx,
                    f"compile raised {type(e).__name__} instead of "
                    f"SpecValidationError: {e}", mutated))
            else:
                report.failures.append(FuzzFailure(
                    "rejection", idx,
                    f"compile_spec accepted a spec the validator rejects "
                    f"({code})", mutated))
    finally:
        if tmp is not None:
            tmp.cleanup()
    return report
