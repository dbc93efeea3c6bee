"""Static plan verifier: abstract interpretation over the Study plan IR.

The port of ``repro.study.analyze``: the same codes, severities and anchor
nodes; engine names are the port's (``kernels.ENGINE_NAMES``: ``cuda`` for
the reference's ``pallas``, ``torch`` for ``jnp``).

``analyze(plan)`` walks a (raw or optimized) plan WITHOUT executing it and
computes per-node facts — inferred schema (columns + dtypes), capacity
bounds, value kinds (table/cohort/host), predicate semantics (per-column
interval + whitelist + nullness constraints), validity-layout alignment, and
predicate-engine feasibility — then reports everything inconsistent as a
``Diagnostic`` with a stable ``SPnnn`` code, a severity, the offending node
id, and a fix hint.

Why this exists (paper §2: "sharp interactive control ... through legible
code"): today an ill-typed or self-contradictory tenant plan is only caught
when the executor reaches it — or worse, a 49-minute extraction silently
returns zero rows because two conjuncts of one predicate contradict each
other.  The verifier runs in microseconds on the host and is surfaced as
``Study.check()`` (the diagnostic list) and as the chunked executor's
preflight (``study/chunked.py``: error-level plans are refused before any
chunk is read); ``defects.py`` holds one seeded defect per code.

The analysis is deliberately *sound-for-errors*: an ``error``-level finding
means the plan cannot produce the rows the author intended (unknown source,
read of a never-produced column, provably-empty mask, kind-mismatched
wiring), never a heuristic style opinion.  Heuristics live at warn/info.

Diagnostic codes (stable; the README table and the seeded-defect fixtures
mirror this registry):

  SP001 error  scan of a source absent from the bound table environment
  SP002 error  column read is never produced upstream
  SP003 error  predicate is provably always-false (contradictory conjuncts,
               empty whitelist)
  SP004 warn   predicate conjunct is provably always-true (no-op filter)
  SP005 warn   isin whitelist contains the NULL sentinel
  SP006 error  join key dtype mismatch between left and right inputs
  SP007 error/warn  planned capacity misaligned to the 32-bit validity word
               (error when it also breaks the n_shards split quantum)
  SP008 warn   predicate not cuda-compilable (oversized isin whitelist /
               non-boolean root) — the executor runs the torch engine
  SP009 info   cuda predicate carries literals; ``normalize()`` hoists
               them into slots that ride as B1's operands (the node keeps
               the cuda engine when served)
  SP010 info   concat of non-word-aligned capacities expands validity to a
               bool mask (loses the packed-bitset fast path)
  SP011 warn   expand_join without a planned capacity (run-time
               ``(L+R)*slack`` heuristic; overflow risk)
  SP012 error  op wired to inputs of the wrong kind (table vs cohort)
  SP013 error  op not registered in the plan-IR op tables
  SP014 warn   named output is provably empty
  SP015 error  chunked-execution capacity misaligned to the validity word
               quantum (chunk boundaries would split packed words)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, FrozenSet, List, Mapping, Optional, Tuple

from repro_torch.kernels import predicate as _pk
from repro_torch.study import optimizer as _opt
from repro_torch.study.expr import _NULL_SENTINEL_INT, const_fold_param, \
    node_predicate, param_conjuncts, render_param
from repro_torch.study.plan import JOIN_OPS, OP_KINDS, PREDICATE_OPS, Plan

__all__ = [
    "Diagnostic", "DIAGNOSTIC_CODES", "PlanValidationError", "analyze",
    "errors", "format_diagnostics",
]

WORD = 32  # validity word quantum (bitset.WORD_BITS; kept host-side)

# code -> (default severity, one-line summary); ``defects.py`` holds one
# seeded defect per code
DIAGNOSTIC_CODES: Mapping[str, Tuple[str, str]] = {
    "SP001": ("error", "scan source not in the bound table environment"),
    "SP002": ("error", "column read is never produced upstream"),
    "SP003": ("error", "predicate is provably always-false"),
    "SP004": ("warn", "predicate conjunct is provably always-true"),
    "SP005": ("warn", "isin whitelist contains the NULL sentinel"),
    "SP006": ("error", "join key dtype mismatch"),
    "SP007": ("warn", "capacity misaligned to the 32-bit validity word"),
    "SP008": ("warn", "predicate not cuda-compilable; torch engine"),
    "SP009": ("info", "literals hoist into cuda kernel operands"),
    "SP010": ("info", "concat misalignment expands validity to bool"),
    "SP011": ("warn", "expand_join capacity left to run-time slack"),
    "SP012": ("error", "op wired to inputs of the wrong kind"),
    "SP013": ("error", "op not registered in the plan-IR op tables"),
    "SP014": ("warn", "named output is provably empty"),
    "SP015": ("error", "chunk capacity misaligned to the validity word "
                       "quantum"),
}

SEVERITIES = ("info", "warn", "error")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding, anchored to a plan node."""

    code: str         # stable "SPnnn" identifier
    severity: str     # "error" | "warn" | "info"
    node: int         # offending node id in the analyzed plan
    message: str      # what is wrong, with the concrete evidence
    hint: str = ""    # how to fix it

    def __str__(self) -> str:
        tail = f"  ({self.hint})" if self.hint else ""
        return f"{self.code} {self.severity} @node{self.node}: " \
               f"{self.message}{tail}"


class PlanValidationError(ValueError):
    """Raised by admission-time validation when a plan carries error-level
    diagnostics.  Carries the full diagnostic list for auditing."""

    def __init__(self, diagnostics: List[Diagnostic]):
        self.diagnostics = tuple(diagnostics)
        super().__init__(format_diagnostics(
            [d for d in diagnostics if d.severity == "error"]))


def errors(diagnostics) -> List[Diagnostic]:
    return [d for d in diagnostics if d.severity == "error"]


def format_diagnostics(diagnostics) -> str:
    if not diagnostics:
        return "no diagnostics"
    return "\n".join(str(d) for d in diagnostics)


# ---------------------------------------------------------------------------
# abstract domain
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class NodeFact:
    """Per-node abstract state.  ``None`` fields mean statically unknown —
    every check degrades to silence on unknown, never to a false alarm."""

    kind: str = "table"                                # table | cohort | host
    columns: Optional[FrozenSet[str]] = None
    dtypes: Optional[Dict[str, str]] = None            # partial: known cols
    capacity: Optional[int] = None
    empty: bool = False                                # provably zero rows


@dataclasses.dataclass
class _ColState:
    """Conjunction state for one column inside one predicate node: the
    interval / whitelist / nullness constraints accumulated over the
    conjuncts.  A contradiction here is an always-false mask (SP003)."""

    lo: float = -math.inf
    lo_open: bool = False
    hi: float = math.inf
    hi_open: bool = False
    allowed: Optional[FrozenSet] = None                # isin intersection
    must_null: bool = False
    must_not_null: bool = False

    def narrow_cmp(self, op: str, v: float) -> None:
        if op == "==":
            self.narrow_cmp(">=", v)
            self.narrow_cmp("<=", v)
        elif op == "<":
            if v < self.hi or (v == self.hi and not self.hi_open):
                self.hi, self.hi_open = v, True
        elif op == "<=":
            if v < self.hi:
                self.hi, self.hi_open = v, False
        elif op == ">":
            if v > self.lo or (v == self.lo and not self.lo_open):
                self.lo, self.lo_open = v, True
        elif op == ">=":
            if v > self.lo:
                self.lo, self.lo_open = v, False
        # "!=" carries no interval information

    def narrow_isin(self, values) -> None:
        vals = frozenset(v for v in values
                         if not (isinstance(v, float) and math.isnan(v)))
        self.allowed = vals if self.allowed is None else self.allowed & vals

    def _in_interval(self, v) -> bool:
        if v < self.lo or (v == self.lo and self.lo_open):
            return False
        if v > self.hi or (v == self.hi and self.hi_open):
            return False
        return True

    def contradiction(self) -> Optional[str]:
        """A human-readable reason this conjunction can never hold."""
        if self.must_null and self.must_not_null:
            return "required both null and not-null"
        if self.lo > self.hi or (self.lo == self.hi
                                 and (self.lo_open or self.hi_open)):
            lo = f"{'(' if self.lo_open else '['}{self.lo:g}"
            hi = f"{self.hi:g}{')' if self.hi_open else ']'}"
            return f"interval {lo}, {hi} is empty"
        if self.allowed is not None:
            if not self.allowed:
                return "whitelist intersection is empty"
            if not any(self._in_interval(v) for v in self.allowed):
                return "no whitelist value satisfies the interval bounds"
        return None


def _lit_value(p) -> Optional[float]:
    """Numeric value of a ("lit", v) param, else None."""
    if isinstance(p, tuple) and p and p[0] == "lit" \
            and isinstance(p[1], (int, float)) \
            and not isinstance(p[1], bool):
        return p[1]
    return None


def _col_name(p) -> Optional[str]:
    if isinstance(p, tuple) and p and p[0] == "col":
        return p[1]
    return None


_MIRROR = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}


def _isin_whitelists(p, out: List[Tuple[Tuple, int]]) -> None:
    """Collect (values-or-None, size) for every isin/hisin in a param tree.
    Hoisted whitelists keep their size (it is shape, hence static) but lose
    their values."""
    if not isinstance(p, tuple) or not p:
        return
    if p[0] == "isin":
        out.append((p[2], len(p[2])))
        _isin_whitelists(p[1], out)
        return
    if p[0] == "hisin":
        out.append((None, p[3]))
        _isin_whitelists(p[1], out)
        return
    for x in p[1:]:
        _isin_whitelists(x, out)


def _has_concrete_literal(p) -> bool:
    """True when the param tree carries inline literal values that
    ``normalize()`` hoists into slots (lit / isin whitelists)."""
    if not isinstance(p, tuple) or not p:
        return False
    if p[0] in ("lit", "isin"):
        return True
    return any(_has_concrete_literal(x) for x in p[1:])


# ---------------------------------------------------------------------------
# kind checking against plan.OP_KINDS
# ---------------------------------------------------------------------------
def _dtype_name(v) -> str:
    """A column's dtype as numpy names it (``int32``, ``float32``)."""
    return str(v.dtype).replace("torch.", "")


def _kinds_match(spec: Tuple[str, ...], got: List[Optional[str]]) -> bool:
    i = 0
    for s in spec:
        if s.endswith("*"):
            k = s[:-1]
            return all(g in (k, None, "unknown") for g in got[i:])
        if s.endswith("?"):
            k = s[:-1]
            if i < len(got):
                if got[i] not in (k, None, "unknown"):
                    return False
                i += 1
            continue
        if i >= len(got) or got[i] not in (s, None, "unknown"):
            return False
        i += 1
    return i == len(got)


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------
def analyze(plan: Plan, tables: Optional[Mapping[str, Any]] = None,
            n_shards: int = 1, n_patients: Optional[int] = None,
            chunk_capacity: Optional[int] = None) -> List[Diagnostic]:
    """Abstract-interpret ``plan`` and return its diagnostics.

    ``tables`` (optional name -> ColumnarTable environment — e.g. the
    resident star schema) grounds scans in real schemas, dtypes
    and capacities; without it, schema facts start from ``scan_star``
    ``columns`` declarations and the content-dependent checks stay silent.
    ``n_shards`` tightens the capacity-alignment check to the mesh split
    quantum.  ``n_patients`` is accepted for symmetry with execution entry
    points (cohort capacities) but no current check consumes it.
    ``chunk_capacity`` (the out-of-core executor's per-chunk row capacity)
    enables SP015: chunk boundaries must fall on packed-validity word
    boundaries — and, sharded, on the 32*n_shards mesh quantum — or the
    per-chunk word slices are not the bitsets of their rows."""
    diags: List[Diagnostic] = []
    facts: Dict[int, NodeFact] = {}

    def emit(code: str, node: int, message: str, hint: str = "",
             severity: Optional[str] = None) -> None:
        diags.append(Diagnostic(code, severity or DIAGNOSTIC_CODES[code][0],
                                node, message, hint))

    if chunk_capacity is not None:
        _check_chunk_capacity(int(chunk_capacity), plan, n_shards, emit)

    for i, node in enumerate(plan.nodes):
        spec = OP_KINDS.get(node.op)
        if spec is None:
            emit("SP013", i, f"op {node.op!r} is not registered in "
                 "plan.OP_KINDS / the op tables",
                 hint="register the op in study/plan.py before executing it")
            facts[i] = NodeFact(kind="unknown")
            continue
        in_spec, out_kind = spec
        in_kinds = [facts[j].kind if j in facts else None
                    for j in node.inputs]
        if not _kinds_match(in_spec, in_kinds):
            emit("SP012", i,
                 f"{node.op} expects input kinds {in_spec}, got "
                 f"{tuple(in_kinds)}",
                 hint="rewire the plan: table ops consume tables, cohort "
                      "algebra consumes cohorts")
        fact = _transfer(node, i, [facts.get(j) for j in node.inputs],
                         tables, n_shards, emit)
        fact.kind = out_kind
        facts[i] = fact

    # SP014: provably-empty named outputs — the "silent zero rows" case the
    # verifier exists to catch, anchored where the user will look (the
    # output node), with the upstream contradiction already reported
    for name, i in plan.outputs:
        f = facts.get(i)
        if f is not None and f.empty and f.kind in ("table", "cohort"):
            emit("SP014", i,
                 f"output {name!r} is provably empty (an upstream predicate "
                 "can never hold)",
                 hint="see the SP003 diagnostics upstream of this node")
    return diags


def _transfer(node, i: int, in_facts: List[Optional[NodeFact]], tables,
              n_shards: int, emit) -> NodeFact:
    """Per-op transfer function: fold input facts into the node's fact,
    emitting diagnostics along the way.  Mirrors ``executor._eval_node``
    semantics (and ``optimizer.available_columns`` for schema flow)."""
    op = node.op
    left = in_facts[0] if in_facts else None
    empty = bool(left and left.empty)

    if op in ("scan", "scan_star"):
        source = node.get("source")
        declared = node.get("columns")
        t = (tables or {}).get(source) if tables is not None else None
        if tables is not None and t is None:
            emit("SP001", i, f"scan of {source!r}, which is not among the "
                 f"bound tables {sorted(tables)[:8]}",
                 hint="bind the table or fix the source name")
            return NodeFact(columns=frozenset(declared) if declared else None)
        if t is not None:
            actual = frozenset(t.columns)
            for c in sorted(frozenset(declared or ()) - actual):
                emit("SP002", i, f"scan of {source!r} declares column "
                     f"{c!r} absent from the bound table",
                     hint="the declared schema drifted from the data")
            return NodeFact(columns=actual,
                            dtypes={c: _dtype_name(v)
                                    for c, v in t.columns.items()},
                            capacity=int(t.capacity))
        return NodeFact(columns=frozenset(declared) if declared else None)

    if op == "select":
        cols = frozenset(node.get("cols"))
        fact = NodeFact(columns=cols, capacity=left.capacity if left else None,
                        empty=empty)
        if left and left.columns is not None:
            for c in sorted(cols - left.columns):
                emit("SP002", i, f"select reads column {c!r}, never produced "
                     "upstream", hint="it was dropped by an upstream "
                     "projection or misspelled")
            if left.dtypes:
                fact.dtypes = {c: left.dtypes[c] for c in cols
                               if c in left.dtypes}
        return fact

    if op in PREDICATE_OPS or op == "slice_time":
        fact = NodeFact(columns=left.columns if left else None,
                        dtypes=left.dtypes if left else None,
                        capacity=left.capacity if left else None, empty=empty)
        _check_predicate(node, i, left, emit, fact)
        if op == "slice_time":
            cap = node.get("capacity")
            if cap is not None:
                _check_alignment(int(cap), i, op, n_shards, emit)
                if fact.capacity is None or cap < fact.capacity:
                    fact.capacity = int(cap)
        return fact

    if op in ("dedupe", "compact"):
        fact = NodeFact(columns=left.columns if left else None,
                        dtypes=left.dtypes if left else None,
                        capacity=left.capacity if left else None, empty=empty)
        if op == "dedupe" and left and left.columns is not None:
            for c in sorted(frozenset(node.get("keys")) - left.columns):
                emit("SP002", i, f"dedupe keys on column {c!r}, never "
                     "produced upstream")
        return fact

    if op == "conform_events":
        if left and left.columns is not None:
            read = [node.get(k) for k in ("value_col", "start_col", "end_col",
                                          "group_col", "weight_col")]
            for c in sorted({c for c in read + ["patient_id"] if c}
                            - left.columns):
                emit("SP002", i, f"conform_events reads column {c!r}, never "
                     "produced upstream")
        return NodeFact(columns=frozenset(_opt._EVENT_COLS),
                        capacity=left.capacity if left else None, empty=empty)

    if op == "exchange":
        fact = NodeFact(columns=left.columns if left else None,
                        dtypes=left.dtypes if left else None,
                        capacity=left.capacity if left else None, empty=empty)
        if left and left.columns is not None \
                and node.get("key") not in left.columns:
            emit("SP002", i, f"exchange partitions on column "
                 f"{node.get('key')!r}, never produced upstream")
        per = node.get("per_dest_capacity")
        if per is not None:
            _check_alignment(int(per), i, "exchange per_dest_capacity",
                             n_shards, emit)
        return fact

    if op in JOIN_OPS or op == "key_count":
        right = in_facts[1] if len(in_facts) > 1 else None
        lk, rk = node.get("left_key"), node.get("right_key")
        if left and left.columns is not None and lk not in left.columns:
            emit("SP002", i, f"{op} left key {lk!r} is never produced "
                 "upstream")
        if right and right.columns is not None and rk not in right.columns:
            emit("SP002", i, f"{op} right key {rk!r} is never produced "
                 "upstream")
        if left and right and left.dtypes and right.dtypes:
            lt, rt = left.dtypes.get(lk), right.dtypes.get(rk)
            if lt and rt and lt != rt:
                emit("SP006", i, f"{op} key dtypes differ: left {lk!r} is "
                     f"{lt}, right {rk!r} is {rt}",
                     hint="searchsorted key fills compare raw lanes; cast "
                          "one side at ingestion")
        if op == "key_count":     # value = the left table unchanged
            return NodeFact(columns=left.columns if left else None,
                            dtypes=left.dtypes if left else None,
                            capacity=left.capacity if left else None,
                            empty=empty)
        cols = dtypes = None
        if left and right and left.columns is not None \
                and right.columns is not None:
            named = _opt.join_right_cols(node, right.columns)
            cols = left.columns | frozenset(named)
            if left.dtypes and right.dtypes:
                dtypes = dict(left.dtypes)
                dtypes.update({out: right.dtypes[src]
                               for out, src in named.items()
                               if src in right.dtypes})
        if op == "lookup_join":
            return NodeFact(columns=cols, dtypes=dtypes,
                            capacity=left.capacity if left else None,
                            empty=empty)
        # expand_join
        cap = node.get("capacity")
        if cap is not None:
            _check_alignment(int(cap), i, op, n_shards, emit)
            out_cap = int(cap)
        else:
            emit("SP011", i, "expand_join has no planned capacity; the "
                 "executor will size it from the run-time (L+R)*slack "
                 "heuristic",
                 hint="optimize with tables= so plan_capacities can size it "
                      "exactly")
            out_cap = None
            if left and right and left.capacity is not None \
                    and right.capacity is not None:
                out_cap = int((left.capacity + right.capacity)
                              * (node.get("slack") or 1.5))
        return NodeFact(columns=cols, dtypes=dtypes, capacity=out_cap,
                        empty=empty)

    if op == "concat":
        known = [f for f in in_facts if f is not None]
        colsets = [f.columns for f in known]
        cols = colsets[0] if colsets and all(c == colsets[0]
                                             for c in colsets) else None
        if colsets and all(c is not None for c in colsets) and cols is None:
            diff = frozenset().union(*colsets) - frozenset.intersection(
                *colsets)
            emit("SP002", i, "concat inputs disagree on schema: "
                 f"{sorted(diff)} not produced by every input",
                 hint="ColumnarTable.concat requires identical column sets")
        caps = [f.capacity for f in known]
        cap = sum(caps) if caps and all(c is not None for c in caps) else None
        misaligned = [c for c in caps[:-1] if c is not None and c % WORD]
        if misaligned:
            emit("SP010", i, "concat input capacities "
                 f"{misaligned} are not 32-aligned: validity falls off the "
                 "packed-word fast path and round-trips through a bool mask",
                 hint="pad inputs to a 32-row quantum to keep the bitset "
                      "layout end-to-end")
        return NodeFact(columns=cols, capacity=cap,
                        empty=bool(known) and all(f.empty for f in known))

    if op == "transform":
        return NodeFact()  # opaque host fn: schema/capacity unknown

    if op == "cohort_from_events":
        if left and left.columns is not None \
                and "patient_id" not in left.columns:
            emit("SP002", i, "cohort_from_events needs column 'patient_id', "
                 "never produced upstream")
        return NodeFact(kind="cohort", empty=empty)

    if op == "cohort_op":
        right = in_facts[1] if len(in_facts) > 1 else None
        kind = node.get("kind")
        l_empty = bool(left and left.empty)
        r_empty = bool(right and right.empty)
        out_empty = {"&": l_empty or r_empty, "|": l_empty and r_empty,
                     "-": l_empty}.get(kind, False)
        return NodeFact(kind="cohort", empty=out_empty)

    # host ops (featurize, flow) and anything kind-checked above
    return NodeFact(kind="host")


def _check_chunk_capacity(cap: int, plan: Plan, n_shards: int, emit) -> None:
    """SP015: a chunked manifest whose per-chunk capacity is off the packed
    validity word (or, sharded, the 32*n_shards mesh quantum) cannot slice
    the source bitset on chunk boundaries — reject before any chunk IO.
    Anchored at the plan's scan nodes (the boundary the chunks feed)."""
    quantum = WORD * max(int(n_shards), 1)
    anchor = next((i for i, n in enumerate(plan.nodes)
                   if n.op in ("scan", "scan_star")), 0)
    if cap <= 0:
        emit("SP015", anchor, f"chunk capacity {cap} is not positive",
             hint="partition with a positive multiple of 32 rows per chunk")
    elif cap % quantum:
        what = (f"the sharded validity quantum {quantum} (32*{n_shards} "
                "shards)" if n_shards > 1 else "the 32-bit validity word")
        emit("SP015", anchor, f"chunk capacity {cap} is not a multiple of "
             f"{what}, so chunk boundaries split validity words",
             hint="re-partition the store with a 32-aligned (sharded: "
                  "32*n_shards-aligned) chunk_capacity")


def _check_alignment(cap: int, i: int, what: str, n_shards: int,
                     emit) -> None:
    """SP007: planned capacities must respect the packed-validity word (and,
    sharded, the mesh split quantum 32*n_shards — ``pad_tables_for_mesh``
    pads *inputs*, but a misaligned planned capacity re-breaks alignment
    mid-plan)."""
    quantum = WORD * max(int(n_shards), 1)
    if n_shards > 1 and cap % quantum:
        emit("SP007", i, f"{what} capacity {cap} is not a multiple of the "
             f"sharded validity quantum {quantum} (32*{n_shards} shards)",
             hint="round capacities up to 32*n_shards (plan_capacities "
                  "rounds to 64)", severity="error")
    elif cap % WORD:
        emit("SP007", i, f"{what} capacity {cap} is not a multiple of the "
             "32-bit validity word",
             hint="round capacities up to a 32-row quantum")


def _check_predicate(node, i: int, left: Optional[NodeFact], emit,
                     fact: NodeFact) -> None:
    """Predicate semantics + engine feasibility for one mask-evaluating
    node."""
    e = node_predicate(node)
    if e is None:
        return
    param = e.to_param()

    # SP002: columns the mask reads but no upstream node produces
    if left is not None and left.columns is not None:
        for c in sorted(e.required_columns() - left.columns):
            emit("SP002", i, f"{node.op} reads column {c!r}, never produced "
                 "upstream",
                 hint="it was pruned/dropped upstream or misspelled")

    # conjunct-level semantics: constant folds + per-column interval algebra
    states: Dict[str, _ColState] = {}
    contradicted = False
    for conj in param_conjuncts(param):
        folded = const_fold_param(conj)
        if folded is False:
            emit("SP003", i, f"conjunct {render_param(conj)} is always "
                 "false: the mask keeps zero rows",
                 hint="empty whitelists / literal-only comparisons never "
                      "hold")
            contradicted = True
            continue
        if folded is True:
            emit("SP004", i, f"conjunct {render_param(conj)} is always "
                 "true: the filter is a no-op",
                 hint="drop the tautological conjunct")
            continue
        _narrow(conj, states)
    for c, st in states.items():
        reason = st.contradiction()
        if reason is not None:
            emit("SP003", i, f"constraints on column {c!r} contradict: "
                 f"{reason} — the mask keeps zero rows",
                 hint="two conjuncts of this predicate exclude each other")
            contradicted = True
            break
    if contradicted:
        fact.empty = True

    # SP005: whitelists that name the NULL sentinel (never matches the
    # author's intent — null tests go through is_null, and float NULL is
    # NaN, which isin can never match)
    wls: List[Tuple[Tuple, int]] = []
    _isin_whitelists(param, wls)
    for values, size in wls:
        if values is None:
            continue
        if any(v == _NULL_SENTINEL_INT
               or (isinstance(v, float) and math.isnan(v)) for v in values):
            emit("SP005", i, "isin whitelist contains the NULL sentinel "
                 f"({_NULL_SENTINEL_INT} / NaN)",
                 hint="nulls never match a whitelist; use is_null()/"
                      "drop_nulls instead")
            break

    # engine feasibility
    oversized = [s for _, s in wls if s > _pk.MAX_ISIN_VALUES]
    if oversized:
        vmem = _pk.isin_vmem_bytes(max(oversized))
        emit("SP008", i, f"isin whitelist of {max(oversized)} values "
             f"exceeds the cuda engine's membership budget "
             f"({_pk.MAX_ISIN_VALUES}, the reference's: its broadcast "
             f"intermediate alone needs ~{vmem / 2**20:.1f} MiB) — the "
             "executor runs the torch engine",
             hint="split the whitelist or pre-join a code dimension")
    if node.get("engine") == "cuda":
        if not _pk.compilable(param) and not oversized:
            emit("SP008", i, "node is stamped engine=cuda but its expr is "
                 "not kernel-compilable (non-boolean root); the executor "
                 "runs the torch engine",
                 hint="the mask root must be a comparison/boolean op")
        if _has_concrete_literal(param) and _pk.compilable(param):
            emit("SP009", i, "cuda-stamped mask carries inline literals; "
                 "normalize() hoists them into slots that enter B1 as "
                 "operands (scalar literals as uniform values, sorted isin "
                 "whitelists as padded vectors in shared memory) — the "
                 "node keeps the cuda engine when served",
                 hint="structurally-equal plans with different literal "
                      "values share one runner; only kernel-infeasible "
                      "stamps (SP008) demote to torch")


def _narrow(conj, states: Dict[str, _ColState]) -> None:
    """Fold one conjunct into the per-column constraint states.  Only
    directly-grounded shapes (col vs literal) narrow; anything else is
    conservatively ignored."""
    tag = conj[0] if isinstance(conj, tuple) and conj else None
    if tag == "cmp":
        c, v = _col_name(conj[2]), _lit_value(conj[3])
        op = conj[1]
        if c is None or v is None:
            c, v = _col_name(conj[3]), _lit_value(conj[2])
            op = _MIRROR[conj[1]]
        # NOTE: a satisfied comparison does NOT imply non-null — the int32
        # NULL sentinel compares as an ordinary lane value at runtime, so
        # nullness only narrows through explicit isnull/notnull conjuncts.
        if c is not None and v is not None:
            states.setdefault(c, _ColState()).narrow_cmp(op, v)
    elif tag == "isin":
        c = _col_name(conj[1])
        if c is not None:
            states.setdefault(c, _ColState()).narrow_isin(conj[2])
    elif tag == "isnull":
        c = _col_name(conj[1])
        if c is not None:
            states.setdefault(c, _ColState()).must_null = True
    elif tag == "notnull":
        c = _col_name(conj[1])
        if c is not None:
            states.setdefault(c, _ColState()).must_not_null = True
