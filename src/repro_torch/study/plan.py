"""Plan IR: the lazy query representation behind ``repro_torch.study``.

A copy of the framework-neutral ``repro.study.plan``: the port builds the
identical node graphs, so its optimized plans compare node for node with the
reference's (engine names mapped through ``kernels.ENGINE_NAMES``).

SCALPEL3's eager API runs one projection→mask→compaction pass per extractor,
so N extractors over DCIR cost N scans and N argsort compactions.  The Plan IR
defers everything: user code (the ``Study`` builder, retrofitted ``Extractor``
and ``Cohort`` wrappers) appends *nodes* to a ``PlanBuilder``; the optimizer
rewrites the node graph (shared scans, fused masks, deferred compaction); the
executor runs the whole plan as one cached runner.

Design notes:
  * Nodes are immutable value objects ``(op, inputs, params)`` — hashable, so
    the builder hash-conses (identical sub-plans share nodes) and the executor
    can key its runner cache on plan structure alone.
  * ``inputs`` are node ids (ints); the node list is append-only, so a built
    ``Plan``'s node tuple is always topologically ordered.
  * ``params`` are a frozen (sorted key/value tuple) mapping; lists/dicts are
    recursively frozen so any user-supplied config stays hashable.

Node vocabulary (executor semantics in ``executor.py``):
  scan(source)                      -> flat table from the run-time env
  scan_star(source, star)           -> raw star-schema table (pre-flattening)
  lookup_join(l, r, keys)           -> N:1 sorted-lookup left join
  expand_join(l, r, keys, capacity) -> 1:N offset-expansion left join
  exchange(t, key)                  -> hash-partition shuffle (identity off-mesh)
  slice_time(t, col, lo, hi)        -> temporal slice, bounded per-slice capacity
  select(cols)                      -> column projection       (metadata only)
  predicate(expr)                   -> typed Expr row filter   (mask algebra)
  drop_nulls(cols)                  -> null mask (sugar: emits a predicate)
  value_filter(col, codes)          -> whitelist mask (sugar: emits a predicate)
  fused_mask(null_cols,filters,exprs)-> optimizer-fused single predicate,
                                       evaluated by the stamped engine (torch
                                       mask algebra | cuda bitset kernel)
  dedupe(keys)                      -> DISTINCT over keys (sort + run heads)
  conform_events(...)               -> Event-schema conformance
  compact()                         -> the one materialization per output
  key_count(l, r, keys)             -> eliminated pruned lookup_join: passes
                                       the left table through, keeps the
                                       join audit as a key-membership count
  cohort_from_events(name)          -> packed subject bitset from an event table
  cohort_op(kind ∈ {&,|,-})         -> bitset algebra over two cohorts
  transform(fn, kwargs)             -> registered List[Event]->List[Event] fn
  featurize(kind, kwargs)           -> FeatureDriver export (host-side)
  flow(names)                       -> CohortFlow fold over cohort nodes
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = ["Node", "Plan", "PlanBuilder", "MASK_OPS", "TABLE_OPS", "COHORT_OPS",
           "JOIN_OPS", "STATS_OPS", "PREDICATE_OPS", "HOST_OPS", "OP_KINDS"]

# ops whose value is a ColumnarTable
TABLE_OPS = frozenset({
    "scan", "scan_star", "select", "predicate", "drop_nulls", "value_filter",
    "fused_mask", "dedupe", "conform_events", "compact", "transform", "concat",
    "lookup_join", "expand_join", "exchange", "slice_time", "key_count",
})
# flattening joins (left input 0, right input 1)
JOIN_OPS = frozenset({"lookup_join", "expand_join"})
# ops that emit FlatteningStats metadata alongside their table value
STATS_OPS = frozenset({"lookup_join", "expand_join", "exchange", "slice_time",
                       "key_count"})
# ops whose value is a packed subject bitset
COHORT_OPS = frozenset({"cohort_from_events", "cohort_op"})
# mask-only ops the optimizer may fuse into one vectorized predicate
# (drop_nulls/value_filter survive as raw op names for hand-built plans; the
# PlanBuilder sugar lowers both to typed ``predicate`` nodes)
MASK_OPS = frozenset({"predicate", "drop_nulls", "value_filter"})
# predicate-evaluating ops the executor routes through a predicate engine
# ("torch" mask algebra or the "cuda" Expr->bitset kernel); the optimizer's
# ``assign_engines`` pass stamps each with its chosen engine + bitset layout
PREDICATE_OPS = MASK_OPS | frozenset({"fused_mask"})
# ops executed host-side, after the device portion
HOST_OPS = frozenset({"featurize", "flow"})

# op signatures: op -> (input kind spec, output kind).  The spec is a tuple of
# kind tokens matched positionally against the input nodes' output kinds;
# a trailing "*" means zero-or-more of that kind, a trailing "?" optional.
# ``study/analyze.py`` kind-checks plans against this table and
# ``tools/lint_invariants.py`` asserts it stays in sync with the op sets
# above — registering a new op in one place but not the other is a lint error.
OP_KINDS: Mapping[str, Tuple[Tuple[str, ...], str]] = {
    "scan": ((), "table"),
    "scan_star": ((), "table"),
    "select": (("table",), "table"),
    "predicate": (("table",), "table"),
    "drop_nulls": (("table",), "table"),
    "value_filter": (("table",), "table"),
    "fused_mask": (("table",), "table"),
    "dedupe": (("table",), "table"),
    "conform_events": (("table",), "table"),
    "compact": (("table",), "table"),
    "transform": (("table*",), "table"),
    "concat": (("table*",), "table"),
    "lookup_join": (("table", "table"), "table"),
    "expand_join": (("table", "table"), "table"),
    "exchange": (("table",), "table"),
    "slice_time": (("table",), "table"),
    "key_count": (("table", "table"), "table"),
    "cohort_from_events": (("table",), "cohort"),
    "cohort_op": (("cohort", "cohort"), "cohort"),
    "featurize": (("cohort", "table?"), "host"),
    "flow": (("cohort*",), "host"),
}


def _freeze(v: Any) -> Any:
    """Recursively convert params to hashable value objects."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return tuple(sorted(_freeze(x) for x in v))
    if isinstance(v, Mapping):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (str, bytes, int, float, bool, type(None))):
        return v
    raise TypeError(f"plan param of unhashable type {type(v).__name__}: {v!r}")


@dataclasses.dataclass(frozen=True)
class Node:
    """One IR operation: ``op`` applied to the values of ``inputs``."""

    op: str
    inputs: Tuple[int, ...]
    params: Tuple[Tuple[str, Any], ...]

    def get(self, key: str, default: Any = None) -> Any:
        for k, v in self.params:
            if k == key:
                return v
        return default

    def label(self) -> str:
        name = self.get("name")
        return f"{self.op}:{name}" if name else self.op


@dataclasses.dataclass(frozen=True)
class Plan:
    """An immutable, topologically-ordered node graph with named outputs."""

    nodes: Tuple[Node, ...]
    outputs: Tuple[Tuple[str, int], ...]

    # -- identity ------------------------------------------------------------
    def key(self) -> Tuple:
        """Structural identity — the runner-cache key component."""
        return (self.nodes, self.outputs)

    # -- introspection -------------------------------------------------------
    @property
    def output_ids(self) -> Dict[str, int]:
        return dict(self.outputs)

    def count_ops(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for n in self.nodes:
            out[n.op] = out.get(n.op, 0) + 1
        return out

    def consumers(self) -> Dict[int, List[int]]:
        cons: Dict[int, List[int]] = {i: [] for i in range(len(self.nodes))}
        for i, n in enumerate(self.nodes):
            for j in n.inputs:
                cons[j].append(i)
        return cons

    def sources(self) -> Tuple[str, ...]:
        return tuple(sorted({n.get("source") for n in self.nodes
                             if n.op in ("scan", "scan_star")}))

    def render(self) -> str:
        """Human-readable plan dump (debugging / notebooks)."""
        names = {i: name for name, i in self.outputs}
        lines = []
        for i, n in enumerate(self.nodes):
            params = ", ".join(f"{k}={v!r}" for k, v in n.params)
            tag = f"  -> {names[i]}" if i in names else ""
            ins = ",".join(str(j) for j in n.inputs)
            lines.append(f"[{i:3d}] {n.op}({ins}) {params}{tag}")
        return "\n".join(lines)


class PlanBuilder:
    """Append-only, hash-consing plan constructor."""

    def __init__(self) -> None:
        self._nodes: List[Node] = []
        self._cse: Dict[Node, int] = {}
        self._outputs: Dict[str, int] = {}

    # -- generic -------------------------------------------------------------
    def add(self, op: str, inputs: Sequence[int] = (), **params: Any) -> int:
        for j in inputs:
            if not (0 <= j < len(self._nodes)):
                raise ValueError(f"{op}: unknown input node {j}")
        node = Node(op, tuple(int(j) for j in inputs),
                    tuple(sorted((k, _freeze(v)) for k, v in params.items())))
        if node in self._cse:
            return self._cse[node]
        self._nodes.append(node)
        nid = len(self._nodes) - 1
        self._cse[node] = nid
        return nid

    def set_output(self, name: str, nid: int) -> int:
        self._outputs[name] = nid
        return nid

    def node(self, nid: int) -> Node:
        return self._nodes[nid]

    def build(self) -> Plan:
        return Plan(tuple(self._nodes), tuple(sorted(self._outputs.items())))

    # -- table ops -----------------------------------------------------------
    def scan(self, source: str) -> int:
        return self.add("scan", source=source)

    def scan_star(self, source: str, star: Optional[str] = None,
                  partitioned_on: Optional[str] = None,
                  columns: Optional[Sequence[str]] = None) -> int:
        """Scan a raw (normalized) star-schema table by name.  ``star`` tags
        the sub-database for plan introspection; ``partitioned_on`` declares a
        pre-existing hash partitioning (lets the optimizer prune exchanges);
        ``columns`` declares the table's schema, which is what lets the
        optimizer's column-pruning pass narrow the scan statically."""
        return self.add("scan_star", source=source, star=star,
                        partitioned_on=partitioned_on,
                        columns=None if columns is None else tuple(columns))

    def lookup_join(self, left: int, right: int, left_key: str,
                    right_key: str, prefix: str = "") -> int:
        """N:1 sorted-lookup left join (``core.flattening.lookup_join``)."""
        return self.add("lookup_join", (left, right), left_key=left_key,
                        right_key=right_key, prefix=prefix,
                        name=f"[{left_key}]")

    def expand_join(self, left: int, right: int, left_key: str,
                    right_key: str, capacity: Optional[int] = None,
                    slack: float = 1.5, prefix: str = "") -> int:
        """1:N offset-expansion left join.  ``capacity`` bounds the static
        output size; ``None`` defers it to the optimizer's capacity planner
        (or, failing that, a trace-time ``(L+R)*slack`` heuristic)."""
        return self.add("expand_join", (left, right), left_key=left_key,
                        right_key=right_key, prefix=prefix,
                        capacity=None if capacity is None else int(capacity),
                        slack=float(slack), name=f"[{left_key}]")

    def exchange(self, t: int, key: str,
                 per_dest_capacity: Optional[int] = None, slack: float = 2.0,
                 min_per_dest: int = 64) -> int:
        """Hash-partition shuffle on ``key``.  Identity when executed off-mesh
        (n_shards == 1); under ``shard_map`` it is the Spark exchange."""
        return self.add(
            "exchange", (t,), key=key, slack=float(slack),
            min_per_dest=int(min_per_dest),
            per_dest_capacity=(None if per_dest_capacity is None
                               else int(per_dest_capacity)),
            name=f"[{key}]")

    def slice_time(self, t: int, col: str, lo: int, hi: int,
                   capacity: Optional[int] = None) -> int:
        """Rows with ``lo <= col < hi``, compacted to ``capacity`` rows when
        given (the capacity planner sets it from the slice's actual count)."""
        return self.add("slice_time", (t,), col=col, lo=int(lo), hi=int(hi),
                        capacity=None if capacity is None else int(capacity),
                        name=f"[{lo},{hi})")

    def select(self, t: int, cols: Sequence[str]) -> int:
        return self.add("select", (t,), cols=tuple(sorted(set(cols))))

    def predicate(self, t: int, expr: Any, label: Optional[str] = None) -> int:
        """Typed row filter: ``expr`` is an ``expr.Expr`` (or its serialized
        param form), evaluated as one vectorized mask over the table."""
        from repro_torch.study.expr import as_param

        return self.add("predicate", (t,), expr=as_param(expr), name=label)

    def drop_nulls(self, t: int, cols: Sequence[str]) -> int:
        """Null filter — sugar for a conjunction-of-``not_null`` predicate."""
        from repro_torch.study.expr import all_of, col as _col

        return self.predicate(t, all_of(*[_col(c).not_null() for c in cols]),
                              label="drop_nulls")

    def value_filter(self, t: int, col: str, codes: Sequence[int]) -> int:
        """Whitelist filter — sugar for an ``isin`` predicate."""
        from repro_torch.study.expr import col as _col

        return self.predicate(t, _col(col).isin(int(c) for c in codes),
                              label="value_filter")

    def key_count(self, left: int, right: int, left_key: str,
                  right_key: str) -> int:
        """Audit-only remnant of an eliminated N:1 join: the node's value is
        the left table unchanged; its FlatteningStats record a cheap
        key-membership count against the right side (see the optimizer's
        ``eliminate_joins``)."""
        return self.add("key_count", (left, right), left_key=left_key,
                        right_key=right_key, name=f"[{left_key}]")

    def dedupe(self, t: int, keys: Sequence[str]) -> int:
        return self.add("dedupe", (t,), keys=tuple(keys))

    def conform_events(self, t: int, name: str, category: int, value_col: str,
                       start_col: str, end_col: Optional[str] = None,
                       group_col: Optional[str] = None,
                       weight_col: Optional[str] = None) -> int:
        return self.add("conform_events", (t,), name=name, category=int(category),
                        value_col=value_col, start_col=start_col, end_col=end_col,
                        group_col=group_col, weight_col=weight_col)

    def compact(self, t: int, engine: Optional[str] = None) -> int:
        return self.add("compact", (t,), engine=engine)

    def transform(self, fn: str, inputs: Sequence[int], name: Optional[str] = None,
                  **kwargs: Any) -> int:
        return self.add("transform", tuple(inputs), fn=fn,
                        name=name or fn, kwargs=kwargs)

    def concat(self, tables: Sequence[int], name: str = "concat") -> int:
        return self.add("concat", tuple(tables), name=name)

    # -- cohort ops ----------------------------------------------------------
    def cohort_from_events(self, events: int, name: str) -> int:
        return self.add("cohort_from_events", (events,), name=name)

    def cohort_op(self, kind: str, left: int, right: int, name: str) -> int:
        if kind not in ("&", "|", "-"):
            raise ValueError(f"cohort_op kind must be one of & | -, got {kind!r}")
        return self.add("cohort_op", (left, right), kind=kind, name=name)

    # -- host ops ------------------------------------------------------------
    def featurize(self, cohort: int, name: str, kind: str = "dense",
                  patients: Optional[int] = None, **kwargs: Any) -> int:
        ins = (cohort,) if patients is None else (cohort, patients)
        return self.add("featurize", ins, name=name, kind=kind, kwargs=kwargs)

    def flow(self, cohorts: Sequence[int], name: str = "flow") -> int:
        return self.add("flow", tuple(cohorts), name=name)
