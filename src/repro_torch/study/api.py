"""``Study``: the fluent, lazy entry point unifying extraction → cohort →
features (the paper's three layers) behind one Plan.

The port of ``repro.study.api``.  ``run`` puts the tables on ``device``
(None means CUDA) and executes the optimized plan there, or, given a
``torch.distributed`` process group as ``mesh``, shard-local on every rank
of it.  ``check`` runs the static plan analyzer (``study/analyze.py``);
``run_chunked`` streams a partitioned star (``data.chunkstore``) through the
card chunk by chunk (``study/chunked.py``).

User code reads like the paper's supplementary notebooks::

    result = (Study(n_patients=P)
              .extract(drug_dispenses(), name="drugs")
              .extract(medical_acts_dcir(), name="acts")
              .patients("IR_BEN")
              .transform("exposures", "drugs", name="exposed", purview_days=60)
              .cohort("base", "extract_patients")
              .cohort("final", "exposed & base - acts")
              .flow("base", "exposed", "final")
              .featurize("X", cohort="final", kind="dense",
                         n_buckets=36, bucket_days=31, n_features=128)
              .run({"DCIR": flat, "IR_BEN": ir_ben}, engine="cuda"))

Nothing executes until ``run()``: the builder accumulates Plan nodes, the
optimizer fuses masks / shares scans / defers compaction, and the executor
runs the plan once for all extractors and cohort algebra, logging every node
into an ``OperationLog`` automatically.
"""
from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Any, Dict, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch.core.cohort import Cohort, CohortCollection, CohortFlow
from repro_torch.core.columnar import ColumnarTable, resolve_device
from repro_torch.core.feature_driver import FeatureDriver
from repro_torch.core.metadata import OperationLog
from repro_torch.study import executor as _executor
from repro_torch.study import optimizer as _optimizer
from repro_torch.study.expr import CohortRef, parse_cohort_expr
from repro_torch.study.plan import COHORT_OPS, Plan, PlanBuilder, TABLE_OPS

if TYPE_CHECKING:
    from repro_torch.distributed.pipeline import ShardedTable

__all__ = ["Study", "StudyResult", "contribute_flatten",
           "contribute_flatten_sliced", "flow_rows_from_log",
           "column_audit_from_log"]

_FLOW_OUT = "__flow__"


def contribute_flatten(b: PlanBuilder, schema, central: Optional[int] = None,
                       expand_capacity: Optional[int] = None,
                       expand_slack: float = 1.5, exchange: bool = False,
                       exchange_slack: float = 2.0, min_per_dest: int = 64,
                       partitioned_on: Optional[str] = None) -> int:
    """Append one sub-database's flattening to ``b``; returns the flat node.

    The join chain mirrors ``StarSchema.joins`` (lookup for N:1 dimension
    tables, expand for 1:N children).  ``exchange=True`` emits the Spark
    physical plan for mesh execution — exchange both sides of every join
    onto the join key, then one final exchange onto ``patient_key`` so the
    output is patient-partitioned.  The left side's partitioning is tracked
    while building, so a same-key exchange is never emitted in the first
    place (re-exchanging an already-partitioned shard would funnel every
    local row into one destination bucket — this must hold even for raw,
    unoptimized plans); the optimizer's ``prune_exchanges`` pass additionally
    drops exchanges made redundant by rewrites, and all of them off-mesh.
    ``central`` overrides the central-table node (e.g. a ``slice_time`` of
    it), with ``partitioned_on`` describing *its* partitioning.
    """
    t = central if central is not None else b.scan_star(
        schema.central.name, star=schema.name, partitioned_on=partitioned_on,
        columns=tuple(schema.central.columns))
    pkey = partitioned_on
    for edge in schema.joins:
        r = b.scan_star(edge.right, star=schema.name,
                        columns=tuple(schema.table(edge.right).columns))
        if exchange:
            if pkey != edge.left_key:
                t = b.exchange(t, edge.left_key, slack=exchange_slack,
                               min_per_dest=min_per_dest)
                pkey = edge.left_key
            r = b.exchange(r, edge.right_key, slack=exchange_slack,
                           min_per_dest=min_per_dest)
        if edge.one_to_many:
            t = b.expand_join(t, r, edge.left_key, edge.right_key,
                              capacity=expand_capacity, slack=expand_slack)
        else:
            t = b.lookup_join(t, r, edge.left_key, edge.right_key)
    if exchange and pkey != schema.patient_key \
            and schema.patient_key in schema.flat_columns():
        t = b.exchange(t, schema.patient_key, slack=exchange_slack,
                       min_per_dest=min_per_dest)
    return t


def contribute_flatten_sliced(b: PlanBuilder, schema, time_column: str,
                              n_slices: int, t0: int, t1: int,
                              name: str = "sliced_flatten",
                              partitioned_on: Optional[str] = None,
                              **kw) -> int:
    """Temporal slicing (paper §3.3) as plan nodes: one ``slice_time`` +
    join chain per slice, concatenated.  Slice capacities stay unset here —
    the optimizer's capacity planner bounds each one by the slice's actual
    row count (``plan_capacities``), which is what keeps the concatenated
    output at ~sum-of-slice-rows instead of ``n_slices`` full copies."""
    edges = np.linspace(int(t0), int(t1) + 1,
                        int(n_slices) + 1).astype(np.int32)
    parts = []
    for i in range(int(n_slices)):
        t = b.scan_star(schema.central.name, star=schema.name,
                        partitioned_on=partitioned_on,
                        columns=tuple(schema.central.columns))
        t = b.slice_time(t, time_column, int(edges[i]), int(edges[i + 1]))
        parts.append(contribute_flatten(b, schema, central=t,
                                        partitioned_on=partitioned_on, **kw))
    return b.concat(parts, name=name)


@dataclasses.dataclass
class StudyResult:
    """Realized outputs of one ``Study.run``.

    Table outputs carry the bitset-native validity contract: ``.valid`` is
    the packed word form (int32 bit patterns, ``core.bitset`` layout,
    ``count`` == popcount); use ``.valid_bool()`` / ``.to_numpy()`` for
    per-row views.
    """

    # named table outputs; under a mesh, ``ShardedTable``s (the rank's
    # block, the global count, ``gather()``)
    events: Dict[str, Union[ColumnarTable, ShardedTable]]
    cohorts: Dict[str, Cohort]                # named cohorts
    flow: Optional[CohortFlow]                # if .flow(...) was declared
    features: Dict[str, Any]                  # named featurize outputs
    log: OperationLog                         # automatic provenance
    plan: Plan                                # the plan that actually ran
    feature_checks: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    flatten_stats: Dict[int, Dict[str, int]] = dataclasses.field(default_factory=dict)
    # ^ per-join FlatteningStats (host ints, keyed by plan node id; each dict
    #   carries a "stage" label) — also recorded in ``log`` automatically

    def assert_no_loss(self) -> None:
        """The paper's flattening audit: no join/exchange overflowed."""
        for i, d in self.flatten_stats.items():
            if d.get("overflow", 0):
                raise AssertionError(
                    f"plan node #{i} ({d.get('stage')}): "
                    f"{d['overflow']} rows overflowed")

    def collection(self) -> CohortCollection:
        return CohortCollection(dict(self.cohorts), metadata=self.log)


class Study:
    """Deferred study builder over the Plan IR (see module docstring)."""

    def __init__(self, n_patients: int,
                 window: Tuple[int, int] = (0, 2_000_000_000)) -> None:
        self.n_patients = int(n_patients)
        self._window = (int(window[0]), int(window[1]))
        self._b = PlanBuilder()
        self._names: Dict[str, int] = {}      # name -> node id (pre-optimize)
        self._kinds: Dict[str, str] = {}      # name -> events|table|cohort|feature
        self._sources: Dict[str, ColumnarTable] = {}
        self._flow_names: Optional[List[str]] = None
        self._feature_names: List[str] = []
        self._flatten_keep: Dict[str, Optional[bool]] = {}  # name -> keep mode
        self._chained: set = set()            # flatten names extractors read
        self._opt_cache: Optional[Tuple[Tuple, Plan]] = None  # (key, optimized)
        # declarative build log: one (step, kwargs) record per successful
        # builder call, holding the *arguments* (schema/extractor/Expr
        # objects, not plan nodes).  ``study.spec.spec_from_study`` serializes
        # it into the wire-format spec; methods with no wire equivalent
        # (``source``) record an explicit marker so the exporter can refuse
        # loudly instead of silently dropping state.
        self._recipe: List[Tuple[str, Dict[str, Any]]] = []

    # -- builder steps -------------------------------------------------------
    def _register(self, name: str, nid: int, kind: str) -> "Study":
        if name in self._names:
            raise ValueError(f"duplicate study output name {name!r}")
        self._names[name] = self._b.set_output(name, nid)
        self._kinds[name] = kind
        return self

    def source(self, name: str, table: ColumnarTable) -> "Study":
        """Pre-bind a flat table (alternative to passing it at run())."""
        self._sources[name] = table
        self._recipe.append(("source", {"name": name}))
        return self

    def flatten(self, schema, name: Optional[str] = None,
                time_slices: Optional[int] = None,
                time_column: Optional[str] = None, t0: Optional[int] = None,
                t1: Optional[int] = None, expand_capacity: Optional[int] = None,
                expand_slack: float = 1.5, exchange: bool = True,
                partitioned_on: Optional[str] = None,
                keep: Optional[bool] = None) -> "Study":
        """SCALPEL-Flattening as plan nodes: the star schema's
        denormalization joins enter the same Plan IR as extraction, so one
        ``optimize()`` + executor pass runs raw star tables all the
        way to features.  The flat table registers under ``name`` (default:
        the schema name, e.g. ``"DCIR"``), and later ``extract()`` calls
        whose extractor ``source`` matches chain onto it instead of scanning
        the run-time env — ``run()`` then takes the *normalized* star tables.

        ``time_slices`` (with ``time_column``/``t0``/``t1``) splits the
        central table into temporal slices flattened independently and
        concatenated, each with a bounded capacity set by the optimizer's
        capacity planner.  ``exchange`` keeps the plan mesh-ready (exchange
        nodes are pruned off-mesh and are the identity when unpruned).

        ``keep`` controls whether the flat table is a *realized output* of
        the study (full schema in ``result.events[name]``) or just the
        chaining point for later ``extract()`` calls.  The default ``None``
        is automatic: keep the flat table unless an extractor chains onto it
        — once extraction consumes it, demoting it to an interior node lets
        the optimizer's column-pruning pass drop every dimension column no
        extractor reads *before the joins materialize it* (a named output
        would pin the full flat schema).  Pass ``keep=True`` to always
        materialize the flat table, ``keep=False`` to never.
        """
        b = self._b
        if time_slices:
            if time_column is None or t0 is None or t1 is None:
                raise ValueError("time_slices needs time_column, t0 and t1")
            nid = contribute_flatten_sliced(
                b, schema, time_column, time_slices, t0, t1,
                name=name or schema.name, partitioned_on=partitioned_on,
                expand_capacity=expand_capacity, expand_slack=expand_slack,
                exchange=exchange)
        else:
            nid = contribute_flatten(
                b, schema, expand_capacity=expand_capacity,
                expand_slack=expand_slack, exchange=exchange,
                partitioned_on=partitioned_on)
        self._flatten_keep[name or schema.name] = keep
        self._register(name or schema.name, nid, "table")
        self._recipe.append(("flatten", {
            "schema": schema, "name": name, "time_slices": time_slices,
            "time_column": time_column, "t0": t0, "t1": t1,
            "expand_capacity": expand_capacity, "expand_slack": expand_slack,
            "exchange": exchange, "partitioned_on": partitioned_on,
            "keep": keep}))
        return self

    def extract(self, extractor, name: Optional[str] = None,
                compact: bool = True) -> "Study":
        """Append a declarative ``Extractor``'s steps to the plan.  When the
        extractor's ``source`` names a table built earlier in this study
        (e.g. by ``flatten``), the steps chain onto that node; otherwise they
        scan the run-time env."""
        base = None
        if (extractor.source in self._names
                and self._kinds.get(extractor.source) == "table"):
            base = self._names[extractor.source]
            self._chained.add(extractor.source)
        nid = extractor.contribute(self._b, compact=compact, base=base)
        self._register(name or extractor.name, nid, "events")
        self._recipe.append(("extract", {
            "extractor": extractor, "name": name or extractor.name,
            "compact": compact}))
        return self

    def patients(self, source: str = "IR_BEN",
                 name: str = "extract_patients") -> "Study":
        """Patient demographics table (paper task (a)) as a plan branch."""
        b = self._b
        t = b.select(b.scan(source),
                     ["patient_id", "gender", "birth_date", "death_date"])
        t = b.compact(b.dedupe(t, ["patient_id"]))
        self._register(name, t, "table")
        self._recipe.append(("patients", {"source": source, "name": name}))
        return self

    def transform(self, fn: str, *inputs: str, name: Optional[str] = None,
                  **kwargs: Any) -> "Study":
        """Defer a registered transformer (``executor.TRANSFORMS``) over named
        upstream outputs; ``n_patients`` (and, for the transforms that take
        it, the run's ``engine``) is injected at execution."""
        if fn not in _executor.TRANSFORMS:
            raise ValueError(f"unknown transform {fn!r}; registered: "
                             f"{sorted(_executor.TRANSFORMS)}")
        ids = [self._node_of(x) for x in inputs]
        nid = self._b.transform(fn, ids, name=name or fn, **kwargs)
        self._register(name or fn, nid, "events")
        self._recipe.append(("transform", {
            "fn": fn, "inputs": list(inputs), "name": name or fn,
            "kwargs": dict(kwargs)}))
        return self

    def concat(self, name: str, *inputs: str) -> "Study":
        """Stack named event outputs into one table (schemas must match)."""
        nid = self._b.concat([self._node_of(x) for x in inputs], name=name)
        self._register(name, nid, "events")
        self._recipe.append(("concat", {"name": name, "inputs": list(inputs)}))
        return self

    def filter(self, source: str, expr, name: Optional[str] = None) -> "Study":
        """Filter a named table/events output with a typed column expression:
        ``study.filter("drugs", col("start") >= t0, name="recent")``.  The
        predicate rides the plan like any extractor mask (fusable, prunable);
        the filtered table registers under ``name`` with one compaction."""
        if name is None:
            name = f"{source}_filtered"
        kind = self._kinds.get(source)
        if kind not in ("table", "events"):
            raise ValueError(f"filter source {source!r} is not a table output")
        nid = self._b.predicate(self._node_of(source), expr, label=name)
        self._register(name, nid, kind)
        self._recipe.append(("filter", {
            "source": source, "where": expr, "name": name}))
        return self

    def cohort(self, name: str, expr: str,
               description: Optional[str] = None) -> "Study":
        """Define a cohort from an algebra expression over previously
        declared cohorts / extractions / transforms, e.g.
        ``"(exposed & base) - fractured"``.  Parsed by a real
        recursive-descent parser (``expr.parse_cohort_expr``): ``&`` (∩)
        binds tighter than ``|`` (∪) and ``-`` (\\), parentheses group, and
        each level is left-associative.  Legacy flat expressions keep their
        meaning bit-for-bit wherever the old single-precedence left fold
        agreed with standard precedence (single-operator chains, and mixes
        where every ``&`` precedes ``|``/``-``); where the old fold
        disagreed — ``"a | b & c"``, ``"a - b & c"`` — the old reading was
        the bug this parser fixes, and parentheses restore it explicitly."""
        nid = self._lower_cohort(parse_cohort_expr(expr), name)
        self._register(name, nid, "cohort")
        self._recipe.append(("cohort", {"name": name, "expr": expr}))
        return self

    def flow(self, *names: str) -> "Study":
        """Declare the RECORD-flowchart fold over named cohorts, in order."""
        ids = [self._cohort_node(n) for n in names]
        fid = self._b.flow(ids, name="flow")
        self._flow_names = list(names)
        self._names[_FLOW_OUT] = self._b.set_output(_FLOW_OUT, fid)
        self._kinds[_FLOW_OUT] = "flow"
        self._recipe.append(("flow", {"names": list(names)}))
        return self

    def featurize(self, name: str, cohort: str, kind: str = "dense",
                  patients: Optional[str] = None, **kwargs: Any) -> "Study":
        """Defer a FeatureDriver export (``dense`` or ``tokens``) of a cohort."""
        if kind not in ("dense", "tokens"):
            raise ValueError(f"featurize kind must be dense|tokens, got {kind!r}")
        cid = self._cohort_node(cohort)
        pid = self._node_of(patients) if patients else None
        nid = self._b.featurize(cid, name=name, kind=kind, patients=pid, **kwargs)
        self._feature_names.append(name)
        self._register(name, nid, "feature")
        self._recipe.append(("featurize", {
            "name": name, "cohort": cohort, "kind": kind,
            "patients": patients, "kwargs": dict(kwargs)}))
        return self

    def window(self, start: int, end: int) -> "Study":
        self._window = (int(start), int(end))
        return self

    # -- name resolution -----------------------------------------------------
    def _node_of(self, name: str) -> int:
        if name not in self._names:
            raise ValueError(f"unknown study output {name!r}; defined: "
                             f"{sorted(self._names)}")
        return self._names[name]

    def _cohort_node(self, name: str) -> int:
        """Node id of a cohort; event/table outputs auto-wrap via
        ``cohort_from_events`` (membership = has-any-row, as in the paper)."""
        nid = self._node_of(name)
        if self._kinds[name] == "cohort":
            return nid
        return self._b.cohort_from_events(nid, name=name)

    def _lower_cohort(self, tree, name: str) -> int:
        """Lower a parsed ``CohortExpr`` onto ``cohort_op`` plan nodes.
        Post-order, left-to-right — for legacy flat expressions the node
        names ``name[1]``, ``name[2]``, ... match the old left-fold."""
        counter = [0]

        def lower(t) -> int:
            if isinstance(t, CohortRef):
                return self._cohort_node(t.name)
            left = lower(t.left)
            right = lower(t.right)
            counter[0] += 1
            return self._b.cohort_op(t.op, left, right,
                                     name=f"{name}[{counter[0]}]")

        return lower(tree)

    # -- plans ---------------------------------------------------------------
    def plan(self) -> Plan:
        """The raw (unoptimized) plan built so far.  Flatten outputs in
        automatic ``keep`` mode that an extractor chained onto are demoted
        from named outputs here — they stay the chaining point but stop
        pinning the full flat schema, which is what lets ``optimize()``
        prune unused dimension columns out of the join chain."""
        raw = self._b.build()
        drop = {nm for nm, keep in self._flatten_keep.items()
                if keep is False or (keep is None and nm in self._chained)}
        if drop:
            raw = Plan(raw.nodes, tuple((n, i) for n, i in raw.outputs
                                        if n not in drop))
        return raw

    def optimized_plan(self, tables: Optional[Dict[str, ColumnarTable]] = None,
                       n_shards: int = 1, predicate_engine: str = "auto",
                       engine: str = "torch", device=None) -> Plan:
        """Optimize the built plan.  ``tables`` (concrete run-time tables)
        lets the capacity planner size join outputs from table statistics;
        that path re-plans on every call, since planned capacities depend on
        table content.  Plans with nothing to capacity-plan keep the cached
        path.  ``device`` (where the data lies; by default that of
        ``tables``) lets ``predicate_engine="auto"`` resolve."""
        if device is None and tables:
            device = _executor.env_device(tables)
        raw = self.plan()
        needs_stats = any(n.op in ("expand_join", "slice_time")
                          and n.get("capacity") is None for n in raw.nodes)
        if tables and needs_stats:
            return _optimizer.optimize(raw, tables=tables, n_shards=n_shards,
                                       predicate_engine=predicate_engine,
                                       engine=engine, device=device)
        key = (raw.key(), n_shards, predicate_engine, engine,
               None if device is None else str(device))
        if self._opt_cache is not None and self._opt_cache[0] == key:
            return self._opt_cache[1]
        opt = _optimizer.optimize(raw, n_shards=n_shards,
                                  predicate_engine=predicate_engine,
                                  engine=engine, device=device)
        self._opt_cache = (key, opt)
        return opt

    def check(self, tables: Optional[Dict[str, ColumnarTable]] = None,
              n_shards: int = 1, predicate_engine: str = "auto",
              engine: str = "torch", optimize: bool = True,
              device=None) -> List:
        """Statically verify the study's plan without executing it.

        Runs the abstract-interpretation analyzer (``study/analyze.py``)
        over the optimized plan (or the raw plan with ``optimize=False``)
        and returns the list of ``Diagnostic`` findings — schema errors,
        provably-empty predicates, misaligned capacities, engine-feasibility
        notes — each with a stable ``SPnnn`` code, a severity and a fix
        hint.  Bound sources (``Study.source``) and ``tables`` ground scans
        in real schemas/dtypes (they are read where they lie, never moved);
        without them the structural checks still run.  ``device`` (None =
        CUDA; raises where CUDA is absent) is where the plan would run, which
        resolves ``predicate_engine="auto"``.  A clean bill of health is
        ``[]``."""
        # member import: the package re-exports analyze(), shadowing the
        # submodule
        from repro_torch.study.analyze import analyze as _analyze_plan

        dev = resolve_device(device)
        env = dict(self._sources)
        env.update(tables or {})
        plan = (self.optimized_plan(tables=env or None, n_shards=n_shards,
                                    predicate_engine=predicate_engine,
                                    engine=engine, device=dev)
                if optimize else self.plan())
        return _analyze_plan(plan, tables=env or None, n_shards=n_shards,
                             n_patients=self.n_patients)

    # -- execution -----------------------------------------------------------
    def run(self, tables: Optional[Dict[str, ColumnarTable]] = None,
            engine: str = "torch", optimize: bool = True,
            log: Optional[OperationLog] = None, mesh=None,
            axis_name: str = "data",
            predicate_engine: Optional[str] = None,
            device=None) -> StudyResult:
        """Optimize, execute on ``device`` (None = CUDA; raises where CUDA
        is absent), realize cohorts and flow, and auto-log provenance.

        Tables not already on ``device`` are moved there.  ``engine``
        ("torch" | "cuda") picks the compaction, cohort-algebra and shuffle
        path; ``predicate_engine`` ("torch" | "cuda" | "auto"/None) picks how
        predicate/fused_mask nodes evaluate: torch mask algebra or the CUDA
        Expr->bitset kernel, whose packed words become the table validity
        directly.  The optimizer stamps the resolved choice — and the
        ``bitset_u32`` validity layout — on each node so the OperationLog
        records it.

        ``mesh`` (a ``torch.distributed`` process group; ``axis_name`` is
        kept for the reference's signature) runs the plan sharded: every
        rank calls ``run`` with the same global tables, plans from them for
        ``n_shards`` = the group's size and runs its row block with real
        exchanges (``execute_plan_sharded``).  Each event table of the
        result is then a ``distributed.ShardedTable``: this rank's block
        with the global count, whole only through its ``gather()``; a
        cohort's events are its rank's block.  Cohort words, counts, flow,
        FlatteningStats and the OperationLog are global on every rank."""
        dev = resolve_device(device)
        env = {k: t.to(dev)
               for k, t in {**self._sources, **(tables or {})}.items()}
        n_shards = 1
        if mesh is not None:
            from repro_torch.distributed import comm

            n_shards = comm.world_size(mesh)
        plan = (self.optimized_plan(tables=env, n_shards=n_shards,
                                    predicate_engine=predicate_engine or "auto",
                                    engine=engine, device=dev)
                if optimize else self.plan())
        log = log if log is not None else OperationLog()
        join_stats: Dict[int, Dict[str, int]] = {}
        if mesh is not None:
            from repro_torch.distributed.pipeline import execute_plan_sharded

            vals, counts, join_stats = execute_plan_sharded(
                plan, env, self.n_patients, mesh, axis_name=axis_name,
                engine=engine, predicate_engine=predicate_engine)
            _executor.record_plan(plan, counts, log, engine,
                                  stats=join_stats,
                                  predicate_engine=predicate_engine,
                                  device=dev)
        else:
            vals = _executor.execute(plan, env, n_patients=self.n_patients,
                                     engine=engine, log=log,
                                     stats_sink=join_stats,
                                     predicate_engine=predicate_engine)
        for i, d in join_stats.items():
            d.setdefault("stage", plan.nodes[i].label())
        return self._finish_result(plan, vals, join_stats, log, mesh=mesh)

    def run_chunked(self, store,
                    tables: Optional[Dict[str, ColumnarTable]] = None,
                    engine: str = "torch",
                    predicate_engine: Optional[str] = None,
                    checkpoint_dir: Optional[str] = None,
                    prefetch: bool = True,
                    log: Optional[OperationLog] = None,
                    report_sink: Optional[Dict[str, Any]] = None,
                    device=None, **executor_kwargs: Any) -> StudyResult:
        """Execute this study out-of-core over a partitioned star
        (``data.chunkstore.ChunkStore``) on ``device`` (None = CUDA): the
        central table streams through the device chunk by chunk — ONE cached
        runner for all chunks — with chunk i+1's disk read and copy to the
        card overlapping chunk i's execution, and results merged
        bit-identical to ``run()`` over the unpartitioned star.
        ``checkpoint_dir`` enables the per-chunk journal: a killed run
        re-invoked with the same arguments resumes, executing only the
        chunks the journal does not record.  ``tables`` supplies extra
        resident sources (the store's own ``resident/`` dimension tables
        bind automatically).  ``report_sink`` (a dict) receives the run's
        timing/resume audit (``ChunkedReport`` fields).  See
        ``study/chunked.py`` for merge semantics and the chunk-unsafe op
        guard."""
        from repro_torch.study.chunked import ChunkedExecutor

        ex = ChunkedExecutor(store, engine=engine,
                             predicate_engine=predicate_engine,
                             checkpoint_dir=checkpoint_dir,
                             prefetch=prefetch, device=device,
                             **executor_kwargs)
        result = ex.run(self, tables=tables, log=log)
        if report_sink is not None:
            report_sink.update(ex.report.to_json())
        return result

    def _finish_result(self, plan: Plan, vals: Dict[int, Any],
                       join_stats: Dict[int, Dict[str, int]],
                       log: OperationLog, mesh=None) -> StudyResult:
        """Realize a StudyResult from executed node values: events from named
        table outputs, cohorts by replaying the algebra on wrapped operands,
        then the host ops (flow, featurize).  ``vals`` must cover
        ``executor.keep_ids(plan)`` — exactly what ``execute`` returns.

        Under a ``mesh`` the table values are ``ShardedTable``s: events stay
        as they are, and cohorts take their rank's block (patients are
        partitioned after the plan's exchanges, so the per-patient event
        filter of the algebra is right on a block).  A featurize needs the
        whole events: it gathers its cohort's, and its patients table, once."""
        nodes = plan.nodes

        def block(t):
            return t.block if mesh is not None and t is not None else t

        out_ids = plan.output_ids
        events = {name: vals[i] for name, i in out_ids.items()
                  if nodes[i].op in TABLE_OPS and i in vals}

        # realize cohorts by replaying the algebra on wrapped operands — the
        # thin eager layer keeps description/window/event semantics identical
        # to the interactive Cohort API.  A node can carry several names when
        # two cohort expressions hash-cons to the same sub-plan (aliases), so
        # names are grouped, never inverted into an id-keyed dict.
        names_by_id: Dict[int, List[str]] = {}
        for name, i in out_ids.items():
            if nodes[i].op in COHORT_OPS:
                names_by_id.setdefault(i, []).append(name)
        cohort_names = {i: ns[0] for i, ns in names_by_id.items()}
        realized: Dict[int, Cohort] = {}

        def _realize(i: int) -> Cohort:
            if i in realized:
                return realized[i]
            node = nodes[i]
            if node.op == "cohort_from_events":
                nm = node.get("name")
                ev = block(vals.get(node.inputs[0]))
                c = Cohort(name=nm, description=f"subjects with event {nm}",
                           subjects=vals[i], n_patients=self.n_patients,
                           events=ev, window=self._window)
            else:
                left = _realize(node.inputs[0])
                right = _realize(node.inputs[1])
                kind = node.get("kind")
                c = (left.intersection(right) if kind == "&"
                     else left.union(right) if kind == "|"
                     else left.difference(right))
            if i in cohort_names:
                c.name = cohort_names[i]
            realized[i] = c
            return c

        cohorts = {}
        for i, names in names_by_id.items():
            c = _realize(i)
            for name in names:
                cohorts[name] = (c if c.name == name
                                 else dataclasses.replace(c, name=name))

        flow = None
        if self._flow_names:
            fid = out_ids[_FLOW_OUT]
            flow = CohortFlow([_realize(j) for j in nodes[fid].inputs])
            prev = None
            for nm, stage in zip(self._flow_names, flow.steps):
                n = stage.subject_count()
                log.record(op=f"flow:{nm}",
                           inputs={} if prev is None else {"prev": _Count(prev)},
                           outputs={nm: _Count(n)}, params={})
                prev = n

        features: Dict[str, Any] = {}
        checks: Dict[str, Dict[str, int]] = {}
        for name in self._feature_names:
            fnode = nodes[out_ids[name]]
            cohort = _realize(fnode.inputs[0])
            pats = vals.get(fnode.inputs[1]) if len(fnode.inputs) > 1 else None
            if mesh is not None:
                from repro_torch.distributed.pipeline import gather_table

                if cohort.events is not None:
                    cohort = dataclasses.replace(
                        cohort, events=gather_table(cohort.events, mesh))
                pats = None if pats is None else pats.gather()
            fd = FeatureDriver(cohort, pats)
            kwargs = {k: v for k, v in (fnode.get("kwargs") or ())}
            if fnode.get("kind") == "dense":
                features[name] = fd.dense_features(**kwargs)
            else:
                features[name] = fd.token_sequences(**kwargs)
            checks[name] = dict(fd.checks)
            log.record(op=f"featurize:{name}",
                       inputs={cohort.name: _Count(cohort.subject_count())},
                       outputs={name: _Count(checks[name].get(
                           "events_total", 0))},
                       params={"kind": fnode.get("kind")})

        return StudyResult(events=events, cohorts=cohorts, flow=flow,
                           features=features, log=log, plan=plan,
                           feature_checks=checks, flatten_stats=join_stats)


class _Count:
    """Adapter giving OperationLog.record a ``.count`` to introspect."""

    def __init__(self, c: int) -> None:
        self.count = c


def flow_rows_from_log(log: OperationLog) -> List[Dict[str, object]]:
    """Rebuild the CohortFlow flowchart rows from an OperationLog alone —
    the paper's promise that flowcharts come from metadata, not re-execution."""
    rows: List[Dict[str, object]] = []
    prev: Optional[int] = None
    for e in log.entries:
        if not e["op"].startswith("flow:"):
            continue
        stage = e["op"][len("flow:"):]
        n = next(iter(e["outputs"].values()))
        rows.append({"stage": stage, "subjects": n,
                     "removed": (prev - n) if prev is not None else 0})
        prev = n
    return rows


def column_audit_from_log(log: OperationLog) -> List[Dict[str, object]]:
    """Per-stage column audit from an OperationLog alone: which columns each
    executed plan node *read* (``required_columns``, stamped by the
    optimizer's pruning pass) and which a pruned scan *dropped*
    (``pruned_columns``) — the paper's data-flow flowchart extended from row
    counts to column sets."""
    rows: List[Dict[str, object]] = []
    for e in log.entries:
        if not e["op"].startswith("plan:"):
            continue
        p = e["params"]
        if "required_columns" not in p and "pruned_columns" not in p:
            continue
        rows.append({
            "stage": e["op"][len("plan:"):],
            "rows_out": next(iter(e["outputs"].values())),
            "required_columns": p.get("required_columns"),
            "pruned_columns": p.get("pruned_columns"),
        })
    return rows
