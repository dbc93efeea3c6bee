"""Plan rewrites: shared scans, fused masks, deferred compaction, column
pruning through joins, join rewrites (capacity planning +
partitioning-awareness), DCE.

The passes encode the paper's three columnar properties (§3.4) at the *plan*
level instead of inside each extractor:

  * ``merge_projections`` — all extractors reading one source share a single
    scan + a single union projection, so a study makes ONE pass over DCIR
    instead of one per extractor.
  * ``fuse_masks`` — adjacent predicate / null-filter / value-filter nodes
    collapse into one ``fused_mask`` node, executed as a single vectorized
    Expr conjunction (one mask evaluation per extractor branch instead of
    one per step).
  * ``defer_compaction`` — compaction (the only materialization) is removed
    from plan interiors and appears exactly once per named table output.
  * ``prune_columns`` — join-aware dead-column elimination: every node's
    ``required_columns`` (Expr reads, join/exchange keys, conform/dedupe
    column sets, projections) is propagated *backwards* through
    lookup_join/expand_join/exchange into the star scans, and scans are
    narrowed so unused dimension columns never enter the flatten join chain.
  * ``plan_capacities`` — join capacity planning from table statistics,
    host-side (as Spark sizes shuffle partitions from statistics): exact output
    sizes for ``expand_join``/``slice_time`` nodes, replacing trace-time
    slack heuristics.
  * ``eliminate_joins`` — a ``lookup_join`` whose right side was pruned to
    the bare join key adds no columns and drops no left rows; it degrades to
    an audit-only ``key_count`` node (the no-loss stats survive as a cheap
    key-membership count).
  * ``prune_exchanges`` — partitioning-awareness (Spark's
    EnsureRequirements): an exchange whose input is already hash-partitioned
    on its key is dropped; off-mesh every exchange drops.
  * ``dce`` — drops nodes unreachable from any output (rewrites above strand
    the per-extractor projections).

All passes are pure ``Plan -> Plan`` functions (``plan_capacities`` also
reads concrete tables); ``optimize`` is the default pipeline used by the
executor.  This is the port of ``repro.study.optimizer``, pass for pass with
``OPTIMIZER_VERSION`` unchanged; ``assign_engines`` stamps the port's engine
names (``torch``/``cuda``, see ``kernels.ENGINE_NAMES``).
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Mapping, Optional, Set, Tuple

import numpy as np

from repro_torch.core.columnar import NULL_INT
from repro_torch.kernels import predicate as _pk
from repro_torch.study import expr as _expr
from repro_torch.study.plan import (JOIN_OPS, MASK_OPS, PREDICATE_OPS, Node,
                                    Plan, PlanBuilder)

__all__ = ["optimize", "merge_projections", "fuse_masks", "defer_compaction",
           "prune_columns", "eliminate_joins", "plan_capacities",
           "prune_exchanges", "dce", "assign_engines", "available_columns",
           "required_columns", "join_right_cols", "OPTIMIZER_VERSION"]

# Bumped whenever a pass changes what an optimized plan *means* for a given
# builder-level study.  Cross-run caches keyed on optimized-plan content
# (the service's subgraph result cache, normalization goldens) salt their
# keys with this so stale entries die with the rewrite that produced them.
OPTIMIZER_VERSION = 1

# selects hanging off any of these get merged into one union projection
_MERGE_UPSTREAM = frozenset({
    "scan", "scan_star", "lookup_join", "expand_join", "exchange",
    "slice_time", "compact", "concat", "key_count",
})


def _rebuild(plan: Plan, replace: Dict[int, Node], drop: Optional[set] = None,
             redirect: Optional[Dict[int, int]] = None) -> Plan:
    """Re-emit ``plan`` through a fresh builder with node rewrites applied.

    ``replace`` swaps a node's definition; ``redirect`` makes consumers (and
    outputs) read another old node's value instead; ``drop`` marks old ids
    whose definition must not be re-emitted (their redirect target is used).
    Hash-consing in the builder re-deduplicates rewritten nodes.
    """
    drop = drop or set()
    redirect = redirect or {}
    b = PlanBuilder()
    new_id: Dict[int, int] = {}

    def resolve(old: int) -> int:
        seen = set()
        while old in redirect:
            if old in seen:
                raise ValueError("cyclic redirect in plan rewrite")
            seen.add(old)
            old = redirect[old]
        return new_id[old]

    for i, node in enumerate(plan.nodes):
        if i in drop or i in redirect:
            continue
        n = replace.get(i, node)
        inputs = tuple(resolve(j) for j in n.inputs)
        new_id[i] = b.add(n.op, inputs, **dict(n.params))
    for name, i in plan.outputs:
        b.set_output(name, resolve(i))
    return b.build()


# ---------------------------------------------------------------------------
def merge_projections(plan: Plan) -> Plan:
    """One shared projection per source (or per flattened table): the union
    of every consumer's column set.  (Scan nodes themselves already unify by
    hash-consing; this pass merges the per-extractor ``select`` nodes hanging
    off them.)  Selects that are themselves named outputs keep their exact
    column set — widening them would change the output schema."""
    out_ids = {i for _, i in plan.outputs}
    selects_by_scan: Dict[int, List[int]] = {}
    for i, n in enumerate(plan.nodes):
        if (n.op == "select" and i not in out_ids
                and plan.nodes[n.inputs[0]].op in _MERGE_UPSTREAM):
            selects_by_scan.setdefault(n.inputs[0], []).append(i)

    replace: Dict[int, Node] = {}
    redirect: Dict[int, int] = {}
    for scan_id, sel_ids in selects_by_scan.items():
        if len(sel_ids) < 2:
            continue
        union = sorted({c for i in sel_ids for c in plan.nodes[i].get("cols")})
        keep = sel_ids[0]
        replace[keep] = Node("select", (scan_id,), (("cols", tuple(union)),))
        for i in sel_ids[1:]:
            redirect[i] = keep
    if not (replace or redirect):
        return plan
    return _rebuild(plan, replace, redirect=redirect)


# ---------------------------------------------------------------------------
def _mask_params(node: Node) -> Tuple[Tuple[str, ...], Tuple, Tuple]:
    """(null_cols, value_filters, exprs) contribution of one mask-op node."""
    if node.op == "drop_nulls":
        return tuple(node.get("cols")), (), ()
    if node.op == "value_filter":
        return (), ((node.get("col"), node.get("codes")),), ()
    if node.op == "predicate":
        return (), (), (node.get("expr"),)
    if node.op == "fused_mask":
        return (tuple(node.get("null_cols")), tuple(node.get("filters")),
                tuple(node.get("exprs") or ()))
    raise AssertionError(node.op)


def fuse_masks(plan: Plan) -> Plan:
    """Collapse chains of mask-only nodes into single ``fused_mask`` nodes.

    Every predicate/drop_nulls/value_filter is first normalized to a
    fused_mask; then a fused_mask whose (sole-consumer) input is another
    fused_mask absorbs it.  Runs to fixpoint, so arbitrarily long mask
    chains become one node, executed as a single Expr conjunction (see
    ``expr.fused_predicate``).
    """
    # normalize
    replace = {}
    for i, n in enumerate(plan.nodes):
        if n.op in MASK_OPS:
            nulls, filters, exprs = _mask_params(n)
            replace[i] = Node("fused_mask", n.inputs,
                              (("exprs", exprs), ("filters", filters),
                               ("null_cols", nulls)))
    plan = _rebuild(plan, replace)

    while True:
        consumers = plan.consumers()
        out_ids = {i for _, i in plan.outputs}
        redirect: Dict[int, int] = {}
        replace = {}
        for i, n in enumerate(plan.nodes):
            if n.op != "fused_mask":
                continue
            j = n.inputs[0]
            up = plan.nodes[j]
            if (up.op != "fused_mask" or len(consumers[j]) != 1
                    or j in replace or j in out_ids):
                continue
            u_nulls, u_filters, u_exprs = _mask_params(up)
            n_nulls, n_filters, n_exprs = _mask_params(n)
            nulls = u_nulls + tuple(c for c in n_nulls if c not in u_nulls)
            replace[i] = Node("fused_mask", up.inputs,
                              (("exprs", u_exprs + n_exprs),
                               ("filters", u_filters + n_filters),
                               ("null_cols", nulls)))
            redirect[j] = i  # j had only this consumer; drop its definition
        if not replace:
            return plan
        # re-emit: replaced nodes take their new def; absorbed nodes vanish.
        b = PlanBuilder()
        new_id: Dict[int, int] = {}
        absorbed = set(redirect)
        for i, node in enumerate(plan.nodes):
            if i in absorbed:
                continue
            n = replace.get(i, node)
            inputs = tuple(new_id[j] for j in n.inputs)
            new_id[i] = b.add(n.op, inputs, **dict(n.params))
        for name, i in plan.outputs:
            b.set_output(name, new_id[i])
        plan = b.build()


# ---------------------------------------------------------------------------
def defer_compaction(plan: Plan) -> Plan:
    """Exactly one materialization per table output.

    Interior compact nodes (anything downstream still reads them) are
    bypassed — masks and event conformance operate on uncompacted tables for
    free — and every named table output gets a final compact if it lacks one.
    """
    out_ids = {i for _, i in plan.outputs}
    consumers = plan.consumers()
    redirect: Dict[int, int] = {}
    for i, n in enumerate(plan.nodes):
        if n.op == "compact" and consumers[i] and i not in out_ids:
            redirect[i] = n.inputs[0]
    if redirect:
        plan = _rebuild(plan, {}, redirect=redirect)

    # append a compact to table outputs that end uncompacted
    b = PlanBuilder()
    new_id: Dict[int, int] = {}
    for i, n in enumerate(plan.nodes):
        new_id[i] = b.add(n.op, tuple(new_id[j] for j in n.inputs), **dict(n.params))
    from repro_torch.study.plan import TABLE_OPS
    for name, i in plan.outputs:
        n = plan.nodes[i]
        if n.op in TABLE_OPS and n.op not in ("compact", "transform"):
            b.set_output(name, b.compact(new_id[i]))
        else:
            b.set_output(name, new_id[i])
    return b.build()


# ---------------------------------------------------------------------------
# row-preserving ops through which hash partitioning survives (masks don't
# move rows between shards; joins keep left rows on their shard)
_PART_PRESERVING = frozenset({
    "select", "predicate", "drop_nulls", "value_filter", "fused_mask",
    "dedupe", "conform_events", "compact", "slice_time", "lookup_join",
    "expand_join", "key_count",
})


def prune_exchanges(plan: Plan, n_shards: int = 1) -> Plan:
    """Partitioning-awareness (Spark's EnsureRequirements, lifted out of
    ``distributed_flatten``'s hand-rolled ``flat_pkey`` loop): drop an
    exchange whose input is already hash-partitioned on its key —
    re-exchanging would funnel every local row to one destination bucket.
    With ``n_shards <= 1`` every exchange is the identity and all drop.
    """
    part: Dict[int, Optional[str]] = {}
    redirect: Dict[int, int] = {}
    for i, n in enumerate(plan.nodes):
        if n.op == "scan_star":
            part[i] = n.get("partitioned_on")
        elif n.op == "exchange":
            upstream = part.get(n.inputs[0])
            if n_shards <= 1 or upstream == n.get("key"):
                redirect[i] = n.inputs[0]
                part[i] = upstream
            else:
                part[i] = n.get("key")
        elif n.op in _PART_PRESERVING and n.inputs:
            part[i] = part.get(n.inputs[0])
        else:
            part[i] = None
    if not redirect:
        return plan
    return _rebuild(plan, {}, redirect=redirect)


# ---------------------------------------------------------------------------
# column pruning through joins (the ROADMAP "join-aware DCE of flat columns")
# ---------------------------------------------------------------------------
# the standardized Event layout produced by conform_events (schema.FLAT_EVENT_
# SCHEMA) — conform is a schema boundary, so requirements never propagate
# through it
_EVENT_COLS = frozenset({"patient_id", "category", "group_id", "value",
                         "weight", "start", "end"})
# ops whose output carries exactly their (single) input's column set
_COLS_PRESERVING = frozenset({
    "predicate", "drop_nulls", "value_filter", "fused_mask", "dedupe",
    "compact", "exchange", "slice_time",
})


def join_right_cols(node: Node, right_avail: FrozenSet[str]) -> Dict[str, str]:
    """{output column name: right column name} contributed by a join's right
    side (the right key folds into the left side and never surfaces).

    Shared with ``study/analyze.py``: the static analyzer's schema inference
    must agree with the pruner's view of join output columns."""
    prefix = node.get("prefix") or ""
    rk = node.get("right_key")
    return {prefix + c: c for c in right_avail if c != rk}


_join_right_cols = join_right_cols  # internal alias (pre-analyzer name)


def available_columns(plan: Plan) -> Dict[int, Optional[FrozenSet[str]]]:
    """Forward dataflow: the column set each table node produces, where it is
    statically known (``None`` = unknown).  ``scan_star`` nodes learn their
    schema from the ``columns`` param ``contribute_flatten`` stamps."""
    avail: Dict[int, Optional[FrozenSet[str]]] = {}
    for i, n in enumerate(plan.nodes):
        if n.op == "scan_star" and n.get("columns") is not None:
            avail[i] = frozenset(n.get("columns"))
        elif n.op == "select":
            avail[i] = frozenset(n.get("cols"))
        elif n.op == "conform_events":
            avail[i] = _EVENT_COLS
        elif n.op in _COLS_PRESERVING and n.inputs:
            avail[i] = avail.get(n.inputs[0])
        elif n.op == "key_count":        # value = the left table unchanged
            avail[i] = avail.get(n.inputs[0])
        elif n.op in JOIN_OPS:
            la, ra = avail.get(n.inputs[0]), avail.get(n.inputs[1])
            avail[i] = (None if la is None or ra is None
                        else la | frozenset(_join_right_cols(n, ra)))
        elif n.op == "concat":
            ins = [avail.get(j) for j in n.inputs]
            avail[i] = ins[0] if ins and all(a == ins[0] for a in ins) else None
        else:
            avail[i] = None
    return avail


def required_columns(plan: Plan) -> Dict[int, Optional[FrozenSet[str]]]:
    """Backward dataflow: the columns each table node must *provide* —
    the union over its consumers of what they read (Expr columns, join and
    exchange keys, conform/dedupe column sets, projections).  ``None`` means
    "everything" (named outputs keep their full schema; opaque transforms
    and exported event tables pin their inputs)."""
    avail = available_columns(plan)
    req: Dict[int, Optional[Set[str]]] = {}

    def _push(j: int, cols: Optional[Set[str]]) -> None:
        if cols is None:
            req[j] = None
        elif req.get(j, set()) is not None:
            req[j] = req.get(j, set()) | set(cols)

    for _, i in plan.outputs:
        req[i] = None  # an output's schema is part of the study contract
    for i in range(len(plan.nodes) - 1, -1, -1):
        n = plan.nodes[i]
        r = req.get(i, set())
        if n.op in ("scan", "scan_star"):
            continue
        if n.op == "select":
            # the projection itself declares what it reads; narrowing it
            # would change its (possibly output-visible) schema
            _push(n.inputs[0], set(n.get("cols")))
        elif n.op in ("predicate", "drop_nulls", "value_filter", "fused_mask"):
            e = _expr.node_predicate(n)
            own = set() if e is None else set(e.required_columns())
            _push(n.inputs[0], None if r is None else r | own)
        elif n.op == "dedupe":
            _push(n.inputs[0], None if r is None else r | set(n.get("keys")))
        elif n.op == "compact":
            _push(n.inputs[0], r)
        elif n.op == "exchange":
            _push(n.inputs[0], None if r is None else r | {n.get("key")})
        elif n.op == "slice_time":
            _push(n.inputs[0], None if r is None else r | {n.get("col")})
        elif n.op == "conform_events":
            need = {"patient_id", n.get("value_col"), n.get("start_col")}
            need |= {c for c in (n.get("end_col"), n.get("group_col"),
                                 n.get("weight_col")) if c}
            _push(n.inputs[0], need)
        elif n.op == "concat":
            for j in n.inputs:
                _push(j, r)
        elif n.op == "key_count":
            _push(n.inputs[0],
                  None if r is None else r | {n.get("left_key")})
            _push(n.inputs[1], {n.get("right_key")})
        elif n.op in JOIN_OPS:
            l_in, r_in = n.inputs
            ra = avail.get(r_in)
            if r is None or ra is None:
                _push(l_in, None)
                _push(r_in, None)
                continue
            right_named = _join_right_cols(n, ra)
            from_right = {right_named[c] for c in r if c in right_named}
            _push(r_in, from_right | {n.get("right_key")})
            _push(l_in, {c for c in r if c not in right_named}
                  | {n.get("left_key")})
        elif n.op == "transform":
            for j in n.inputs:
                _push(j, None)  # registered fns are opaque: keep everything
        elif n.op == "cohort_from_events":
            # the event table leaves the program as Cohort.events — full schema
            _push(n.inputs[0], None)
        elif n.op == "featurize":
            if len(n.inputs) > 1:
                _push(n.inputs[1], None)  # the patients table is host-visible
        # cohort_op / flow consume bitsets, not tables
    return {i: (None if c is None else frozenset(c))
            for i, c in req.items()}


# nodes worth stamping with their required-column set for the OperationLog
# audit (the paper's "what did each stage read" data-flow story)
_AUDIT_OPS = frozenset({"lookup_join", "expand_join", "exchange",
                        "slice_time", "scan_star"})


def prune_columns(plan: Plan) -> Plan:
    """Join-aware column pruning: narrow every statically-known scan to the
    columns some consumer actually reads.

    The union projection of all extractors/featurize/conform consumers is
    propagated backwards through ``lookup_join``/``expand_join``/``exchange``
    into the star scans (``required_columns``); each prunable ``scan_star``
    gets a ``select`` of only the required columns inserted directly above
    it, so unused dimension columns are dropped before the flatten join
    chain ever materializes them.  Audited nodes are stamped with
    ``required_columns`` (and pruning selects with ``pruned_columns``) so
    the OperationLog records what each stage read.
    """
    avail = available_columns(plan)
    req = required_columns(plan)

    prune: Dict[int, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {}
    for i, n in enumerate(plan.nodes):
        if n.op != "scan_star" or avail.get(i) is None:
            continue
        r = req.get(i, frozenset())
        if r is None:
            continue
        keep = r & avail[i]
        if keep and keep < avail[i]:
            prune[i] = (tuple(sorted(keep)), tuple(sorted(avail[i] - keep)))
    if not prune and not any(
            n.op in _AUDIT_OPS and req.get(i) is not None
            for i, n in enumerate(plan.nodes)):
        return plan

    b = PlanBuilder()
    new_id: Dict[int, int] = {}
    for i, n in enumerate(plan.nodes):
        params = dict(n.params)
        if n.op in _AUDIT_OPS and req.get(i) is not None:
            params["required_columns"] = tuple(sorted(req[i]))
        nid = b.add(n.op, tuple(new_id[j] for j in n.inputs), **params)
        if i in prune:
            keep, dropped = prune[i]
            nid = b.add("select", (nid,), cols=keep, pruned_columns=dropped)
        new_id[i] = nid
    for name, i in plan.outputs:
        b.set_output(name, new_id[i])
    return b.build()


# ---------------------------------------------------------------------------
def eliminate_joins(plan: Plan) -> Plan:
    """Join elimination on pruned N:1 joins (the ROADMAP item).

    Column pruning can narrow a ``lookup_join``'s right side to the bare
    join key; such a join contributes no output column and — N:1 left-join
    semantics — never drops a left row, so the join itself is dead.  The
    node degrades to an audit-only ``key_count``: the left table passes
    through unchanged (no sort-gather of right attributes), while the
    paper's no-loss audit survives as a cheap key-membership count
    (matched / null_keys FlatteningStats against the pruned-to-key right
    side).  Runs after ``prune_columns`` so the stamped
    ``required_columns`` audit fields carry over.
    """
    avail = available_columns(plan)
    req = required_columns(plan)
    replace: Dict[int, Node] = {}
    for i, n in enumerate(plan.nodes):
        if n.op != "lookup_join":
            continue
        r, ra = req.get(i, frozenset()), avail.get(n.inputs[1])
        if r is None or ra is None:
            continue
        right_named = _join_right_cols(n, ra)
        if any(c in right_named for c in r):
            continue
        params = {"left_key": n.get("left_key"),
                  "right_key": n.get("right_key"),
                  "name": f"[{n.get('left_key')}]"}
        if n.get("required_columns") is not None:
            params["required_columns"] = n.get("required_columns")
        replace[i] = Node("key_count", n.inputs, tuple(sorted(params.items())))
    if not replace:
        return plan
    return _rebuild(plan, replace)


# ---------------------------------------------------------------------------
def _np_null_mask(a: np.ndarray) -> np.ndarray:
    """Host-side mirror of ``columnar.is_null`` (same sentinel source)."""
    if np.issubdtype(a.dtype, np.floating):
        return np.isnan(a)
    return a == int(NULL_INT)


def _round_up(n: int, quantum: int) -> int:
    return -(-max(n, 1) // quantum) * quantum


def plan_capacities(plan: Plan, tables: Mapping, round_to: int = 64,
                    ops: Tuple[str, ...] = ("expand_join", "slice_time")
                    ) -> Plan:
    """Capacity planning from table statistics, host-side.

    Replaces the ad-hoc ``expand_slack`` guesses: the plan's join-key columns
    are simulated through the node graph with numpy (as Spark derives
    shuffle sizes from table statistics), giving the
    *exact* output row count of every ``expand_join`` and ``slice_time``
    node, which is rounded up to ``round_to`` (runner-cache stability) and
    written into the node's ``capacity`` param.  ``ops`` restricts which node
    kinds get a capacity stamped (the simulation always runs in full).
    Nodes already carrying an explicit capacity, or whose inputs cannot be
    resolved to concrete tables, are left to the executor's trace-time
    heuristics.
    """
    if not any(n.op in ops and n.get("capacity") is None for n in plan.nodes):
        return plan  # nothing consumes table statistics — skip the sim
    needed = set()
    for n in plan.nodes:
        if n.op in JOIN_OPS:
            needed.add(n.get("left_key"))
            needed.add(n.get("right_key"))
        elif n.op == "slice_time":
            needed.add(n.get("col"))

    sim: Dict[int, Optional[Dict[str, np.ndarray]]] = {}
    replace: Dict[int, Node] = {}

    def _with_capacity(n: Node, cap: int) -> Node:
        p = dict(n.params)
        p["capacity"] = int(cap)
        return Node(n.op, n.inputs, tuple(sorted(p.items())))

    for i, n in enumerate(plan.nodes):
        if n.op in ("scan", "scan_star"):
            t = tables.get(n.get("source"))
            if t is None:
                sim[i] = None
                continue
            valid = t.valid_numpy()
            sim[i] = {c: t.columns[c].cpu().numpy()[valid]
                      for c in needed if c in t.columns}
        elif n.op == "select":
            up = sim.get(n.inputs[0])
            sim[i] = (None if up is None else
                      {c: v for c, v in up.items() if c in n.get("cols")})
        elif n.op in ("compact", "exchange", "lookup_join", "key_count"):
            # row-multiset preserved (lookup_join: N:1 keeps left rows; the
            # gained right attributes are not join keys in a star schema)
            sim[i] = sim.get(n.inputs[0])
        elif n.op == "slice_time":
            up = sim.get(n.inputs[0])
            col = n.get("col")
            if up is None or col not in up:
                sim[i] = None
                continue
            m = (up[col] >= n.get("lo")) & (up[col] < n.get("hi"))
            if n.op in ops and n.get("capacity") is None:
                replace[i] = _with_capacity(n, _round_up(int(m.sum()),
                                                         round_to))
            sim[i] = {c: v[m] for c, v in up.items()}
        elif n.op == "expand_join":
            left = sim.get(n.inputs[0])
            right = sim.get(n.inputs[1])
            lk_name, rk_name = n.get("left_key"), n.get("right_key")
            if left is None or right is None or lk_name not in left \
                    or rk_name not in right:
                sim[i] = None
                continue
            lk = left[lk_name]
            rk = right[rk_name]
            rs = np.sort(rk[~_np_null_mask(rk)])
            cnt = (np.searchsorted(rs, lk, side="right")
                   - np.searchsorted(rs, lk, side="left"))
            cnt[_np_null_mask(lk)] = 0
            reps = np.maximum(cnt, 1)
            if n.op in ops and n.get("capacity") is None:
                replace[i] = _with_capacity(n, _round_up(int(reps.sum()),
                                                         round_to))
            sim[i] = {c: np.repeat(v, reps) for c, v in left.items()}
        else:
            sim[i] = None
    if not replace:
        return plan
    return _rebuild(plan, replace)


# ---------------------------------------------------------------------------
def assign_engines(plan: Plan, predicate_engine: str = "auto",
                   engine: str = "torch",
                   block: Optional[int] = None, device=None) -> Plan:
    """Stamp every predicate-evaluating node with its chosen engine and, for
    the CUDA kernel path, the bitset layout (block quantum + word dtype).

    The stamp is what the executor obeys (run-level ``predicate_engine`` is
    only the fallback for un-stamped plans), and because node params flow
    into ``record_plan`` verbatim, the ``OperationLog`` audit records *which*
    engine and layout each mask pass actually used — the same legibility
    story as ``required_columns``/``pruned_columns``.  Exprs whose root is
    not boolean-valued (not kernel-compilable) are stamped ``torch``.
    ``device`` (where the data lies) lets ``"auto"`` resolve.
    """
    resolved = _pk.resolve_engine(predicate_engine, engine, device)
    block = int(block or _pk.DEFAULT_BLOCK)
    replace: Dict[int, Node] = {}
    for i, n in enumerate(plan.nodes):
        if n.op not in PREDICATE_OPS and n.op != "compact":
            continue
        p = dict(n.params)
        # table validity is the packed-word bitset end-to-end; the stamp
        # pins the layout in plan goldens and the OperationLog audit
        p["valid_layout"] = "bitset_u32"
        if n.op in PREDICATE_OPS:
            e = _expr.node_predicate(n)
            eng = resolved
            if eng == "cuda" and (e is None
                                  or not _pk.compilable(e.to_param())):
                eng = "torch"
            p["engine"] = eng
            if eng == "cuda":
                p["bitset_block"] = block
                p["bitset_word"] = "uint32"
            else:
                p.pop("bitset_block", None)
                p.pop("bitset_word", None)
        node = Node(n.op, n.inputs, tuple(sorted(p.items())))
        if node != n:
            replace[i] = node
    if not replace:
        return plan
    return _rebuild(plan, replace)


# ---------------------------------------------------------------------------
def dce(plan: Plan) -> Plan:
    """Drop nodes unreachable from any named output."""
    live = set()
    stack = [i for _, i in plan.outputs]
    while stack:
        i = stack.pop()
        if i in live:
            continue
        live.add(i)
        stack.extend(plan.nodes[i].inputs)
    if len(live) == len(plan.nodes):
        return plan
    b = PlanBuilder()
    new_id: Dict[int, int] = {}
    for i, n in enumerate(plan.nodes):
        if i not in live:
            continue
        new_id[i] = b.add(n.op, tuple(new_id[j] for j in n.inputs), **dict(n.params))
    for name, i in plan.outputs:
        b.set_output(name, new_id[i])
    return b.build()


# ---------------------------------------------------------------------------
def optimize(plan: Plan, tables: Optional[Mapping] = None,
             n_shards: int = 1, prune_cols: bool = True,
             predicate_engine: str = "auto", engine: str = "torch",
             device=None) -> Plan:
    """Default rewrite pipeline (executor calls this unless told not to).

    ``tables`` (concrete run-time tables) enables host-side capacity
    planning; ``n_shards`` informs exchange pruning (off-mesh, every exchange
    is the identity and drops); ``prune_cols=False`` disables join-aware
    column pruning (the benchmark baseline); ``predicate_engine``/``engine``
    feed the engine-assignment pass that stamps predicate nodes with their
    evaluation engine + bitset layout; ``device`` (where the data lies)
    lets ``"auto"`` resolve.
    """
    plan = merge_projections(plan)
    plan = fuse_masks(plan)
    plan = defer_compaction(plan)
    plan = prune_exchanges(plan, n_shards=n_shards)
    if prune_cols:
        plan = prune_columns(plan)
        plan = eliminate_joins(plan)
    plan = assign_engines(plan, predicate_engine=predicate_engine,
                          engine=engine, device=device)
    if tables:
        # The planner's exact sizes are GLOBAL row counts.  Sharded, each
        # shard would allocate that full size, so sharded expand_joins
        # keep the executor's per-shard slack heuristic (see ROADMAP);
        # slice_time is still planned there — a global slice count is a sound
        # per-shard bound (the executor's shrink is a no-op when the local
        # capacity is already smaller) and slice_time has no slack
        # fallback at all.
        ops = (("expand_join", "slice_time") if n_shards <= 1
               else ("slice_time",))
        plan = plan_capacities(plan, tables, ops=ops)
    return dce(plan)
