"""Plan executor: one cached runner per (plan, n_patients, engines).

The port of ``repro.study.executor``.  The executor walks a (usually
optimizer-rewritten) ``Plan`` and evaluates each node eagerly with torch
ops — scans, joins, masks, dedupe, event conformance, compaction, cohort
bitset algebra, registered transformers; host-side nodes (``featurize``,
``flow``) run after, in the Study layer.

Engines (``kernels.ENGINE_NAMES``): ``engine="torch"`` compacts by gather
and combines cohorts with tensor ops; ``engine="cuda"`` runs the compaction
kernel, the segmented-scan kernel inside ``exposures``, and the bitset
kernel once for each group of ``cohort_op`` nodes joined by ``cohort_op``
edges (a whole cohort expression), whose counts are the nodes' counts.
Predicate nodes follow their stamped engine (or the run-level
``predicate_engine``): ``"torch"`` mask algebra or the ``"cuda"``
Expr->bitset kernel.  A ``cuda`` engine on CPU tensors runs each kernel's
plain version, which is how the tests here hold it against the reference.

PyTorch runs eagerly, so there is nothing to jit: ``cached_executable`` keeps
the reference's cache key and its compile/hit counting over the port's plan
runner.  Per-node counts and stats leave as one stacked tensor each, read
back once in ``execute``; the body waits for the device only where
``fractures`` reads its frontier's size, once per link of its longest
washout chain.
"""
from __future__ import annotations

import inspect
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import bitset as _bs
from repro_torch.core import flattening as _fl
from repro_torch.core import transformers as _tr
from repro_torch.core.cohort import Bitset
from repro_torch.core.columnar import ColumnarTable, is_null, max_key
from repro_torch.core.events import make_events
from repro_torch.core.metadata import OperationLog
from repro_torch.kernels import ENGINES
from repro_torch.kernels import predicate as _pk
from repro_torch.study import expr as _expr
from repro_torch.study.plan import (COHORT_OPS, PREDICATE_OPS, Plan, STATS_OPS,
                                    TABLE_OPS)

__all__ = ["execute", "TRANSFORMS", "jit_cache_info", "clear_jit_cache",
           "cached_executable", "run_plan_body", "record_plan", "keep_ids",
           "traced_ids"]

# Registered transformer free functions usable from ``transform`` nodes.
# Values are (fn, wants_n_patients); params must stay hashable in the plan.
def _registry() -> Dict[str, Tuple[Callable, bool]]:
    fns = {}
    for name in ("observation_period", "follow_up", "trackloss", "exposures",
                 "fractures", "drug_prescriptions", "drug_interactions",
                 "bladder_cancer", "infarctus", "heart_failure"):
        fn = getattr(_tr, name)
        wants = "n_patients" in inspect.signature(fn).parameters
        fns[name] = (fn, wants)
    return fns


TRANSFORMS = _registry()
# transforms that take the executor's engine as a keyword (never a plan
# param, so optimized plans stay node-for-node equal to the reference's)
_ENGINE_TRANSFORMS = frozenset(
    name for name, (fn, _) in TRANSFORMS.items()
    if "engine" in inspect.signature(fn).parameters)

_JIT_CACHE: Dict[Tuple, Callable] = {}
_JIT_STATS: Dict[str, int] = {"compiles": 0, "hits": 0}
_JIT_LOCK = threading.Lock()


def jit_cache_info() -> Dict[str, int]:
    """Cache-surface audit: ``plans`` (live entries), ``compiles`` (runners
    built) and ``hits`` (lookups served by an existing entry).  Counters
    reset with ``clear_jit_cache``."""
    with _JIT_LOCK:
        return {"plans": len(_JIT_CACHE), **_JIT_STATS}


def clear_jit_cache() -> None:
    with _JIT_LOCK:
        _JIT_CACHE.clear()
        _JIT_STATS["compiles"] = 0
        _JIT_STATS["hits"] = 0


def cached_executable(key: Tuple, build: Callable[[], Callable]) -> Callable:
    """The process-wide runner cache: ``build`` runs once per distinct
    ``key``; later lookups count as hits."""
    with _JIT_LOCK:
        fn = _JIT_CACHE.get(key)
        if fn is None:
            _JIT_STATS["compiles"] += 1
            fn = _JIT_CACHE[key] = build()
        else:
            _JIT_STATS["hits"] += 1
        return fn


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")


# ---------------------------------------------------------------------------
# node evaluation
# ---------------------------------------------------------------------------
def _compact_table(t: ColumnarTable, engine: str) -> ColumnarTable:
    if engine == "torch":
        return t.compact()
    _check_engine(engine)
    from repro_torch.kernels import ops as kops

    if t.capacity == 0:
        return t
    # every column in one pass, the packed keep-mask straight in
    cols, count = kops.filter_compact_table(t.columns, t.valid)
    return ColumnarTable(cols, _bs.first_n(count, t.capacity), count,
                         t.capacity)


def _stats_dict(fs) -> Dict[str, torch.Tensor]:
    return {k: getattr(fs, k) for k in _fl.STAT_FIELDS}


def _key_checksum(t: ColumnarTable, key: str) -> torch.Tensor:
    return _fl.key_checksum(t.columns[key], t.valid_bool())


def _eval_node(node, ins, env: Dict[str, ColumnarTable], n_patients: int,
               engine: str, n_shards: int = 1,
               predicate_engine: str = "torch", group=None):
    op = node.op
    if op in ("scan", "scan_star"):
        src = node.get("source")
        if src not in env:
            raise KeyError(f"plan scans source {src!r} but run() got "
                           f"{sorted(env)}")
        return env[src]
    if op == "lookup_join":
        out, fs = _fl.lookup_join(ins[0], ins[1], node.get("left_key"),
                                  node.get("right_key"),
                                  prefix=node.get("prefix") or "")
        return out, _stats_dict(fs)
    if op == "expand_join":
        cap = node.get("capacity")
        if cap is None:
            # fallback when the host-side capacity planner did not run
            cap = int((ins[0].capacity + ins[1].capacity)
                      * (node.get("slack") or 1.5))
        out, fs = _fl.expand_join(ins[0], ins[1], node.get("left_key"),
                                  node.get("right_key"), cap,
                                  prefix=node.get("prefix") or "")
        return out, _stats_dict(fs)
    if op == "exchange":
        t = ins[0]
        key = node.get("key")
        ksum_in = _key_checksum(t, key)
        zero = torch.zeros((), dtype=torch.int32, device=t.device)
        if group is None or n_shards <= 1:
            # off-mesh (or single shard): the shuffle is the identity; the
            # process group, not axis_name, says whether there is a mesh
            return t, {"rows_in": t.count, "rows_out": t.count,
                       "matched": t.count, "overflow": zero,
                       "null_keys": zero, "key_sum_in": ksum_in,
                       "key_sum_out": ksum_in}
        per = node.get("per_dest_capacity")
        if per is None:
            per = max(int(node.get("min_per_dest") or 64),
                      int(t.capacity * (node.get("slack") or 2.0) / n_shards))
        out, overflow = _fl.exchange(t, key, group, n_shards, per,
                                     engine=engine)
        return out, {"rows_in": t.count, "rows_out": out.count,
                     "matched": out.count, "overflow": overflow,
                     "null_keys": zero, "key_sum_in": ksum_in,
                     "key_sum_out": _key_checksum(out, key)}
    if op == "slice_time":
        t = ins[0]
        out = t.filter(_expr.node_predicate(node).evaluate(t))
        n_sel = out.count
        ksum_in = _key_checksum(out, node.get("col"))
        cap = node.get("capacity")
        overflow = torch.zeros((), dtype=torch.int32, device=t.device)
        if cap is not None and cap < t.capacity:
            out = _compact_table(out, engine).shrink_to(cap)
            overflow = torch.clamp(n_sel - cap, min=0).to(torch.int32)
        return out, {"rows_in": t.count, "rows_out": out.count,
                     "matched": n_sel, "overflow": overflow,
                     "null_keys": torch.zeros((), dtype=torch.int32,
                                              device=t.device),
                     "key_sum_in": ksum_in,
                     "key_sum_out": _key_checksum(out, node.get("col"))}
    if op == "key_count":
        # an eliminated (column-pruned) lookup_join: the value is the LEFT
        # table unchanged; the join's no-loss audit survives as a cheap
        # key-membership count over the (pruned-to-key) right side
        left, right = ins
        dev = left.device
        lk = left.columns[node.get("left_key")]
        lvb = left.valid_bool()
        l_null = is_null(lk) & lvb
        rk_col = right.columns[node.get("right_key")]
        rvb = right.valid_bool()
        r_null = is_null(rk_col) & rvb
        if right.capacity == 0:
            found = torch.zeros((left.capacity,), dtype=torch.bool,
                                device=dev)
        else:
            r_ok = rvb & ~is_null(rk_col)
            rk = torch.where(r_ok, rk_col, max_key(rk_col.dtype))
            order = torch.argsort(rk, stable=True)
            rs = rk[order].contiguous()
            pos = torch.searchsorted(rs, lk, side="left")
            posc = torch.clamp(pos, 0, right.capacity - 1)
            found = ((pos < right.capacity) & (rs[posc] == lk)
                     & r_ok[order][posc] & lvb & ~is_null(lk))
        ksum = _fl.key_checksum(lk, lvb)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return left, {"rows_in": left.count, "rows_out": left.count,
                      "matched": found.sum().to(torch.int32),
                      "overflow": zero,
                      "null_keys": (l_null.sum() + r_null.sum()
                                    ).to(torch.int32),
                      "key_sum_in": ksum, "key_sum_out": ksum}
    if op == "select":
        return ins[0].select(list(node.get("cols")))
    if op in PREDICATE_OPS:
        # every predicate-ish op re-expresses as an Expr; the node's stamped
        # engine — or the run-level predicate engine — picks torch mask
        # algebra or the CUDA Expr->bitset kernel
        t = ins[0]
        e = _expr.node_predicate(node)
        if e is None:
            return t
        eng = node.get("engine") or predicate_engine
        param = e.to_param()
        if eng == "cuda" and _pk.compilable(param):
            words, cnt = _pk.predicate_bitset(
                t.columns, t.valid, expr_param=param, capacity=t.capacity,
                params=_expr.current_bound_params())
            # the kernel's packed words ARE the table's validity
            return ColumnarTable(t.columns, words, cnt, t.capacity)
        mask = e.mask(t)
        return ColumnarTable(t.columns, mask.to(torch.bool),
                             mask.sum().to(torch.int32))
    if op == "dedupe":
        from repro_torch.core.extraction import dedupe_by

        return dedupe_by(ins[0], list(node.get("keys")))
    if op == "conform_events":
        t = ins[0]
        end_col, group_col, weight_col = (node.get("end_col"),
                                          node.get("group_col"),
                                          node.get("weight_col"))
        return make_events(
            patient_id=t.columns["patient_id"],
            category=node.get("category"),
            value=t.columns[node.get("value_col")],
            start=t.columns[node.get("start_col")],
            end=t.columns[end_col] if end_col else None,
            group_id=t.columns[group_col] if group_col else None,
            weight=t.columns[weight_col] if weight_col else None,
            valid=t.valid,
        )
    if op == "compact":
        return _compact_table(ins[0], node.get("engine") or engine)
    if op == "transform":
        fn, wants_np = TRANSFORMS[node.get("fn")]
        kwargs = {k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in (node.get("kwargs") or ())}
        if wants_np:
            kwargs.setdefault("n_patients", n_patients)
        if node.get("fn") in _ENGINE_TRANSFORMS:
            kwargs["engine"] = engine
        return fn(*ins, **kwargs)
    if op == "concat":
        return ColumnarTable.concat(list(ins))
    if op == "cohort_from_events":
        ev = ins[0]
        return Bitset.from_indices(ev.columns["patient_id"], ev.valid,
                                   n_patients)
    if op == "cohort_op":
        # the torch engine; the cuda engine runs whole groups (_eval_group)
        a, b = ins
        kind = node.get("kind")
        if kind == "&":
            return a & b
        if kind == "|":
            return a | b
        return a & ~b
    raise ValueError(f"unknown traced op {node.op!r}")


def _node_count(node, val) -> torch.Tensor:
    if node.op in COHORT_OPS:
        return Bitset.count(val)
    return val.count.to(torch.int32)


_BITSET_OPS = {"&": "and", "|": "or", "-": "andnot"}


def cohort_groups(plan: Plan) -> Dict[int, Tuple[int, ...]]:
    """Every maximal group of ``cohort_op`` nodes joined by ``cohort_op``
    edges, keyed by its last node: ``{last id: member ids in order}``.
    A group runs at its last node's position, so no other traced node may
    read a member before it (``run_plan_body`` checks)."""
    parent = {i: i for i, n in enumerate(plan.nodes) if n.op == "cohort_op"}

    def root(i):
        while parent[i] != i:
            i = parent[i]
        return i

    for i in parent:
        for j in plan.nodes[i].inputs:
            if j in parent:
                parent[root(j)] = root(i)
    groups: Dict[int, List[int]] = {}
    for i in sorted(parent):
        groups.setdefault(root(i), []).append(i)
    return {ms[-1]: tuple(ms) for ms in groups.values()}


def _eval_group(plan: Plan, members: Tuple[int, ...],
                vals: Dict[int, Any]):
    """A group of ``cohort_op`` nodes through the bitset kernel: one launch
    of at most ``MAX_OPS`` ops over at most ``MAX_LEAVES`` leaves, so a
    larger group runs as consecutive launches.  Returns every member's
    words and count."""
    from repro_torch.kernels import bitset_ops as _bo
    from repro_torch.kernels import ops as kops

    words: Dict[int, torch.Tensor] = {}
    counts: Dict[int, torch.Tensor] = {}
    k = 0
    while k < len(members):
        leaves: List[int] = []
        chunk: List[int] = []
        for i in members[k:]:
            new = [j for j in dict.fromkeys(plan.nodes[i].inputs)
                   if j not in chunk and j not in leaves]
            if (len(chunk) == _bo.MAX_OPS
                    or len(leaves) + len(new) > _bo.MAX_LEAVES):
                break
            leaves += new
            chunk.append(i)
        slot = {j: s for s, j in enumerate(leaves + chunk)}
        program = [(_BITSET_OPS[plan.nodes[i].get("kind")],
                    *(slot[j] for j in plan.nodes[i].inputs)) for i in chunk]
        out, cnt = kops.bitset_expr(
            [words[j] if j in words else vals[j] for j in leaves], program)
        for r, i in enumerate(chunk):
            words[i], counts[i] = out[r], cnt[r]
        k += len(chunk)
    return words, counts


# ---------------------------------------------------------------------------
# plan-level execution
# ---------------------------------------------------------------------------
def traced_ids(plan: Plan) -> Tuple[int, ...]:
    return tuple(i for i, n in enumerate(plan.nodes)
                 if n.op in TABLE_OPS or n.op in COHORT_OPS)


def keep_ids(plan: Plan) -> Tuple[int, ...]:
    """Node values handed back to the caller: named outputs, base cohort
    bitsets, and the event tables cohorts were built from."""
    traced = set(traced_ids(plan))
    keep = {i for _, i in plan.outputs if i in traced}
    for i, n in enumerate(plan.nodes):
        if n.op == "cohort_from_events":
            keep.add(i)
            keep.update(j for j in n.inputs if j in traced)
    return tuple(sorted(keep))


def env_device(env: Dict[str, ColumnarTable]) -> Optional[torch.device]:
    """The device the run's tables lie on (None for an empty env)."""
    for t in env.values():
        return t.device
    return None


def run_plan_body(plan: Plan, env: Dict[str, ColumnarTable], n_patients: int,
                  engine: str, n_shards: int = 1,
                  predicate_engine: Optional[str] = None, group=None, *,
                  keep: Tuple[int, ...],
                  shape_sink: Optional[Dict[int, int]] = None):
    """node id -> value for every array-valued node, plus per-node counts
    (0-d tensors) and per-join FlatteningStats dicts.  ``predicate_engine``
    is the fallback for predicate nodes the optimizer did not stamp
    (``"auto"``/None resolve by engine and device).  Reused by
    ``distributed.pipeline`` on every rank: ``n_shards`` and the process
    ``group`` make exchange nodes real all-to-alls there; without a group
    they are the identity.  Only the values of the ``keep`` nodes
    are returned; every other value is dropped after its last consumer ran
    (as XLA frees a buffer past its last use).  ``shape_sink`` (a dict)
    receives every table node's capacity (padded rows)."""
    _check_engine(engine)
    peng = _pk.resolve_engine(predicate_engine, engine, env_device(env))
    ids = traced_ids(plan)
    # under the cuda engine a cohort_op group runs at its last node
    groups = cohort_groups(plan) if engine == "cuda" else {}
    at = {m: last for last, ms in groups.items() for m in ms}
    for i in ids:
        late = [j for j in plan.nodes[i].inputs if i not in at
                and at.get(j, -1) > i]
        if late:
            raise ValueError(
                f"node {i} ({plan.nodes[i].op}) reads cohort_op nodes "
                f"{late} before their group's last node runs")
    last_use: Dict[int, int] = {}
    for i in ids:
        for j in plan.nodes[i].inputs:
            last_use[j] = max(last_use.get(j, -1), at.get(i, i))
    vals: Dict[int, Any] = {}
    counts: Dict[int, torch.Tensor] = {}
    stats: Dict[int, Dict[str, torch.Tensor]] = {}
    for i in ids:
        node = plan.nodes[i]
        if i in at:
            if at[i] != i:
                continue
            out, cnt = _eval_group(plan, groups[i], vals)
            vals.update(out)
            counts.update(cnt)
            used = {j for m in groups[i] for j in plan.nodes[m].inputs}
        else:
            ins = [vals[j] for j in node.inputs]
            out = _eval_node(node, ins, env, n_patients, engine, n_shards,
                             predicate_engine=peng, group=group)
            if node.op in STATS_OPS:
                out, stats[i] = out
            if shape_sink is not None and node.op in TABLE_OPS:
                shape_sink[i] = int(out.capacity)
            vals[i] = out
            counts[i] = _node_count(node, vals[i])
            del ins
            used = set(node.inputs)
        for j in used:
            if last_use[j] == i and j not in keep:
                del vals[j]
    return {i: vals[i] for i in keep}, counts, stats


def _runner(plan: Plan, n_patients: int, engine: str,
            predicate_engine: Optional[str], device,
            params_sig: Optional[Tuple] = None) -> Callable:
    peng = _pk.resolve_engine(predicate_engine, engine, device)
    key = (plan.key(), n_patients, engine, peng, params_sig)

    def build():
        keep = keep_ids(plan)

        def run(env, lits=(), vecs=(), shape_sink=None):
            with _expr.bound_params(lits, vecs):
                vals, counts, stats = run_plan_body(
                    plan, env, n_patients, engine, predicate_engine=peng,
                    keep=keep, shape_sink=shape_sink)
            # counts leave as ONE stacked vector: a single host transfer for
            # provenance instead of one device sync per node
            ids = tuple(sorted(counts))
            dev = env_device(env)
            stacked = (torch.stack([counts[i].to(dev) for i in ids])
                       if ids else torch.zeros((0,), dtype=torch.int32))
            return vals, stacked, stats

        return run

    return cached_executable(key, build)


def _host_stats(stats) -> Dict[int, Dict[str, int]]:
    """All stats scalars in one device->host transfer."""
    flat = [(i, k, v) for i, d in sorted(stats.items()) for k, v in d.items()]
    if not flat:
        return {}
    host = torch.stack([v.to(torch.int64) for _, _, v in flat]).cpu().tolist()
    out: Dict[int, Dict[str, int]] = {}
    for (i, k, _), h in zip(flat, host):
        out.setdefault(i, {})[k] = int(h)
    return out


def execute(plan: Plan, tables: Dict[str, ColumnarTable], n_patients: int = 0,
            engine: str = "torch", log: Optional[OperationLog] = None,
            stats_sink: Optional[Dict[int, Dict[str, int]]] = None,
            predicate_engine: Optional[str] = None,
            expr_params: Optional[Tuple[Tuple, Tuple]] = None,
            counts_sink: Optional[Dict[int, int]] = None,
            shape_sink: Optional[Dict[int, int]] = None
            ) -> Dict[int, Any]:
    """Evaluate every array-valued node of ``plan`` over ``tables``.

    Returns {node id: value} for the ``keep_ids`` subset.  Per-join
    ``FlatteningStats`` are recorded into ``log`` automatically and, when
    ``stats_sink`` is given, copied into it as host ints keyed by node id;
    ``counts_sink`` receives every traced node's count (host ints) and
    ``shape_sink`` every table node's capacity.  ``predicate_engine``
    ("torch" | "cuda" | "auto"/None) picks how un-stamped predicate nodes
    evaluate.  ``expr_params`` is the ``(lits, vecs)`` pair backing a
    normalized plan's hoisted-literal slots."""
    missing = [s for s in plan.sources() if s not in tables]
    if missing:
        raise KeyError(f"plan scans source(s) {missing} but run() only got "
                       f"{sorted(tables)}")
    env = {src: tables[src] for src in plan.sources()}
    device = env_device(env)
    if expr_params is None:
        fn, args = _runner(plan, n_patients, engine, predicate_engine,
                           device), (env,)
    else:
        from repro_torch.study.normalize import params_signature

        lits, vecs = expr_params
        fn = _runner(plan, n_patients, engine, predicate_engine, device,
                     params_sig=params_signature(lits, vecs))
        args = (env, tuple(lits), tuple(vecs))
    vals, counts_vec, stats = fn(*args, shape_sink=shape_sink)
    counts = dict(zip(traced_ids(plan), counts_vec.cpu().tolist()))
    if counts_sink is not None:
        counts_sink.update(counts)
    if log is not None or stats_sink is not None:
        host_stats = _host_stats(stats)
        if log is not None:
            record_plan(plan, counts, log, engine, stats=host_stats,
                        predicate_engine=predicate_engine, device=device)
        if stats_sink is not None:
            stats_sink.update(host_stats)
    return vals


def record_plan(plan: Plan, counts: Dict[int, int], log: OperationLog,
                engine: str,
                stats: Optional[Dict[int, Dict[str, int]]] = None,
                predicate_engine: Optional[str] = None,
                device=None) -> None:
    """One OperationLog entry per executed node — automatic provenance.
    ``counts``/``stats`` must already be host ints.  Join nodes carry their
    FlatteningStats fields in the entry params.  ``predicate_engine`` and
    ``device`` must match the executing call so un-stamped predicate nodes
    log the engine they actually ran."""
    peng = _pk.resolve_engine(predicate_engine, engine, device)
    out_names = {i: name for name, i in plan.outputs}
    host_counts = {i: int(c) for i, c in counts.items()}

    class _N:  # OperationLog.record introspects ``.count``
        def __init__(self, c):
            self.count = c

    for i, c in host_counts.items():
        node = plan.nodes[i]
        ins = {f"#{j}:{plan.nodes[j].label()}": _N(host_counts[j])
               for j in node.inputs if j in host_counts}
        label = out_names.get(i, node.label())
        params = {}
        for k, v in node.params:
            if k in ("required_columns", "pruned_columns", "cols"):
                params[k] = list(v)
            elif k == "expr":
                params[k] = _expr.render_param(v)
            elif k == "exprs":
                params[k] = [_expr.render_param(e) for e in v]
            elif isinstance(v, (int, float, str, bool, type(None))):
                params[k] = v
            else:
                params[k] = len(v)
        if params.get("engine") is None:
            if node.op in PREDICATE_OPS:
                e = _expr.node_predicate(node)
                params["engine"] = (
                    "cuda" if peng == "cuda" and e is not None
                    and _pk.compilable(e.to_param()) else "torch")
            else:
                params["engine"] = engine
        if stats and i in stats:
            params.update(stats[i])
        log.record(op=f"plan:{node.op}:{label}", inputs=ins,
                   outputs={label: _N(c)}, params=params)
