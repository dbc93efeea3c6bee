"""Multi-tenant cohort-query service: one resident star schema, many
concurrent Study plans.

The port of ``repro.study.service``'s local path.  SCALPEL3's end state is
interactive cohort analysis over a population-scale claims database — many
analysts (tenants) issuing structured cohort queries against one dataset
that stays resident on the card.  ``CohortQueryService`` adds the serving
layer in three tiers:

1. **Admission + batching** — a ``serving.batching.SlotScheduler``: bounded
   in-flight window (``n_slots``), FIFO-with-priority queueing, per-tenant
   in-flight quotas, bounded queue depth (over-depth submissions are
   *rejected*, not silently dropped).
2. **Plan normalization** (``study.normalize``) — every admitted study's
   optimized plan is canonicalized (stable order, labels stripped, literals
   hoisted into a params vector), so structurally-equal queries from
   different tenants share ONE runner; the literals enter as B1 operands
   (``device_params``), so a new literal never builds a runner.
3. **Cross-tenant subgraph result cache** — each cacheable plan prefix
   (scan/predicate/join subtrees, ``normalize.cut_points``) is
   content-hashed with its literal values resolved back in and keyed by
   table version; a shared scan or predicate bitset is computed once and
   served from the cache for every later query, with LRU eviction under a
   device-byte budget and wholesale invalidation on table-version bump.

Cache injection: the reference wraps each cut node in ``jax.lax.cond`` over
a traced hit flag so that one executable serves every hit pattern.  PyTorch
runs eagerly, so a runner is built once per normalized shape (the key
``(plan.key(), n_patients, engine, predicate engine, params_signature)``,
counted in ``stats.compile_count``) and the hit flag is a host bool: on a
hit the cut node takes the cached table instead of evaluating (its kernel
does not launch; its FlatteningStats come from the cache entry at realize),
while its inputs still run, as in the reference; on a miss the node
computes in place (``executor.run_plan_body(cached=...)``).

Async step pipeline: each admitted ticket runs in two stages.  The
*submit* stage (optimize, analyze, normalize, runner lookup, cache lookup,
the runner's launches) runs on the calling thread; the *realize* stage
(counts and stats read back, cache insert, ``_finish_result`` replay) runs
on a single worker thread, so the card's work for the next admitted ticket
overlaps host realization of the previous one.  Scheduler slots release
when realization *finishes*.  A submit-stage cache miss publishes its cut
hash in an in-flight registry; a later admission wanting the same subgraph
waits for that realization's insert instead of recomputing, so pipelined
hit/miss accounting matches the synchronous mode
(``ServiceConfig.pipeline=False``) exactly.

Results are realized through ``Study._finish_result`` — the exact code path
``Study.run`` uses — and the realize stage records the plan's nodes into
each result's OperationLog as ``Study.run`` does (the reference's local
path leaves them out), so every admitted query's events, cohorts,
flowcharts, features, FlatteningStats and plan log entries equal a solo run
of the same study.  The sharded service (``mesh=``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.columnar import ColumnarTable, resolve_device
from repro_torch.core.metadata import OperationLog
from repro_torch.kernels import predicate as _pk
from repro_torch.serving.batching import SlotScheduler
from repro_torch.study import executor as _executor
# member imports, not `from repro_torch.study import normalize`: the package
# re-exports the normalize() function, shadowing the submodule attribute
from repro_torch.study.normalize import (
    NormalPlan, cut_points, device_params, normalize, params_signature,
    subgraph_hashes,
)
from repro_torch.study.analyze import (PlanValidationError,
                                       analyze as _analyze_plan)
from repro_torch.study.api import Study, StudyResult
from repro_torch.study.expr import bound_params
from repro_torch.study.optimizer import OPTIMIZER_VERSION
from repro_torch.study.plan import Plan

__all__ = ["CohortQueryService", "ServiceConfig", "ServiceStats",
           "TenantStats", "QueryTicket"]


# ---------------------------------------------------------------------------
# config / audit surface
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ServiceConfig:
    n_slots: int = 8                      # in-flight admission window
    per_tenant_inflight: int = 2          # per-tenant quota within the window
    max_queue: int = 256                  # queue depth; beyond this: reject
    cache_budget_bytes: int = 256 << 20   # subgraph-cache LRU budget
    engine: str = "torch"
    predicate_engine: Optional[str] = None  # None/"auto" resolve by device
    pipeline: bool = True                 # overlap realize with next submit


@dataclasses.dataclass
class TenantStats:
    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    rejected: int = 0
    failed: int = 0
    invalid: int = 0     # plans rejected by admission-time static analysis
    demoted: int = 0     # predicate nodes normalization demoted cuda->torch


@dataclasses.dataclass
class ServiceStats:
    """The audit surface: per-tenant admission counts plus cache/compile
    counters.  Mirrored into the service ``OperationLog`` per event."""

    tenants: Dict[str, TenantStats] = dataclasses.field(default_factory=dict)
    queries: int = 0
    compile_count: int = 0            # distinct runners built
    cache_hits: int = 0               # cut subgraphs served from cache
    cache_misses: int = 0             # cut subgraphs computed + inserted
    cache_evictions: int = 0
    cache_entries: int = 0
    cache_bytes: int = 0
    table_version: int = 0
    plans_rejected: int = 0           # error-level static analysis findings
    demotions: int = 0                # cuda->torch normalization demotions
    submit_s: float = 0.0             # summed submit stage time
    realize_s: float = 0.0            # summed realize stage time
    wall_s: float = 0.0               # summed drain() wall time

    def tenant(self, name: str) -> TenantStats:
        return self.tenants.setdefault(name, TenantStats())

    def hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def overlap_s(self) -> float:
        """Wall time saved by the submit/realize pipeline: the summed stage
        times minus the drain wall they actually took (0 when the service
        has only been stepped outside ``drain``)."""
        if not self.wall_s:
            return 0.0
        return max(0.0, self.submit_s + self.realize_s - self.wall_s)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "tenants": {k: dataclasses.asdict(v)
                        for k, v in sorted(self.tenants.items())},
            "queries": self.queries,
            "compile_count": self.compile_count,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_hit_rate": round(self.hit_rate(), 4),
            "cache_evictions": self.cache_evictions,
            "cache_entries": self.cache_entries,
            "cache_bytes": self.cache_bytes,
            "table_version": self.table_version,
            "plans_rejected": self.plans_rejected,
            "demotions": self.demotions,
            "submit_s": round(self.submit_s, 6),
            "realize_s": round(self.realize_s, 6),
            "wall_s": round(self.wall_s, 6),
            "overlap_s": round(self.overlap_s(), 6),
        }


@dataclasses.dataclass
class QueryTicket:
    """One submitted study: filled in as it moves queued -> done/failed.

    ``wire=True`` marks tickets that entered through the declarative wire
    path (``submit_spec``): their failures are always *structured* — any
    exception class maps to ``status == "invalid"`` with ``SPEC-nnn``/
    ``SPnnn`` error codes, and ``wire_payload()`` renders the ticket as the
    service's JSON response (a traceback never reaches a tenant)."""

    tenant: str
    study: Optional[Study]
    priority: int = 0
    seq: int = -1
    status: str = "queued"    # queued | rejected | invalid | done | failed
    result: Optional[StudyResult] = None
    error: Optional[BaseException] = None
    wire: bool = False                # submitted as a spec via the wire path
    cache_hits: int = 0
    cache_misses: int = 0
    # the op of every cut node served from the cache, in plan order (a hit
    # node's kernel does not launch)
    hit_ops: List[str] = dataclasses.field(default_factory=list)
    compiled: bool = False            # this query built a new runner
    latency_s: float = 0.0
    submit_s: float = 0.0             # submit stage time
    realize_s: float = 0.0            # realize stage time
    # in-flight cut registration (see _cut_lookup / _release_cuts)
    _cut_evt: Optional[threading.Event] = dataclasses.field(
        default=None, repr=False, compare=False)
    _cut_hashes: List[str] = dataclasses.field(
        default_factory=list, repr=False, compare=False)

    def wire_payload(self) -> Dict[str, Any]:
        """The ticket as a structured wire response.

        ``done`` -> result summary (event/cohort counts, flow stages, cache
        accounting); ``rejected``/``invalid``/``failed`` -> an ``errors``
        list of ``{code, path|node, message, hint}`` entries
        (``spec.error_payload``).  Exception *types* are mapped to stable
        codes; messages of unexpected exceptions and tracebacks are never
        included."""
        if self.status == "queued":
            return {"status": "queued", "seq": self.seq}
        if self.status == "rejected":
            return {"status": "rejected", "errors": [{
                "code": "SPEC-429",
                "message": "service queue is full; the query was not "
                           "admitted",
                "hint": "resubmit once in-flight queries drain"}]}
        if self.status == "done" and self.result is not None:
            r = self.result
            payload: Dict[str, Any] = {
                "status": "done",
                "events": {k: int(t.count) for k, t in r.events.items()},
                "cohorts": {k: int(c.subject_count())
                            for k, c in r.cohorts.items()},
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "compiled": self.compiled,
            }
            if r.flow is not None:
                payload["flow"] = [int(c.subject_count())
                                   for c in r.flow.steps]
            if r.features:
                payload["features"] = sorted(r.features)
            return payload
        from repro_torch.study.spec import error_payload
        err = self.error if self.error is not None \
            else RuntimeError("unresolved ticket")
        return {"status": self.status, "errors": error_payload(err)}


class _Count:
    def __init__(self, c: int) -> None:
        self.count = int(c)


# ---------------------------------------------------------------------------
# shape runners + cache entries
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Program:
    fn: Callable                       # (env, lits, vecs, cached) -> outs
    cut_ids: Tuple[int, ...]


@dataclasses.dataclass
class _CacheEntry:
    value: Any                         # ColumnarTable on the service device
    stats: Optional[Dict[str, int]]    # host FlatteningStats (STATS_OPS cuts)
    nbytes: int


def _table_nbytes(t: ColumnarTable) -> int:
    return int(sum(c.element_size() * c.numel() for c in t.columns.values())
               + t.valid.element_size() * t.valid.numel() + 4)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------
class CohortQueryService:
    """Admit many tenants' Study plans against one resident table set.

    ``submit`` queues, ``step`` admits one window and dispatches it,
    ``drain`` runs to empty (blocking on in-flight realizations).  With
    ``config.pipeline`` (the default) realization runs on a worker thread so
    the next admission's work on the card overlaps it; ``pipeline=False`` is
    the synchronous reference mode.  ``device`` (None = CUDA; raises where
    CUDA is absent) is where the tables reside and every query runs;
    ``axis_name`` is kept for the reference's signature.  See the module
    docstring for the three-layer architecture.
    """

    def __init__(self, tables: Dict[str, ColumnarTable],
                 table_version: int = 0,
                 config: Optional[ServiceConfig] = None,
                 mesh=None, axis_name: str = "data",
                 log: Optional[OperationLog] = None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "CohortQueryService(mesh=...): the sharded service is not "
                "ported yet (ROADMAP A7, the sharded service)")
        self.config = config or ServiceConfig()
        self.device = resolve_device(device)
        self.log = log if log is not None else OperationLog()
        self.stats = ServiceStats(table_version=int(table_version))
        self._version = int(table_version)
        self._env: Dict[str, ColumnarTable] = {}
        self._load_tables(tables)
        self._sched = SlotScheduler(
            self.config.n_slots,
            per_key_quota=self.config.per_tenant_inflight,
            max_queue=self.config.max_queue)
        self._seq = 0
        self._programs: Dict[Tuple, _Program] = {}
        self._cache: "OrderedDict[str, _CacheEntry]" = OrderedDict()
        self._cache_bytes = 0
        # shared mutable state (stats, log, cache, in-flight registry) is
        # touched from the main thread and the realization worker
        self._lock = threading.RLock()
        self._realizer: Optional[ThreadPoolExecutor] = None
        self._pending: "deque[Tuple[QueryTicket, Future]]" = deque()
        self._inflight_cuts: Dict[str, threading.Event] = {}
        self._on_done: Optional[Callable[[QueryTicket], None]] = None

    @classmethod
    def from_npz_dir(cls, dirpath: str, **kwargs) -> "CohortQueryService":
        """Resident service over a star schema persisted by
        ``data.io.save_star`` (one load per table version), on
        ``kwargs["device"]`` (None = CUDA)."""
        from repro_torch.data.io import load_star

        return cls(load_star(dirpath, device=kwargs.get("device")), **kwargs)

    # -- residency -----------------------------------------------------------
    def _load_tables(self, tables: Dict[str, ColumnarTable]) -> None:
        # loaded ONCE per table version: residency on the card is the
        # service's contract — queries never re-upload sources
        self._env = {k: t.to(self.device) for k, t in tables.items()}
        self.log.record(
            op="service:load_tables", inputs={},
            outputs={k: _Count(int(t.count)) for k, t in self._env.items()},
            params={"version": self._version,
                    "resident_bytes": sum(_table_nbytes(t)
                                          for t in self._env.values())})

    def update_tables(self, tables: Dict[str, ColumnarTable],
                      version: Optional[int] = None) -> None:
        """Install a new table version: re-residents the star schema, bumps
        the version (invalidating every subgraph-cache entry — the version
        salts the content hashes — and dropping the cached entries' bytes),
        and discards shape runners (table capacities may have changed).
        Quiesces in-flight realizations first: they hold references into the
        outgoing table set."""
        self._quiesce()
        with self._lock:
            self._version = int(version) if version is not None \
                else self._version + 1
            self.stats.table_version = self._version
            dropped = len(self._cache)
            self._cache.clear()
            self._cache_bytes = 0
            self.stats.cache_entries = 0
            self.stats.cache_bytes = 0
            self._programs.clear()
            self._load_tables(tables)
            self.log.record(op="service:update_tables", inputs={},
                            outputs={},
                            params={"version": self._version,
                                    "cache_dropped": dropped})

    # -- admission -----------------------------------------------------------
    def submit(self, study: Study, tenant: str = "default",
               priority: int = 0, wire: bool = False) -> QueryTicket:
        """Queue a study for ``tenant``.  Returns its ticket immediately;
        the ticket resolves during ``step``/``drain``.  Over-depth queues
        reject (``status == "rejected"``)."""
        t = QueryTicket(tenant=tenant, study=study, priority=int(priority),
                        seq=self._seq, wire=wire)
        self._seq += 1
        with self._lock:
            self.stats.tenant(tenant).submitted += 1
        if not self._sched.submit(t, key=tenant, priority=priority):
            t.status = "rejected"
            with self._lock:
                self.stats.tenant(tenant).rejected += 1
                self.log.record(op=f"service:reject:{tenant}", inputs={},
                                outputs={},
                                params={"queued": self._sched.queued()})
        return t

    def submit_spec(self, spec: Any, tenant: str = "default",
                    priority: int = 0) -> QueryTicket:
        """Queue a declarative wire-format study spec (``study.spec``).

        The spec validates and compiles *before* admission: a malformed
        payload comes back immediately as an ``"invalid"`` ticket carrying
        every ``SPEC-nnn`` finding (and counts into
        ``stats.plans_rejected``), without consuming a queue slot.  A
        compiling spec queues exactly like the equivalent Python-built
        ``Study`` — same optimize -> analyze -> normalize admission, same
        runner sharing, same subgraph cache, bit-identical results — but its
        ticket is marked ``wire``: every later failure, including ``SPnnn``
        analyzer rejections and runtime surprises, is rendered structurally
        by ``QueryTicket.wire_payload()``; no exception class leaks a
        traceback to the tenant."""
        from repro_torch.study.spec import compile_spec, error_payload

        try:
            study = compile_spec(spec)
        except Exception as e:  # noqa: BLE001 — wire admission never raises:
            # SpecValidationError carries its SPEC-nnn issues; anything else
            # renders as a single SPEC-900 entry via error_payload.
            t = QueryTicket(tenant=tenant, study=None,
                            priority=int(priority), seq=self._seq, wire=True)
            self._seq += 1
            t.status = "invalid"
            t.error = e
            with self._lock:
                ts = self.stats.tenant(tenant)
                ts.submitted += 1
                ts.invalid += 1
                self.stats.plans_rejected += 1
                self.log.record(
                    op=f"service:invalid:{tenant}", inputs={}, outputs={},
                    params={"errors": [
                        " ".join(str(d.get(k)) for k in
                                 ("code", "node", "path", "message")
                                 if d.get(k) is not None)
                        for d in error_payload(e)][:8]})
            return t
        return self.submit(study, tenant=tenant, priority=priority,
                           wire=True)

    def step(self) -> int:
        """Admit one window of queued tickets (priority order, per-tenant
        quotas) and run their submit stage; returns the number admitted.
        With ``config.pipeline`` the realize stage is handed to the
        realization worker and the slot releases when it completes;
        otherwise it runs inline."""
        self._reap(block=False)
        admitted = self._sched.admit()
        for ticket, tenant in admitted:
            with self._lock:
                self.stats.tenant(tenant).admitted += 1
            try:
                realize = self._submit_ticket(ticket)
            except Exception as e:  # noqa: BLE001 — isolate tenant failures
                self._resolve_failure(ticket, e)
                self._release_cuts(ticket)
                self._sched.release(tenant)
                self._notify(ticket)
            else:
                if self.config.pipeline:
                    self._pending.append(
                        (ticket,
                         self._pool().submit(self._realize_ticket, ticket,
                                             realize)))
                else:
                    self._realize_ticket(ticket, realize)
                    self._notify(ticket)
        return len(admitted)

    def drain(self, on_done: Optional[Callable[[QueryTicket], None]] = None
              ) -> None:
        """Run until the queue is empty and every in-flight realization has
        resolved.  The elapsed wall accrues into ``stats.wall_s`` — the
        baseline the pipeline's ``overlap_s`` accounting is measured
        against.

        ``on_done`` (the port's addition) is called on this thread with
        each ticket the drain resolves, as soon as the drain sees it
        resolved: a tenant that takes each result there, and lets it go,
        keeps on the card only the results of the in-flight window."""
        t0 = time.perf_counter()
        self._on_done = on_done
        try:
            while True:
                if self.step():
                    continue
                if self._pending:
                    # nothing admittable: a finishing realization frees slots
                    self._reap(block=True)
                    continue
                break
        finally:
            self._on_done = None
        with self._lock:
            self.stats.wall_s += time.perf_counter() - t0

    def query(self, study: Study, tenant: str = "default",
              priority: int = 0) -> StudyResult:
        """Submit + drain convenience for single-query callers."""
        t = self.submit(study, tenant=tenant, priority=priority)
        self.drain()
        if t.status == "rejected":
            raise RuntimeError("query rejected: service queue is full")
        if t.error is not None:
            raise t.error
        assert t.result is not None
        return t.result

    # -- pipeline machinery --------------------------------------------------
    def _pool(self) -> ThreadPoolExecutor:
        if self._realizer is None:
            self._realizer = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="svc-realize")
        return self._realizer

    def _notify(self, ticket: QueryTicket) -> None:
        if self._on_done is not None:
            self._on_done(ticket)

    def _reap(self, block: bool) -> int:
        """Pop finished realizations off the pending deque (FIFO — the
        single worker realizes in submission order).  ``block`` waits for
        the oldest one.  Main-thread only."""
        done = 0
        while self._pending and self._pending[0][1].done():
            self._notify(self._pending.popleft()[0])
            done += 1
        if block and self._pending:
            self._pending[0][1].result()   # _realize_ticket never raises
            self._notify(self._pending.popleft()[0])
            done += 1
            while self._pending and self._pending[0][1].done():
                self._notify(self._pending.popleft()[0])
                done += 1
        return done

    def _quiesce(self) -> None:
        while self._pending:
            self._reap(block=True)

    def _realize_ticket(self, ticket: QueryTicket,
                        realize: Callable[[], None]) -> None:
        try:
            realize()
            with self._lock:
                ticket.status = "done"
                self.stats.tenant(ticket.tenant).completed += 1
        except Exception as e:  # noqa: BLE001 — isolate tenant failures
            self._resolve_failure(ticket, e)
        finally:
            self._release_cuts(ticket)
            self._sched.release(ticket.tenant)

    def _resolve_failure(self, ticket: QueryTicket,
                         e: BaseException) -> None:
        """Resolve a ticket whose submit or realize stage threw.

        ``PlanValidationError`` (admission-time static analysis) always maps
        to ``"invalid"`` — it never touched the runner cache, distinct from
        runtime failures.  Wire tickets map *every* exception to
        ``"invalid"`` too: the wire contract is structured rejection with
        stable codes (``QueryTicket.wire_payload``), never a leaked
        traceback, and each counts into ``stats.plans_rejected``.  Python
        tickets keep the ``"failed"`` status with the exception re-raisable
        from ``ticket.error``."""
        invalid = ticket.wire or isinstance(e, PlanValidationError)
        with self._lock:
            ticket.error = e
            ts = self.stats.tenant(ticket.tenant)
            if invalid:
                from repro_torch.study.spec import error_payload

                ticket.status = "invalid"
                ts.invalid += 1
                self.stats.plans_rejected += 1
                self.log.record(
                    op=f"service:invalid:{ticket.tenant}", inputs={},
                    outputs={},
                    params={"errors": [
                        " ".join(str(d.get(k)) for k in
                                 ("code", "node", "path", "message")
                                 if d.get(k) is not None)
                        for d in error_payload(e)][:8]})
            else:
                ticket.status = "failed"
                ts.failed += 1
                self.log.record(op=f"service:failed:{ticket.tenant}",
                                inputs={}, outputs={},
                                params={"error": repr(e)})

    def _release_cuts(self, ticket: QueryTicket) -> None:
        """Retire the ticket's in-flight cut registrations and wake waiters
        (who re-check the cache — on a failed realization the entry is
        absent and the waiter becomes the computer)."""
        evt = ticket._cut_evt
        if evt is None:
            return
        with self._lock:
            for h in ticket._cut_hashes:
                if self._inflight_cuts.get(h) is evt:
                    del self._inflight_cuts[h]
        evt.set()

    # -- execution -----------------------------------------------------------
    def _submit_ticket(self, ticket: QueryTicket) -> Callable[[], None]:
        """Submit stage: optimize, admission analysis, normalize, runner +
        cache lookup, the runner's launches.  Returns the realize closure
        (run by ``_realize_ticket``, possibly on the worker)."""
        t0 = time.perf_counter()
        study = ticket.study
        peng_arg = self.config.predicate_engine
        plan = study.optimized_plan(tables=self._env,
                                    predicate_engine=peng_arg or "auto",
                                    engine=self.config.engine,
                                    device=self.device)
        # admission-time static analysis: error-level plans (unknown
        # sources, dropped-column reads, provably-empty masks, kind
        # mismatches) are rejected BEFORE they reach normalization or the
        # runner cache — a broken tenant plan must not cost a runner or
        # poison shared ones
        diags = _analyze_plan(plan, tables=self._env, n_shards=1,
                              n_patients=study.n_patients)
        if any(d.severity == "error" for d in diags):
            raise PlanValidationError(diags)
        realize_vals = self._run_local(ticket, study, plan)
        ticket.submit_s = time.perf_counter() - t0
        with self._lock:
            self.stats.submit_s += ticket.submit_s

        def realize() -> None:
            t1 = time.perf_counter()
            vals, stats_orig, req_log = realize_vals()
            for i, d in stats_orig.items():
                d.setdefault("stage", plan.nodes[i].label())
            ticket.result = study._finish_result(plan, vals, stats_orig,
                                                 req_log)
            now = time.perf_counter()
            ticket.realize_s = now - t1
            ticket.latency_s = now - t0
            with self._lock:
                self.stats.realize_s += ticket.realize_s
                self.stats.queries += 1
                self.log.record(
                    op=f"service:query:{ticket.tenant}", inputs={},
                    outputs={name: _Count(t.count)
                             for name, t in ticket.result.events.items()},
                    params={"plan_nodes": len(plan.nodes),
                            "cache_hits": ticket.cache_hits,
                            "cache_misses": ticket.cache_misses,
                            "compiled": ticket.compiled,
                            "submit_us": round(ticket.submit_s * 1e6, 1),
                            "realize_us": round(ticket.realize_s * 1e6, 1),
                            "latency_us": round(ticket.latency_s * 1e6, 1)})

        return realize

    def _audit_demotions(self, ticket: QueryTicket,
                         nplan: NormalPlan) -> None:
        if not nplan.demoted:
            return
        # the silent cuda->torch demotion is auditable — logged per query
        # and counted per tenant.  With hoisted literals B1 operands this
        # fires only for kernel-infeasible stamps (oversized isin
        # whitelists, non-boolean roots).
        with self._lock:
            self.stats.tenant(ticket.tenant).demoted += len(nplan.demoted)
            self.stats.demotions += len(nplan.demoted)
            self.log.record(
                op=f"service:demote:{ticket.tenant}", inputs={}, outputs={},
                params={"nodes": list(nplan.demoted),
                        "engine": "cuda->torch",
                        "reason": "kernel-infeasible predicate (oversized "
                                  "isin whitelist or non-boolean root)"})

    def _cut_lookup(self, prog: _Program, hashes, ticket: QueryTicket):
        """Per-cut cache lookup: the cached tables to inject, keyed by cut
        node.  Misses are published in the in-flight registry; a hash
        another ticket is currently realizing is *waited on* (outside the
        lock) so pipelined admissions hit exactly like synchronous ones."""
        if ticket._cut_evt is None:
            ticket._cut_evt = threading.Event()
        # entries pinned at lookup time: a later miss's insert may LRU-evict
        # a hit of this very query, but its device value stays referenced
        hit_entries: Dict[int, _CacheEntry] = {}
        for i in prog.cut_ids:
            h = hashes[i]
            while True:
                with self._lock:
                    entry = self._cache.get(h)
                    if entry is not None:
                        self._cache.move_to_end(h)
                        hit_entries[i] = entry
                        break
                    evt = self._inflight_cuts.get(h)
                    if evt is None or evt is ticket._cut_evt:
                        # we compute it; publish intent for later admissions
                        self._inflight_cuts[h] = ticket._cut_evt
                        if h not in ticket._cut_hashes:
                            ticket._cut_hashes.append(h)
                        break
                # an earlier ticket is realizing this subgraph: wait for its
                # insert, then re-check (it may have failed -> we compute)
                evt.wait()
        return hit_entries

    def _run_local(self, ticket: QueryTicket, study: Study, plan: Plan):
        """Normalize -> shared runner -> subgraph cache; returns the
        realize closure mapping canonical values back to the original
        plan's node ids."""
        peng = _pk.resolve_engine(self.config.predicate_engine,
                                  self.config.engine, self.device)
        nplan = normalize(plan)
        self._audit_demotions(ticket, nplan)
        lits, vecs = device_params(nplan, self.device)
        env = {s: self._env[s] for s in nplan.plan.sources()}
        prog = self._program(ticket, nplan, study.n_patients, peng, lits,
                             vecs)

        salt = (self._version, study.n_patients, self.config.engine, peng,
                OPTIMIZER_VERSION)
        hashes = subgraph_hashes(nplan, salt=salt)
        hit_entries = self._cut_lookup(prog, hashes, ticket)

        vals_c, counts_vec, stats = prog.fn(
            env, lits, vecs, {i: e.value for i, e in hit_entries.items()})
        cplan = nplan.plan

        def realize_vals():
            # the only reads of the card's results: two transfers, here
            counts_c = dict(zip(_executor.traced_ids(cplan),
                                counts_vec.cpu().tolist()))
            host_stats = _executor._host_stats(stats)
            with self._lock:
                for i in prog.cut_ids:
                    if i in hit_entries:
                        ticket.cache_hits += 1
                        ticket.hit_ops.append(cplan.nodes[i].op)
                        self.stats.cache_hits += 1
                        if hit_entries[i].stats is not None:
                            host_stats[i] = dict(hit_entries[i].stats)
                    else:
                        ticket.cache_misses += 1
                        self.stats.cache_misses += 1
                        self._insert(hashes[i], vals_c[i],
                                     host_stats.get(i))

            # canonical ids -> original ids (many-to-one, canonical side)
            canon_of = nplan.orig_to_canon()
            keep_orig = _executor.keep_ids(plan)
            vals: Dict[int, Any] = {}
            counts: Dict[int, int] = {}
            stats_orig: Dict[int, Dict[str, int]] = {}
            for oi in range(len(plan.nodes)):
                ci = canon_of.get(oi)
                if ci is None:
                    continue
                if oi in keep_orig and ci in vals_c:
                    vals[oi] = vals_c[ci]
                if ci in counts_c:
                    counts[oi] = counts_c[ci]
                if ci in host_stats:
                    stats_orig[oi] = dict(host_stats[ci])
            req_log = OperationLog()
            _executor.record_plan(
                plan, counts, req_log, self.config.engine, stats=stats_orig,
                predicate_engine=self.config.predicate_engine,
                device=self.device)
            return vals, stats_orig, req_log

        return realize_vals

    # -- shape runners -------------------------------------------------------
    def _program(self, ticket: QueryTicket, nplan: NormalPlan,
                 n_patients: int, peng: str, lits, vecs) -> _Program:
        skey = (nplan.plan.key(), n_patients, self.config.engine, peng,
                params_signature(lits, vecs))
        prog = self._programs.get(skey)
        if prog is not None:
            return prog
        prog = self._build_local_program(nplan, n_patients, peng)
        self._programs[skey] = prog
        with self._lock:
            self.stats.compile_count += 1
            ticket.compiled = True
            self.log.record(op="service:compile", inputs={}, outputs={},
                            params={"plan_nodes": len(nplan.plan.nodes),
                                    "cut_points": len(prog.cut_ids),
                                    "sharded": False,
                                    "executables": self.stats.compile_count})
        return prog

    def _build_local_program(self, nplan: NormalPlan, n_patients: int,
                             peng: str) -> _Program:
        """The runner of one normalized shape: the plan body
        (``executor.run_plan_body``, which evaluates each node with
        ``_eval_node``) with the hit cut nodes' tables injected.  It returns
        the kept and cut values, every traced node's count stacked into one
        tensor, and the stats tensors — nothing read back to the host."""
        plan = nplan.plan
        engine = self.config.engine
        cut_ids = cut_points(plan)
        keep = tuple(sorted(set(_executor.keep_ids(plan)) | set(cut_ids)))
        ids = _executor.traced_ids(plan)

        def fn(env, lits, vecs, cached):
            with bound_params(lits, vecs):
                vals, counts, stats = _executor.run_plan_body(
                    plan, env, n_patients, engine, predicate_engine=peng,
                    keep=keep, cached=cached)
            stacked = (torch.stack([counts[i].to(self.device) for i in ids])
                       if ids else torch.zeros((0,), dtype=torch.int32))
            return vals, stacked, stats

        return _Program(fn=fn, cut_ids=cut_ids)

    # -- subgraph cache ------------------------------------------------------
    def _insert(self, h: str, value: Any,
                stats: Optional[Dict[str, int]]) -> None:
        """Insert under the service lock (callers hold it).  Idempotent: a
        duplicate hash replaces the old entry without double-counting."""
        nbytes = _table_nbytes(value)
        if nbytes > self.config.cache_budget_bytes:
            return                      # larger than the whole budget: skip
        old = self._cache.pop(h, None)
        if old is not None:
            self._cache_bytes -= old.nbytes
        self._cache[h] = _CacheEntry(value=value, stats=stats, nbytes=nbytes)
        self._cache_bytes += nbytes
        while self._cache_bytes > self.config.cache_budget_bytes:
            _, old = self._cache.popitem(last=False)   # LRU eviction
            self._cache_bytes -= old.nbytes
            self.stats.cache_evictions += 1
            self.log.record(op="service:evict", inputs={}, outputs={},
                            params={"freed_bytes": old.nbytes,
                                    "cache_bytes": self._cache_bytes})
        self.stats.cache_entries = len(self._cache)
        self.stats.cache_bytes = self._cache_bytes
