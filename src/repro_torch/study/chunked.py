"""Out-of-core chunked plan execution — streaming a ``ChunkStore`` through
the resident executor with double-buffered prefetch and resumable
checkpoints.

The port of ``repro.study.chunked``.  The paper's headline run (15e9
events, ~15 TB, 49 minutes) cannot be device-resident; this module is the
physical strategy that retargets an unchanged logical Study plan onto a
partitioned star.  The pieces:

* **One runner for all chunks.**  Every chunk has the same fixed capacity,
  so the executor's runner cache (``executor.cached_executable``) serves
  chunk 2..N from the chunk-1 entry.  Plans whose join capacities are
  content-dependent are capacity-planned per chunk (from the chunks' host
  arrays) and the stamped capacities merged to the elementwise max
  (``_merge_capacity_plans``) — one conservative plan instead of one per
  chunk.
* **Double-buffered prefetch.**  On the card, a one-worker thread reads
  chunk i+1's file members straight into one of two reused pinned host
  buffer sets and copies them to the card on a side CUDA stream while chunk
  i runs on the default stream.  The default stream waits on the copy's
  event before it reads the chunk, and every staged tensor is
  ``record_stream``'d on it, so the caching allocator does not hand its
  memory to the side stream while the default stream may still read it; a
  buffer set is refilled only after its last copy's event completed.
  ``prefetch=False`` is the serial baseline (read, copy, wait, execute).
* **Exact merge.**  Chunk-dependent table outputs concatenate in chunk
  order on the device (row-local plan ops preserve per-chunk row order, so
  the valid rows of the concat ARE the resident path's valid rows, in
  order); cohort words OR together on the device (has-any-event membership
  is a union over the patient's chunks); FlatteningStats fields and node
  counts sum (uint32 key checksums are modular); chunk-independent branches
  (resident dimension lineage) are taken from one chunk instead of summed
  N times; cohort-algebra words and counts are replayed over the merged
  words through the executor's cohort groups (under the ``cuda`` engine one
  B3 launch per cohort expression), so provenance is exact, not a sum of
  per-chunk popcounts.  Each chunk-dependent table output is allocated
  once and assembled in place as chunks finish (``_Assembly``), so the
  chunks' tables are not all held beside a final concatenation.
  Plan-level ``concat`` outputs get a *branch-aware* merge: the resident
  path emits [branch1; branch2] while each chunk emits its own
  [branch1_ci; branch2_ci], so naive chunk-order concatenation would
  interleave the branches — instead each chunk's concat table is placed
  by its branch windows (boundaries from the capacities the first
  executed chunk's run reported, ``shape_sink``; capacities are 32-row
  aligned so validity copies word-wise), branch-major.
* **Checkpoint journal.**  With ``checkpoint_dir`` set, each completed
  chunk spills its kept values via ``data/io.py`` and appends a journal
  line (fsync'd); a killed run re-opens the journal, verifies the plan/
  store stamp, loads the spilled partial state onto the device and
  executes only the remaining chunks.

Soundness guard: ``transform`` (per-patient folds) and ``dedupe`` nodes
downstream of the chunked scan see only one chunk's rows at a time — a
patient's events may span chunks, so per-chunk evaluation + concat is NOT
the resident semantics.  Such plans are rejected with a clear error
(``allow_unsafe=True`` opts out, documented as approximate).  The static
analyzer additionally rejects misaligned chunk capacities (SP015) before
any chunk is read.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import bitset as _bs
from repro_torch.core.cohort import Bitset
from repro_torch.core.columnar import (_NP_TO_TORCH, ColumnarTable,
                                       resolve_device)
from repro_torch.core.metadata import OperationLog
from repro_torch.data.chunkstore import ChunkStore
from repro_torch.data.io import (host_words, load_columnar_arrays,
                                 save_columnar_arrays)
from repro_torch.study import executor as _executor
from repro_torch.study import optimizer as _optimizer
from repro_torch.study.plan import COHORT_OPS, Node, Plan

__all__ = ["ChunkedExecutor", "ChunkedReport", "chunk_dependent_ids",
           "chunk_unsafe_ops"]

JOURNAL_NAME = "journal.jsonl"

# ops whose per-chunk evaluation differs from whole-table evaluation when a
# patient's rows span a chunk boundary (cross-row folds / cross-row dedupe)
CHUNK_UNSAFE_OPS = ("transform", "dedupe")


def _fsync_dir(path: str) -> None:
    """Durably record directory entries (the renamed meta.json) — best
    effort on platforms whose directories cannot be opened for fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def chunk_dependent_ids(plan: Plan, source: str) -> Set[int]:
    """Node ids whose value depends on the chunked ``source`` — everything
    reachable from its scans.  Complement = resident lineage (dimension
    branches), computed once and merged by reference, not summed N times."""
    dep: Set[int] = set()
    for i, n in enumerate(plan.nodes):
        if n.op in ("scan", "scan_star") and n.get("source") == source:
            dep.add(i)
        elif any(j in dep for j in n.inputs):
            dep.add(i)
    return dep


def chunk_unsafe_ops(plan: Plan, source: str) -> List[Tuple[int, str]]:
    """(node id, op) for every chunk-unsafe op downstream of the chunked
    scan (see module docstring)."""
    dep = chunk_dependent_ids(plan, source)
    return [(i, plan.nodes[i].op) for i in sorted(dep)
            if plan.nodes[i].op in CHUNK_UNSAFE_OPS]


def _unwrap_compacted_concats(plan: Plan, dep: Set[int]) -> Plan:
    """Retarget named outputs that are compact wrappers over chunk-dependent
    concats at the concat node itself.  Each chunk's compact squeezes ITS
    OWN branch rows together, so the dense layout's branch boundaries are
    data-dependent and the merge could not slice branches back apart; the
    raw concat's branch windows are fixed (planned capacities) and its
    valid-row contents are identical — compaction only drops padding."""
    new_out = []
    changed = False
    for name, nid in plan.outputs:
        tgt = nid
        while plan.nodes[tgt].op == "compact":
            tgt = plan.nodes[tgt].inputs[0]
        if (tgt != nid and tgt in dep and plan.nodes[tgt].op == "concat"
                and len(plan.nodes[tgt].inputs) > 1):
            new_out.append((name, tgt))
            changed = True
        else:
            new_out.append((name, nid))
    return dataclasses.replace(plan, outputs=tuple(new_out)) if changed \
        else plan


def _concat_windows(plan: Plan, nid: int, dep: Set[int],
                    rows_of: Dict[int, int], off: int = 0
                    ) -> List[Tuple[int, int, int]]:
    """Resident-ordered ``(node, start, stop)`` padded-row windows of a
    concat node's branches inside its per-chunk output table, recursing
    through nested chunk-dependent concats so a concat-of-concats flattens
    to the same leaf order the resident path materializes."""
    out: List[Tuple[int, int, int]] = []
    for k in plan.nodes[nid].inputs:
        if plan.nodes[k].op == "concat" and k in dep:
            out.extend(_concat_windows(plan, k, dep, rows_of, off))
        else:
            out.append((k, off, off + rows_of[k]))
        off += rows_of[k]
    return out


class _Assembly:
    """One chunk-dependent table output, assembled on the device as the
    chunks finish: the merged table is allocated once and each chunk's
    table is copied into its place, so the chunks' tables are never all
    held beside a final concatenation (that would hold the outputs twice).
    ``pieces`` are ``(a, b, base, per_chunk)``: rows ``[a, b)`` of a
    chunk's table land at ``base + ci * (b - a)`` (``per_chunk``) or, for
    a chunk-independent concat branch, once at ``base``.  Every window is
    32-row aligned, so validity words copy word-wise, and the result is
    the concatenation slot for slot."""

    def __init__(self, pieces, rows: int, first: ColumnarTable) -> None:
        self.pieces, self.rows = pieces, rows
        dev = first.device
        self.cols = {c: torch.empty((rows,), dtype=v.dtype, device=dev)
                     for c, v in first.columns.items()}
        self.words = torch.empty((rows // 32,), dtype=torch.int32,
                                 device=dev)
        self.placed_once = False

    def add(self, ci: int, t: ColumnarTable) -> None:
        for a, b, base, per_chunk in self.pieces:
            if not per_chunk and self.placed_once:
                continue
            d = base + ci * (b - a) if per_chunk else base
            for c, v in t.columns.items():
                self.cols[c][d:d + b - a] = v[a:b]
            self.words[d // 32:(d + b - a) // 32] = t.valid[a // 32:b // 32]
        self.placed_once = True

    def table(self) -> ColumnarTable:
        return ColumnarTable(self.cols, self.words, _bs.count(self.words),
                             self.rows)


def _assembly_layout(plan: Plan, nid: int, dep: Set[int],
                     rows_of: Dict[int, int], n_chunks: int):
    """``(pieces, rows)`` of ``_Assembly`` for a chunk-dependent table
    output: a concat's branch windows, branch-major as the resident path
    lays them out (chunk-independent branches once), or the whole table
    per chunk.  None for a table whose capacity is not 32-row aligned (its
    chunks' tables are then concatenated at the end); a concat branch off
    the 32-row quantum raises."""
    node = plan.nodes[nid]
    if node.op == "concat" and len(node.inputs) > 1:
        windows = _concat_windows(plan, nid, dep, rows_of)
        bad = [(a, b) for _, a, b in windows if a % 32 or b % 32]
        if bad:
            raise RuntimeError(
                f"concat branch windows {bad} are not 32-row aligned")
    elif rows_of[nid] % 32:
        return None
    else:
        windows = [(nid, 0, rows_of[nid])]
    pieces, base = [], 0
    for k, a, b in windows:
        per_chunk = k in dep
        pieces.append((a, b, base, per_chunk))
        base += (b - a) * (n_chunks if per_chunk else 1)
    return pieces, base


def _merge_capacity_plans(plans: List[Plan]) -> Plan:
    """Merge per-chunk capacity-planned plans into one: identical structure
    required; ``capacity``/``per_dest_capacity`` params take the max across
    chunks so ONE plan holds every chunk's rows."""
    base = plans[0]
    if any(p.outputs != base.outputs or len(p.nodes) != len(base.nodes)
           for p in plans[1:]):
        raise ValueError("per-chunk optimized plans diverged structurally; "
                         "cannot share one runner")
    nodes = []
    for idx, n0 in enumerate(base.nodes):
        variants = [p.nodes[idx] for p in plans]
        if all(v == n0 for v in variants[1:]):
            nodes.append(n0)
            continue
        keys = [k for k, _ in n0.params]
        if any(v.op != n0.op or v.inputs != n0.inputs
               or [k for k, _ in v.params] != keys for v in variants[1:]):
            raise ValueError(f"per-chunk plans diverged at node {idx} "
                             f"({n0.op}) beyond planned capacities")
        params = []
        for k in keys:
            vals = [v.get(k) for v in variants]
            if all(v == vals[0] for v in vals[1:]):
                params.append((k, vals[0]))
            elif k in ("capacity", "per_dest_capacity") and all(
                    isinstance(v, int) for v in vals):
                params.append((k, max(vals)))
            else:
                raise ValueError(f"per-chunk plans disagree on param {k!r} "
                                 f"of node {idx} ({n0.op}); only planned "
                                 "capacities may vary across chunks")
        nodes.append(Node(n0.op, n0.inputs, tuple(params)))
    return Plan(tuple(nodes), base.outputs)


def _sum_stats(acc: Dict[str, int], d: Dict[str, int]) -> Dict[str, int]:
    out = dict(acc)
    for k, v in d.items():
        s = out.get(k, 0) + int(v)
        if k.startswith("key_sum"):
            s &= 0xFFFFFFFF          # uint32 modular checksum
        out[k] = s
    return out


def _replay_cohorts(plan: Plan, base: Dict[int, torch.Tensor], engine: str
                    ) -> Tuple[Dict[int, torch.Tensor], Dict[int, int]]:
    """Exact merged words and counts of EVERY cohort node, replayed over the
    merged ``cohort_from_events`` words (summing per-chunk popcounts of an
    intersection would overcount patients present in several chunks).
    Under the ``cuda`` engine each cohort expression is one B3 launch
    (``executor.cohort_groups``), as in a resident run."""
    words: Dict[int, torch.Tensor] = dict(base)
    counts: Dict[int, torch.Tensor] = {i: Bitset.count(w)
                                       for i, w in base.items()}
    if engine == "cuda":
        for members in _executor.cohort_groups(plan).values():
            out, cnt = _executor._eval_group(plan, members, words)
            words.update(out)
            counts.update(cnt)
    else:
        for i, n in enumerate(plan.nodes):
            if n.op != "cohort_op":
                continue
            a, b = (words[j] for j in n.inputs)
            kind = n.get("kind")
            words[i] = (a & b if kind == "&" else a | b if kind == "|"
                        else a & ~b)
            counts[i] = Bitset.count(words[i])
    ids = sorted(counts)
    host = (torch.stack([counts[i].reshape(()).to(torch.int64)
                         for i in ids]).cpu().tolist() if ids else [])
    return words, dict(zip(ids, (int(c) for c in host)))


@dataclasses.dataclass
class ChunkedReport:
    """Timing/audit facts of one chunked run.  On the card every time is
    taken after synchronization: ``load_s`` sums each chunk's file read
    into host buffers (host clock) and its copy to the card (CUDA events
    on the copy stream); ``exec_s`` each chunk's execution and merge up to
    a synchronization of the default stream; ``wall_s`` the loop, ended by
    a synchronization of the device."""

    n_chunks: int = 0
    executed: int = 0                # chunks run in this process
    resumed: int = 0                 # chunks restored from the journal
    compiles: int = 0                # runners built during the run (==1)
    load_s: float = 0.0              # sum of file reads + copies to device
    exec_s: float = 0.0              # sum of on-device execution
    wall_s: float = 0.0              # pipelined wall clock of the loop
    rows: int = 0                    # valid rows streamed

    @property
    def serial_s(self) -> float:
        """What a load-then-execute loop would have cost (no overlap)."""
        return self.load_s + self.exec_s

    @property
    def overlap_saved_s(self) -> float:
        return max(0.0, self.serial_s - self.wall_s)

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["serial_s"] = self.serial_s
        d["overlap_saved_s"] = self.overlap_saved_s
        return d


class _InjectedCrash(RuntimeError):
    """Raised by the ``crash_after`` test/ops hook — simulates preemption
    mid-extraction after N chunks committed to the journal."""


class _Loader:
    """Reads chunks and puts them on the device.

    On CUDA: two pinned host buffer sets, reused in turn; a chunk's file
    members are read straight into one set's numpy views, then copied to
    the card on a side stream.  ``get`` makes the default stream wait on
    that copy and ``record_stream``s the staged tensors on it.  On the CPU
    each chunk is read into fresh arrays (its tensors alias them)."""

    def __init__(self, store: ChunkStore, device: torch.device) -> None:
        self.store = store
        self.device = device
        self.cuda = device.type == "cuda"
        m = store.manifest
        self.spec = {c: _NP_TO_TORCH[np.dtype(dt)]
                     for c, dt in m.columns.items()}
        self.cap = m.chunk_capacity
        self.read_s = 0.0
        self.copies: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        if self.cuda:
            self.stream = torch.cuda.Stream(device=device)
            # two sets, each allocated at its first use (serial runs use one)
            self.pinned: List[Optional[Dict[str, torch.Tensor]]] = [None, None]
            self.copied: List[Optional[torch.cuda.Event]] = [None, None]

    def _buffers(self, pin: bool) -> Dict[str, torch.Tensor]:
        bufs = {c: torch.empty((self.cap,), dtype=dt, pin_memory=pin)
                for c, dt in self.spec.items()}
        bufs["__valid__"] = torch.empty((self.cap // _bs.WORD_BITS,),
                                        dtype=torch.int32, pin_memory=pin)
        return bufs

    def stage(self, ci: int, slot: int):
        """Chunk ``ci`` read and (on CUDA) its copy to the card enqueued:
        ``(columns, words, copy-done event or None)``.  Runs on the
        prefetch thread or inline."""
        if not self.cuda:
            t0 = time.perf_counter()
            bufs = self._buffers(pin=False)
            self.store.read_chunk_into(
                ci, {k: v.numpy() for k, v in bufs.items()})
            self.read_s += time.perf_counter() - t0
            words = bufs.pop("__valid__")
            return bufs, words, None
        with torch.cuda.device(self.device):
            last = self.copied[slot]
            if last is not None:
                last.synchronize()      # the set's last copy has read it
            if self.pinned[slot] is None:
                self.pinned[slot] = self._buffers(pin=True)
            bufs = self.pinned[slot]
            t0 = time.perf_counter()
            self.store.read_chunk_into(
                ci, {k: v.numpy() for k, v in bufs.items()})
            self.read_s += time.perf_counter() - t0
            with torch.cuda.stream(self.stream):
                start = torch.cuda.Event(enable_timing=True)
                done = torch.cuda.Event(enable_timing=True)
                start.record()
                cols = {k: v.to(self.device, non_blocking=True)
                        for k, v in bufs.items() if k != "__valid__"}
                words = bufs["__valid__"].to(self.device, non_blocking=True)
                done.record()
            self.copied[slot] = done
            self.copies.append((start, done))
            return cols, words, done

    def get(self, staged) -> ColumnarTable:
        """A staged chunk as a table the default stream may read."""
        cols, words, done = staged
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in (*cols.values(), words):
                t.record_stream(cur)
        return ColumnarTable(cols, words, _bs.count(words), self.cap)

    def copy_s(self) -> float:
        """Seconds of every copy to the card so far (call after a device
        synchronization)."""
        return sum(a.elapsed_time(b) for a, b in self.copies) / 1e3


class ChunkedExecutor:
    """Drives one Study over a ``ChunkStore`` (see module docstring) on
    ``device`` (None = CUDA).

    ``checkpoint_dir`` enables the resumable journal; ``prefetch=False``
    degrades to serial load-then-execute (the baseline);
    ``crash_after=k`` kills the run after k chunks committed (tests)."""

    def __init__(self, store: ChunkStore, engine: str = "torch",
                 predicate_engine: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None, prefetch: bool = True,
                 allow_unsafe: bool = False,
                 crash_after: Optional[int] = None, device=None) -> None:
        self.store = store
        self.engine = engine
        self.predicate_engine = predicate_engine
        self.checkpoint_dir = checkpoint_dir
        self.prefetch = bool(prefetch)
        self.allow_unsafe = bool(allow_unsafe)
        self.crash_after = crash_after
        self.device = resolve_device(device)
        self.report = ChunkedReport()

    # -- planning ------------------------------------------------------------
    def _resident_env(self, study, tables) -> Dict[str, ColumnarTable]:
        env = self.store.resident_tables(device=self.device)
        env.update({k: t.to(self.device) for k, t in study._sources.items()})
        env.update({k: t.to(self.device) for k, t in (tables or {}).items()})
        return env

    def _chunk_env(self, resident: Dict[str, ColumnarTable],
                   chunk: ColumnarTable) -> Dict[str, ColumnarTable]:
        env = dict(resident)
        env[self.store.source] = chunk
        return env

    def _schema_table(self) -> ColumnarTable:
        """The chunked source's schema at chunk capacity, without data
        (meta tensors): all that the analyzer reads of it."""
        m = self.store.manifest
        cap = m.chunk_capacity
        cols = {c: torch.empty((cap,), dtype=_NP_TO_TORCH[np.dtype(dt)],
                               device="meta")
                for c, dt in m.columns.items()}
        words = torch.empty((max(cap, 0) // _bs.WORD_BITS,),
                            dtype=torch.int32, device="meta")
        return ColumnarTable(cols, words, torch.empty(
            (), dtype=torch.int32, device="meta"), cap)

    def _plan(self, study, resident: Dict[str, ColumnarTable]) -> Plan:
        raw = study.plan()
        needs_stats = any(n.op in ("expand_join", "slice_time")
                          and n.get("capacity") is None for n in raw.nodes)
        peng = self.predicate_engine or "auto"
        if not needs_stats:
            return study.optimized_plan(tables=None, n_shards=1,
                                        predicate_engine=peng,
                                        engine=self.engine,
                                        device=self.device)
        # content-dependent capacities: plan each chunk exactly (from its
        # host arrays: the planner reads keys on the host), then take the
        # elementwise max so one plan serves every chunk
        plans = []
        for ci in range(self.store.n_chunks):
            cols, valid = self.store.load_chunk_arrays(ci)
            chunk = ColumnarTable.from_columns(cols, valid=valid,
                                               device="cpu")
            plans.append(_optimizer.optimize(
                raw, tables=self._chunk_env(resident, chunk), n_shards=1,
                predicate_engine=peng, engine=self.engine,
                device=self.device))
        return _merge_capacity_plans(plans)

    def _preflight(self, study, plan: Plan,
                   env0: Dict[str, ColumnarTable]) -> None:
        from repro_torch.study.analyze import (PlanValidationError, analyze,
                                               errors)

        diags = analyze(plan, tables=env0, n_shards=1,
                        n_patients=study.n_patients,
                        chunk_capacity=self.store.chunk_capacity)
        if errors(diags):
            raise PlanValidationError(diags)
        unsafe = chunk_unsafe_ops(plan, self.store.source)
        if unsafe and not self.allow_unsafe:
            ops = ", ".join(f"#{i}:{op}" for i, op in unsafe)
            raise ValueError(
                f"plan has chunk-unsafe ops downstream of the chunked scan "
                f"({ops}): per-patient folds/dedupe see one chunk at a time, "
                "so chunked results would differ from the resident path when "
                "a patient's rows span chunks.  Run resident, or pass "
                "allow_unsafe=True to accept approximate semantics")

    # -- checkpoint journal --------------------------------------------------
    def _stamp(self, plan: Plan, n_patients: int) -> str:
        blob = repr((plan.key(), self.engine, self.predicate_engine,
                     int(n_patients),
                     self.store.fingerprint())).encode()
        return hashlib.sha256(blob).hexdigest()

    def _journal_path(self) -> str:
        return os.path.join(self.checkpoint_dir, JOURNAL_NAME)

    def _spill_dir(self, ci: int) -> str:
        return os.path.join(self.checkpoint_dir, "spill", f"chunk_{ci:05d}")

    def _read_journal(self, stamp: str) -> Set[int]:
        """Completed chunk ids from a valid journal; a stamp mismatch (other
        plan/store/engine) discards the journal rather than mixing state.

        Parsed line by line: a kill mid-append leaves a torn final line, and
        that must cost exactly the one uncommitted chunk — not every chunk
        before it.  Parsing stops at the first undecodable line; everything
        already read stays resumable (the append-only protocol guarantees
        all prior lines are complete).  The valid prefix length is kept in
        ``_journal_keep_bytes`` so ``_start_journal`` can truncate the torn
        tail before new lines append onto it."""
        path = self._journal_path()
        self._journal_keep_bytes = None
        if not os.path.exists(path):
            return set()
        lines = []
        keep = 0
        try:
            with open(path, "rb") as f:
                for raw in f:
                    if not raw.endswith(b"\n"):
                        break            # unterminated tail: treat as torn
                    ln = raw.decode("utf-8", errors="replace")
                    if not ln.strip():
                        keep += len(raw)
                        continue
                    try:
                        lines.append(json.loads(ln))
                    except json.JSONDecodeError:
                        break            # torn tail: keep the valid prefix
                    keep += len(raw)
            self._journal_keep_bytes = keep
        except OSError:
            return set()
        if not lines or lines[0].get("kind") != "header" \
                or lines[0].get("stamp") != stamp:
            return set()
        done: Set[int] = set()
        for ln in lines[1:]:
            if ln.get("kind") == "chunk":
                done.add(int(ln["index"]))
        return done

    def _start_journal(self, stamp: str, resumed: Set[int]) -> None:
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        path = self._journal_path()
        if resumed:
            # keep appending to the valid journal — after cutting off any
            # torn tail, or the next append would concatenate onto it and
            # corrupt a good record
            keep = getattr(self, "_journal_keep_bytes", None)
            if keep is not None and keep < os.path.getsize(path):
                with open(path, "r+b") as f:
                    f.truncate(keep)
                    f.flush()
                    os.fsync(f.fileno())
            return
        with open(path, "w") as f:
            f.write(json.dumps({"kind": "header", "stamp": stamp,
                                "n_chunks": self.store.n_chunks}) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def _commit_chunk(self, ci: int, vals: Dict[int, Any],
                      counts: Dict[int, int],
                      stats: Dict[int, Dict[str, int]],
                      shapes: Dict[int, int]) -> None:
        """Spill chunk ci's kept values, then append+fsync the journal line.
        The line is written only after the spill completes, so a kill at any
        point leaves either a resumable chunk or a re-executable one."""
        sd = self._spill_dir(ci)
        os.makedirs(sd, exist_ok=True)
        table_ids = []
        for nid, v in vals.items():
            if isinstance(v, ColumnarTable):
                save_columnar_arrays(v.columns, v.valid,
                                     os.path.join(sd, f"table_{nid}"),
                                     compressed=False)
                table_ids.append(nid)
        bits = {str(nid): host_words(v) for nid, v in vals.items()
                if not isinstance(v, ColumnarTable)}
        np.savez(os.path.join(sd, "bits"), **bits)
        meta = {"counts": {str(k): int(v) for k, v in counts.items()},
                "stats": {str(k): {kk: int(vv) for kk, vv in d.items()}
                          for k, d in stats.items()},
                "shapes": {str(k): int(v) for k, v in shapes.items()},
                "tables": table_ids}
        tmp = os.path.join(sd, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(sd, "meta.json"))
        # the rename itself must be durable before the journal line commits
        # the chunk, or a crash could journal a chunk whose meta.json the
        # directory never learned about
        _fsync_dir(sd)
        with open(self._journal_path(), "a") as f:
            f.write(json.dumps({"kind": "chunk", "index": ci}) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def _load_spill(self, ci: int):
        """A journaled chunk's values (on the device), counts, stats and
        table capacities."""
        sd = self._spill_dir(ci)
        with open(os.path.join(sd, "meta.json")) as f:
            meta = json.load(f)
        vals: Dict[int, Any] = {}
        for nid in meta["tables"]:
            cols, valid = load_columnar_arrays(
                os.path.join(sd, f"table_{nid}"))
            vals[int(nid)] = ColumnarTable.from_columns(cols, valid=valid,
                                                        device=self.device)
        with np.load(os.path.join(sd, "bits.npz")) as z:
            for k in z.files:
                vals[int(k)] = torch.from_numpy(
                    z[k].view(np.int32).copy()).to(self.device)
        counts = {int(k): int(v) for k, v in meta["counts"].items()}
        stats = {int(k): dict(d) for k, d in meta["stats"].items()}
        shapes = {int(k): int(v) for k, v in meta["shapes"].items()}
        return vals, counts, stats, shapes

    # -- the run -------------------------------------------------------------
    def run(self, study, tables: Optional[Dict[str, ColumnarTable]] = None,
            log: Optional[OperationLog] = None):
        """Execute ``study`` over the store; returns its ``StudyResult``
        (bit-identical valid rows / cohort words / counts / stats to
        ``Study.run`` over the unpartitioned star).  ``self.report`` holds
        the timing + resume audit afterwards."""
        store = self.store
        store.validate()
        dev = self.device
        resident = self._resident_env(study, tables)
        plan = self._plan(study, resident)
        dep = chunk_dependent_ids(plan, store.source)
        plan = _unwrap_compacted_concats(plan, dep)
        self._preflight(study, plan,
                        self._chunk_env(resident, self._schema_table()))

        keep = _executor.keep_ids(plan)
        cohort_keep = {i for i in keep if plan.nodes[i].op in COHORT_OPS}
        log = log if log is not None else OperationLog()
        rep = self.report = ChunkedReport(n_chunks=store.n_chunks)
        compiles0 = _executor.jit_cache_info()["compiles"]

        stamp = self._stamp(plan, study.n_patients)
        done: Set[int] = set()
        if self.checkpoint_dir is not None:
            done = self._read_journal(stamp)
            self._start_journal(stamp, done)

        # merge state (tables and words stay on the device)
        assembled: Dict[int, _Assembly] = {}
        dep_parts: Dict[int, Dict[int, ColumnarTable]] = {}  # unaligned
        indep_vals: Dict[int, Any] = {}
        bits_acc: Dict[int, torch.Tensor] = {}
        counts_dep: Dict[int, int] = {}
        counts_indep: Dict[int, int] = {}
        stats_dep: Dict[int, Dict[str, int]] = {}
        stats_indep: Dict[int, Dict[str, int]] = {}
        shapes: Dict[int, int] = {}

        def merge(ci: int, vals: Dict[int, Any], counts: Dict[int, int],
                  stats: Dict[int, Dict[str, int]]) -> None:
            for nid, v in vals.items():
                if nid in cohort_keep or not isinstance(v, ColumnarTable):
                    bits_acc[nid] = v if nid not in bits_acc \
                        else bits_acc[nid] | v
                elif nid in dep:
                    rep.rows += int(counts.get(nid, 0))
                    if nid not in assembled and nid not in dep_parts:
                        layout = _assembly_layout(plan, nid, dep, shapes,
                                                  store.n_chunks)
                        if layout is None:
                            dep_parts[nid] = {}
                        else:
                            assembled[nid] = _Assembly(*layout, v)
                    if nid in assembled:
                        assembled[nid].add(ci, v)
                    else:
                        dep_parts[nid][ci] = v
                elif nid not in indep_vals:
                    indep_vals[nid] = v
            for nid, c in counts.items():
                if nid in dep:
                    counts_dep[nid] = counts_dep.get(nid, 0) + int(c)
                elif nid not in counts_indep:
                    counts_indep[nid] = int(c)
            for nid, d in stats.items():
                if nid in dep:
                    stats_dep[nid] = _sum_stats(stats_dep.get(nid, {}), d)
                elif nid not in stats_indep:
                    stats_indep[nid] = {k: int(v) for k, v in d.items()}

        for ci in sorted(done):
            vals, counts, stats, spilled_shapes = self._load_spill(ci)
            if not shapes:
                shapes.update(spilled_shapes)
            merge(ci, vals, counts, stats)
            rep.resumed += 1
            log.record(op=f"chunked:resume:{ci}", inputs={}, outputs={},
                       params={"chunk": ci, "rows":
                               store.manifest.chunks[ci].rows})

        todo = [ci for ci in range(store.n_chunks) if ci not in done]
        loader = _Loader(store, dev)
        cuda = dev.type == "cuda"

        def sync_default() -> None:
            if cuda:
                torch.cuda.current_stream(dev).synchronize()

        pool = ThreadPoolExecutor(max_workers=1) if self.prefetch and todo \
            else None
        if cuda:
            torch.cuda.synchronize(dev)
        t_loop = time.perf_counter()
        try:
            fut = pool.submit(loader.stage, todo[0], 0) if pool else None
            for pos, ci in enumerate(todo):
                if self.crash_after is not None and \
                        rep.executed >= self.crash_after:
                    raise _InjectedCrash(
                        f"injected crash after {rep.executed} chunks")
                if fut is not None:
                    staged = fut.result()
                    if pos + 1 < len(todo):
                        fut = pool.submit(loader.stage, todo[pos + 1],
                                          (pos + 1) % 2)
                    chunk = loader.get(staged)
                    load_s = None
                else:
                    t0 = time.perf_counter()
                    staged = loader.stage(ci, 0)
                    if staged[2] is not None:
                        staged[2].synchronize()
                    chunk = loader.get(staged)
                    load_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                stats_sink: Dict[int, Dict[str, int]] = {}
                counts: Dict[int, int] = {}
                shape_sink: Dict[int, int] = {}
                vals = _executor.execute(
                    plan, self._chunk_env(resident, chunk),
                    n_patients=study.n_patients, engine=self.engine,
                    log=None, stats_sink=stats_sink,
                    predicate_engine=self.predicate_engine,
                    counts_sink=counts, shape_sink=shape_sink)
                del chunk
                if not shapes:
                    shapes.update(shape_sink)
                if self.checkpoint_dir is not None:
                    self._commit_chunk(ci, vals, counts, stats_sink,
                                       shape_sink)
                merge(ci, vals, counts, stats_sink)
                del vals
                sync_default()
                exec_s = time.perf_counter() - t0
                rep.exec_s += exec_s
                rep.executed += 1
                params = {"chunk": ci, "exec_s": round(exec_s, 6)}
                if load_s is not None:
                    rep.load_s += load_s
                    params["load_s"] = round(load_s, 6)
                log.record(op=f"chunked:chunk:{ci}", inputs={}, outputs={},
                           params=params)
        finally:
            if pool:
                pool.shutdown(wait=True, cancel_futures=True)
        if cuda:
            torch.cuda.synchronize(dev)
        rep.wall_s = time.perf_counter() - t_loop
        if self.prefetch:
            # the prefetch thread's reads plus the copies' device times
            rep.load_s = loader.read_s + (loader.copy_s() if cuda else 0.0)
        rep.compiles = _executor.jit_cache_info()["compiles"] - compiles0

        # -- merge into one StudyResult -------------------------------------
        merged_vals: Dict[int, Any] = dict(indep_vals)
        for nid, a in assembled.items():
            merged_vals[nid] = a.table()
            # a concat's per-chunk count sum double-counts its
            # chunk-independent branches; the merged popcount is exact
            counts_dep[nid] = int(merged_vals[nid].count)
        for nid, by_chunk in dep_parts.items():
            parts = [by_chunk[ci] for ci in sorted(by_chunk)]
            merged_vals[nid] = (parts[0] if len(parts) == 1
                                else ColumnarTable.concat(parts))
        assembled.clear()
        dep_parts.clear()
        words, cohort_counts = _replay_cohorts(
            plan, {i: w for i, w in bits_acc.items()
                   if plan.nodes[i].op == "cohort_from_events"}, self.engine)
        for nid, w in bits_acc.items():
            merged_vals[nid] = words.get(nid, w)

        counts = dict(counts_indep)
        counts.update(counts_dep)
        counts.update(cohort_counts)
        counts = {i: counts[i] for i in sorted(counts)}   # node order
        join_stats = dict(stats_indep)
        join_stats.update(stats_dep)
        _executor.record_plan(plan, counts, log, self.engine,
                              stats=join_stats,
                              predicate_engine=self.predicate_engine,
                              device=dev)
        for i, d in join_stats.items():
            d.setdefault("stage", plan.nodes[i].label())
        log.record(op="chunked:summary", inputs={}, outputs={},
                   params=rep.to_json())
        return study._finish_result(plan, merged_vals, join_stats, log)
