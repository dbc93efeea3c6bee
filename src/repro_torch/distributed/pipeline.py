"""Sharded study-plan execution over a ``torch.distributed`` process group.

The port of ``repro.distributed.pipeline``'s study half
(``pad_tables_for_mesh``, ``execute_plan_sharded``).  The mesh is a process
group: its size is the shard count and every rank runs this code on its own
device.  Where the reference's ``shard_map`` splits each source over the
mesh axis, each rank takes its contiguous row block of every source
(``shard_rows``); ``psum`` becomes ``comm.all_reduce_sum``, and a
``P(axis)`` table output becomes a ``ShardedTable``: each rank keeps its own
block, and ``gather()`` concatenates the blocks where a caller needs the
whole table.

Part 2, the pipeline-parallel model stack: ``gpipe`` and
``pipeline_transformer`` over a mesh axis ("pipe"), each rank one stage
holding a contiguous block of layers.  The schedule is the reference's
GPipe fill-drain: ``M + P - 1`` ticks for M microbatches over P stages
(bubble ``(P - 1) / (M + P - 1)``); at tick t stage s runs microbatch
``t - s``, and every stage runs every tick, on zeros or a spent
microbatch in the bubble, as the reference's does; activations hop s -> s
+ 1 through ``comm.ppermute`` between ticks; the last stage's outputs are
summed to every rank.  Gradients flow back through the hops: every
hop's backward is a collective, so each rank anchors the hops whose
outputs it does not use (stage 0 never reads one) to its result, and
every rank runs all of them, in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import bitset as _bs
from repro_torch.core.columnar import ColumnarTable
from repro_torch.distributed import comm

__all__ = ["execute_plan_sharded", "run_shard", "pad_tables_for_mesh",
           "shard_rows", "gather_table", "ShardedTable", "gpipe",
           "pipeline_transformer"]

_M32 = 1 << 32


def pad_tables_for_mesh(tables: Mapping[str, ColumnarTable], n_shards: int
                        ) -> Dict[str, ColumnarTable]:
    """Pad table capacities to a multiple of ``32 * n_shards`` so the packed
    validity words split across the shards exactly on row boundaries (each
    shard's word slice is the bitset of its local rows).  Idempotent."""
    quantum = 32 * int(n_shards)
    out = {}
    for name, t in tables.items():
        cap = -(-t.capacity // quantum) * quantum
        out[name] = t.pad_to(cap) if cap != t.capacity else t
    return out


def shard_rows(table: ColumnarTable, rank: int, n_shards: int
               ) -> ColumnarTable:
    """Rank ``rank``'s contiguous row block of a table whose capacity is a
    multiple of ``32 * n_shards`` (views, no copy)."""
    if table.capacity % (32 * n_shards):
        raise ValueError(f"capacity {table.capacity} is not a multiple of "
                         f"32 x {n_shards}; pad_tables_for_mesh first")
    lc = table.capacity // n_shards
    lo = rank * lc
    words = table.valid[lo // 32:(lo + lc) // 32]
    return ColumnarTable({k: v[lo:lo + lc] for k, v in table.columns.items()},
                         words, _bs.count(words), lc)


def gather_table(table: ColumnarTable, group) -> ColumnarTable:
    """Every rank's table (equal schemas and 32-aligned capacities),
    concatenated in rank order, with the popcount as its count; one
    all-gather per column and one for the validity words."""
    n = comm.world_size(group)
    if table.capacity % 32:
        raise ValueError(f"gather_table needs a 32-aligned capacity, got "
                         f"{table.capacity}")
    cols = {k: comm.all_gather_cat(v, group)
            for k, v in table.columns.items()}
    words = comm.all_gather_cat(table.valid, group)
    return ColumnarTable(cols, words, _bs.count(words), n * table.capacity)


@dataclasses.dataclass
class ShardedTable:
    """A table sharded over a process group, as seen from one rank: the
    counterpart of the reference's ``ColumnarTable`` over ``P(axis)``
    arrays.  ``block`` is this rank's rows (a 32-aligned capacity, its own
    count), ``count`` the global count, and ``gather()`` the whole table:
    every rank's block in rank order, on every rank (a collective: every
    rank of ``group`` calls it)."""

    block: ColumnarTable
    group: Any
    count: int

    def gather(self) -> ColumnarTable:
        return gather_table(self.block, self.group)


def _aligned(t: ColumnarTable) -> ColumnarTable:
    """32-align the local capacity so the shard-concatenated validity words
    stay row-exact."""
    cap = -(-t.capacity // 32) * 32
    return t if cap == t.capacity else t.pad_to(cap)


def _output_ids(plan) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The nodes a sharded run hands back: the event tables (named table
    outputs and the tables cohorts are built from) and the cohort bitsets
    that cross shards (base cohorts and named cohort outputs; interior
    ``cohort_op`` bits stay local, the Study layer replays the algebra)."""
    from repro_torch.study.plan import COHORT_OPS, TABLE_OPS

    out_ids = {i for _, i in plan.outputs}
    table_ids = {i for i in out_ids if plan.nodes[i].op in TABLE_OPS}
    cohort_ids = tuple(i for i, nd in enumerate(plan.nodes)
                       if nd.op == "cohort_from_events"
                       or (nd.op in COHORT_OPS and i in out_ids))
    ev_ids = tuple(sorted(table_ids | {
        nd.inputs[0] for nd in plan.nodes if nd.op == "cohort_from_events"}))
    return ev_ids, cohort_ids


def run_shard(plan, local: Mapping[str, ColumnarTable], n_patients: int,
              engine: str, predicate_engine: str, group, *,
              cached: Optional[Dict[int, ColumnarTable]] = None,
              cuts: Tuple[int, ...] = ()):
    """Run ``plan`` over this rank's row blocks ``local``: the shard-local
    runner of ``execute_plan_sharded`` and of the sharded query service.

    Every rank of ``group`` calls it with the same plan (its exchanges are
    all-to-alls over the group).  ``cached`` maps node ids to this rank's
    blocks of earlier results (the service's cache hits): such a node takes
    its block and does not evaluate, and contributes no stats.  Returns,
    with no gather:

    - ``t_out``: every event table (``_output_ids``) as this rank's block,
      its capacity 32-aligned;
    - ``b_out``: the cohort words, summed over the group (each patient lives
      on one shard, so the int32 sum of the disjoint partial bitsets is
      their OR);
    - ``c_out``, ``s_out``: every node's count and every stat, global, from
      one int64 sum over the group (host ints; the uint32 ``key_sum*``
      checksums modulo 2**32);
    - ``cut_out``: the blocks of the ``cuts`` nodes, as computed (or as
      cached)."""
    from repro_torch.study.executor import env_device, run_plan_body

    ev_ids, cohort_ids = _output_ids(plan)
    device = env_device(local)
    vals, counts, stats = run_plan_body(
        plan, dict(local), n_patients, engine, n_shards=comm.world_size(group),
        predicate_engine=predicate_engine, group=group, cached=cached,
        keep=tuple(sorted(set(ev_ids) | set(cohort_ids) | set(cuts))))
    cut_out = {i: vals[i] for i in cuts}
    t_out = {i: _aligned(vals.pop(i)) for i in ev_ids}
    b_out = {}
    if cohort_ids:
        words = comm.all_reduce_sum(
            torch.cat([vals[i] for i in cohort_ids]), group)
        for i, w in zip(cohort_ids,
                        words.split([vals[i].shape[0] for i in cohort_ids])):
            b_out[i] = w
    del vals
    # every count and stat in one int64 sum
    ids = tuple(sorted(counts))
    flat = [(i, k) for i in sorted(stats) for k in stats[i]]
    vec = torch.stack([counts[i].to(device, torch.int64) for i in ids]
                      + [stats[i][k].to(device, torch.int64)
                         for i, k in flat])
    host = comm.all_reduce_sum(vec, group).cpu().tolist()
    c_out = dict(zip(ids, host[:len(ids)]))
    s_out: Dict[int, Dict[str, int]] = {}
    for (i, k), v in zip(flat, host[len(ids):]):
        s_out.setdefault(i, {})[k] = v % _M32 if k.startswith("key_sum") else v
    return t_out, b_out, c_out, s_out, cut_out


def execute_plan_sharded(plan, tables, n_patients: int, mesh,
                         axis_name: str = "data", engine: str = "torch",
                         predicate_engine=None):
    """Execute a study ``Plan`` shard-local on every rank of ``mesh``.

    Requirement (as for ``transformers.exposures_sharded``): the event
    tables are patient-partitioned once the plan's exchanges ran, so every
    per-patient operation is shard-local.  Cross-shard stitches are sums
    only: each patient lives on one shard, so partial subject bitsets are
    disjoint and their int32 sum is their OR; local counts, stats and
    overflows sum to the global ones (the uint32 key checksums modulo
    2**32).

    ``axis_name`` is kept for the reference's signature: the group alone
    gives the shard count and makes the exchanges real.  Every rank passes
    the same global ``tables`` (every rank planned from
    them, so the plans agree); each pads them to ``32 * n`` rows and runs
    its row block (``run_shard``).  Each table output stays on its rank as a
    ``ShardedTable``: the rank's block, 32-aligned, with the global count;
    cohort words come back summed, whole on every rank.  Returns ``(vals,
    counts, stats)`` shaped like the local executor's (counts and stats as
    host ints) so ``Study.run`` shares its realization path."""
    from repro_torch.kernels import predicate as _pk
    from repro_torch.study.executor import (cached_executable, env_device,
                                            traced_ids)

    n = comm.world_size(mesh)
    me = dist.get_rank(mesh)
    missing = [s for s in plan.sources() if s not in tables]
    if missing:
        raise KeyError(f"plan scans source(s) {missing} but run() only got "
                       f"{sorted(tables)}")
    env = pad_tables_for_mesh({s: tables[s] for s in plan.sources()}, n)
    local = {s: shard_rows(t, me, n) for s, t in env.items()}
    device = env_device(local)
    peng = _pk.resolve_engine(predicate_engine, engine, device)
    key = (plan.key(), n_patients, engine, peng, comm.group_key(mesh),
           str(device))

    def build():
        def run(local, group):
            return run_shard(plan, local, n_patients, engine, peng, group)[:4]

        return run

    fn = cached_executable(key, build)
    t_out, b_out, c_out, s_out = fn(local, mesh)
    counts = {i: int(c_out[i]) for i in traced_ids(plan)}
    vals = {i: ShardedTable(t, mesh, counts[i]) for i, t in t_out.items()}
    vals.update(b_out)
    return vals, counts, s_out


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------
class _Anchor(torch.autograd.Function):
    """``out`` unchanged, with ``extras`` made its inputs: the backward
    reaches them (with zero gradients) without touching the numbers."""

    @staticmethod
    def forward(ctx, out, *extras):
        ctx.shapes = [(e.shape, e.dtype, e.device) for e in extras]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v)
                     for s, d, v in ctx.shapes))


def gpipe(stage_fn, mesh, n_stages: int, axis_name: str = "pipe"):
    """A pipelined apply ``run(stage_params, mbs) -> outs``.

    ``stage_fn(params_one_stage, x_mb) -> y_mb`` (same shape as x_mb);
    ``stage_params``: this rank's block of the params stacked on a leading
    stage axis (extent 1, as ``shard_map`` hands it; ``sharding.block``
    with spec ``(axis_name, ...)``); ``mbs``: ``(M, mb, ...)``
    microbatches, the same on every rank.  ``outs`` (M, mb, ...) is whole
    on every rank."""
    group = mesh.group_of(axis_name)
    stage = mesh.coords[axis_name]
    pairs = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def run(stage_params, mbs):
        from repro_torch.interop import tree_map

        params = tree_map(lambda a: a[0], stage_params)
        M = mbs.shape[0]
        buf = torch.zeros_like(mbs[0])
        outs = [torch.zeros_like(mbs[0])] * M
        spare = []                            # hops this stage never reads
        for t in range(M + n_stages - 1):
            # stage 0 takes microbatch t; the others the hop's buffer
            x_in = mbs[min(t, M - 1)] if stage == 0 else buf
            if stage == 0 and t:
                spare.append(buf)
            y = stage_fn(params, x_in)
            if stage == n_stages - 1 and 0 <= t - stage < M:
                outs[t - stage] = y
            buf = comm.ppermute(y, group, pairs)
        spare.append(buf)
        out = torch.stack(outs) if stage == n_stages - 1 \
            else torch.zeros_like(mbs)
        out = comm.reduce_from(out, group)
        spare = [b for b in spare if b.requires_grad]
        return _Anchor.apply(out, *spare) if spare else out

    return run


def pipeline_transformer(layer_fn, mesh, n_stages: int,
                         axis_name: str = "pipe"):
    """A pipelined stack of identical layers: params stacked (n_stages,
    layers_per_stage, ...); each stage runs its layers in order
    (``layer_fn(layer_params, x)``)."""
    from repro_torch.interop import tree_map
    from repro_torch.train.optimizer import tree_leaves

    def stage_fn(stage_params, x):
        for i in range(tree_leaves(stage_params)[0].shape[0]):
            x = layer_fn(tree_map(lambda a: a[i], stage_params), x)
        return x

    return gpipe(stage_fn, mesh, n_stages, axis_name)
