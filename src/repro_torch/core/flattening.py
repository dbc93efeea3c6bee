"""SCALPEL-Flattening: denormalization of star-schema claims data.

The port of ``repro.core.flattening``: recursively left-join the dimension
and child tables onto the central fact table once, so later queries are
columnar scans.

  * N:1 join       -> sorted-lookup join (stable sort + searchsorted + gather)
  * 1:N join       -> offset-expansion join (prefix sum over match counts)
  * temporal slice -> per-slice flatten, appended (``flatten_sliced``)
  * monitoring     -> per-stage row counts + modular uint32 key checksums
  * exchange       -> hash partition + all-to-all over a ``torch.distributed``
                      process group (the Spark shuffle), ``distributed_flatten``
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.core import bitset as _bs
from repro_torch.core.columnar import (ColumnarTable, NULL_FLOAT, NULL_INT,
                                       is_null, max_key)
from repro_torch.core.schema import StarSchema

__all__ = [
    "lookup_join",
    "expand_join",
    "flatten_star",
    "flatten_sliced",
    "FlatteningStats",
    "STAT_FIELDS",
    "stats_from_dict",
    "key_checksum",
    "hash_partition",
    "exchange",
    "distributed_flatten",
]


def _sentinel(dtype: torch.dtype):
    return NULL_FLOAT if dtype.is_floating_point else NULL_INT


def key_checksum(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``where(valid, keys as uint32, 0).sum(dtype=uint32)``: the sum of the
    keys' 32-bit patterns modulo 2**32 (NULL_INT keys wrap like any other),
    as a 0-d int64 tensor."""
    k = keys.to(torch.int64) & 0xFFFFFFFF
    return torch.where(valid, k, 0).sum() % (1 << 32)


@dataclasses.dataclass
class FlatteningStats:
    """Monitoring statistics computed along the flattening (paper §3.3)."""

    stage: str
    rows_in: torch.Tensor
    rows_out: torch.Tensor
    matched: torch.Tensor   # left rows that found >=1 (non-null) right match
    overflow: torch.Tensor  # rows dropped because a static capacity was hit
    key_sum_in: torch.Tensor
    key_sum_out: torch.Tensor
    null_keys: torch.Tensor = None  # key-is-NULL rows excluded from matching

    def assert_no_loss(self):
        """Host-side check: every input row survived (paper's no-loss audit)."""
        if int(self.overflow) != 0:
            raise AssertionError(f"stage {self.stage}: {int(self.overflow)} rows overflowed")


# Field order of the per-node stats dicts the plan executor emits.
STAT_FIELDS = ("rows_in", "rows_out", "matched", "overflow", "null_keys",
               "key_sum_in", "key_sum_out")


def stats_from_dict(stage: str, d: Mapping[str, torch.Tensor]) -> FlatteningStats:
    """Rehydrate a FlatteningStats from an executor stats dict."""
    return FlatteningStats(stage=stage, **{k: d[k] for k in STAT_FIELDS})


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _searchsorted(seq: torch.Tensor, values: torch.Tensor,
                  side: str) -> torch.Tensor:
    """``jnp.searchsorted`` (int32 result) on a sorted 1-D tensor."""
    return torch.searchsorted(seq, values.to(seq.dtype), side=side,
                              out_int32=True)


# ---------------------------------------------------------------------------
# N:1 sorted-lookup join (DCIR block-sparse detail tables, patient repository)
# ---------------------------------------------------------------------------
def lookup_join(left: ColumnarTable, right: ColumnarTable, left_key: str,
                right_key: str, prefix: str = ""
                ) -> Tuple[ColumnarTable, FlatteningStats]:
    """Left join where ``right`` has at most one row per key.

    Right is stably sorted by key (invalid rows sink with the max key), left
    keys are located by ``searchsorted``, right attributes gathered, misses
    filled with null sentinels.  A NULL key never matches; null-key rows on
    either side are counted in ``FlatteningStats.null_keys``."""
    dev = left.device
    l_valid = _bs.bit_at(left.valid, _arange(left.capacity, dev))
    r_key_null = is_null(right.columns[right_key]) \
        & _bs.bit_at(right.valid, _arange(right.capacity, dev))
    right = right.filter(~is_null(right.columns[right_key]))
    r = right.sort_by([right_key])
    cap_r = r.capacity
    lk = left.columns[left_key]
    l_key_null = is_null(lk) & l_valid
    if cap_r == 0:  # empty right table: every left row misses
        posc = torch.zeros(left.capacity, dtype=torch.int64, device=dev)
        found = torch.zeros(left.capacity, dtype=torch.bool, device=dev)
        r = r.pad_to(1)
    else:
        rk_col = r.columns[right_key]
        rk = torch.where(_bs.bit_at(r.valid, _arange(cap_r, dev)), rk_col,
                         max_key(rk_col.dtype))
        pos = _searchsorted(rk, lk, "left").to(torch.int64)
        posc = torch.clamp(pos, 0, cap_r - 1)
        found = ((pos < cap_r) & (rk[posc] == lk) & _bs.bit_at(r.valid, posc)
                 & l_valid & ~is_null(lk))

    new_cols = dict(left.columns)
    for name in r.column_names:
        if name == right_key:
            continue
        out_name = prefix + name
        if out_name in new_cols:
            raise ValueError(f"column collision {out_name!r}; pass a prefix")
        col = r.columns[name]
        new_cols[out_name] = torch.where(found, col[posc], _sentinel(col.dtype))

    out = ColumnarTable(new_cols, left.valid, left.count, left.capacity)
    key_sum = key_checksum(lk, l_valid)
    stats = FlatteningStats(
        stage=f"lookup_join[{left_key}]",
        rows_in=left.count,
        rows_out=out.count,
        matched=found.sum().to(torch.int32),
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
        key_sum_in=key_sum,
        key_sum_out=key_sum,  # validity unchanged: identical by construction
        null_keys=(l_key_null.sum() + r_key_null.sum()).to(torch.int32),
    )
    return out, stats


# ---------------------------------------------------------------------------
# 1:N offset-expansion join (PMSI child tables -> the Table-1 blow-up)
# ---------------------------------------------------------------------------
def expand_join(left: ColumnarTable, right: ColumnarTable, left_key: str,
                right_key: str, out_capacity: int, prefix: str = ""
                ) -> Tuple[ColumnarTable, FlatteningStats]:
    """Left join where ``right`` may hold N rows per key; one output row per
    pair.  Match counts come from two ``searchsorted`` passes over the
    sorted right keys, an exclusive prefix sum turns them into output
    offsets, and each output slot finds its (left row, right row) pair by
    binary search.  Unmatched left rows still emit one row; slots past the
    true total are invalid, and ``overflow`` counts rows past
    ``out_capacity``."""
    L = left.capacity
    dev = left.device
    l_valid = _bs.bit_at(left.valid, _arange(L, dev))
    r_key_null = is_null(right.columns[right_key]) \
        & _bs.bit_at(right.valid, _arange(right.capacity, dev))
    right = right.filter(~is_null(right.columns[right_key]))
    if right.capacity == 0:
        right = right.pad_to(1)
    r = right.sort_by([right_key])
    cap_r = r.capacity
    rk_col = r.columns[right_key]
    rk = torch.where(_bs.bit_at(r.valid, _arange(cap_r, dev)), rk_col,
                     max_key(rk_col.dtype))
    lk = left.columns[left_key]
    l_key_null = is_null(lk) & l_valid

    start = _searchsorted(rk, lk, "left")
    stop = _searchsorted(rk, lk, "right")
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    cnt = torch.where(l_valid & ~is_null(lk), stop - start, zero)
    out_cnt = torch.where(l_valid, torch.clamp(cnt, min=1), zero)
    offs = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                      torch.cumsum(out_cnt, 0, dtype=torch.int32)])
    total = offs[-1]

    j = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    src = torch.clamp(_searchsorted(offs, j, "right").to(torch.int64) - 1,
                      0, L - 1)
    rel = j - offs[src]
    has_match = cnt[src] > 0
    ridx = torch.clamp(start[src].to(torch.int64) + rel, 0, cap_r - 1)
    out_valid = (j < total) & l_valid[src]
    right_ok = has_match & out_valid

    new_cols = {k: torch.where(out_valid, v[src], _sentinel(v.dtype))
                for k, v in left.columns.items()}
    for name in r.column_names:
        if name == right_key:
            continue
        out_name = prefix + name
        if out_name in new_cols:
            raise ValueError(f"column collision {out_name!r}; pass a prefix")
        col = r.columns[name]
        new_cols[out_name] = torch.where(right_ok, col[ridx],
                                         _sentinel(col.dtype))

    out = ColumnarTable(new_cols, out_valid, out_valid.sum().to(torch.int32))
    stats = FlatteningStats(
        stage=f"expand_join[{left_key}]",
        rows_in=left.count,
        rows_out=out.count,
        matched=(cnt > 0).sum().to(torch.int32),
        overflow=torch.clamp(total - out_capacity, min=0).to(torch.int32),
        key_sum_in=key_checksum(lk, l_valid),
        key_sum_out=key_checksum(new_cols[left_key], out_valid),
        null_keys=(l_key_null.sum() + r_key_null.sum()).to(torch.int32),
    )
    return out, stats


# ---------------------------------------------------------------------------
# Whole-star flattening
# ---------------------------------------------------------------------------
def _run_flatten_plan(plan, out_id, tables):
    """Execute a flattening plan body and rehydrate its stats."""
    from repro_torch.study.executor import run_plan_body

    env = {s: tables[s] for s in plan.sources()}
    vals, _, stats = run_plan_body(plan, env, 0, "torch", keep=(out_id,))
    stats_list = [stats_from_dict(plan.nodes[i].label(), stats[i])
                  for i in sorted(stats)]
    return vals[out_id], stats_list


def flatten_star(schema: StarSchema, tables: Mapping[str, ColumnarTable],
                 expand_capacity: Optional[int] = None,
                 expand_slack: float = 1.5
                 ) -> Tuple[ColumnarTable, List[FlatteningStats]]:
    """Denormalize one sub-database: sequential joins from the central
    table, built as ``scan_star``/join plan nodes and evaluated at once.
    ``expand_capacity`` bounds each 1:N expansion; when omitted it is derived
    from the table capacities (``(L + R) * expand_slack``)."""
    from repro_torch.study.api import contribute_flatten
    from repro_torch.study.plan import PlanBuilder

    b = PlanBuilder()
    out = contribute_flatten(b, schema, expand_capacity=expand_capacity,
                             expand_slack=expand_slack)
    b.set_output("flat", out)
    return _run_flatten_plan(b.build(), out, tables)


def flatten_sliced(schema: StarSchema, tables: Mapping[str, ColumnarTable],
                   time_column: str, n_slices: int, t0: int, t1: int, **kw
                   ) -> Tuple[ColumnarTable, List[FlatteningStats]]:
    """Temporal slicing (paper §3.3): divide the central table by time unit,
    flatten each slice, and append the results; the capacity planner bounds
    each slice by its actual row count."""
    from repro_torch.study.api import contribute_flatten_sliced
    from repro_torch.study.optimizer import plan_capacities
    from repro_torch.study.plan import PlanBuilder

    b = PlanBuilder()
    out = contribute_flatten_sliced(b, schema, time_column, n_slices, t0, t1,
                                    **kw)
    b.set_output("flat", out)
    plan = plan_capacities(b.build(), tables)
    return _run_flatten_plan(plan, plan.output_ids["flat"], tables)


# ---------------------------------------------------------------------------
# Distributed exchange: the Spark shuffle over a torch.distributed group
# ---------------------------------------------------------------------------
def hash_partition(table: ColumnarTable, key: str, n_shards: int,
                   per_dest_capacity: int, engine: str = "torch"
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                              torch.Tensor]:
    """Bucket rows by ``hash(key) % n_shards`` into a fixed send layout.

    Returns ``(send_cols, send_valid, overflow)``: each send array has shape
    ``(n_shards, per_dest_capacity)``, a destination's rows in their table
    order, empty slots NULL and invalid; rows past a destination's capacity
    are dropped and counted in ``overflow``.  ``engine="torch"`` is the
    reference's route op for op (a stable argsort groups the rows by
    destination); ``engine="cuda"`` takes each row's place from B5 — its
    in-block rank plus its block's offset, an exclusive cumsum of the
    histograms over blocks — and scatters the rows there unsorted, which
    gives the same buffers, since a stable order within a destination is
    the table order."""
    from repro_torch.kernels import hash_partition as _hp
    from repro_torch.kernels import ops as _kops

    if engine not in ("torch", "cuda"):
        raise ValueError(f"unknown engine {engine!r}")
    cap = table.capacity
    dev = table.device
    n, per = int(n_shards), int(per_dest_capacity)
    oob = n * per                       # scatter target for dropped rows
    rows = _arange(cap, dev)
    if engine == "torch":
        dest = _hp.hash_dest(table.columns[key], table.valid_bool(), n)
        order = torch.argsort(dest, stable=True)
        dsort = dest[order]
        group_start = _searchsorted(
            dsort, torch.arange(n + 1, dtype=torch.int32, device=dev), "left")
        pos = rows - group_start[dsort.to(torch.int64)].to(torch.int64)
        ok = (dsort < n) & (pos < per)
        slot = torch.where(ok, dsort.to(torch.int64) * per + pos, oob)
        overflow = ((dsort < n) & ~ok).sum().to(torch.int32)
    else:
        dest, rank, hist = _kops.hash_partition_plan(
            table.columns[key], table.valid.view(torch.uint32), n,
            block=_hp.DEFAULT_BLOCK)
        # per destination, the scan over blocks runs along the inner axis
        # (torch's scan along the outer axis of (blocks, n) is serial)
        hist_t = hist.t().contiguous()
        incl = torch.cumsum(hist_t, 1, dtype=torch.int64)
        offs = (incl - hist_t).reshape(-1)
        routed = dest < n
        d = dest.to(torch.int64).clamp(max=n - 1)
        pos = offs[d * hist.shape[0] + rows // _hp.DEFAULT_BLOCK] + rank
        ok = routed & (pos < per)
        slot = torch.where(ok, d * per + pos, oob)
        order = None
        overflow = torch.clamp(incl[:, -1:] - per, min=0).sum() \
            .to(torch.int32)

    send_valid = torch.zeros((oob + 1,), dtype=torch.bool, device=dev)
    send_valid[slot] = True
    send_cols = {}
    for name, col in table.columns.items():
        buf = torch.full((oob + 1,), _sentinel(col.dtype), dtype=col.dtype,
                         device=dev)
        buf[slot] = col if order is None else col[order]
        send_cols[name] = buf[:oob].reshape(n, per)
    return send_cols, send_valid[:oob].reshape(n, per), overflow


def exchange(table: ColumnarTable, key: str, group, n_shards: int,
             per_dest_capacity: int, engine: str = "torch"
             ) -> Tuple[ColumnarTable, torch.Tensor]:
    """One shuffle: hash-partition + all-to-all + local concatenation.

    Every rank of ``group`` (a ``torch.distributed`` process group of
    ``n_shards`` ranks) calls it; afterwards each holds exactly the rows
    whose key hashes to it, shard ``s``'s block first.  One all-to-all per
    column, and one for the validity (as int8, like the reference's)."""
    from repro_torch.distributed import comm

    if comm.world_size(group) != n_shards:
        raise ValueError(f"exchange over {n_shards} shards needs a group of "
                         f"{n_shards} ranks, got {comm.world_size(group)}")
    send_cols, send_valid, overflow = hash_partition(
        table, key, n_shards, per_dest_capacity, engine=engine)
    cols = {k: comm.all_to_all(v, group).reshape(-1)
            for k, v in send_cols.items()}
    valid = comm.all_to_all(send_valid.to(torch.int8), group).reshape(-1) \
        .to(torch.bool)
    return (ColumnarTable(cols, valid, valid.sum().to(torch.int32)),
            overflow)


def distributed_flatten(schema: StarSchema,
                        tables: Mapping[str, ColumnarTable], mesh,
                        axis_name: str = "data", slack: float = 2.0,
                        min_per_dest: int = 64,
                        expand_capacity: Optional[int] = None,
                        engine: str = "torch"
                        ) -> Tuple[ColumnarTable, torch.Tensor]:
    """Multi-shard denormalization: shuffle every table onto the join key,
    then flatten locally — the SCALPEL-Flattening plan over a process group.

    Builds the exchange-aware flatten plan (exchange both sides of every
    join onto the join key, then one final exchange onto ``patient_id``),
    prunes exchanges whose input is already partitioned on the key, and
    runs it with ``execute_plan_sharded`` on every rank of ``mesh`` (a
    process group).  Returns ``(flat, overflow)``: the flat table,
    patient-partitioned, as a ``distributed.ShardedTable`` (this rank's
    block; ``gather()`` concatenates the blocks in rank order), and the
    summed overflow of every exchange and join."""
    from repro_torch.distributed import comm
    from repro_torch.distributed.pipeline import execute_plan_sharded
    from repro_torch.study.api import contribute_flatten
    from repro_torch.study.optimizer import dce, prune_exchanges
    from repro_torch.study.plan import PlanBuilder

    n = comm.world_size(mesh)
    b = PlanBuilder()
    out = contribute_flatten(b, schema, expand_capacity=expand_capacity,
                             exchange=True, exchange_slack=slack,
                             min_per_dest=min_per_dest)
    b.set_output("flat", out)
    plan = dce(prune_exchanges(b.build(), n_shards=n))
    vals, _, stats = execute_plan_sharded(plan, tables, 0, mesh,
                                          axis_name=axis_name, engine=engine)
    flat = vals[plan.output_ids["flat"]]
    overflow = torch.tensor(sum(s["overflow"] for s in stats.values()),
                            dtype=torch.int32, device=flat.block.device)
    return flat, overflow
