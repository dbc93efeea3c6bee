"""SCALPEL-Extraction Transformers: ``List[Event] -> List[Event]`` per patient.

The port of ``repro.core.transformers``.  With events sorted by
``(patient, ...)`` every per-patient fold is a segment operation:
``jax.ops.segment_min/max/sum`` become ``scatter_reduce`` into tensors
pre-filled with the same identities (``INT32_MAX`` for min, ``INT32_MIN``
for max, 0 for sum), so empty segments hold exactly the reference's values.

``exposures`` (and ``drug_prescriptions`` through it) takes the executor's
``engine``: under ``"cuda"`` its five per-exposure folds become one launch of
the segmented-scan kernel B4 (``kernels/segment_scan``), read at each run's
last row.  ``fractures``' greedy washout chain, a sequential ``lax.scan`` in
the reference, is a frontier walk here: one vectorised step per link of the
longest chain.

Implemented (paper Table 4): observation period, follow-up, trackloss,
exposures (limited/unlimited), fractures-per-body-site outcome, drug
prescriptions and interactions, bladder cancer, infarctus, heart failure.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.columnar import ColumnarTable, NULL_INT, is_null
from repro_torch.core.events import Category, make_events, sort_events

__all__ = [
    "observation_period", "follow_up", "trackloss", "exposures", "fractures",
    "drug_prescriptions", "drug_interactions", "bladder_cancer", "infarctus",
    "heart_failure", "drop_index", "scatter_set", "SPARE_SLOTS",
    "exposures_sharded",
]

_BIG = 2_000_000_000
_I32_MAX = 2 ** 31 - 1
_I32_MIN = -2 ** 31
_I32 = torch.int32


def _seg(x, seg, num, valid, reduce, masked, identity) -> torch.Tensor:
    src = torch.where(valid, x, masked).to(_I32)
    out = torch.full((num,), identity, dtype=_I32, device=x.device)
    return out.scatter_reduce_(0, seg.to(torch.int64), src, reduce=reduce,
                               include_self=True)


def _seg_min(x, seg, num, valid):
    return _seg(x, seg, num, valid, "amin", _BIG, _I32_MAX)


def _seg_max(x, seg, num, valid):
    return _seg(x, seg, num, valid, "amax", -_BIG, _I32_MIN)


def _seg_sum(x, seg, num, valid):
    return _seg(x, seg, num, valid, "sum", 0, 0)


def _clip_seg(events: ColumnarTable, n_patients: int) -> torch.Tensor:
    seg = torch.clamp(events.columns["patient_id"], 0, n_patients - 1)
    return torch.where(events.valid_bool(), seg, n_patients - 1)


def _prepend(x: torch.Tensor, fill) -> torch.Tensor:
    """``fill`` followed by ``x``: a per-pair tensor (``n - 1`` rows) as a
    per-row one, or ``x[i-1]`` when given ``x[:-1]``."""
    head = torch.full((1,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([head, x])


SPARE_SLOTS = 1024


def drop_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """A ``mode="drop"`` scatter index into ``size + SPARE_SLOTS`` slots: a
    negative index counts from the end, and one still out of ``[0, size)``
    goes to a spare slot past ``size``.  The spare slots are spread by row,
    so that rows dropped by the million (a table's invalid tail) do not all
    contend for one atomic address on the card."""
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + size, i)
    rows = torch.arange(i.shape[0], dtype=torch.int64, device=i.device)
    return torch.where((i >= 0) & (i < size), i,
                       size + (rows & (SPARE_SLOTS - 1)))


def scatter_set(base: torch.Tensor, idx: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].set(src, mode="drop")`` as the reference computes it
    (``drop_index``), where of several rows aimed at one slot the last one
    wins — a fixed order on every device, where ``index_put_`` leaves it
    open."""
    n = base.shape[0]
    if src.shape[0] == 0:
        return base.clone()
    rows = torch.arange(src.shape[0], dtype=torch.int64, device=base.device)
    win = torch.full((n + SPARE_SLOTS,), -1, dtype=torch.int64,
                     device=base.device)
    win = win.scatter_reduce_(0, drop_index(idx, n), rows, reduce="amax",
                              include_self=True)[:n]
    return torch.where(win >= 0, src[torch.clamp(win, min=0)], base)


# ---------------------------------------------------------------------------
def observation_period(events: ColumnarTable, n_patients: int) -> ColumnarTable:
    """Per-patient [first event, last event] continuous event (Table 4)."""
    seg = _clip_seg(events, n_patients)
    ev_valid = events.valid_bool()
    start, end = events.columns["start"], events.columns["end"]
    first = _seg_min(start, seg, n_patients, ev_valid)
    last_s = _seg_max(start, seg, n_patients, ev_valid)
    last_e = _seg_max(torch.where(is_null(end), start, end), seg, n_patients,
                      ev_valid)
    cnt = _seg_sum(torch.ones_like(seg), seg, n_patients, ev_valid)
    pid = torch.arange(n_patients, dtype=_I32, device=start.device)
    return make_events(
        patient_id=pid, category=Category.OBSERVATION,
        value=torch.zeros_like(pid), start=first,
        end=torch.maximum(last_s, last_e), weight=cnt.to(torch.float32),
        valid=cnt > 0,
    )


def follow_up(patients: ColumnarTable, events: ColumnarTable, n_patients: int,
              study_end: int, delay_days: int = 0) -> ColumnarTable:
    """Follow-up window per patient: [first event + delay, min(death, end)]."""
    obs = observation_period(events, n_patients)
    start = obs.columns["start"] + int(delay_days)
    dev = start.device
    pidx = torch.where(patients.valid_bool(), patients.columns["patient_id"],
                       n_patients)
    death = scatter_set(torch.full((n_patients,), NULL_INT, dtype=_I32,
                                   device=dev),
                        pidx, patients.columns["death_date"])
    end = torch.where(is_null(death),
                      torch.full_like(death, int(study_end)),
                      torch.clamp(death, max=int(study_end)))
    valid = obs.valid_bool() & (start < end)
    pid = torch.arange(n_patients, dtype=_I32, device=dev)
    return make_events(
        patient_id=pid, category=Category.FOLLOW_UP, value=torch.zeros_like(pid),
        start=start, end=end, valid=valid,
    )


def trackloss(dispenses: ColumnarTable, n_patients: int,
              gap_days: int) -> ColumnarTable:
    """Trackloss: a gap > ``gap_days`` between consecutive dispenses of the
    same patient marks loss of follow-up at ``last_seen + gap_days``.

    The earliest-per-patient fold stays a segment reduction: rows whose gap
    is too short stay in place, invalid, yet fold into segment
    ``n_patients - 1``, so its segments are not contiguous runs and B4 does
    not apply."""
    ev = sort_events(dispenses)
    pid, start = ev.columns["patient_id"], ev.columns["start"]
    evv = ev.valid_bool()
    same = _prepend((pid[1:] == pid[:-1]) & evv[:-1], False)
    prev = _prepend(start[:-1], 0)
    gap = torch.where(same & evv, start - prev, torch.zeros_like(start))
    hit = gap > gap_days
    out = make_events(
        patient_id=pid, category=Category.TRACKLOSS,
        value=torch.zeros_like(pid), start=prev + int(gap_days), valid=hit,
    )
    # one trackloss per patient: keep the earliest
    seg = _clip_seg(out, n_patients)
    outv = out.valid_bool()
    first = _seg_min(out.columns["start"], seg, n_patients, outv)
    keep = outv & (out.columns["start"] == first[seg.to(torch.int64)])
    dup = _prepend((seg[1:] == seg[:-1]) & keep[:-1], False)
    return out.filter(keep & ~dup)


def _exposure_folds_scan(start, pid, val, evv, new_exposure, eid, cap):
    """The five per-exposure folds of ``exposures`` from ONE segmented scan.

    After the sort, an exposure's rows form one contiguous run and invalid
    rows sit at the tail, each flagged as a run of its own; the scan's run
    aggregates are exact (``EXACT_FILL``), so the run-end rows carry each
    exposure's first/last start and dispense count, and its patient and drug
    (constant within a run).  They are scattered into ``eid``-indexed arrays
    pre-filled with the segment identities, as ``segment_min/max/sum``
    leaves an empty segment."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.segment_scan import EXACT_FILL

    flags = new_exposure | ~evv
    mn, mx, cnt = kops.segmented_scan(flags, start, fill=EXACT_FILL)
    is_end = evv & torch.cat([flags[1:], flags.new_ones((1,))])
    slot = torch.where(is_end, eid.to(torch.int64), cap)

    def put(identity, src):
        out = torch.full((cap + 1,), identity, dtype=_I32, device=src.device)
        return out.scatter_(0, slot, src)[:cap]   # non-ends land on slot cap

    first, last, n_disp = put(_I32_MAX, mn), put(_I32_MIN, mx), put(0, cnt)
    e_pid, e_val = put(_I32_MIN, pid), put(_I32_MIN, val)
    # the reference folds the invalid rows, masked to (2e9, -2e9, 0), into
    # the tail segment eid[-1] whenever there are any
    tail = (torch.arange(cap, device=start.device) == eid[-1].to(torch.int64)) \
        & ~evv[-1]
    first = torch.where(tail, torch.clamp(first, max=_BIG), first)
    last = torch.where(tail, torch.clamp(last, min=-_BIG), last)
    e_pid = torch.where(tail, torch.clamp(e_pid, min=-_BIG), e_pid)
    e_val = torch.where(tail, torch.clamp(e_val, min=-_BIG), e_val)
    return first, last, n_disp, e_pid, e_val


def exposures(dispenses: ColumnarTable, n_patients: int,
              purview_days: int = 60, limited: bool = True,
              follow_up_events: Optional[ColumnarTable] = None,
              min_dispenses: int = 1, engine: str = "torch") -> ColumnarTable:
    """Drug-exposure transformer (paper Table 4, 'Limited in time'/'Unlimited').

    Consecutive dispenses of the same (patient, drug) closer than
    ``purview_days`` merge into one exposure interval: sort by (patient,
    drug, date) -> boundary flags -> exposure ids by prefix sum ->
    per-exposure folds, as segment reductions (``engine="torch"``) or one
    segmented-scan kernel launch (``engine="cuda"``)."""
    if engine not in ("torch", "cuda"):
        raise ValueError(f"unknown engine {engine!r}")
    ev = dispenses.sort_by(["patient_id", "value", "start"])
    cap = ev.capacity
    pid, val, start = ev.columns["patient_id"], ev.columns["value"], \
        ev.columns["start"]

    evv = ev.valid_bool()
    same_group = _prepend((pid[1:] == pid[:-1]) & (val[1:] == val[:-1])
                          & evv[:-1], False)
    prev_start = _prepend(start[:-1], 0)
    chained = same_group & (start - prev_start <= purview_days)
    new_exposure = evv & ~chained
    # exposure id per row (0-based); invalid rows ride along harmlessly
    eid = torch.cumsum(new_exposure.to(_I32), 0, dtype=_I32) - 1
    eid = torch.clamp(eid, 0, cap - 1)

    if engine == "cuda" and cap:
        first, last, n_disp, e_pid, e_val = _exposure_folds_scan(
            start, pid, val, evv, new_exposure, eid, cap)
    else:
        first = _seg_min(start, eid, cap, evv)
        last = _seg_max(start, eid, cap, evv)
        n_disp = _seg_sum(torch.ones_like(eid), eid, cap, evv)
        e_pid = _seg_max(pid, eid, cap, evv)
        e_val = _seg_max(val, eid, cap, evv)

    end = last + int(purview_days)
    if not limited:
        if follow_up_events is None:
            raise ValueError("unlimited exposures require follow_up_events")
        fu_end = follow_up_events.sort_by(["patient_id"]).columns["end"][
            :n_patients]
        # a gather clamps out-of-range indices, as jnp's does
        idx = torch.clamp(torch.clamp(e_pid, 0, n_patients - 1).to(torch.int64),
                          max=fu_end.shape[0] - 1)
        end = torch.maximum(end, fu_end[idx])

    valid = n_disp >= min_dispenses
    return make_events(
        patient_id=e_pid, category=Category.EXPOSURE, value=e_val,
        start=first, end=end, weight=n_disp.to(torch.float32), valid=valid,
    ).compact()


def exposures_sharded(dispenses: ColumnarTable, n_patients: int, mesh,
                      axis_name: str = "data", **kw):
    """Shard-local ``exposures`` over a *patient-partitioned* event table.

    ``distributed_flatten`` keys its output on ``patient_id``, so every
    patient's events live on one shard and the per-patient fold needs no
    collective: each rank of ``mesh`` (a process group) runs ``exposures``
    on its row block (the capacity padded to ``32 * n`` rows first) and
    keeps it: the result is a ``distributed.ShardedTable`` with the global
    count (one summed scalar), whose ``gather()`` concatenates the blocks in
    rank order.  ``axis_name`` is kept for the reference's signature;
    ``kw`` goes to ``exposures`` (``engine`` included)."""
    import torch.distributed as dist

    from repro_torch.distributed import comm
    from repro_torch.distributed.pipeline import (ShardedTable,
                                                  pad_tables_for_mesh,
                                                  shard_rows)

    n = comm.world_size(mesh)
    t = pad_tables_for_mesh({"d": dispenses}, n)["d"]
    out = exposures(shard_rows(t, dist.get_rank(mesh), n), n_patients, **kw)
    count = comm.all_reduce_sum(out.count.reshape(1).to(torch.int64), mesh)
    return ShardedTable(out, mesh, int(count))


def _washout_keep(pid: torch.Tensor, site: torch.Tensor, date: torch.Tensor,
                  n_valid: torch.Tensor, washout_days: int) -> torch.Tensor:
    """Rows the reference's greedy washout scan keeps, without its scan.

    Rows are sorted by (patient, site, date), valid ones first.  Within a
    (patient, site) group the scan keeps the head, then from each kept row
    ``i`` the first later row ``j`` whose int32 difference ``date[j] -
    date[i]`` is at least the washout.  Dates ascend within a group, so
    ``d = date[j] - date[i]`` (in int64) lies in ``[0, 2**32)`` and the
    wrapped difference reaches the washout ``w`` exactly for ``d`` in ``[max(w,
    0), 2**31 - 1]`` or ``d >= max(2**31, 2**32 + w)``: two intervals, each
    found by one ``searchsorted`` over the keys ``group * 2**34 + date``.
    The chains then unroll as a frontier walk, one step per link of the
    longest chain."""
    cap = pid.shape[0]
    dev = pid.device
    rows = torch.arange(cap, dtype=torch.int64, device=dev)
    valid = rows < n_valid
    head = valid & _prepend((pid[1:] != pid[:-1]) | (site[1:] != site[:-1]),
                            True)
    group = torch.cumsum(head, 0, dtype=torch.int64)
    t = date.to(torch.int64)
    key = torch.where(valid, (group << 34) + t + 2 ** 31, 2 ** 62)
    w = int(washout_days)

    def in_group(j, upper=None):
        """Row ``j`` exists, is valid and lies in this row's group (and at
        most ``upper`` days after it)."""
        jc = torch.clamp(j, max=cap - 1)
        ok = (j < cap) & valid[jc] & (group[jc] == group)
        return ok & (t[jc] - t <= upper) if upper is not None else ok

    low = max(w, 0)
    j1 = rows + 1 if low == 0 else \
        torch.searchsorted(key, key + low, side="left")
    j2 = torch.searchsorted(key, key + max(2 ** 31, 2 ** 32 + w), side="left")
    nxt = torch.where(in_group(j1, 2 ** 31 - 1), j1,
                      torch.where(in_group(j2), j2, cap))
    nxt = torch.cat([torch.where(valid, nxt, cap), nxt.new_full((1,), cap)])

    kept = torch.zeros((cap + 1,), dtype=torch.bool, device=dev)
    frontier = torch.nonzero(head).flatten()
    while frontier.numel():
        kept[frontier] = True
        frontier = nxt[frontier]
        frontier = frontier[frontier < cap]
    return kept[:cap]


def fractures(acts: ColumnarTable, diags: ColumnarTable,
              fracture_act_codes: Sequence[int],
              fracture_diag_codes: Sequence[int], n_sites: int = 8,
              washout_days: int = 90) -> ColumnarTable:
    """Fracture outcome (paper task (g), algorithm of ref. [9]): fracture
    candidates from medical acts + diagnoses, one outcome per body site per
    washout window (the greedy chain of ``_washout_keep``)."""
    dev = acts.device
    a_codes = torch.as_tensor(np.asarray(fracture_act_codes, np.int32),
                              device=dev)
    d_codes = torch.as_tensor(np.asarray(fracture_diag_codes, np.int32),
                              device=dev)
    a = acts.filter(torch.isin(acts.columns["value"], a_codes))
    d = diags.filter(torch.isin(diags.columns["value"], d_codes))
    cand = ColumnarTable.concat([a.select(["patient_id", "value", "start"]),
                                 d.select(["patient_id", "value", "start"])])
    # body-site mapping: configurable hash of the code space
    site = torch.remainder(cand.columns["value"], int(n_sites)).to(_I32)
    cand = cand.with_columns({"site": site})
    cand = cand.sort_by(["patient_id", "site", "start"])

    keep = _washout_keep(cand.columns["patient_id"], cand.columns["site"],
                         cand.columns["start"], cand.count, washout_days)
    kept = cand.filter(keep)
    return make_events(
        patient_id=kept.columns["patient_id"],
        category=Category.OUTCOME_FRACTURE, value=kept.columns["value"],
        start=kept.columns["start"], group_id=kept.columns["site"],
        valid=kept.valid,
    ).compact()


# --- additional transformers (paper Table 4) ---------------------------------
def drug_prescriptions(dispenses: ColumnarTable, n_patients: int,
                       refill_days: int = 30,
                       engine: str = "torch") -> ColumnarTable:
    """Drug-prescription proxy (Table 4): consecutive dispenses of the same
    drug within ``refill_days`` belong to one prescription; the event spans
    first..last dispense (weight = refill count)."""
    ex = exposures(dispenses, n_patients, purview_days=refill_days,
                   limited=True, engine=engine)
    # re-tag: a prescription ends at its last dispense, not +purview
    end = torch.maximum(ex.columns["end"] - int(refill_days),
                        ex.columns["start"])
    return ColumnarTable(
        {**ex.columns, "end": end,
         "category": torch.full_like(ex.columns["category"],
                                     Category.DRUG_DISPENSE)},
        ex.valid, ex.count, ex.capacity,
    )


def drug_interactions(dispenses: ColumnarTable, n_patients: int,
                      window_days: int = 30) -> ColumnarTable:
    """Drug-interaction events (Table 4): two *different* drugs dispensed to
    the same patient within ``window_days``.  value = pair hash, group =
    other drug."""
    ev = dispenses.sort_by(["patient_id", "start"])
    pid, val, start = ev.columns["patient_id"], ev.columns["value"], \
        ev.columns["start"]
    evv = ev.valid_bool()
    prev_ok = _prepend(evv[:-1], False)
    same_p = _prepend(pid[1:] == pid[:-1], False) & prev_ok
    prev_val = _prepend(val[:-1], 0)
    prev_start = _prepend(start[:-1], 0)
    hit = evv & same_p & (val != prev_val) & \
        (start - prev_start <= window_days)
    pair = torch.minimum(val, prev_val) * 100_003 + torch.maximum(val, prev_val)
    out = make_events(
        patient_id=pid, category=Category.EXPOSURE, value=pair,
        start=start, group_id=prev_val, valid=hit,
    )
    return out.compact()


def _code_outcome(acts: ColumnarTable, diags: ColumnarTable, act_codes,
                  diag_codes, washout_days: int) -> ColumnarTable:
    return fractures(acts, diags, act_codes, diag_codes, n_sites=1,
                     washout_days=washout_days)


def bladder_cancer(acts: ColumnarTable, diags: ColumnarTable,
                   act_codes=(101, 102), diag_codes=(188, 189),
                   washout_days: int = 365) -> ColumnarTable:
    """Bladder-cancer outcome (paper Table 4; act+diagnosis conjunction,
    yearly washout)."""
    return _code_outcome(acts, diags, list(act_codes), list(diag_codes),
                         washout_days)


def _no_rows(t: ColumnarTable) -> ColumnarTable:
    return t.filter(torch.zeros((t.capacity,), dtype=torch.bool,
                                device=t.device))


def infarctus(diags: ColumnarTable, diag_codes=(210, 211, 212),
              washout_days: int = 180) -> ColumnarTable:
    """Myocardial-infarction outcome (Table 4: diagnoses only)."""
    return _code_outcome(_no_rows(diags), diags, [], list(diag_codes),
                         washout_days)


def heart_failure(diags: ColumnarTable, diag_codes=(220, 221),
                  washout_days: int = 180) -> ColumnarTable:
    """Heart-failure outcome (Table 4: diagnoses only)."""
    return _code_outcome(_no_rows(diags), diags, [], list(diag_codes),
                         washout_days)
