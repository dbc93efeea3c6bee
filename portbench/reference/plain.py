"""Plain PyTorch versions of the operations the cells' studies use.

A table is a dict of equal-length column tensors whose rows are all valid;
an output keeps the rows it keeps, in a stated order.  Nothing here reads
the program: the operations follow the semantics the port documents (paper
§3.3-3.5), written the direct way, with one tensor op a step and, for the
fractures' washout, a loop.  Each function takes the integer dtype the
columns come in, so the control can run the same code over int16 copies of
the int32 columns.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

Table = Dict[str, torch.Tensor]

NULL_INT = -2_147_483_648 + 1
STATS = ("rows_in", "rows_out", "matched", "overflow", "null_keys",
         "key_sum_in", "key_sum_out")

# event categories (paper §3.4)
DRUG_DISPENSE, MEDICAL_ACT, DIAGNOSIS, HOSPITAL_STAY = 1, 2, 3, 4
FOLLOW_UP, EXPOSURE, OUTCOME_FRACTURE = 10, 11, 12


def nrows(t: Table) -> int:
    return int(next(iter(t.values())).shape[0])


def null_of(col: torch.Tensor) -> int:
    """The NULL sentinel of a column's dtype (the control's int16 columns
    hold theirs at the type's minimum)."""
    return -32768 if col.dtype == torch.int16 else NULL_INT


def is_null(col: torch.Tensor) -> torch.Tensor:
    return col == null_of(col)


def checksum(keys: torch.Tensor) -> int:
    """The sum of the keys' 32-bit patterns modulo 2**32."""
    return int(((keys.to(torch.int64) & 0xFFFFFFFF).sum() % (1 << 32)).item())


def take(t: Table, idx: torch.Tensor) -> Table:
    return {k: v[idx] for k, v in t.items()}


def lexsort(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row order by the columns, most significant first, ties in row
    order."""
    n = cols[0].shape[0]
    order = torch.arange(n, device=cols[0].device)
    for c in reversed(list(cols)):
        order = order[torch.argsort(c[order], stable=True)]
    return order


def lookup_join(left: Table, right: Table, lkey: str, rkey: str):
    """Left join on a right side with at most one row a key: every left
    row stays, in order; a NULL key never matches; misses get NULLs."""
    lk, rk = left[lkey], right[rkey]
    l_null, r_null = is_null(lk), is_null(rk)
    r_ok = ~r_null & (rk >= 0)           # ids are never negative
    rk_ok = rk[r_ok].to(torch.int64)
    rows_ok = torch.nonzero(r_ok).flatten()
    size = int(rk_ok.max().item()) + 1 if rk_ok.numel() else 1
    slot = torch.full((size,), -1, dtype=torch.int64, device=lk.device)
    slot[rk_ok] = rows_ok
    li = lk.to(torch.int64)
    inside = ~l_null & (li >= 0) & (li < size)
    pos = torch.where(inside, slot[li.clamp(0, size - 1)], -1)
    found = pos >= 0
    out = dict(left)
    for name, col in right.items():
        if name != rkey:
            out[name] = torch.where(found, col[pos.clamp(min=0)],
                                    null_of(col))
    n = nrows(left)
    ks = checksum(lk)
    stats = {"rows_in": n, "rows_out": n, "matched": int(found.sum()),
             "overflow": 0,
             "null_keys": int(l_null.sum()) + int(r_null.sum()),
             "key_sum_in": ks, "key_sum_out": ks}
    return out, stats


def expand_join(left: Table, right: Table, lkey: str, rkey: str):
    """Left join on a right side with any number of rows a key: one output
    row a (left row, matching right row) pair, left rows in order and each
    one's matches in right-table order; an unmatched left row gives one row
    with NULLs.  No row is lost (overflow 0)."""
    lk, rk = left[lkey], right[rkey]
    l_null, r_null = is_null(lk), is_null(rk)
    nn = torch.nonzero(~r_null & (rk >= 0)).flatten()
    rkn = rk[nn].to(torch.int64)
    order = nn[torch.argsort(rkn, stable=True)]
    size = int(rkn.max().item()) + 1 if rkn.numel() else 1
    per_key = torch.bincount(rkn, minlength=size)
    first_of_key = torch.cumsum(per_key, 0) - per_key
    li = lk.to(torch.int64)
    inside = ~l_null & (li >= 0) & (li < size)
    lic = li.clamp(0, size - 1)
    c = torch.where(inside, per_key[lic], 0)
    out_c = c.clamp(min=1)
    L = nrows(left)
    src = torch.repeat_interleave(torch.arange(L, device=lk.device), out_c)
    offs = torch.cumsum(out_c, 0) - out_c
    rank = torch.arange(src.shape[0], device=lk.device) - offs[src]
    has = c[src] > 0
    ridx = order[(first_of_key[lic[src]] + rank).clamp(0, max(order.shape[0] - 1, 0))] \
        if order.numel() else torch.zeros_like(src)
    out = take(left, src)
    for name, col in right.items():
        if name != rkey:
            out[name] = torch.where(has, col[ridx], null_of(col))
    stats = {"rows_in": L, "rows_out": int(src.shape[0]),
             "matched": int((c > 0).sum()), "overflow": 0,
             "null_keys": int(l_null.sum()) + int(r_null.sum()),
             "key_sum_in": checksum(lk), "key_sum_out": checksum(out[lkey])}
    return out, stats


def flatten(star: Dict[str, Table], central: str, joins) -> tuple:
    """The flat table of one sub-database and each join's stats, in the
    schema's join order.  ``joins``: (right table, left key, right key,
    one-to-many)."""
    t, stats = star[central], []
    for right, lkey, rkey, many in joins:
        t, s = (expand_join if many else lookup_join)(t, star[right], lkey,
                                                      rkey)
        stats.append(s)
    return t, stats


def events(t: Table, idx: torch.Tensor, category: int, value: str,
           start: str, end: Optional[str] = None, group: Optional[str] = None
           ) -> Table:
    """The standard event rows (paper §3.4) of the rows ``idx``."""
    n = idx.shape[0]
    dev = idx.device
    i32 = torch.int32
    return {
        "patient_id": t["patient_id"][idx],
        "category": torch.full((n,), category, dtype=i32, device=dev),
        "group_id": t[group][idx] if group else torch.zeros(n, dtype=i32,
                                                             device=dev),
        "value": t[value][idx],
        "weight": torch.ones(n, dtype=torch.float32, device=dev),
        "start": t[start][idx],
        "end": t[end][idx] if end else torch.full((n,), NULL_INT, dtype=i32,
                                                  device=dev),
    }


def extract(flat: Table, category: int, value: str, start: str,
            null_cols: Sequence[str] = (), codes: Optional[Sequence[int]] = None,
            where: Optional[torch.Tensor] = None, end: Optional[str] = None,
            group: Optional[str] = None, distinct: Sequence[str] = ()) -> Table:
    """An extractor: rows with no NULL in ``null_cols`` (the value column
    when none is given), whose value is in ``codes`` and where ``where``
    holds, as events in table order; with ``distinct``, the first row of
    each distinct key, in key order."""
    keep = torch.ones(nrows(flat), dtype=torch.bool, device=flat[value].device)
    for c in (null_cols or (value,)):
        keep &= ~is_null(flat[c])
    if codes is not None:
        wl = torch.as_tensor(list(codes), device=keep.device).to(flat[value].dtype)
        keep &= torch.isin(flat[value], wl)
    if where is not None:
        keep &= where
    idx = torch.nonzero(keep).flatten()
    if distinct:
        idx = idx[lexsort([flat[k][idx] for k in distinct])]
        diff = torch.zeros(idx.shape[0], dtype=torch.bool, device=idx.device)
        diff[0:1] = True
        for k in distinct:
            v = flat[k][idx]
            diff[1:] |= v[1:] != v[:-1]
        idx = idx[diff]
    return events(flat, idx, category, value, start, end, group)


def patients(ir_ben: Table) -> Table:
    """The patient table: one row a patient id, by id."""
    cols = ("patient_id", "gender", "birth_date", "death_date")
    pid = ir_ben["patient_id"]
    order = torch.argsort(pid, stable=True)
    p = pid[order]
    head = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
    head[1:] = p[1:] != p[:-1]
    idx = order[head]
    return {c: ir_ben[c][idx] for c in cols}


def subjects(pid: torch.Tensor, n_patients: int) -> torch.Tensor:
    """Membership mask of the patients with a row."""
    mask = torch.zeros(n_patients, dtype=torch.bool, device=pid.device)
    i = pid.to(torch.int64)
    mask[i[(i >= 0) & (i < n_patients)]] = True
    return mask


def flow(masks: List[torch.Tensor]) -> List[int]:
    """Subjects left after each stage of the left fold of intersections."""
    out, cur = [], None
    for m in masks:
        cur = m if cur is None else cur & m
        out.append(int(cur.sum()))
    return out


def where_rows(t: Table, keep: torch.Tensor) -> Table:
    return take(t, torch.nonzero(keep).flatten())


def concat(*tables: Table) -> Table:
    return {k: torch.cat([t[k] for t in tables]) for k in tables[0]}


def as_int16(star: Dict[str, Table]) -> Dict[str, Table]:
    """The control's star: every int32 column as int16, the integer width
    below the configuration's int32 (half the bytes a column: the step a
    bandwidth-bound port is tempted by); values wrap, NULLs keep a NULL."""
    def narrow(v):
        if v.dtype != torch.int32:
            return v
        return torch.where(v == NULL_INT, -32768, v).to(torch.int16)

    return {name: {k: narrow(v) for k, v in t.items()}
            for name, t in star.items()}
