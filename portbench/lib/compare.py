"""The comparison that decides ``correct``.

``digest`` reads what the program's timed path produced (a ``StudyResult``)
the moment the loop keeps it, and keeps only exact checksums of it, so that
the window holds no result: each output table's valid rows (in order, by
blocks, and as a set), each cohort's membership mask, the flow's counts,
the flatten's stats, each feature tensor (by blocks of rows) and the
feature checks.  It unpacks the packed validity and subject words itself,
from the layout the port documents (row ``i`` at word ``i // 32``, bit
``i % 32``), so that a fault in the program's own unpack cannot hide.
``answer_digest`` takes the same checksums of a plain reference's answer;
``compare`` counts what differs, every number held to 0, because the
configurations' guarantees are exact.

The checksums are integer sums (int64, wrapping alike on both sides) of
each value's bits: per block of rows, the total, the row sums weighted by
row and the column sums weighted by column (a value moved to another row or
column changes one of them); a table's set checksum sums a per-row mix of
its columns and that mix squared, whatever the order.
"""
from __future__ import annotations

from typing import Dict

import torch

BLOCK = 1 << 24                # values a checksum block
_MIX = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1,
        0xD3A2646C, 0xFD7046C5, 0xB55A4F09, 0x2545F491, 0x61C88647,
        0x7FEB352D, 0x846CA68B, 0x1B873593)


def _raw(x: torch.Tensor) -> torch.Tensor:
    """A tensor's values as integers of the same bits (floats by their
    bits)."""
    if x.dtype == torch.float32:
        return x.contiguous().view(torch.int32)
    if x.dtype == torch.float64:
        return x.contiguous().view(torch.int64)
    return x


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A tensor's values as int64 bit patterns, flat."""
    return _raw(x).reshape(-1).to(torch.int64)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """Per block of about ``BLOCK`` values (whole rows): the total, the row
    sums weighted by row and the column sums weighted by column."""
    x2 = _raw(x.reshape(x.shape[0], -1) if x.dim() > 1 else x[:, None])
    per = max(1, BLOCK // max(1, x2.shape[1]))
    out = []
    for i in range(0, max(x2.shape[0], 1), per):
        b = x2[i:i + per]
        rs = b.sum(1, dtype=torch.int64)
        cs = b.sum(0, dtype=torch.int64)
        out.append(torch.stack([
            rs.sum(),
            (rs * torch.arange(1, rs.shape[0] + 1, device=b.device)).sum(),
            (cs * torch.arange(1, cs.shape[0] + 1, device=b.device)).sum()]))
    return torch.stack(out).cpu()


def unpack(words: torch.Tensor, n: int) -> torch.Tensor:
    lanes = torch.arange(32, dtype=torch.int64, device=words.device)
    w = words.to(torch.int64) & 0xFFFFFFFF
    return ((w[:, None] >> lanes[None, :]) & 1).to(torch.bool).reshape(-1)[:n]


def table_rows(t) -> Dict[str, torch.Tensor]:
    """A program table's valid rows, in order."""
    valid = t.valid
    mask = unpack(valid, t.capacity) if valid.dtype == torch.int32 else \
        valid.to(torch.bool)
    return {k: v[mask] for k, v in t.columns.items()}


def rows_digest(rows: Dict[str, torch.Tensor], count=None) -> Dict:
    """Checksums of a table's rows: ``n``, the stated count, each column by
    blocks of rows in order, and the set of rows."""
    cols = sorted(rows)
    n = int(rows[cols[0]].shape[0]) if cols else 0
    h = None
    for k, mix in zip(cols, _MIX):
        v = (_bits(rows[k]) & 0xFFFFFFFF) * mix
        h = v if h is None else h * 0x100000001B3 + v
    return {"n": n, "count": n if count is None else int(count),
            "cols": {k: _blocks(rows[k]) for k in cols},
            "set": torch.stack([h.sum(), (h * h).sum()]).cpu()
            if h is not None and n else torch.zeros(2, dtype=torch.int64)}


def _features_digest(features: Dict) -> Dict:
    out = {}
    for name, f in features.items():
        parts = f if isinstance(f, tuple) else (f,)
        out[name] = [(tuple(x.shape), _blocks(x)) for x in parts]
    return out


def digest(result, n_patients: int) -> Dict:
    """The checksums of a program's ``StudyResult``."""
    steps = result.flow.steps if result.flow is not None else []
    return {
        "events": {k: rows_digest(table_rows(t), t.count)
                   for k, t in result.events.items()},
        "cohorts": {k: unpack(c.subjects, n_patients).cpu()
                    for k, c in result.cohorts.items()},
        "flow": [int(unpack(s.subjects, n_patients).sum()) for s in steps]
        if steps else None,
        "flatten_stats": [dict(result.flatten_stats[i])
                          for i in sorted(result.flatten_stats)],
        "features": _features_digest(result.features),
        "feature_checks": {k: dict(v)
                           for k, v in result.feature_checks.items()},
    }


def answer_digest(ans: Dict) -> Dict:
    """The same checksums of a plain reference's answer."""
    return {"events": {k: rows_digest(t) for k, t in ans["events"].items()},
            "cohorts": {k: m.cpu() for k, m in ans["cohorts"].items()},
            "flow": ans["flow"], "flatten_stats": ans["flatten_stats"],
            "features": _features_digest(ans["features"]),
            "feature_checks": ans["feature_checks"],
            "unordered": tuple(ans.get("unordered", ()))}


def tables_differing(a: Dict, b: Dict, ordered: bool = True) -> int:
    """What differs between two tables' checksums: rows one has beyond the
    other, a stated count that is not the rows', and each differing block
    of a column (in order) or the set of rows."""
    bad = abs(a["n"] - b["n"]) + abs(a["count"] - a["n"])
    if sorted(a["cols"]) != sorted(b["cols"]):
        return bad + max(a["n"], b["n"], 1)
    if a["n"] != b["n"]:
        return bad
    if not ordered:
        return bad + int(not torch.equal(a["set"], b["set"]))
    for k in a["cols"]:
        bad += int((a["cols"][k] != b["cols"][k]).any(1).sum())
    return bad


def rows_differing(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
                   ) -> int:
    """Rows of two tables (the same columns) that differ, position by
    position, plus the rows one has beyond the other."""
    cols = sorted(b)
    na = int(next(iter(a.values())).shape[0])
    nb = int(next(iter(b.values())).shape[0])
    if sorted(a) != cols:
        return max(na, nb, 1)
    m = min(na, nb)
    diff = torch.zeros(m, dtype=torch.bool, device=a[cols[0]].device)
    for k in cols:
        diff |= _bits(a[k][:m]) != _bits(b[k][:m].to(a[k].device))
    return abs(na - nb) + int(diff.sum())


def compare(got: Dict, want: Dict, n_patients: int) -> Dict[str, int]:
    """What differs between the program's digest and the reference's, by
    kind; the numbers the limits hold."""
    unordered = set(want.get("unordered", ()))
    events = transforms = 0
    for name in set(got["events"]) | set(want["events"]):
        if name not in got["events"] or name not in want["events"]:
            bad = max((got["events"].get(name) or want["events"][name])["n"], 1)
        else:
            bad = tables_differing(got["events"][name], want["events"][name],
                                   ordered=name not in unordered)
        if name in unordered:
            transforms += bad
        else:
            events += bad
    cohorts = 0
    for name in set(got["cohorts"]) | set(want["cohorts"]):
        if name not in got["cohorts"] or name not in want["cohorts"]:
            cohorts += n_patients
        else:
            cohorts += int((got["cohorts"][name]
                            != want["cohorts"][name]).sum())
    gf, wf = got["flow"] or [], want["flow"] or []
    flow = sum(abs(a - b) for a, b in zip(gf, wf)) + 1_000_000 * abs(
        len(gf) - len(wf))
    gs, ws = got["flatten_stats"], want["flatten_stats"]
    flatten = 7 * abs(len(gs) - len(ws)) + sum(
        int(a.get(k) != b.get(k)) for a, b in zip(gs, ws)
        for k in ("rows_in", "rows_out", "matched", "overflow", "null_keys",
                  "key_sum_in", "key_sum_out"))
    out = {"flatten": flatten, "events": events, "cohorts": cohorts,
           "flow": flow}
    if unordered:
        out["transforms"] = transforms
    if want["features"] or got["features"]:
        out["features"] = features_differing(got, want)
    return out


def features_differing(got: Dict, want: Dict) -> int:
    """Feature tensors of another shape, their differing blocks, and the
    feature checks that differ."""
    bad = 0
    for name in set(got["features"]) | set(want["features"]):
        g, w = got["features"].get(name), want["features"].get(name)
        if g is None or w is None or len(g) != len(w):
            bad += 1
            continue
        for (gs, gb), (ws, wb) in zip(g, w):
            bad += 1 + len(gb) if gs != ws else int((gb != wb).any(1).sum())
    gc, wc = got["feature_checks"], want["feature_checks"]
    for name in set(gc) | set(wc):
        a, b = gc.get(name, {}), wc.get(name, {})
        bad += sum(int(a.get(k) != b.get(k)) for k in set(a) | set(b))
    return bad
