"""scalpel.stats analogue: patient-centric and event-centric descriptive
statistics over cohorts (paper §3.5 — ">25 statistics", cached, pluggable).

The port of ``repro.core.stats``.  Each statistic is a function ``(cohort,
patients|events) -> dict`` of host values; a tiny registry makes adding a
custom statistic a one-liner.  ``jax.ops.segment_sum`` histograms become
``bincount``-style ``scatter_add_``; float statistics are computed in
float32, as the reference's are (its sums may add in another order, so
they agree to float32 rounding, not bit for bit).

Empty-cohort semantics: every statistic is total over empty cohorts/event
sets and NaN-free.  Ratios and means whose denominator (subject or event
count) is zero return the documented sentinel ``0.0`` / ``0`` alongside an
explicit count key (``n``/``pairs``/…).
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.cohort import Cohort
from repro_torch.core.columnar import ColumnarTable, is_null
from repro_torch.core.events import Category, sort_events
from repro_torch.core.transformers import observation_period, scatter_set

__all__ = ["STATISTICS", "register", "compute", "report",
           "distribution_by_gender_age_bucket"]

STATISTICS: Dict[str, Callable] = {}
_F32 = torch.float32


def register(name: str):
    def deco(fn):
        STATISTICS[name] = fn
        return fn
    return deco


def _valid_mask(t: ColumnarTable) -> torch.Tensor:
    """Per-row validity of a table, memoized on the table instance so the
    registered statistics of one ``compute`` call share ONE expansion of the
    packed validity bitset."""
    m = t.__dict__.get("_stats_valid_cache")
    if m is None:
        m = t.__dict__["_stats_valid_cache"] = t.valid_bool()
    return m


def _cohort_patient_mask(cohort: Cohort, patients: ColumnarTable) -> torch.Tensor:
    """Cohort-membership mask over the patients table's rows, memoized per
    (cohort, patients) pair; the patients table is held by weak reference."""
    cached = cohort.__dict__.get("_patient_mask_cache")
    if cached is not None and cached[0]() is patients:
        return cached[1]
    mask = cohort.subjects_mask()
    idx = torch.clamp(patients.columns["patient_id"], 0, cohort.n_patients - 1)
    m = _valid_mask(patients) & mask[idx.to(torch.int64)]
    cohort.__dict__["_patient_mask_cache"] = (weakref.ref(patients), m)
    return m


def _hist(mask: torch.Tensor, bucket: torch.Tensor, n: int) -> torch.Tensor:
    """``segment_sum(mask.astype(int32), bucket, n)`` for in-range buckets."""
    out = torch.zeros((n,), dtype=torch.int32, device=mask.device)
    return out.scatter_add_(0, bucket.to(torch.int64), mask.to(torch.int32))


def _div32(a, b) -> float:
    """``float(a / b)`` of two int32 scalars in the reference: float32."""
    return float(torch.tensor(int(a), dtype=_F32) / torch.tensor(int(b),
                                                                 dtype=_F32))


# -- patient-centric ----------------------------------------------------------
@register("gender_distribution")
def gender_distribution(cohort: Cohort, patients: ColumnarTable, **_) -> Dict:
    m = _cohort_patient_mask(cohort, patients)
    g = patients.columns["gender"]
    return {"male": int((m & (g == 1)).sum()),
            "female": int((m & (g == 2)).sum())}


def _age_bucket(patients: ColumnarTable, ref_date: int, bucket_years: int,
                n_buckets: int) -> torch.Tensor:
    age = torch.div(ref_date - patients.columns["birth_date"], 365,
                    rounding_mode="floor")
    return torch.clamp(torch.div(age, bucket_years, rounding_mode="floor"),
                       0, n_buckets - 1)


@register("age_buckets")
def age_buckets(cohort: Cohort, patients: ColumnarTable, ref_date: int = 14_600,
                bucket_years: int = 10, n_buckets: int = 11, **_) -> Dict:
    m = _cohort_patient_mask(cohort, patients)
    hist = _hist(m, _age_bucket(patients, ref_date, bucket_years, n_buckets),
                 n_buckets).tolist()
    return {f"{i*bucket_years}-{(i+1)*bucket_years-1}": int(hist[i])
            for i in range(n_buckets)}


@register("mortality")
def mortality(cohort: Cohort, patients: ColumnarTable, **_) -> Dict:
    m = _cohort_patient_mask(cohort, patients)
    dead = m & ~is_null(patients.columns["death_date"])
    return {"dead": int(dead.sum()), "alive": int((m & ~dead).sum())}


# -- event-centric ------------------------------------------------------------
def _cohort_events(cohort: Cohort) -> ColumnarTable:
    if cohort.events is None:
        raise ValueError(f"cohort {cohort.name} carries no events")
    return cohort.events


def _category_hist(ev: ColumnarTable) -> list:
    return _hist(_valid_mask(ev), torch.clamp(ev.columns["category"], 0, 15),
                 16).tolist()


@register("events_per_category")
def events_per_category(cohort: Cohort, *_, **__) -> Dict:
    hist = _category_hist(_cohort_events(cohort))
    return {Category.NAMES.get(i, str(i)): int(hist[i]) for i in range(16)
            if int(hist[i])}


def _per_patient_counts(cohort: Cohort) -> torch.Tensor:
    ev = _cohort_events(cohort)
    P = cohort.n_patients
    seg = torch.where(_valid_mask(ev), ev.columns["patient_id"], P)
    return _hist(torch.ones_like(seg, dtype=torch.bool),
                 torch.clamp(seg, 0, P), P + 1)[:P]


@register("events_per_patient")
def events_per_patient(cohort: Cohort, *_, **__) -> Dict:
    per = _per_patient_counts(cohort)
    total = int(per.sum())
    n = int((per > 0).sum())
    return {
        "patients_with_events": n,
        "mean": _div32(total, max(n, 1)),
        "max": int(per.max()),
    }


@register("events_per_month")
def events_per_month(cohort: Cohort, *_, t0: int = 14_600, n_months: int = 37,
                     **__) -> Dict:
    ev = _cohort_events(cohort)
    m = torch.clamp(torch.div(ev.columns["start"] - t0, 30,
                              rounding_mode="floor"), 0, n_months - 1)
    return {"per_month": _hist(_valid_mask(ev), m, n_months).tolist()}


@register("top_values")
def top_values(cohort: Cohort, *_, k: int = 10, n_codes: int = 4096, **__
               ) -> Dict:
    ev = _cohort_events(cohort)
    v = torch.clamp(ev.columns["value"], 0, n_codes - 1)
    hist = _hist(_valid_mask(ev), v, n_codes).cpu().numpy()
    # jnp.argsort is stable: ties keep code order
    top = np.argsort(-hist, kind="stable")[:k]
    return {int(c): int(hist[c]) for c in top if int(hist[c]) > 0}


# -- driver -------------------------------------------------------------------
def compute(cohort: Cohort, patients: Optional[ColumnarTable] = None,
            names: Optional[list] = None, **kw) -> Dict[str, Dict]:
    out = {}
    for name in names or list(STATISTICS):
        fn = STATISTICS[name]
        try:
            out[name] = fn(cohort, patients, **kw)
        except (ValueError, TypeError):
            continue  # statistic not applicable (e.g. no events attached)
    return out


def report(cohort: Cohort, patients: Optional[ColumnarTable] = None, **kw) -> str:
    """Automatic textual report (the paper's automated audit reports)."""
    stats = compute(cohort, patients, **kw)
    lines = [f"cohort {cohort.name!r}: {cohort.subject_count()} subjects",
             f"  {cohort.description}"]
    for name, d in stats.items():
        lines.append(f"  [{name}]")
        for k, v in d.items():
            lines.append(f"    {k}: {v}")
    return "\n".join(lines)


def distribution_by_gender_age_bucket(cohort: Cohort, patients: ColumnarTable,
                                      ref_date: int = 14_600) -> Dict:
    """The Supplementary-A figure: age-bucket histogram split by gender."""
    out = {}
    b = _age_bucket(patients, ref_date, 10, 11)
    for gname, gval in (("male", 1), ("female", 2)):
        m = _cohort_patient_mask(cohort, patients) & \
            (patients.columns["gender"] == gval)
        out[gname] = _hist(m, b, 11).tolist()
    return out


# -- extended statistics battery ----------------------------------------------
@register("age_mean")
def age_mean(cohort: Cohort, patients: ColumnarTable, ref_date: int = 14_600,
             **_):
    """Mean/std of age at ``ref_date``.  Empty cohort: sentinel
    ``{"mean": 0.0, "std": 0.0, "n": 0}`` — never NaN."""
    m = _cohort_patient_mask(cohort, patients)
    n_true = int(m.sum())
    if n_true == 0:
        return {"mean": 0.0, "std": 0.0, "n": 0}
    age = (ref_date - patients.columns["birth_date"]).to(_F32) / 365.0
    zero = torch.zeros((), dtype=_F32, device=age.device)
    mean = torch.where(m, age, zero).sum() / n_true
    var = torch.where(m, (age - mean) ** 2, zero).sum() / n_true
    return {"mean": float(mean), "std": float(torch.sqrt(var)), "n": n_true}


@register("subject_count")
def subject_count(cohort: Cohort, *_, **__):
    return {"subjects": cohort.subject_count()}


@register("events_total")
def events_total(cohort: Cohort, *_, **__):
    return {"events": int(_cohort_events(cohort).count)}


@register("events_per_patient_percentiles")
def events_per_patient_percentiles(cohort: Cohort, *_, **__):
    """Event-count percentiles over patients with >=1 event; sentinel
    ``p50=p90=p99=0`` with ``n=0`` when there are none."""
    per = _per_patient_counts(cohort).cpu().numpy()
    per = per[per > 0]
    if per.size == 0:
        return {"p50": 0, "p90": 0, "p99": 0, "n": 0}
    out = {f"p{p}": int(np.percentile(per, p)) for p in (50, 90, 99)}
    out["n"] = int(per.size)
    return out


@register("distinct_values")
def distinct_values(cohort: Cohort, *_, n_codes: int = 65_536, **__):
    ev = _cohort_events(cohort)
    v = torch.clamp(ev.columns["value"], 0, n_codes - 1)
    return {"distinct": int((_hist(_valid_mask(ev), v, n_codes) > 0).sum())}


@register("first_event_date")
def first_event_date(cohort: Cohort, *_, **__):
    ev = _cohort_events(cohort)
    s = torch.where(_valid_mask(ev), ev.columns["start"], 2_000_000_000)
    return {"min_start": int(s.min())}


@register("last_event_date")
def last_event_date(cohort: Cohort, *_, **__):
    ev = _cohort_events(cohort)
    s = torch.where(_valid_mask(ev), ev.columns["start"], -2_000_000_000)
    return {"max_start": int(s.max())}


@register("event_duration")
def event_duration(cohort: Cohort, *_, **__):
    ev = _cohort_events(cohort)
    longi = _valid_mask(ev) & ~is_null(ev.columns["end"])
    dur = torch.where(longi, ev.columns["end"] - ev.columns["start"], 0)
    n_long = int(longi.sum())
    # int32 sum, as the reference's
    total = int(dur.sum()) & 0xFFFFFFFF
    total = total - 2 ** 32 if total >= 2 ** 31 else total
    return {"longitudinal": n_long, "mean_days": _div32(total, max(n_long, 1))}


@register("weight_total")
def weight_total(cohort: Cohort, *_, **__):
    ev = _cohort_events(cohort)
    w = ev.columns["weight"]
    return {"weight_sum": float(torch.where(_valid_mask(ev), w,
                                            torch.zeros_like(w)).sum())}


@register("events_by_gender")
def events_by_gender(cohort: Cohort, patients: ColumnarTable, **_):
    ev = _cohort_events(cohort)
    P = cohort.n_patients
    pid = torch.clamp(ev.columns["patient_id"], 0, P - 1).to(torch.int64)
    pidx = torch.where(_valid_mask(patients), patients.columns["patient_id"], P)
    g_dense = scatter_set(torch.zeros((P,), dtype=torch.int32,
                                      device=pid.device),
                          pidx, patients.columns["gender"])
    g = g_dense[pid]
    vm = _valid_mask(ev)
    return {"male_events": int((vm & (g == 1)).sum()),
            "female_events": int((vm & (g == 2)).sum())}


@register("events_per_year")
def events_per_year(cohort: Cohort, *_, t0: int = 14_600, **__):
    ev = _cohort_events(cohort)
    y = torch.clamp(torch.div(ev.columns["start"] - t0, 365,
                              rounding_mode="floor"), 0, 3)
    hist = _hist(_valid_mask(ev), y, 4).tolist()
    return {f"year_{i}": int(hist[i]) for i in range(4)}


@register("group_distribution")
def group_distribution(cohort: Cohort, *_, n_groups: int = 16, **__):
    ev = _cohort_events(cohort)
    g = torch.clamp(ev.columns["group_id"], 0, n_groups - 1)
    hist = _hist(_valid_mask(ev), g, n_groups).tolist()
    return {int(i): int(hist[i]) for i in range(n_groups) if int(hist[i])}


@register("patients_without_events")
def patients_without_events(cohort: Cohort, *_, **__):
    per = _per_patient_counts(cohort)
    mask = cohort.subjects_mask()
    return {"in_cohort_without_events": int((mask & (per == 0)).sum())}


@register("mean_gap_days")
def mean_gap_days(cohort: Cohort, *_, **__):
    """Mean gap between a patient's consecutive events; sentinel
    ``{"mean_gap": 0.0, "pairs": 0}`` when no consecutive pair exists."""
    ev = sort_events(_cohort_events(cohort))
    pid, start = ev.columns["patient_id"], ev.columns["start"]
    vm = ev.valid_bool()
    no = torch.zeros((1,), dtype=torch.bool, device=vm.device)
    same = torch.cat([no, (pid[1:] == pid[:-1]) & vm[:-1]]) & vm
    pairs = int(same.sum())
    if pairs == 0:
        return {"mean_gap": 0.0, "pairs": 0}
    prev = torch.cat([torch.zeros((1,), dtype=start.dtype, device=vm.device),
                      start[:-1]])
    gaps = torch.where(same, start - prev, 0)
    total = int(gaps.sum()) & 0xFFFFFFFF            # int32 sum
    total = total - 2 ** 32 if total >= 2 ** 31 else total
    return {"mean_gap": _div32(total, pairs), "pairs": pairs}


@register("mortality_rate")
def mortality_rate(cohort: Cohort, patients: ColumnarTable, **_):
    m = _cohort_patient_mask(cohort, patients)
    dead = int((m & ~is_null(patients.columns["death_date"])).sum())
    return {"rate": _div32(dead, max(int(m.sum()), 1))}


@register("gender_ratio")
def gender_ratio(cohort: Cohort, patients: ColumnarTable, **_):
    """Male fraction of the cohort; sentinel ``{"male_fraction": 0.0,
    "n": 0}`` when no subject is gendered."""
    d = gender_distribution(cohort, patients)
    tot = d["male"] + d["female"]
    if tot == 0:
        return {"male_fraction": 0.0, "n": 0}
    return {"male_fraction": round(d["male"] / tot, 4), "n": tot}


@register("value_range")
def value_range(cohort: Cohort, *_, **__):
    ev = _cohort_events(cohort)
    v = ev.columns["value"]
    vm = _valid_mask(ev)
    return {"min": int(torch.where(vm, v, 2 ** 30).min()),
            "max": int(torch.where(vm, v, -2 ** 30).max())}


@register("events_per_category_per_patient")
def events_per_category_per_patient(cohort: Cohort, *_, **__):
    hist = _category_hist(_cohort_events(cohort))
    n = max(cohort.subject_count(), 1)
    return {Category.NAMES.get(i, str(i)): round(float(hist[i]) / n, 3)
            for i in range(16) if int(hist[i])}


@register("age_at_first_event")
def age_at_first_event(cohort: Cohort, patients: ColumnarTable, **_):
    ev = _cohort_events(cohort)
    P = cohort.n_patients
    obs = observation_period(ev, P)
    pidx = torch.where(_valid_mask(patients), patients.columns["patient_id"], P)
    birth = scatter_set(torch.zeros((P,), dtype=torch.int32,
                                    device=pidx.device),
                        pidx, patients.columns["birth_date"])
    age = (obs.columns["start"] - birth).to(_F32) / 365.0
    om = _valid_mask(obs)
    n = max(int(om.sum()), 1)
    return {"mean": float(torch.where(om, age, torch.zeros_like(age)).sum()
                          / n)}


@register("top_patients_by_events")
def top_patients_by_events(cohort: Cohort, *_, k: int = 5, **__):
    per = _per_patient_counts(cohort).cpu().numpy()
    top = np.argsort(-per)[:k]
    return {int(p): int(per[p]) for p in top if per[p] > 0}
