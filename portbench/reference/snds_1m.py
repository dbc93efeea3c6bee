"""Plain reference of the configuration ``snds_1m``: DCIR and PMSI-MCO
stars, flattened once (``setup_answer``), and the paper's cohort study over
the flat tables (``answer``): extractions, exposures, fractures, follow-up,
cohorts, flow, the dense design matrix and the token streams.

The study's window is ``[14600, 14600 + 3 * 365)``.  Outputs whose row
order is a matter of the implementation (the transforms') are compared as
sets of rows; the rest in order.  With ``control``, every int32 column is
int16 first (see ``dcir_2m``).
"""
from __future__ import annotations

import torch

from portbench.reference import plain as p
from portbench.reference.dcir_2m import DCIR_JOINS

PMSI_JOINS = (("MCO_D", "stay_id", "stay_id", True),
              ("MCO_A", "stay_id", "stay_id", True))
T0, T1 = 14_600, 14_600 + 3 * 365
N_SITES, WASHOUT = 8, 90
# token = offset + clamp(value, 0, size - 1) by category (the default
# tokenizer: 8 special tokens, then the categories in this order)
TOKENS = {p.DRUG_DISPENSE: (8, 512), p.MEDICAL_ACT: (520, 512),
          p.DIAGNOSIS: (1032, 512), p.HOSPITAL_STAY: (1544, 256),
          p.EXPOSURE: (1800, 512), p.OUTCOME_FRACTURE: (2312, 64)}
PAD, BOS, EOS = 0, 1, 2


class State:
    def __init__(self, star, n_patients: int, control: bool = False):
        self.star = p.as_int16(star) if control else star
        self.n_patients = int(n_patients)
        self.dcir, dstats = p.flatten(self.star, "ER_PRS", DCIR_JOINS)
        self.pmsi, pstats = p.flatten(self.star, "MCO_B", PMSI_JOINS)
        self.stats = dstats + pstats


def prepare(star, cfg, control: bool = False) -> State:
    return State(star, cfg["n_patients"], control)


def setup_answer(s: State):
    """What the set-up's flatten must give: both flat tables and the five
    joins' stats."""
    return {"flat": {"DCIR": s.dcir, "PMSI_MCO": s.pmsi},
            "flatten_stats": [dict(x) for x in s.stats]}


def exposures(ev, purview: int):
    """Dispenses of one (patient, drug) less than ``purview`` days apart
    merge into one exposure: [first, last + purview], weight the count."""
    order = p.lexsort([ev["patient_id"], ev["value"], ev["start"]])
    pid, val, st = (ev[k][order] for k in ("patient_id", "value", "start"))
    new = torch.ones(pid.shape[0], dtype=torch.bool, device=pid.device)
    new[1:] = ((pid[1:] != pid[:-1]) | (val[1:] != val[:-1])
               | (st[1:] - st[:-1] > purview))
    eid = torch.cumsum(new.to(torch.int64), 0) - 1
    n = int(new.sum())
    count = torch.bincount(eid, minlength=n)
    last_row = torch.cumsum(count, 0) - 1
    i32 = torch.int32
    return {"patient_id": pid[new], "category": torch.full(
                (n,), p.EXPOSURE, dtype=i32, device=pid.device),
            "group_id": torch.zeros(n, dtype=i32, device=pid.device),
            "value": val[new], "weight": count.to(torch.float32),
            "start": st[new], "end": st[last_row] + purview}


def fractures(acts, diags, act_codes, diag_codes):
    """Fracture candidates (acts and diagnoses of the given codes, in that
    order), body site = code mod 8; per (patient, site), by date, keep the
    first and then each next one at least the washout after the last kept."""
    def pick(ev, codes):
        wl = torch.as_tensor(list(codes), device=ev["value"].device).to(
            ev["value"].dtype)
        return p.where_rows(ev, torch.isin(ev["value"], wl))

    c = p.concat(*[{k: t[k] for k in ("patient_id", "value", "start")}
                   for t in (pick(acts, act_codes), pick(diags, diag_codes))])
    site = torch.remainder(c["value"], N_SITES)
    order = p.lexsort([c["patient_id"], site, c["start"]])
    pid, st = c["patient_id"][order].tolist(), c["start"][order].tolist()
    sites = site[order].tolist()
    keep, last, group = [], None, None
    for i, (a, b, d) in enumerate(zip(pid, sites, st)):
        if (a, b) != group:
            group, last = (a, b), d
            keep.append(i)
        elif d - last >= WASHOUT:
            last = d
            keep.append(i)
    idx = order[torch.as_tensor(keep, dtype=torch.int64,
                                device=order.device)]
    n = idx.shape[0]
    i32 = torch.int32
    dev = idx.device
    return {"patient_id": c["patient_id"][idx],
            "category": torch.full((n,), p.OUTCOME_FRACTURE, dtype=i32,
                                   device=dev),
            "group_id": site[idx], "value": c["value"][idx],
            "weight": torch.ones(n, dtype=torch.float32, device=dev),
            "start": c["start"][idx],
            "end": torch.full((n,), p.NULL_INT, dtype=i32, device=dev)}


def follow_up(pats, ev, P: int):
    """Per patient with an event: [first event, min(death, study end)),
    kept where it is not empty."""
    dev = ev["start"].device
    pid = ev["patient_id"].to(torch.int64)
    inside = (pid >= 0) & (pid < P)
    pid, start = pid[inside], ev["start"][inside].to(torch.int64)
    first = torch.full((P,), 2 ** 31 - 1, dtype=torch.int64, device=dev)
    if pid.numel():
        first = first.scatter_reduce(0, pid, start, "amin")
    has = torch.bincount(pid, minlength=P) > 0
    death = torch.full((P,), p.NULL_INT, dtype=torch.int64, device=dev)
    death[pats["patient_id"].to(torch.int64)] = pats["death_date"].to(
        torch.int64)
    end = torch.where(death == p.NULL_INT, T1, death.clamp(max=T1))
    ok = has & (first < end)
    idx = torch.nonzero(ok).flatten()
    n = idx.shape[0]
    i32 = torch.int32
    return {"patient_id": idx.to(i32),
            "category": torch.full((n,), p.FOLLOW_UP, dtype=i32, device=dev),
            "group_id": torch.zeros(n, dtype=i32, device=dev),
            "value": torch.zeros(n, dtype=i32, device=dev),
            "weight": torch.ones(n, dtype=torch.float32, device=dev),
            "start": first[idx].to(i32), "end": end[idx].to(i32)}


def _checked(ev):
    st, en = ev["start"], ev["end"]
    in_window = (st >= T0) & (st < T1)
    dates_ok = p.is_null(en) | (en >= st)
    checks = {"events_total": p.nrows(ev),
              "events_out_of_window": int((~in_window).sum()),
              "events_bad_dates": int((~dates_ok).sum())}
    return p.where_rows(ev, in_window & dates_ok), checks


def dense(ev, P: int):
    """(patients, 36 buckets of 31 days, 128 features) sums of weights."""
    kept, checks = _checked(ev)
    b = torch.div(kept["start"].to(torch.int64) - T0, 31,
                  rounding_mode="floor").clamp(0, 35)
    f = kept["value"].to(torch.int64).clamp(0, 127)
    pid = kept["patient_id"].to(torch.int64).clamp(0, P - 1)
    X = torch.zeros(P * 36 * 128, dtype=torch.float32, device=b.device)
    if pid.numel():       # an empty scatter is refused by some launches
        X.index_add_(0, (pid * 36 + b) * 128 + f,
                     kept["weight"].to(torch.float32))
    return X.view(P, 36, 128), checks


def tokens(ev, P: int, seq_len: int = 256):
    """BOS, each event's token by (start, category, value), EOS, PAD."""
    kept, checks = _checked(ev)
    cat, val = kept["category"].to(torch.int64), kept["value"].to(torch.int64)
    tok = torch.full_like(cat, PAD)
    for c, (off, size) in TOKENS.items():
        tok = torch.where(cat == c, off + val.clamp(0, size - 1), tok)
    known = tok != PAD
    order = p.lexsort([kept["patient_id"], kept["start"], kept["category"],
                       kept["value"]])
    pid = kept["patient_id"].to(torch.int64)
    order = order[(known & (pid >= 0) & (pid < P))[order]]
    pid = pid[order]
    tok = tok[order]
    count = torch.bincount(pid, minlength=P)
    rank = torch.arange(pid.shape[0], device=pid.device) - (
        torch.cumsum(count, 0) - count)[pid]
    fits = rank < seq_len - 2
    out = torch.full((P, seq_len), PAD, dtype=torch.int32, device=pid.device)
    if fits.any():
        out[pid[fits], 1 + rank[fits]] = tok[fits].to(torch.int32)
    out[:, 0] = BOS
    eos = (count + 1).clamp(1, seq_len - 1)
    out[torch.arange(P, device=pid.device), eos] = EOS
    mask = torch.arange(seq_len, device=pid.device)[None, :] <= eos[:, None]
    checks = dict(checks, events_truncated=int((~fits).sum()))
    return (out, mask), checks


def cohort(s: State, q):
    P = s.n_patients
    dcir, pmsi = s.dcir, s.pmsi
    pats = p.patients(s.star["IR_BEN"])
    drugs = p.extract(dcir, p.DRUG_DISPENSE, "cip13", "execution_date",
                      null_cols=("cip13",))
    wl = torch.as_tensor(q["atc_classes"], device=dcir["atc_class"].device)
    prevalent = p.extract(
        dcir, p.DRUG_DISPENSE, "cip13", "execution_date", null_cols=("cip13",),
        where=torch.isin(dcir["atc_class"], wl.to(dcir["atc_class"].dtype))
        & (dcir["execution_date"] >= T0) & (dcir["execution_date"] < T1))
    acts = p.extract(dcir, p.MEDICAL_ACT, "ccam_code", "execution_date",
                     null_cols=("ccam_code",))
    h_acts = p.extract(pmsi, p.MEDICAL_ACT, "ccam_code", "act_date",
                       null_cols=("ccam_code",),
                       distinct=("stay_id", "ccam_code", "act_date"))
    diags = p.extract(pmsi, p.DIAGNOSIS, "icd_code", "stay_start",
                      null_cols=("icd_code",), group="diag_kind",
                      distinct=("stay_id", "icd_code", "diag_kind"))
    stays = p.extract(pmsi, p.HOSPITAL_STAY, "ghm_code", "stay_start",
                      end="stay_end", distinct=("stay_id",))
    expo = exposures(drugs, int(q["purview_days"]))
    all_acts = p.concat(acts, h_acts)
    frac = fractures(all_acts, diags, q["fracture_acts"], q["fracture_diags"])
    fu = follow_up(pats, drugs, P)
    base = p.subjects(pats["patient_id"], P)
    exposed = p.subjects(expo["patient_id"], P)
    fractured = p.subjects(frac["patient_id"], P)
    final = exposed & base & ~fractured
    # the final cohort's events: the exposures of its patients, in order
    fin_ev = p.where_rows(expo, final[expo["patient_id"].to(torch.int64)])
    X, x_checks = dense(fin_ev, P)
    toks, t_checks = tokens(fin_ev, P)
    return {"events": {"extract_patients": pats, "drug_purchases": drugs,
                       "prevalent_drugs": prevalent, "acts": acts,
                       "hospital_acts": h_acts, "diagnoses": diags,
                       "stays": stays, "exposures": expo, "all_acts": all_acts,
                       "fractures": frac, "follow_up": fu},
            "cohorts": {"base": base, "exposed": exposed,
                        "fractured": fractured, "final": final},
            "flow": p.flow([base, exposed, final]),
            "flatten_stats": [], "features": {"X": X, "tokens": toks},
            "feature_checks": {"X": x_checks, "tokens": t_checks},
            "unordered": ("exposures", "fractures", "follow_up")}


SHAPES = {"cohort": cohort}


def answer(s: State, q):
    return SHAPES[q["shape"]](s, q)
