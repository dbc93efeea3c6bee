"""The claims star a cell runs over, made from ``--seed``.

The statistical shape is ``repro_torch.data.synthetic``'s (the SCALPEL3
paper's Table 1 layout: DCIR cash flows with block-sparse pharmacy and act
detail tables, PMSI-MCO stays with one-to-many diagnoses and acts), with
the sizes of the configuration file.  The large DCIR tables are drawn on
the device with one ``torch.Generator`` in a few bulk calls; the patient
repository and the PMSI star (a few million rows) are drawn on the host
with numpy and copied over once.  Every column is a plain tensor: both the
program (wrapped as its tables) and the plain reference read these same
tensors.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

Star = Dict[str, Dict[str, torch.Tensor]]

NULL_INT = -2_147_483_648 + 1      # the port's sentinel for a NULL int32
EPOCH = 14_600                      # ~2010-01-01 in days since 1970
DAYS_3Y = 3 * 365


def seed64(seed: int) -> int:
    """Any whole number (the driver's seeds pass 2**31) as a 64-bit seed."""
    return int(seed) % (1 << 64)


def _patients(rng: np.random.Generator, n: int, p_dead: float) -> dict:
    gender = rng.integers(1, 3, size=n).astype(np.int32)
    age = (18 + 77 * rng.beta(2.0, 1.6, size=n)).astype(np.int32)
    birth = (EPOCH - age.astype(np.int64) * 365).astype(np.int32)
    death = np.full(n, NULL_INT, dtype=np.int32)
    dead = rng.random(n) < p_dead
    death[dead] = (EPOCH + rng.integers(0, DAYS_3Y, size=int(dead.sum()))
                   ).astype(np.int32)
    return {"patient_id": np.arange(n, dtype=np.int32), "gender": gender,
            "birth_date": birth, "death_date": death}


def _to(cols: dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in cols.items()}


def dcir_star(cfg: dict, seed: int, device) -> Star:
    """ER_PRS (one row a cash flow) with ER_PHA / ER_CAM detail rows for
    the drug and act flows and the IR_BEN patient repository."""
    s = seed64(seed)
    P = int(cfg["n_patients"])
    n = int(P * float(cfg["flows_per_patient"]))
    rng = np.random.default_rng(s)
    ir_ben = _to(_patients(rng, P, float(cfg["p_dead"])), device)
    g = torch.Generator(device=device)
    g.manual_seed(s)
    i32 = torch.int32

    def randint(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=g, device=device,
                             dtype=i32)

    def rand(size):
        return torch.rand((size,), generator=g, device=device)

    flow_id = torch.arange(n, dtype=i32, device=device)
    patient_id = randint(0, P, n)
    date = EPOCH + randint(0, DAYS_3Y, n)
    death = ir_ben["death_date"][patient_id.to(torch.int64)]
    date = torch.where(death != NULL_INT, torch.minimum(date, death), date)
    prestation = randint(1000, 1100, n)
    # gamma(2, 18): the sum of two exponentials, rounded to cents
    expo = -torch.log1p(-rand(2 * n)).view(2, n)
    amount = torch.round(18.0 * expo.sum(0) * 100.0) / 100.0
    kind = rand(n)
    is_drug = kind < float(cfg["p_flow_is_drug"])
    is_act = ~is_drug & (kind < float(cfg["p_flow_is_drug"])
                         + float(cfg["p_flow_is_act"]))
    p_null = float(cfg["p_null_code"])

    pha_flow = flow_id[is_drug]
    m = pha_flow.shape[0]
    cip13 = randint(0, int(cfg["n_drug_codes"]), m)
    cip13 = torch.where(rand(m) < p_null, NULL_INT, cip13)
    atc = torch.where(cip13 == NULL_INT, NULL_INT,
                      cip13 % int(cfg["n_atc_classes"]))
    quantity = randint(1, 4, m)

    cam_flow = flow_id[is_act]
    k = cam_flow.shape[0]
    ccam = randint(0, int(cfg["n_act_codes"]), k)
    ccam = torch.where(rand(k) < p_null, NULL_INT, ccam)
    return {
        "ER_PRS": {"flow_id": flow_id, "patient_id": patient_id,
                   "prestation_code": prestation, "execution_date": date,
                   "amount": amount.to(torch.float32)},
        "ER_PHA": {"flow_id": pha_flow, "cip13": cip13,
                   "atc_class": atc.to(i32), "quantity": quantity},
        "ER_CAM": {"flow_id": cam_flow, "ccam_code": ccam},
        "IR_BEN": ir_ben,
    }


def pmsi_star(cfg: dict, seed: int, device) -> Star:
    """MCO_B (one row a hospital stay) with its MCO_D diagnoses and MCO_A
    acts, several rows a stay (the one-to-many layout of paper Table 1)."""
    rng = np.random.default_rng(seed64(seed) ^ 0x5EED_0F_9A5)
    P = int(cfg["n_patients"])
    n = max(1, int(P * float(cfg["stays_per_patient"])))
    stay_id = np.arange(n, dtype=np.int32)
    start = (EPOCH + rng.integers(0, DAYS_3Y - 30, size=n)).astype(np.int32)
    length = rng.geometric(0.25, size=n).clip(1, 60).astype(np.int32)
    mco_b = {"stay_id": stay_id,
             "patient_id": rng.integers(0, P, size=n).astype(np.int32),
             "stay_start": start, "stay_end": (start + length).astype(np.int32),
             "ghm_code": rng.integers(0, 2000, size=n).astype(np.int32)}
    n_diag = np.maximum(1, rng.poisson(float(cfg["diags_per_stay"]), size=n))
    d_stay = np.repeat(stay_id, n_diag)
    kind = np.ones(d_stay.shape[0], dtype=np.int32)
    later = np.r_[False, d_stay[1:] == d_stay[:-1]]
    kind[later] = rng.integers(2, 4, size=int(later.sum())).astype(np.int32)
    mco_d = {"stay_id": d_stay.astype(np.int32),
             "icd_code": rng.integers(0, int(cfg["n_diag_codes"]),
                                      size=d_stay.shape[0]).astype(np.int32),
             "diag_kind": kind}
    n_act = rng.poisson(float(cfg["acts_per_stay"]), size=n)
    a_stay = np.repeat(stay_id, n_act)
    mco_a = {"stay_id": a_stay.astype(np.int32),
             "ccam_code": rng.integers(0, int(cfg["n_act_codes"]),
                                       size=a_stay.shape[0]).astype(np.int32),
             "act_date": (start[a_stay] + rng.integers(0, 5, size=a_stay.shape[0])
                          ).astype(np.int32)}
    return {"MCO_B": _to(mco_b, device), "MCO_D": _to(mco_d, device),
            "MCO_A": _to(mco_a, device)}


def make_star(cfg: dict, seed: int, device) -> Star:
    """Every table the configuration's ``star`` names."""
    star = dcir_star(cfg, seed, device)
    if cfg["star"] == "snds":
        star.update(pmsi_star(cfg, seed, device))
    return star


def rows(star: Star, tables) -> int:
    """Rows of the named tables (every generated row is valid)."""
    return sum(int(next(iter(star[t].values())).shape[0]) for t in tables)
