"""Synthetic SNDS-shaped claims generator (the port of
``repro.data.synthetic``).

Reproduces the *statistical shape* of the paper's Table 1 dataset at a
configurable scale factor: DCIR (outpatient cash flows, block-sparse detail
tables) and PMSI-MCO (hospital stays with one-to-many child tables).  Events
are timestamped over a 3-year follow-up, with drug/act/diagnosis code
vocabularies, null injection, and demographic distributions (gender, age,
mortality) matching the supplementary-material examples.

Everything is deterministic given ``seed``.  The ``*_arrays`` functions are
numpy copies of the reference generators and give identical arrays from the
same seed; ``generate_*`` put those arrays on ``device`` as tables
(``device=None`` means CUDA, and raises where CUDA is absent).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.columnar import ColumnarTable
from repro_torch.core.schema import DCIR_SCHEMA, PMSI_MCO_SCHEMA

__all__ = ["SyntheticConfig", "generate_dcir", "generate_pmsi", "generate_snds",
           "generate_ssr", "generate_had", "generate_ir_imb", "dcir_arrays",
           "pmsi_arrays", "ssr_arrays", "had_arrays", "ir_imb_arrays",
           "to_tables"]

Arrays = Dict[str, Dict[str, np.ndarray]]

DAYS_3Y = 3 * 365
EPOCH_OFFSET = 14_600  # ~2010-01-01 in days-since-1970, arbitrary anchor

# Null sentinel must match core.columnar.NULL_INT.
_NULL = np.int32(-2_147_483_648 + 1)


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    n_patients: int = 2_000
    flows_per_patient: float = 24.0     # DCIR cash flows / patient / 3y
    stays_per_patient: float = 0.6      # PMSI stays / patient / 3y
    diags_per_stay: float = 3.0         # one-to-many blow-up (paper Table 1)
    acts_per_stay: float = 2.0
    n_drug_codes: int = 500             # paper: 16,289 distinct CIP13
    n_atc_classes: int = 65             # paper task (c): 65 drugs of interest
    n_act_codes: int = 300              # paper: ~7k distinct CCAM
    n_diag_codes: int = 400             # paper: ~17k distinct ICD
    p_flow_is_drug: float = 0.55        # block-sparsity profile of DCIR
    p_flow_is_act: float = 0.25
    p_null_code: float = 0.01           # dirty-data injection
    p_dead: float = 0.05
    seed: int = 0

    @property
    def n_flows(self) -> int:
        return int(self.n_patients * self.flows_per_patient)

    @property
    def n_stays(self) -> int:
        return max(1, int(self.n_patients * self.stays_per_patient))


def _patients(rng: np.random.Generator, cfg: SyntheticConfig) -> Dict[str, np.ndarray]:
    n = cfg.n_patients
    gender = rng.integers(1, 3, size=n).astype(np.int32)  # 1=M, 2=F
    # Age 18–95 at epoch, skewed old (claims data shape).
    age_years = (18 + 77 * rng.beta(2.0, 1.6, size=n)).astype(np.int32)
    birth = (EPOCH_OFFSET - age_years.astype(np.int64) * 365).astype(np.int32)
    death = np.full(n, _NULL, dtype=np.int32)
    dead = rng.random(n) < cfg.p_dead
    death[dead] = (EPOCH_OFFSET + rng.integers(0, DAYS_3Y, size=dead.sum())).astype(np.int32)
    return {
        "patient_id": np.arange(n, dtype=np.int32),
        "gender": gender,
        "birth_date": birth,
        "death_date": death,
    }


def to_tables(arrays: Arrays, device=None) -> Dict[str, ColumnarTable]:
    """Host arrays -> all-valid tables on ``device``."""
    return {name: ColumnarTable.from_columns(cols, device=device)
            for name, cols in arrays.items()}


def dcir_arrays(cfg: SyntheticConfig) -> Arrays:
    """Normalized DCIR star as numpy: ER_PRS central + ER_PHA / ER_CAM /
    IR_BEN dims."""
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_flows
    pat = _patients(rng, cfg)

    flow_id = np.arange(n, dtype=np.int32)
    patient_id = rng.integers(0, cfg.n_patients, size=n).astype(np.int32)
    exec_date = (EPOCH_OFFSET + rng.integers(0, DAYS_3Y, size=n)).astype(np.int32)
    # Patients who died stop generating events at death (keeps monitoring
    # stats honest for follow-up transformers).
    death = pat["death_date"][patient_id]
    has_death = death != _NULL
    exec_date = np.where(
        has_death, np.minimum(exec_date, np.where(has_death, death, exec_date)), exec_date
    ).astype(np.int32)
    prestation = rng.integers(1000, 1100, size=n).astype(np.int32)
    amount = np.round(rng.gamma(2.0, 18.0, size=n), 2).astype(np.float32)

    kind = rng.random(n)
    is_drug = kind < cfg.p_flow_is_drug
    is_act = (~is_drug) & (kind < cfg.p_flow_is_drug + cfg.p_flow_is_act)

    # ER_PHA: one row per drug flow (block-sparse: <=1 per central row).
    pha_flow = flow_id[is_drug]
    m = pha_flow.shape[0]
    cip13 = rng.integers(0, cfg.n_drug_codes, size=m).astype(np.int32)
    cip13[rng.random(m) < cfg.p_null_code] = _NULL
    atc = (cip13 % np.int32(cfg.n_atc_classes)).astype(np.int32)
    atc[cip13 == _NULL] = _NULL
    er_pha = {
        "flow_id": pha_flow,
        "cip13": cip13,
        "atc_class": atc,
        "quantity": rng.integers(1, 4, size=m).astype(np.int32),
    }

    # ER_CAM: one row per act flow.
    cam_flow = flow_id[is_act]
    k = cam_flow.shape[0]
    ccam = rng.integers(0, cfg.n_act_codes, size=k).astype(np.int32)
    ccam[rng.random(k) < cfg.p_null_code] = _NULL
    er_cam = {"flow_id": cam_flow, "ccam_code": ccam}

    tables = {
        "ER_PRS": {
            "flow_id": flow_id,
            "patient_id": patient_id,
            "prestation_code": prestation,
            "execution_date": exec_date,
            "amount": amount,
        },
        "ER_PHA": er_pha,
        "ER_CAM": er_cam,
        "IR_BEN": pat,
    }
    _check_schema(tables, DCIR_SCHEMA)
    return tables


def _check_schema(tables: Arrays, schema) -> None:
    """Generated columns must match the schema's declarations."""
    for ts in schema.all_tables():
        got, want = set(tables[ts.name]), set(ts.columns)
        if got != want:
            raise ValueError(f"{ts.name}: generated {got}, declared {want}")


def generate_dcir(cfg: SyntheticConfig, device=None) -> Dict[str, ColumnarTable]:
    """Normalized DCIR star as tables on ``device`` (None = CUDA)."""
    return to_tables(dcir_arrays(cfg), device)


def pmsi_arrays(cfg: SyntheticConfig) -> Arrays:
    """Normalized PMSI-MCO star as numpy: MCO_B central + MCO_D / MCO_A
    children."""
    rng = np.random.default_rng(cfg.seed + 1)
    n = cfg.n_stays
    stay_id = np.arange(n, dtype=np.int32)
    patient_id = rng.integers(0, cfg.n_patients, size=n).astype(np.int32)
    start = (EPOCH_OFFSET + rng.integers(0, DAYS_3Y - 30, size=n)).astype(np.int32)
    length = rng.geometric(0.25, size=n).clip(1, 60).astype(np.int32)
    mco_b = {
        "stay_id": stay_id,
        "patient_id": patient_id,
        "stay_start": start,
        "stay_end": (start + length).astype(np.int32),
        "ghm_code": rng.integers(0, 2000, size=n).astype(np.int32),
    }

    # One-to-many children: Poisson counts per stay (>=1 main diagnosis).
    n_diag = np.maximum(1, rng.poisson(cfg.diags_per_stay, size=n)).astype(np.int64)
    d_stay = np.repeat(stay_id, n_diag)
    md = d_stay.shape[0]
    diag_kind = np.ones(md, dtype=np.int32)  # 1=main
    # mark non-first diagnoses as associated(2)/linked(3)
    first = np.r_[True, d_stay[1:] != d_stay[:-1]]
    diag_kind[~first] = rng.integers(2, 4, size=(~first).sum()).astype(np.int32)
    mco_d = {
        "stay_id": d_stay.astype(np.int32),
        "icd_code": rng.integers(0, cfg.n_diag_codes, size=md).astype(np.int32),
        "diag_kind": diag_kind,
    }

    n_act = rng.poisson(cfg.acts_per_stay, size=n).astype(np.int64)
    a_stay = np.repeat(stay_id, n_act)
    ma = a_stay.shape[0]
    mco_a = {
        "stay_id": a_stay.astype(np.int32),
        "ccam_code": rng.integers(0, cfg.n_act_codes, size=max(ma, 1))[:ma].astype(np.int32),
        "act_date": (start[a_stay] + rng.integers(0, 5, size=ma)).astype(np.int32),
    }
    if ma == 0:  # degenerate tiny configs
        mco_a = {k: np.zeros(0, dtype=np.int32) for k in ("stay_id", "ccam_code", "act_date")}

    tables = {"MCO_B": mco_b, "MCO_D": mco_d, "MCO_A": mco_a}
    _check_schema(tables, PMSI_MCO_SCHEMA)
    return tables


def generate_pmsi(cfg: SyntheticConfig, device=None) -> Dict[str, ColumnarTable]:
    """Normalized PMSI-MCO star as tables on ``device`` (None = CUDA)."""
    return to_tables(pmsi_arrays(cfg), device)


def generate_snds(cfg: SyntheticConfig, device=None
                  ) -> Tuple[Dict[str, ColumnarTable], Dict[str, ColumnarTable]]:
    """Both sub-databases, sharing the patient universe."""
    return generate_dcir(cfg, device), generate_pmsi(cfg, device)


def ssr_arrays(cfg: SyntheticConfig) -> Arrays:
    """SSR rehabilitation star (supplementary Table 2), as numpy."""
    rng = np.random.default_rng(cfg.seed + 2)
    n = max(1, int(cfg.n_patients * 0.08))
    stay_id = np.arange(n, dtype=np.int32)
    patient_id = rng.integers(0, cfg.n_patients, size=n).astype(np.int32)
    start = (EPOCH_OFFSET + rng.integers(0, DAYS_3Y - 60, size=n)).astype(np.int32)
    length = rng.geometric(0.05, size=n).clip(7, 120).astype(np.int32)
    ssr_b = {
        "stay_id": stay_id,
        "patient_id": patient_id,
        "stay_start": start,
        "stay_end": (start + length).astype(np.int32),
        "takeover_code": rng.integers(0, 40, size=n).astype(np.int32),
    }
    n_act = rng.poisson(4.0, size=n).astype(np.int64)
    a_stay = np.repeat(stay_id, n_act)
    ma = max(int(a_stay.shape[0]), 1)
    ssr_a = {
        "stay_id": (a_stay if a_stay.shape[0] else np.zeros(0, np.int32)).astype(np.int32),
        "csarr_code": rng.integers(0, 200, size=ma)[: a_stay.shape[0]].astype(np.int32),
        "act_date": (start[a_stay] + rng.integers(0, 30, size=a_stay.shape[0])).astype(np.int32)
        if a_stay.shape[0] else np.zeros(0, np.int32),
    }
    n_diag = np.maximum(1, rng.poisson(1.5, size=n)).astype(np.int64)
    d_stay = np.repeat(stay_id, n_diag)
    ssr_d = {
        "stay_id": d_stay.astype(np.int32),
        "icd_code": rng.integers(0, cfg.n_diag_codes, size=d_stay.shape[0]).astype(np.int32),
        "diag_kind": np.ones(d_stay.shape[0], np.int32),
    }
    return {"SSR_B": ssr_b, "SSR_A": ssr_a, "SSR_D": ssr_d}


def generate_ssr(cfg: SyntheticConfig, device=None) -> Dict[str, ColumnarTable]:
    return to_tables(ssr_arrays(cfg), device)


def had_arrays(cfg: SyntheticConfig) -> Arrays:
    """HAD home-care episodes (supplementary Table 2), as numpy."""
    rng = np.random.default_rng(cfg.seed + 3)
    n = max(1, int(cfg.n_patients * 0.04))
    start = (EPOCH_OFFSET + rng.integers(0, DAYS_3Y - 90, size=n)).astype(np.int32)
    assoc = rng.integers(0, 25, size=n).astype(np.int32)
    assoc[rng.random(n) < 0.5] = _NULL
    had_b = {
        "episode_id": np.arange(n, dtype=np.int32),
        "patient_id": rng.integers(0, cfg.n_patients, size=n).astype(np.int32),
        "episode_start": start,
        "episode_end": (start + rng.integers(14, 90, size=n)).astype(np.int32),
        "main_takeover": rng.integers(0, 25, size=n).astype(np.int32),
        "assoc_takeover": assoc,
    }
    return {"HAD_B": had_b}


def generate_had(cfg: SyntheticConfig, device=None) -> Dict[str, ColumnarTable]:
    return to_tables(had_arrays(cfg), device)


def ir_imb_arrays(cfg: SyntheticConfig) -> Arrays:
    """IR_IMB_R long-term chronic diseases (ALD), as numpy."""
    rng = np.random.default_rng(cfg.seed + 4)
    n = max(1, int(cfg.n_patients * 0.15))
    start = (EPOCH_OFFSET - rng.integers(0, 3650, size=n)).astype(np.int32)
    return {
        "IR_IMB_R": {
            "patient_id": rng.integers(0, cfg.n_patients, size=n).astype(np.int32),
            "ald_icd_code": rng.integers(0, cfg.n_diag_codes, size=n).astype(np.int32),
            "ald_start": start,
            "ald_end": (start + rng.integers(365, 7300, size=n)).astype(np.int32),
        }
    }


def generate_ir_imb(cfg: SyntheticConfig, device=None) -> Dict[str, ColumnarTable]:
    return to_tables(ir_imb_arrays(cfg), device)
