"""The paper's own pipeline configuration (SCALPEL3's equivalent of the
textual configuration files driving SCALPEL-Flattening/-Extraction, §3.2-3.4).

A declarative study config: which sub-databases to flatten (with temporal
slicing), which concepts to extract, which transformers to run and with what
clinical parameters — the fracture/exposure study of paper §4.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class FlattenJob:
    database: str                 # DCIR | PMSI_MCO | SSR | HAD | IR_IMB
    time_column: str = ""         # temporal slicing column ("" = no slicing)
    n_slices: int = 1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """One SCALPEL3 study, end to end."""

    name: str
    flatten: Tuple[FlattenJob, ...]
    extractors: Tuple[str, ...]          # names from repro_torch.core.extraction
    drug_granularity: str = "cip13"
    prevalent_drug_codes: Tuple[int, ...] = tuple(range(65))  # task (c)
    exposure_purview_days: int = 60      # task (d)
    fracture_act_codes: Tuple[int, ...] = tuple(range(30))    # task (g)
    fracture_diag_codes: Tuple[int, ...] = tuple(range(40))
    fracture_washout_days: int = 90
    trackloss_gap_days: int = 120
    study_start: int = 14_600
    study_end: int = 14_600 + 3 * 365
    seq_len: int = 256                   # FeatureDriver token stream length


# the paper's §4 evaluation study
PAPER_STUDY = PipelineConfig(
    name="fractures-vs-exposures",
    flatten=(
        FlattenJob("DCIR", time_column="execution_date", n_slices=3),
        FlattenJob("PMSI_MCO"),
    ),
    extractors=(
        "patients", "drug_dispenses", "medical_acts_dcir",
        "medical_acts_pmsi", "diagnoses", "hospital_stays",
    ),
)

# the full Table-2 denormalization scope
FULL_SNDS = PipelineConfig(
    name="full-snds",
    flatten=(
        FlattenJob("DCIR", time_column="execution_date", n_slices=12),
        FlattenJob("PMSI_MCO"),
        FlattenJob("SSR"),
        FlattenJob("HAD"),
        FlattenJob("IR_IMB"),
    ),
    extractors=(
        "patients", "drug_dispenses", "medical_acts_dcir",
        "medical_acts_pmsi", "diagnoses", "hospital_stays",
        "biology_acts", "practitioner_encounters", "csarr_acts",
        "ssr_stays", "takeover_reasons", "long_term_diseases",
    ),
)
