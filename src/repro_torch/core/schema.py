"""Star-schema declarations for SNDS-shaped claims databases.

SNDS is "multiple sub-databases, each one with a star schema" (paper §3.1): a
central fact table recording cash flows / hospital stays, joined to dimension
tables for medical detail.  We declare the two sub-databases the paper
evaluates (DCIR outpatient, PMSI-MCO inpatient) with the join topology that
SCALPEL-Flattening denormalizes.

Column dtypes are the fixed-width SoA encodings of ``core.columnar``; nullable
columns use sentinel encoding (see ``NULL_INT``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["TableSchema", "JoinEdge", "StarSchema", "DCIR_SCHEMA", "PMSI_MCO_SCHEMA", "FLAT_EVENT_SCHEMA"]


@dataclasses.dataclass(frozen=True)
class TableSchema:
    """One normalized table: name, columns (name -> numpy dtype), primary key."""

    name: str
    columns: Dict[str, np.dtype]
    key: str                        # join key column (into parent)
    nullable: Tuple[str, ...] = ()  # sentinel-encoded nullable columns

    def dtypes(self) -> Dict[str, np.dtype]:
        return dict(self.columns)


@dataclasses.dataclass(frozen=True)
class JoinEdge:
    """A left-join step of the flattening: ``left.key_col == right.key``.

    ``one_to_many`` marks child tables (N child rows per parent row).  The
    denormalized output is keyed on child rows for such joins — this is what
    produces the PMSI blow-up in Table 1 of the paper (35M stays ->
    3.2B denormalized rows), versus DCIR's near-1:1 block-sparse layout.
    """

    left: str
    right: str
    left_key: str
    right_key: str
    one_to_many: bool = False


@dataclasses.dataclass(frozen=True)
class StarSchema:
    """A sub-database: one central fact table + dimension/child tables."""

    name: str
    central: TableSchema
    dims: Tuple[TableSchema, ...]
    joins: Tuple[JoinEdge, ...]
    patient_key: str = "patient_id"

    def table(self, name: str) -> TableSchema:
        if name == self.central.name:
            return self.central
        for d in self.dims:
            if d.name == name:
                return d
        raise KeyError(name)

    def all_tables(self) -> List[TableSchema]:
        return [self.central, *self.dims]

    def flat_columns(self) -> Tuple[str, ...]:
        """Column set of the denormalized flat table: the central columns plus
        every joined table's columns minus its join key (which the joins fold
        into the left side)."""
        cols = set(self.central.columns)
        for e in self.joins:
            cols |= set(self.table(e.right).columns) - {e.right_key}
        return tuple(sorted(cols))


_i32 = np.dtype(np.int32)
_f32 = np.dtype(np.float32)

# ---------------------------------------------------------------------------
# DCIR — outpatient reimbursement (analogue of ER_PRS_F + ER_PHA_F/ER_CAM_F/
# ER_BIO_F + IR_BEN_R).  Central row = one cash flow (paper Table 1 caption).
# Detail tables are *sparse by block*: a cash-flow row has at most one matching
# row per detail table (drug OR act OR bio), so the flat table stays ~1:1.
# ---------------------------------------------------------------------------
DCIR_SCHEMA = StarSchema(
    name="DCIR",
    central=TableSchema(
        name="ER_PRS",
        columns={
            "flow_id": _i32,        # primary key of the cash flow
            "patient_id": _i32,
            "prestation_code": _i32,  # nature of the reimbursed act
            "execution_date": _i32,   # days since epoch
            "amount": _f32,
        },
        key="flow_id",
    ),
    dims=(
        TableSchema(  # pharmacy detail (drug dispenses)
            name="ER_PHA",
            columns={"flow_id": _i32, "cip13": _i32, "atc_class": _i32, "quantity": _i32},
            key="flow_id",
            nullable=("cip13",),
        ),
        TableSchema(  # medical act detail (CCAM)
            name="ER_CAM",
            columns={"flow_id": _i32, "ccam_code": _i32},
            key="flow_id",
            nullable=("ccam_code",),
        ),
        TableSchema(  # patient repository
            name="IR_BEN",
            columns={"patient_id": _i32, "gender": _i32, "birth_date": _i32, "death_date": _i32},
            key="patient_id",
            nullable=("death_date",),
        ),
    ),
    joins=(
        JoinEdge("ER_PRS", "ER_PHA", "flow_id", "flow_id"),
        JoinEdge("ER_PRS", "ER_CAM", "flow_id", "flow_id"),
        JoinEdge("ER_PRS", "IR_BEN", "patient_id", "patient_id"),
    ),
)

# ---------------------------------------------------------------------------
# PMSI-MCO — inpatient stays.  Central row = one hospital stay; events during
# the stay live in child tables with N rows per stay (NOT sparse-by-block),
# which is exactly the layout the paper blames for tasks (e)/(f) slowness.
# ---------------------------------------------------------------------------
PMSI_MCO_SCHEMA = StarSchema(
    name="PMSI_MCO",
    central=TableSchema(
        name="MCO_B",
        columns={
            "stay_id": _i32,
            "patient_id": _i32,
            "stay_start": _i32,
            "stay_end": _i32,
            "ghm_code": _i32,   # diagnosis-related group
        },
        key="stay_id",
    ),
    dims=(
        TableSchema(  # diagnoses during the stay (main/associated/linked)
            name="MCO_D",
            columns={"stay_id": _i32, "icd_code": _i32, "diag_kind": _i32},
            key="stay_id",
        ),
        TableSchema(  # medical acts during the stay
            name="MCO_A",
            columns={"stay_id": _i32, "ccam_code": _i32, "act_date": _i32},
            key="stay_id",
        ),
    ),
    joins=(
        JoinEdge("MCO_B", "MCO_D", "stay_id", "stay_id", one_to_many=True),
        JoinEdge("MCO_B", "MCO_A", "stay_id", "stay_id", one_to_many=True),
    ),
)

# Standardized Event schema the extractors conform to (paper §3.4):
# Event(patientID, category, groupID, value, weight, start, end).
FLAT_EVENT_SCHEMA: Dict[str, np.dtype] = {
    "patient_id": _i32,
    "category": _i32,
    "group_id": _i32,
    "value": _i32,
    "weight": _f32,
    "start": _i32,
    "end": _i32,  # NULL_INT for punctual events
}


# ---------------------------------------------------------------------------
# SSR — rehabilitation stays (supplementary Table 2).  Same star topology as
# MCO: central stay table + 1:N act/diagnosis children.
# ---------------------------------------------------------------------------
SSR_SCHEMA = StarSchema(
    name="SSR",
    central=TableSchema(
        name="SSR_B",
        columns={
            "stay_id": _i32,
            "patient_id": _i32,
            "stay_start": _i32,
            "stay_end": _i32,
            "takeover_code": _i32,   # hospital-takeover reason
        },
        key="stay_id",
    ),
    dims=(
        TableSchema(  # CSARR rehabilitation acts
            name="SSR_A",
            columns={"stay_id": _i32, "csarr_code": _i32, "act_date": _i32},
            key="stay_id",
        ),
        TableSchema(  # diagnoses during rehab
            name="SSR_D",
            columns={"stay_id": _i32, "icd_code": _i32, "diag_kind": _i32},
            key="stay_id",
        ),
    ),
    joins=(
        JoinEdge("SSR_B", "SSR_A", "stay_id", "stay_id", one_to_many=True),
        JoinEdge("SSR_B", "SSR_D", "stay_id", "stay_id", one_to_many=True),
    ),
)

# ---------------------------------------------------------------------------
# HAD — home-to-home care.  Central takeover episodes; main/associated
# takeover reasons are columns (punctual extractors read them directly).
# ---------------------------------------------------------------------------
HAD_SCHEMA = StarSchema(
    name="HAD",
    central=TableSchema(
        name="HAD_B",
        columns={
            "episode_id": _i32,
            "patient_id": _i32,
            "episode_start": _i32,
            "episode_end": _i32,
            "main_takeover": _i32,
            "assoc_takeover": _i32,
        },
        key="episode_id",
        nullable=("assoc_takeover",),
    ),
    dims=(),
    joins=(),
)

# ---------------------------------------------------------------------------
# IR_IMB_R — long-term chronic diseases (ALD).  A plain table (paper suppl.
# Table 2: "were simply converted to Parquet files"); no joins.
# ---------------------------------------------------------------------------
IR_IMB_SCHEMA = StarSchema(
    name="IR_IMB",
    central=TableSchema(
        name="IR_IMB_R",
        columns={
            "patient_id": _i32,
            "ald_icd_code": _i32,   # chronic-disease ICD
            "ald_start": _i32,
            "ald_end": _i32,
        },
        key="patient_id",
    ),
    dims=(),
    joins=(),
)
