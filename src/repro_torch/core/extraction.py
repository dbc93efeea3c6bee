"""SCALPEL-Extraction: concept extractors over the denormalized flat table.

An ``Extractor`` maps flat-table rows to zero-or-more standardized ``Event``
rows (paper §3.4, Figure 2), as a composition of columnar steps:

  step 1  column projection            (metadata-only)
  step 2  null filtering               (mask algebra over validity/sentinels)
  step 2b optional row-value filtering (vectorized predicate, late — on
                                        already-reduced data, as in the paper)
  step 3  schema conformance + compaction to the Event layout

Steps 1–2b never materialize rows (masks only); the single materialization is
the final compaction: the ``cuda`` engine's compaction kernel
(``repro_torch.kernels.ops``) or the ``torch`` engine's gather.  This is the
port of ``repro.core.extraction``.

Every extraction records provenance into an ``OperationLog`` so
SCALPEL-Analysis can rebuild flowcharts from metadata (paper §3.4 last ¶).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core.columnar import ColumnarTable
from repro_torch.core.events import Category
from repro_torch.core.metadata import OperationLog

__all__ = [
    "Extractor",
    "dedupe_by",
    "drug_dispenses",
    "medical_acts_dcir",
    "medical_acts_pmsi",
    "diagnoses",
    "hospital_stays",
    "patients",
    "biology_acts",
    "practitioner_encounters",
    "csarr_acts",
    "ssr_stays",
    "takeover_reasons",
    "long_term_diseases",
]


def dedupe_by(table: ColumnarTable, keys: Sequence[str]) -> ColumnarTable:
    """DISTINCT over key columns: sort, keep the first row of each run.

    Needed because a denormalized 1:N flat table repeats parent attributes
    (e.g. one hospital stay appears once per diagnosis×act pair).

    Word-wise validity: ``sort_by`` sinks invalid rows, so the sorted
    table's valid rows are exactly the first ``count`` — row validity here
    is an iota compare (no packed-word expansion), and the only new mask is
    the data-derived run-head test ``filter`` packs at its boundary.
    """
    t = table.sort_by(list(keys))
    dev = t.device
    tv = torch.arange(t.capacity, dtype=torch.int32, device=dev) < t.count
    neq = torch.zeros((t.capacity,), dtype=torch.bool, device=dev)
    for k in keys:
        col = t.columns[k]
        neq = neq | torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                               col[1:] != col[:-1]])
    # neq[0] is True, so every first-of-run valid row survives; rows past
    # count (the sunk invalid tail) drop via tv
    keep = tv & neq
    return t.filter(keep)


@dataclasses.dataclass(frozen=True)
class Extractor:
    """Declarative concept extractor (paper Table 3 entries are instances)."""

    name: str
    source: str                      # flat-table name this extractor reads
    category: int                    # Event.category to emit
    value_col: str                   # -> Event.value
    start_col: str                   # -> Event.start
    end_col: Optional[str] = None    # -> Event.end (None => punctual)
    group_col: Optional[str] = None  # -> Event.groupID
    weight_col: Optional[str] = None # -> Event.weight
    null_cols: Tuple[str, ...] = ()  # step-2 null filter columns
    codes: Optional[Tuple[int, ...]] = None  # step-2b value whitelist
    distinct: Tuple[str, ...] = ()   # dedupe keys (for 1:N flat layouts)
    # optional typed row predicate (repro_torch.study.expr.Expr) applied after the
    # null/whitelist steps; excluded from equality/hash (Exprs are
    # value-built trees) — use ``filtered()`` to attach one
    where: Optional[Any] = dataclasses.field(default=None, compare=False)

    def filtered(self, expr) -> "Extractor":
        """A copy of this extractor with ``expr`` AND-ed into its ``where``
        predicate: ``drug_dispenses().filtered(col("cip13").isin(codes))``."""
        combined = expr if self.where is None else (self.where & expr)
        return dataclasses.replace(self, where=combined)

    def projection(self) -> Tuple[str, ...]:
        """Step-1 column set: only the columns this extractor touches."""
        needed = ["patient_id", self.value_col, self.start_col]
        for c in (self.end_col, self.group_col, self.weight_col):
            if c:
                needed.append(c)
        needed += [c for c in self.null_cols if c not in needed]
        needed += [c for c in self.distinct if c not in needed]
        if self.where is not None:
            needed += [c for c in self.where.required_columns()
                       if c not in needed]
        return tuple(sorted(set(needed)))

    def contribute(self, b, compact: bool = True,
                   base: Optional[int] = None) -> int:
        """Append this extractor's steps 1-3 to a ``PlanBuilder``; returns the
        output node id.  Scans hash-cons, so every extractor over one source
        shares the scan node, and the optimizer then merges projections and
        fuses the mask steps (``repro.study.optimizer``).  ``base`` chains
        the steps onto an existing plan node (e.g. a ``Study.flatten``
        output) instead of a fresh env scan."""
        t = b.select(base if base is not None else b.scan(self.source),
                     self.projection())
        t = b.drop_nulls(t, self.null_cols or (self.value_col,))
        if self.codes is not None:
            t = b.value_filter(t, self.value_col, self.codes)
        if self.where is not None:
            t = b.predicate(t, self.where, label="where")
        if self.distinct:
            t = b.dedupe(t, self.distinct)
        t = b.conform_events(
            t, name=self.name, category=self.category, value_col=self.value_col,
            start_col=self.start_col, end_col=self.end_col,
            group_col=self.group_col, weight_col=self.weight_col,
        )
        if compact:
            t = b.compact(t)
        return t

    def __call__(self, flat: ColumnarTable, log: Optional[OperationLog] = None,
                 compact: bool = True, engine: str = "torch") -> ColumnarTable:
        """Eager wrapper: builds the single-extractor plan and executes it
        immediately.

        engine: 'torch' (gather compaction, default) or 'cuda' (the
        compaction kernel on CUDA tables, its plain version on CPU tables).
        Multi-extractor studies should use ``repro_torch.study.Study``,
        which shares one scan across extractors."""
        from repro_torch.study import executor as _executor
        from repro_torch.study.plan import PlanBuilder

        b = PlanBuilder()
        out = self.contribute(b, compact=compact)
        b.set_output(self.name, out)
        ev = _executor.execute(b.build(), {self.source: flat}, engine=engine)[out]
        if log is not None:
            log.record(
                op=f"extract:{self.name}",
                inputs={self.source: flat},
                outputs={self.name: ev},
                params={"codes": None if self.codes is None else len(self.codes)},
            )
        return ev


# --- ready-to-use extractors (paper Table 3) --------------------------------
def drug_dispenses(granularity: str = "cip13", codes: Optional[Sequence[int]] = None) -> Extractor:
    """Drug dispense extractor; granularity ∈ {cip13, atc} (paper §3.4:
    "events at multiple levels of granularity (drug, molecule, ATC class)")."""
    col = {"cip13": "cip13", "atc": "atc_class"}[granularity]
    return Extractor(
        name=f"drug_purchases[{granularity}]",
        source="DCIR",
        category=Category.DRUG_DISPENSE,
        value_col=col,
        start_col="execution_date",
        weight_col=None,
        null_cols=("cip13",),
        codes=None if codes is None else tuple(int(c) for c in codes),
    )


def medical_acts_dcir(codes: Optional[Sequence[int]] = None) -> Extractor:
    return Extractor(
        name="acts",
        source="DCIR",
        category=Category.MEDICAL_ACT,
        value_col="ccam_code",
        start_col="execution_date",
        null_cols=("ccam_code",),
        codes=None if codes is None else tuple(int(c) for c in codes),
    )


def medical_acts_pmsi(codes: Optional[Sequence[int]] = None) -> Extractor:
    """Acts from the hospital flat table — the paper's slow task (e): the 1:N
    flat layout forces a distinct + more row-value tests (§5 discussion)."""
    return Extractor(
        name="hospital_acts",
        source="PMSI_MCO",
        category=Category.MEDICAL_ACT,
        value_col="ccam_code",
        start_col="act_date",
        null_cols=("ccam_code",),
        codes=None if codes is None else tuple(int(c) for c in codes),
        distinct=("stay_id", "ccam_code", "act_date"),
    )


def diagnoses(kinds: Sequence[int] = (1, 2, 3), codes: Optional[Sequence[int]] = None) -> Extractor:
    """Main/associated/linked diagnoses (paper Table 3); group_id = kind."""
    return Extractor(
        name="diagnoses",
        source="PMSI_MCO",
        category=Category.DIAGNOSIS,
        value_col="icd_code",
        start_col="stay_start",
        group_col="diag_kind",
        null_cols=("icd_code",),
        codes=None if codes is None else tuple(int(c) for c in codes),
        distinct=("stay_id", "icd_code", "diag_kind"),
    )


def hospital_stays() -> Extractor:
    return Extractor(
        name="extract_hospital_stays",
        source="PMSI_MCO",
        category=Category.HOSPITAL_STAY,
        value_col="ghm_code",
        start_col="stay_start",
        end_col="stay_end",
        distinct=("stay_id",),
    )


def patients(ir_ben: ColumnarTable, log: Optional[OperationLog] = None) -> ColumnarTable:
    """Patient demographics (task (a) of the paper's evaluation)."""
    t = dedupe_by(ir_ben.select(["patient_id", "gender", "birth_date", "death_date"]),
                  ["patient_id"]).compact()
    if log is not None:
        log.record(op="extract:extract_patients", inputs={"IR_BEN": ir_ben},
                   outputs={"extract_patients": t}, params={})
    return t


# --- additional extractors (paper Table 3: biology, NGAP, practitioner
# encounters, CSARR, long-term diseases, takeover reasons) --------------------
def biology_acts(codes: Optional[Sequence[int]] = None) -> Extractor:
    """Biological acts from DCIR (paper Table 3 'Biological acts').

    In the synthetic star, biology rides the prestation code space (the real
    ER_BIO_F table joins like ER_CAM); prestation codes >= 1080 model biology.
    """
    return Extractor(
        name="biological_acts",
        source="DCIR",
        category=Category.BIOLOGY,
        value_col="prestation_code",
        start_col="execution_date",
        codes=tuple(codes) if codes is not None else tuple(range(1080, 1100)),
    )


def practitioner_encounters(medical: bool = True) -> Extractor:
    """Practitioner encounters (paper Table 3, medical vs non-medical) —
    identified by the prestation code band of the cash flow."""
    band = range(1000, 1040) if medical else range(1040, 1080)
    return Extractor(
        name=f"{'medical' if medical else 'non_medical'}_encounters",
        source="DCIR",
        category=Category.PRACTITIONER,
        value_col="prestation_code",
        start_col="execution_date",
        codes=tuple(band),
    )


def csarr_acts(codes: Optional[Sequence[int]] = None) -> Extractor:
    """CSARR rehabilitation acts from the SSR flat table."""
    return Extractor(
        name="csarr_acts",
        source="SSR",
        category=Category.MEDICAL_ACT,
        value_col="csarr_code",
        start_col="act_date",
        null_cols=("csarr_code",),
        codes=None if codes is None else tuple(int(c) for c in codes),
        distinct=("stay_id", "csarr_code", "act_date"),
    )


def ssr_stays() -> Extractor:
    """SSR stay (longitudinal) events (paper Table 3 'SSR Stay')."""
    return Extractor(
        name="ssr_stays",
        source="SSR",
        category=Category.HOSPITAL_STAY,
        value_col="takeover_code",
        start_col="stay_start",
        end_col="stay_end",
        distinct=("stay_id",),
    )


def takeover_reasons(main: bool = True) -> Extractor:
    """HAD main/associated takeover reasons (paper Table 3)."""
    return Extractor(
        name=f"{'main' if main else 'associated'}_takeover",
        source="HAD",
        category=Category.PRACTITIONER,
        value_col="main_takeover" if main else "assoc_takeover",
        start_col="episode_start",
        null_cols=("main_takeover",) if main else ("assoc_takeover",),
    )


def long_term_diseases(codes: Optional[Sequence[int]] = None) -> Extractor:
    """Long-term chronic disease (ALD) longitudinal events from IR_IMB_R."""
    return Extractor(
        name="long_term_diseases",
        source="IR_IMB",
        category=Category.DIAGNOSIS,
        value_col="ald_icd_code",
        start_col="ald_start",
        end_col="ald_end",
        group_col=None,
        codes=None if codes is None else tuple(int(c) for c in codes),
    )
