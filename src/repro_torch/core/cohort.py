"""SCALPEL-Analysis: Cohort / CohortCollection / CohortFlow abstractions.

The port of ``repro.core.cohort``.  A ``Cohort`` is a set of patients + their
events in a time window (paper §3.5).  Subject membership is a packed bitset
of int32 words over the patient universe (``core.bitset`` layout), so the
paper's algebra (∩ ∪ \\) is bitwise ops + popcount — the plan executor's
``cuda`` engine runs it through the fused kernel (``kernels/bitset_ops``).
Descriptions compose automatically, as in the paper's Supplementary Out[6].

``CohortFlow`` is the left fold ``(((c0 ∩ c1) ∩ c2) ∩ ...)`` with per-stage
retention counts — the RECORD-statement flowchart generator.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import bitset as _bs
from repro_torch.core.columnar import ColumnarTable
from repro_torch.core.metadata import OperationLog

__all__ = ["Bitset", "Cohort", "CohortCollection", "CohortFlow"]


# ---------------------------------------------------------------------------
# Packed-bitset subject sets — thin facade over the shared ``core.bitset``
# layout (ONE packing for subject sets, table validity and kernel outputs)
# ---------------------------------------------------------------------------
class Bitset:
    """Fixed-universe packed bitset (int32 words, ``core.bitset`` layout)."""

    @staticmethod
    def n_words(n_patients: int) -> int:
        return _bs.n_words(n_patients)

    @staticmethod
    def from_mask(mask: torch.Tensor) -> torch.Tensor:
        return _bs.pack(mask)

    @staticmethod
    def from_indices(idx: torch.Tensor, valid: torch.Tensor,
                     n_patients: int) -> torch.Tensor:
        """Subject bitset from event-row patient indices.  ``valid`` is the
        event rows' validity: a bool row mask or the packed word form.

        The reference scatters with ``mode="drop"`` after jax's index
        normalization (a negative index counts from the end); torch raises
        on out-of-range indices, so those rows are dropped before the
        scatter."""
        if _bs.is_packed(valid):
            valid = _bs.bit_at(valid, torch.arange(idx.shape[0],
                                                   device=idx.device))
        i = idx.to(torch.int64)
        i = torch.where(i < 0, i + n_patients, i)
        keep = valid & (i >= 0) & (i < n_patients)
        # dropped rows land in one spare slot past the universe
        mask = torch.zeros((n_patients + 1,), dtype=torch.bool,
                           device=idx.device)
        mask[torch.where(keep, i, n_patients)] = True
        return _bs.pack(mask[:n_patients])

    @staticmethod
    def to_mask(bits: torch.Tensor, n_patients: int) -> torch.Tensor:
        return _bs.unpack(bits, n_patients)

    @staticmethod
    def count(bits: torch.Tensor) -> torch.Tensor:
        return _bs.count(bits)


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Cohort:
    """Patients + events in a [start, end] window (paper §3.5)."""

    name: str
    description: str
    subjects: torch.Tensor                   # packed int32 bitset
    n_patients: int
    events: Optional[ColumnarTable] = None   # associated Event table
    window: Tuple[int, int] = (0, 2_000_000_000)

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_events(cls, name: str, events: ColumnarTable, n_patients: int,
                    description: Optional[str] = None) -> "Cohort":
        bits = Bitset.from_indices(events.columns["patient_id"], events.valid, n_patients)
        return cls(
            name=name,
            description=description or f"subjects with event {name}",
            subjects=bits,
            n_patients=n_patients,
            events=events,
        )

    @classmethod
    def from_patient_table(cls, name: str, patients: ColumnarTable, n_patients: int) -> "Cohort":
        bits = Bitset.from_indices(patients.columns["patient_id"], patients.valid, n_patients)
        return cls(name=name, description=name, subjects=bits, n_patients=n_patients)

    # -- paper API ------------------------------------------------------------
    def subject_count(self) -> int:
        return int(Bitset.count(self.subjects))

    def subjects_mask(self) -> torch.Tensor:
        """Per-patient bool membership mask.  The unpack of the packed
        subject bitset is memoized per subjects array — the ">25 statistics"
        battery hits this once per ``stats.compute`` instead of once per
        statistic."""
        cached = self.__dict__.get("_subjects_mask_cache")
        if cached is not None and cached[0] is self.subjects:
            return cached[1]
        mask = Bitset.to_mask(self.subjects, self.n_patients)
        self.__dict__["_subjects_mask_cache"] = (self.subjects, mask)
        return mask

    def describe(self) -> str:
        return self.description

    def _combine(self, other: "Cohort", bits: torch.Tensor, desc: str, name: str,
                 window: Tuple[int, int]) -> "Cohort":
        if self.n_patients != other.n_patients:
            raise ValueError("cohorts live in different patient universes")
        ev = self.events
        if ev is not None:
            keep_mask = Bitset.to_mask(bits, self.n_patients)
            pid = ev.columns["patient_id"].to(torch.int64)
            ev = ev.filter(keep_mask[torch.clamp(pid, 0, self.n_patients - 1)])
        return Cohort(name=name, description=desc, subjects=bits,
                      n_patients=self.n_patients, events=ev, window=window)

    def intersection(self, other: "Cohort") -> "Cohort":
        # a subject must satisfy both -> coverage is the window overlap
        return self._combine(
            other, self.subjects & other.subjects,
            f"{self.description} with {other.description}",
            f"{self.name}&{other.name}",
            (max(self.window[0], other.window[0]),
             min(self.window[1], other.window[1])),
        )

    def union(self, other: "Cohort") -> "Cohort":
        # either side suffices -> coverage spans both windows
        return self._combine(
            other, self.subjects | other.subjects,
            f"{self.description} or {other.description}",
            f"{self.name}|{other.name}",
            (min(self.window[0], other.window[0]),
             max(self.window[1], other.window[1])),
        )

    def difference(self, other: "Cohort") -> "Cohort":
        # subjects (and events) all come from self -> keep self's coverage
        return self._combine(
            other, self.subjects & ~other.subjects,
            f"{self.description} without {other.description}",
            f"{self.name}-{other.name}",
            self.window,
        )

    # granular control: underlying tables stay reachable (paper: "More
    # granular control is kept available through accesses to the underlying
    # Spark DataFrames")
    def events_of(self) -> Optional[ColumnarTable]:
        return self.events


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CohortCollection:
    """Named cohorts + shared metadata (paper §3.5)."""

    cohorts: Dict[str, Cohort]
    metadata: Optional[OperationLog] = None

    @property
    def cohorts_names(self) -> set:
        return set(self.cohorts)

    def get(self, name: str) -> Cohort:
        return self.cohorts[name]

    def add(self, cohort: Cohort) -> None:
        self.cohorts[cohort.name] = cohort

    @classmethod
    def from_extractions(cls, named_events: Dict[str, ColumnarTable], n_patients: int,
                         metadata: Optional[OperationLog] = None) -> "CohortCollection":
        return cls(
            {n: Cohort.from_events(n, ev, n_patients) for n, ev in named_events.items()},
            metadata=metadata,
        )


# ---------------------------------------------------------------------------
class CohortFlow:
    """Ordered left fold of intersections with per-stage tracking."""

    def __init__(self, cohorts: Sequence[Cohort]):
        if not cohorts:
            raise ValueError("empty flow")
        self.inputs = list(cohorts)
        self.steps: List[Cohort] = [cohorts[0]]
        for c in cohorts[1:]:
            self.steps.append(self.steps[-1].intersection(c))

    @property
    def final(self) -> Cohort:
        return self.steps[-1]

    def flowchart(self) -> List[Dict[str, object]]:
        rows = []
        prev = None
        for inp, st in zip(self.inputs, self.steps):
            n = st.subject_count()
            rows.append({
                "stage": inp.name,
                "subjects": n,
                "removed": (prev - n) if prev is not None else 0,
                "description": st.description,
            })
            prev = n
        return rows

    def render(self) -> str:
        lines = [f"{'stage':32s} {'subjects':>10s} {'removed':>8s}"]
        for r in self.flowchart():
            lines.append(f"{r['stage']:32s} {r['subjects']:10d} {r['removed']:8d}")
        return "\n".join(lines)
