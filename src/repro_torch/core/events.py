"""Patient / Event abstractions (paper §3.4) in columnar batch form.

The port of ``repro.core.events``: ``Event(patientID, category, groupID,
value, weight, start, end)`` batches are ``ColumnarTable``s with the
standardized schema; punctual events carry ``end == NULL``.
"""
from __future__ import annotations

import torch

from repro_torch.core.columnar import ColumnarTable, NULL_INT

__all__ = ["Category", "make_events", "empty_events", "sort_events", "EVENT_COLUMNS"]


class Category:
    """Event-category vocabulary (extractor outputs + transformer outputs)."""

    DRUG_DISPENSE = 1
    MEDICAL_ACT = 2
    DIAGNOSIS = 3
    HOSPITAL_STAY = 4
    BIOLOGY = 5
    PRACTITIONER = 6
    # transformer-produced (complex) events:
    FOLLOW_UP = 10
    EXPOSURE = 11
    OUTCOME_FRACTURE = 12
    TRACKLOSS = 13
    OBSERVATION = 14

    NAMES = {
        1: "drug_dispense", 2: "medical_act", 3: "diagnosis", 4: "hospital_stay",
        5: "biology", 6: "practitioner", 10: "follow_up", 11: "exposure",
        12: "fracture", 13: "trackloss", 14: "observation",
    }


EVENT_COLUMNS = ("patient_id", "category", "group_id", "value", "weight", "start", "end")


def make_events(patient_id: torch.Tensor, category, value: torch.Tensor,
                start: torch.Tensor, end=None, group_id=None, weight=None,
                valid=None) -> ColumnarTable:
    """Assemble a standardized event batch on ``patient_id``'s device."""
    n = patient_id.shape[0]
    dev = patient_id.device
    i32 = torch.int32
    cols = {
        "patient_id": patient_id.to(i32),
        "category": torch.full((n,), int(category), dtype=i32, device=dev),
        "group_id": (group_id if group_id is not None
                     else torch.zeros((n,), dtype=i32, device=dev)).to(i32),
        "value": value.to(i32),
        "weight": (weight if weight is not None
                   else torch.ones((n,), dtype=torch.float32, device=dev)
                   ).to(torch.float32),
        "start": start.to(i32),
        "end": (end if end is not None
                else torch.full((n,), NULL_INT, dtype=i32, device=dev)).to(i32),
    }
    return ColumnarTable.from_columns(cols, valid=valid, device=dev)


def empty_events(capacity: int, device=None) -> ColumnarTable:
    from repro_torch.core.columnar import resolve_device

    z = torch.zeros((capacity,), dtype=torch.int32, device=resolve_device(device))
    return make_events(z, 0, z, z, valid=torch.zeros((capacity,), dtype=torch.bool,
                                                      device=z.device))


def sort_events(events: ColumnarTable) -> ColumnarTable:
    """Canonical event order: (patient, start, category, value)."""
    return events.sort_by(["patient_id", "start", "category", "value"])
