"""FeatureDriver: cohorts -> ML tensor formats (paper §3.5).

The port of ``repro.core.feature_driver``:

  * ``dense_features``   — (patients × time-buckets × features) scatter-add
                           tensor (the ConvSCCS-style longitudinal design
                           matrix of paper ref. [27]);
  * ``token_sequences``  — per-patient event-code token streams for language
                           models;
  * ``to_numpy``         — host export for external libraries.

Flat indices are int64 here, where the reference computes them in int32:
the two agree wherever the reference's do not wrap, i.e. below 2**31 /
(n_buckets * n_features) patients for the design matrix and 2**31 / seq_len
for the tokens (ROADMAP C7).  Scatters follow the reference's ``mode="drop"``
(negative indices count from the end; the rest out of range are dropped,
spread over spare slots: ``transformers.drop_index``).
The design matrix sums float32 weights with ``index_add_``, whose order on
the card is not fixed: it equals the reference bit for bit while each cell's
sum is exact, as it is for integer weights (dispense counts, or 1.0) below
2**24.

Sanity checks mirror the paper: events outside the cohort window or with
inconsistent dates are counted and excluded, never silently kept.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cohort import Cohort
from repro_torch.core.columnar import ColumnarTable, as_tensor, is_null
from repro_torch.core.events import Category
from repro_torch.core.transformers import SPARE_SLOTS, drop_index, scatter_set

__all__ = ["FeatureDriver", "TokenizerSpec"]

# LM special tokens for event streams
PAD, BOS, EOS = 0, 1, 2
N_SPECIAL = 8  # room for time-gap buckets etc.


@dataclasses.dataclass(frozen=True)
class TokenizerSpec:
    """Event -> token mapping: token = offset[category] + value (clipped)."""

    category_offsets: Dict[int, int]
    category_sizes: Dict[int, int]

    @classmethod
    def default(cls, n_drug: int = 512, n_act: int = 512,
                n_diag: int = 512) -> "TokenizerSpec":
        offs, sizes, cur = {}, {}, N_SPECIAL
        for cat, n in ((Category.DRUG_DISPENSE, n_drug),
                       (Category.MEDICAL_ACT, n_act),
                       (Category.DIAGNOSIS, n_diag),
                       (Category.HOSPITAL_STAY, 256),
                       (Category.EXPOSURE, n_drug),
                       (Category.OUTCOME_FRACTURE, 64)):
            offs[cat], sizes[cat] = cur, n
            cur += n
        return cls(offs, sizes)

    @property
    def vocab_size(self) -> int:
        return N_SPECIAL + sum(self.category_sizes.values())


class FeatureDriver:
    def __init__(self, cohort: Cohort, patients: Optional[ColumnarTable] = None):
        if cohort.events is None:
            raise ValueError("FeatureDriver needs a cohort with events")
        self.cohort = cohort
        self.patients = patients
        self.checks: Dict[str, int] = {}

    # -- sanity checks ---------------------------------------------------------
    def _checked_events(self) -> ColumnarTable:
        ev = self.cohort.events
        t0, t1 = self.cohort.window
        start = ev.columns["start"]
        end = ev.columns["end"]
        in_window = (start >= t0) & (start < t1)
        dates_ok = is_null(end) | (end >= start)
        keep = in_window & dates_ok
        evv = ev.valid_bool()
        self.checks = {
            "events_total": int(ev.count),
            "events_out_of_window": int((evv & ~in_window).sum()),
            "events_bad_dates": int((evv & ~dates_ok).sum()),
        }
        return ev.filter(keep)

    # -- dense longitudinal tensor ----------------------------------------------
    def dense_features(self, n_buckets: int, bucket_days: int, n_features: int,
                       feature_of_value=None) -> torch.Tensor:
        """(n_patients, n_buckets, n_features) float32 scatter-add design
        matrix.  ``feature_of_value`` (host array or tensor) maps an event
        value to its feature column."""
        ev = self._checked_events()
        P = self.cohort.n_patients
        t0 = self.cohort.window[0]
        dev = ev.device
        b = torch.clamp(torch.div(ev.columns["start"] - t0, bucket_days,
                                  rounding_mode="floor"), 0, n_buckets - 1)
        v = ev.columns["value"]
        if feature_of_value is not None:
            fov = as_tensor(feature_of_value, dev)
            f = fov[torch.clamp(v, 0, fov.shape[0] - 1).to(torch.int64)]
        else:
            f = torch.clamp(v, 0, n_features - 1)
        pid = torch.clamp(ev.columns["patient_id"], 0, P - 1).to(torch.int64)
        size = P * n_buckets * n_features
        flat = (pid * n_buckets + b) * n_features + f
        flat = drop_index(torch.where(ev.valid_bool(), flat, size), size)
        out = torch.zeros((size + SPARE_SLOTS,), dtype=torch.float32,
                          device=dev)
        out.index_add_(0, flat, ev.columns["weight"])
        return out[:size].view(P, n_buckets, n_features)

    # -- LM token streams --------------------------------------------------------
    def token_sequences(self, seq_len: int, spec: Optional[TokenizerSpec] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(n_patients, seq_len) int32 tokens + bool mask, time-ordered.

        Each patient's claims history becomes a token stream
        ``BOS e1 e2 ... EOS PAD...``; overflowing events are truncated (kept
        count is in ``self.checks``)."""
        spec = spec or TokenizerSpec.default()
        ev = self._checked_events().sort_by(["patient_id", "start", "category",
                                             "value"])
        P = self.cohort.n_patients
        dev = ev.device
        i32 = torch.int32

        cat = ev.columns["category"]
        val = ev.columns["value"]
        tok = torch.full((ev.capacity,), PAD, dtype=i32, device=dev)
        for c, off in spec.category_offsets.items():
            n = spec.category_sizes[c]
            tok = torch.where(cat == c, off + torch.clamp(val, 0, n - 1), tok)
        known = tok != PAD

        pid = ev.columns["patient_id"].to(torch.int64)
        evv = ev.valid_bool()
        ok = evv & known
        # position within patient = rank among valid rows of the same patient
        seg = torch.where(ok, pid, P)
        one = ok.to(i32)
        cum = torch.cumsum(one, 0, dtype=i32) - one  # exclusive prefix count
        # min of exclusive-cumsum within a segment = count before its start
        seg_start = torch.full((P + 1 + SPARE_SLOTS,), 1 << 30, dtype=i32,
                               device=dev)
        seg_start.scatter_reduce_(0, drop_index(seg, P + 1), cum,
                                  reduce="amin", include_self=True)
        pos = cum - seg_start[torch.clamp(seg, 0, P)]
        slot = torch.where(ok & (pos < seq_len - 2), pid * seq_len + 1 + pos,
                           P * seq_len)

        toks = scatter_set(torch.full((P * seq_len,), PAD, dtype=i32,
                                      device=dev), slot, tok)
        toks = toks.view(P, seq_len)
        toks[:, 0] = BOS
        n_per = torch.zeros((P + 1,), dtype=i32, device=dev).scatter_add_(
            0, torch.clamp(seg, 0, P), one)[:P]
        eos_pos = torch.clamp(n_per + 1, 1, seq_len - 1)
        toks[torch.arange(P, device=dev), eos_pos.to(torch.int64)] = EOS
        mask = torch.arange(seq_len, device=dev)[None, :] <= eos_pos[:, None]
        self.checks["events_truncated"] = int(
            (evv & known & (pos >= seq_len - 2)).sum())
        return toks, mask

    # -- host export --------------------------------------------------------------
    def to_numpy(self, **kw) -> Dict[str, np.ndarray]:
        X = self.dense_features(**kw)
        return {"features": X.cpu().numpy(),
                "subjects": self.cohort.subjects_mask().cpu().numpy()}
