"""Star tables between numpy and the port.

A star travels as ``{table name: {"columns": {name: ndarray}, "valid":
uint32 words, "count": int, "capacity": int}}`` — the packed validity words
viewed as ``uint32`` exactly as the reference stores them.  The tests feed
one seeded star into both packages through this form (weights have no place
in this system; data takes theirs).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.columnar import ColumnarTable, as_tensor, resolve_device

__all__ = ["tables_from_numpy", "tables_to_numpy"]


def tables_from_numpy(star: Mapping[str, Mapping], device=None
                      ) -> Dict[str, ColumnarTable]:
    """Numpy star -> port tables on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    out = {}
    for name, t in star.items():
        cols = {k: as_tensor(np.asarray(v), dev)
                for k, v in t["columns"].items()}
        words = as_tensor(np.asarray(t["valid"], np.uint32), dev)
        out[name] = ColumnarTable(
            cols, words, torch.tensor(int(t["count"]), dtype=torch.int32,
                                      device=dev), int(t["capacity"]))
    return out


def tables_to_numpy(tables: Mapping[str, ColumnarTable]) -> Dict[str, Dict]:
    """Port tables -> numpy star (validity words as uint32)."""
    return {name: {"columns": {k: v.cpu().numpy()
                               for k, v in t.columns.items()},
                   "valid": t.valid.cpu().numpy().view(np.uint32),
                   "count": int(t.count), "capacity": int(t.capacity)}
            for name, t in tables.items()}
