"""ColumnarTable: fixed-capacity struct-of-arrays tables on a torch device.

The port of ``repro.core.columnar``.  A table has a static *capacity*
(allocated rows) and a *count* (valid rows); ``valid`` is a packed bitset of
int32 words (``core.bitset`` layout).  ``count`` stays a 0-d device tensor so
that no table op waits for the device.

Every entry point that creates tables from host data takes ``device``;
``None`` means ``"cuda"`` and raises where CUDA is absent — the port never
falls back to the CPU on its own.  Ops on existing tables keep their
tensors' device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bitset as _bs

__all__ = [
    "ColumnarTable",
    "NULL_INT",
    "NULL_FLOAT",
    "is_null",
    "resolve_device",
]

# Sentinel encodings for nulls (identical to the reference's).
NULL_INT = -2_147_483_648 + 1  # INT32_MIN+1, keeps INT32_MIN usable for -inf keys
NULL_FLOAT = float("nan")

_NP_TO_TORCH = {np.dtype(np.int32): torch.int32,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.bool_): torch.bool}


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without CUDA raises (the port
    never carries on on the CPU unless the caller asks for it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def as_tensor(x, device) -> torch.Tensor:
    """Host array or tensor -> tensor on ``device`` (numpy dtypes kept)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()               # torch.from_numpy needs a writable buffer
    return torch.from_numpy(a).to(device)


def is_null(col: torch.Tensor) -> torch.Tensor:
    """Elementwise null mask for a sentinel-encoded column."""
    if col.dtype.is_floating_point:
        return torch.isnan(col)
    return col == NULL_INT


def max_key(dtype: torch.dtype):
    if dtype.is_floating_point:
        return torch.finfo(dtype).max
    return torch.iinfo(dtype).max


@dataclasses.dataclass
class ColumnarTable:
    """Fixed-capacity struct-of-arrays table with a packed-bitset validity.

    Attributes:
      columns:  name -> (capacity,) tensor.  All columns share the capacity.
      valid:    (ceil(capacity/32),) int32 packed row-validity words (bits >=
                capacity are 0).  A bool ``(capacity,)`` row mask may be
                passed instead; the constructor packs it.
      count:    0-d int32 tensor — number of valid rows (== popcount(valid)).
      capacity: static row capacity; derived from the columns (or a bool
                mask) when omitted.
    """

    columns: Dict[str, torch.Tensor]
    valid: torch.Tensor
    count: torch.Tensor
    capacity: Optional[int] = None

    def __post_init__(self):
        v = self.valid
        if not _bs.is_packed(v):
            v = v.to(torch.bool)
            if self.capacity is None:
                self.capacity = int(v.shape[0])
            self.valid = _bs.pack(v)
        elif self.capacity is None:
            if not self.columns:
                raise ValueError(
                    "packed validity needs at least one column (or an "
                    "explicit capacity) to recover the row capacity")
            self.capacity = int(next(iter(self.columns.values())).shape[0])

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_columns(cls, columns: Mapping[str, object], valid=None,
                     device=None) -> "ColumnarTable":
        """Build a table on ``device`` (``None`` = CUDA).  ``valid`` may be a
        ``(capacity,) bool`` row mask or packed words (int32 tensor, or a
        uint32/int32 numpy array); either form is length-checked."""
        dev = resolve_device(device)
        cols = {k: as_tensor(v, dev) for k, v in columns.items()}
        cap = next(iter(cols.values())).shape[0]
        for k, v in cols.items():
            if v.shape[0] != cap:
                raise ValueError(f"column {k!r} capacity {v.shape[0]} != {cap}")
        if valid is None:
            words = _bs.first_n(cap, cap, device=dev)
            return cls(dict(cols), words,
                       torch.tensor(cap, dtype=torch.int32, device=dev),
                       int(cap))
        valid = as_tensor(valid, dev)
        if _bs.is_packed(valid):
            if valid.shape[0] != _bs.n_words(cap):
                raise ValueError(
                    f"packed valid has {valid.shape[0]} words but capacity "
                    f"{cap} needs {_bs.n_words(cap)}")
            valid = valid & _bs.first_n(cap, cap, device=dev)
            return cls(dict(cols), valid, _bs.count(valid), int(cap))
        valid = valid.to(torch.bool)
        if valid.shape[0] != cap:
            raise ValueError(
                f"valid mask length {valid.shape[0]} != capacity {cap}")
        return cls(dict(cols), _bs.pack(valid),
                   valid.sum().to(torch.int32), int(cap))

    @classmethod
    def empty(cls, spec: Mapping[str, np.dtype], capacity: int,
              device=None) -> "ColumnarTable":
        dev = resolve_device(device)
        cols = {k: torch.zeros((capacity,), dtype=_NP_TO_TORCH[np.dtype(dt)],
                               device=dev) for k, dt in spec.items()}
        valid = torch.zeros((_bs.n_words(capacity),), dtype=torch.int32,
                            device=dev)
        return cls(cols, valid, torch.zeros((), dtype=torch.int32, device=dev),
                   int(capacity))

    # -- basic properties ----------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.valid.device

    @property
    def column_names(self) -> tuple:
        return tuple(sorted(self.columns))

    def num_valid(self) -> torch.Tensor:
        return self.count

    def valid_bool(self) -> torch.Tensor:
        """Per-row bool validity (the explicit expansion boundary)."""
        return _bs.unpack(self.valid, self.capacity)

    def valid_numpy(self) -> np.ndarray:
        """Host-side per-row bool validity (numpy)."""
        return _bs.unpack_np(self.valid.cpu().numpy(), self.capacity)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def to(self, device) -> "ColumnarTable":
        """The same table on ``device``."""
        dev = torch.device(device)
        return ColumnarTable({k: v.to(dev) for k, v in self.columns.items()},
                             self.valid.to(dev), self.count.to(dev),
                             self.capacity)

    # -- columnar ops (paper Fig. 2 steps) ------------------------------------
    def select(self, names: Sequence[str]) -> "ColumnarTable":
        """Column projection: metadata only."""
        return ColumnarTable({n: self.columns[n] for n in names},
                             self.valid, self.count, self.capacity)

    def with_columns(self, extra: Mapping[str, torch.Tensor]) -> "ColumnarTable":
        cols = dict(self.columns)
        cols.update(extra)
        return ColumnarTable(cols, self.valid, self.count, self.capacity)

    def filter(self, mask: torch.Tensor) -> "ColumnarTable":
        """Lazy row filter: a word-wise AND into the validity bitset.
        ``mask`` is a ``(capacity,) bool`` row mask or packed words."""
        if _bs.is_packed(mask):
            new_valid = self.valid & mask
        else:
            new_valid = self.valid & _bs.pack(mask.to(torch.bool))
        return ColumnarTable(self.columns, new_valid, _bs.count(new_valid),
                             self.capacity)

    def drop_nulls(self, names: Sequence[str]) -> "ColumnarTable":
        """Null filtering via mask algebra."""
        mask = None
        for n in names:
            ok = ~is_null(self.columns[n])
            mask = ok if mask is None else mask & ok
        if mask is None:
            return self
        return self.filter(mask)

    def compact(self) -> "ColumnarTable":
        """Gather valid rows to the front, preserving order (the ``torch``
        compaction engine).

        The inclusive rank of row ``i`` is rebuilt from the packed words
        (exclusive cumsum of per-word popcounts plus an in-word masked
        popcount); output slot ``j`` gathers ``searchsorted(rank, j+1)``.
        Slots past ``count`` hold clamped gathered rows (the last row), as in
        the reference, and are marked invalid word-wise."""
        cap = self.capacity
        if cap == 0:
            return self
        dev = self.device
        words = self.valid
        per_word = _bs.popcount(words)
        excl = torch.cumsum(per_word, 0, dtype=torch.int32) - per_word
        rows = torch.arange(cap, dtype=torch.int64, device=dev)
        w, b = rows >> 5, rows & 31
        upto = ((torch.ones_like(b) << (b + 1)) - 1)       # bits <= b
        within = _bs.popcount(words[w].to(torch.int64) & upto)
        rank = excl[w] + within                            # inclusive rank
        idx = torch.searchsorted(rank, (rows + 1).to(torch.int32),
                                 side="left")
        idx = torch.clamp(idx, max=cap - 1)
        cols = {k: v[idx] for k, v in self.columns.items()}
        return ColumnarTable(cols, _bs.first_n(self.count, cap), self.count,
                             cap)

    def take(self, idx: torch.Tensor,
             idx_valid: Optional[torch.Tensor] = None) -> "ColumnarTable":
        """Row gather.  ``idx_valid`` marks which gathered rows exist."""
        cols = {k: v[idx] for k, v in self.columns.items()}
        valid = _bs.bit_at(self.valid, idx)
        if idx_valid is not None:
            valid = valid & idx_valid
        return ColumnarTable(cols, valid, valid.sum().to(torch.int32))

    def sort_by(self, names: Sequence[str]) -> "ColumnarTable":
        """Stable lexicographic sort; invalid rows sink to the end.

        ``jnp.lexsort`` becomes a chain of stable sorts, least significant
        key first; the most significant key is the invalid flag."""
        if self.capacity == 0:
            return self
        dev = self.device
        rows = torch.arange(self.capacity, dtype=torch.int64, device=dev)
        bit = _bs.bit_at(self.valid, rows)
        keys = []
        for n in reversed(list(names)):      # least significant first
            col = self.columns[n]
            keys.append(torch.where(bit, col, max_key(col.dtype)))
        keys.append((~bit).to(torch.int32))
        idx = rows
        for k in keys:
            idx = idx[torch.argsort(k[idx], stable=True)]
        cols = {k: v[idx] for k, v in self.columns.items()}
        return ColumnarTable(cols, _bs.first_n(self.count, self.capacity),
                             self.count, self.capacity)

    def shrink_to(self, capacity: int) -> "ColumnarTable":
        """Truncate to a smaller static capacity (inverse of ``pad_to``)."""
        if capacity >= self.capacity:
            return self
        cols = {k: v[:capacity] for k, v in self.columns.items()}
        valid = self.valid[: _bs.n_words(capacity)] & \
            _bs.first_n(capacity, capacity, device=self.device)
        return ColumnarTable(cols, valid, _bs.count(valid), int(capacity))

    def pad_to(self, capacity: int) -> "ColumnarTable":
        if capacity < self.capacity:
            raise ValueError("pad_to cannot shrink a table")
        extra = capacity - self.capacity
        cols = {k: torch.nn.functional.pad(v, (0, extra))
                for k, v in self.columns.items()}
        valid = torch.nn.functional.pad(
            self.valid, (0, _bs.n_words(capacity) - self.valid.shape[0]))
        return ColumnarTable(cols, valid, self.count, int(capacity))

    @staticmethod
    def concat(tables: Sequence["ColumnarTable"]) -> "ColumnarTable":
        names = tables[0].column_names
        for t in tables[1:]:
            if t.column_names != names:
                raise ValueError("concat: mismatched schemas")
        cols = {n: torch.cat([t.columns[n] for t in tables]) for n in names}
        if all(t.capacity % _bs.WORD_BITS == 0 for t in tables[:-1]):
            valid = torch.cat([t.valid for t in tables])
        else:
            valid = _bs.pack(torch.cat([t.valid_bool() for t in tables]))
        count = torch.stack([t.count for t in tables]).sum().to(torch.int32)
        capacity = sum(t.capacity for t in tables)
        return ColumnarTable(cols, valid, count, capacity)

    # -- host-side conveniences ----------------------------------------------
    def to_numpy(self) -> Dict[str, np.ndarray]:
        n = int(self.count)
        idx = np.argsort(~self.valid_numpy(), kind="stable")[:n]
        return {k: v.cpu().numpy()[idx] for k, v in self.columns.items()}

    def head(self, n: int = 8) -> str:
        data = self.to_numpy()
        names = list(data)
        lines = ["| " + " | ".join(names) + " |"]
        m = min(n, len(next(iter(data.values()))) if data else 0)
        for i in range(m):
            lines.append("| " + " | ".join(str(data[c][i]) for c in names) + " |")
        return "\n".join(lines)

    # -- monitoring (paper §3.3: statistics proving no information loss) -----
    def monitoring_stats(self, key: str) -> Dict[str, torch.Tensor]:
        """Row count and order-independent checksums of the ``key`` column
        over the valid rows, as the reference's: ``rows`` (int32),
        ``key_sum`` (the uint32 modular sum of the keys' 32-bit patterns)
        and ``key_xor`` (their xor).  The checksums are 0-d int64 tensors
        holding the uint32 value (torch has no uint32 arithmetic)."""
        from repro_torch.core.flattening import key_checksum

        valid = self.valid_bool()
        words = torch.where(valid, self.columns[key].to(torch.int64)
                            & 0xFFFFFFFF, 0)
        # torch has no xor reduction: fold the halves until one word is left
        while words.numel() > 1:
            half = words.numel() // 2
            folded = words[:half] ^ words[half:2 * half]
            words = torch.cat([folded, words[2 * half:]])
        return {"rows": self.count.to(torch.int32),
                "key_sum": key_checksum(self.columns[key], valid),
                "key_xor": words.sum()}
