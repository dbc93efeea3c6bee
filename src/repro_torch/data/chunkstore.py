"""Partitioned on-disk star schema — the substrate for out-of-core execution.

The port of ``repro.data.chunkstore``, byte-compatible with it: a store
written by either package opens in the other with the same manifest, chunk
hashes and ``fingerprint()``.  Tables come back on ``device`` (None = CUDA);
``read_chunk_into`` fills caller-owned host buffers (the chunked executor's
pinned staging).

SCALPEL3's headline run flattens 15e9 events (~15 TB) — far past any single
device's memory.  ``ChunkStore`` makes that shape executable: the star's
central (fact) table is partitioned into fixed-capacity, 32-row-aligned
chunks persisted as packed-npz files (``data/io.py`` format: ``col::*``
members + the canonical ``__valid__`` uint32 bitset), while the small
dimension tables stay resident.  A JSON manifest records per-chunk row
counts, key ranges and content hashes, so a reader can plan, verify and
resume without touching the chunk payloads.

Layout of a store directory::

    store/
      manifest.json            # ChunkManifest (versioned)
      chunk_00000.npz          # fixed-capacity slices of the central table
      chunk_00001.npz
      ...
      resident/<name>.npz      # dimension tables, loaded whole

Alignment contract: ``chunk_capacity % 32 == 0`` (``bitset.WORD_BITS``), so
every chunk boundary falls exactly on a validity-word boundary and the
source table's packed words slice into per-chunk bitsets with **zero**
repacking — the same quantum ``distributed.pipeline.pad_tables_for_mesh``
uses for shard splits (chunks therefore re-pad to any 32*n_shards mesh for
free).  The writer refuses misaligned capacities; the static analyzer
(SP015) rejects misaligned *manifests* before an executor ever streams one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np

from repro_torch.core import bitset as _bs
from repro_torch.core.columnar import ColumnarTable
from repro_torch.data.io import (host_array, host_words, load_columnar_arrays,
                                 load_star, read_columnar_into,
                                 save_columnar_arrays)

__all__ = ["ChunkMeta", "ChunkManifest", "ChunkStore", "partition_star"]

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1
WORD = _bs.WORD_BITS  # 32 — the row quantum every chunk boundary respects


@dataclasses.dataclass(frozen=True)
class ChunkMeta:
    """Per-chunk facts a reader can plan/verify against without IO."""

    index: int
    rows: int                       # valid rows (popcount of the bitset)
    key_lo: Optional[int]           # min/max partition key among valid rows
    key_hi: Optional[int]           # (None for an all-invalid chunk)
    sha256: str                     # content hash of columns + validity

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Mapping) -> "ChunkMeta":
        return cls(index=int(d["index"]), rows=int(d["rows"]),
                   key_lo=d["key_lo"], key_hi=d["key_hi"],
                   sha256=str(d["sha256"]))


@dataclasses.dataclass(frozen=True)
class ChunkManifest:
    """The store's self-description (``manifest.json``)."""

    source: str                     # name of the chunked central table
    key: str                        # partition key column (row-order ranges)
    chunk_capacity: int             # fixed per-chunk capacity (rows)
    total_rows: int                 # sum of per-chunk valid rows
    columns: Dict[str, str]         # central-table schema: name -> dtype str
    resident: Tuple[str, ...]       # dimension tables stored whole
    chunks: Tuple[ChunkMeta, ...]
    version: int = MANIFEST_VERSION

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["chunks"] = [c.to_json() for c in self.chunks]
        d["resident"] = list(self.resident)
        return d

    @classmethod
    def from_json(cls, d: Mapping) -> "ChunkManifest":
        return cls(source=str(d["source"]), key=str(d["key"]),
                   chunk_capacity=int(d["chunk_capacity"]),
                   total_rows=int(d["total_rows"]),
                   columns=dict(d["columns"]),
                   resident=tuple(d["resident"]),
                   chunks=tuple(ChunkMeta.from_json(c) for c in d["chunks"]),
                   version=int(d.get("version", MANIFEST_VERSION)))

    def fingerprint(self) -> str:
        """Content identity of the whole store (chunk hashes included) —
        what the chunked executor's checkpoint journal stamps, so a resumed
        run refuses to mix partial state from a different dataset."""
        blob = json.dumps(self.to_json(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()


def _chunk_hash(cols: Mapping[str, np.ndarray], valid: np.ndarray) -> str:
    h = hashlib.sha256()
    for name in sorted(cols):
        a = np.ascontiguousarray(cols[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    h.update(b"__valid__")
    h.update(np.ascontiguousarray(valid).tobytes())
    return h.hexdigest()


def _chunk_fname(i: int) -> str:
    return f"chunk_{i:05d}.npz"


def _host_arrays(t: ColumnarTable) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    return ({k: host_array(v) for k, v in t.columns.items()},
            host_words(t.valid))


def partition_star(tables: Union[str, Mapping[str, ColumnarTable]],
                   dirpath: str, source: str, chunk_capacity: int,
                   key: str = "patient_id", compressed: bool = False,
                   mmap_mode: Optional[str] = "r") -> "ChunkStore":
    """Write a ``ChunkStore`` under ``dirpath``: ``tables[source]`` split
    into fixed-capacity chunks, every other table stored resident.

    ``tables`` may be an in-memory ``{name: ColumnarTable}`` star or a path
    to a ``data.io.save_star`` directory — the latter streams through
    ``mmap_mode`` so peak host memory stays ~one chunk, not the whole
    central table (the io.py bugfix this subsystem rides on).  Chunks
    default to uncompressed npz so the chunked executor's prefetch thread
    can mmap them back; pass ``compressed=True`` to trade load CPU for disk.
    """
    chunk_capacity = int(chunk_capacity)
    if chunk_capacity <= 0 or chunk_capacity % WORD:
        raise ValueError(
            f"chunk_capacity must be a positive multiple of {WORD} (the "
            f"validity word quantum), got {chunk_capacity}: chunk boundaries "
            "must fall on packed-bitset word boundaries")

    if isinstance(tables, str):
        names = sorted(f[:-4] for f in os.listdir(tables)
                       if f.endswith(".npz"))
        if source not in names:
            raise KeyError(f"source table {source!r} not in star dir "
                           f"{tables!r} (found {names})")
        src_cols, src_valid = load_columnar_arrays(
            os.path.join(tables, source), mmap_mode=mmap_mode)
        resident_arrays = {
            n: load_columnar_arrays(os.path.join(tables, n),
                                    mmap_mode=mmap_mode)
            for n in names if n != source}
    else:
        if source not in tables:
            raise KeyError(f"source table {source!r} not among {sorted(tables)}")
        src_cols, src_valid = _host_arrays(tables[source])
        resident_arrays = {n: _host_arrays(t) for n, t in tables.items()
                           if n != source}
    if key not in src_cols:
        raise KeyError(f"partition key {key!r} not a column of {source!r}")

    os.makedirs(dirpath, exist_ok=True)
    res_dir = os.path.join(dirpath, "resident")
    for name, (cols, valid) in resident_arrays.items():
        os.makedirs(res_dir, exist_ok=True)
        save_columnar_arrays(cols, valid, os.path.join(res_dir, name),
                             compressed=compressed)

    cap = next(iter(src_cols.values())).shape[0] if src_cols else 0
    n_chunks = max(1, -(-cap // chunk_capacity))
    metas = []
    total_rows = 0
    for ci in range(n_chunks):
        i0 = ci * chunk_capacity
        i1 = min(cap, i0 + chunk_capacity)
        # i0 % 32 == 0, so the packed words slice exactly on the chunk
        # boundary — each chunk's words ARE the bitset of its local rows
        words = np.asarray(src_valid[i0 // WORD: -(-i1 // WORD)],
                           dtype=np.uint32)
        cols = {}
        for name, col in src_cols.items():
            sl = np.asarray(col[i0:i1])
            if sl.shape[0] < chunk_capacity:
                pad = np.zeros(chunk_capacity, dtype=sl.dtype)
                pad[: sl.shape[0]] = sl
                sl = pad
            cols[name] = sl
        if words.shape[0] < chunk_capacity // WORD:
            words = np.pad(words,
                           (0, chunk_capacity // WORD - words.shape[0]))
        vmask = _bs.unpack_np(words, chunk_capacity)
        rows = int(vmask.sum())
        lo = hi = None
        if rows:
            kvals = cols[key][vmask]
            lo, hi = int(kvals.min()), int(kvals.max())
        save_columnar_arrays(cols, words,
                             os.path.join(dirpath, _chunk_fname(ci)),
                             compressed=compressed)
        metas.append(ChunkMeta(index=ci, rows=rows, key_lo=lo, key_hi=hi,
                               sha256=_chunk_hash(cols, words)))
        total_rows += rows

    manifest = ChunkManifest(
        source=source, key=key, chunk_capacity=chunk_capacity,
        total_rows=total_rows,
        columns={n: str(np.asarray(c).dtype) for n, c in src_cols.items()},
        resident=tuple(sorted(resident_arrays)), chunks=tuple(metas))
    tmp = os.path.join(dirpath, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest.to_json(), f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(dirpath, MANIFEST_NAME))
    # compressed members can never map — don't ask, or every chunk load
    # would warn about the degrade we just chose at write time
    return ChunkStore(dirpath, mmap_mode=None if compressed else mmap_mode)


class ChunkStore:
    """Reader over a partitioned store directory (see module docstring).

    ``load_chunk_arrays`` returns host numpy (mmap-backed when the chunks
    are uncompressed); ``read_chunk_into`` reads a chunk into the caller's
    host buffers (the chunked executor's pinned staging); ``chunk_table``
    wraps one chunk as a ``ColumnarTable`` on a device.
    """

    def __init__(self, dirpath: str, mmap_mode: Optional[str] = "r",
                 verify: bool = False) -> None:
        self.dirpath = dirpath
        self.mmap_mode = mmap_mode
        self.verify = bool(verify)
        mpath = os.path.join(dirpath, MANIFEST_NAME)
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"no {MANIFEST_NAME} under {dirpath!r} — not a chunk store "
                "(write one with partition_star / ChunkStore.create)")
        with open(mpath) as f:
            self.manifest = ChunkManifest.from_json(json.load(f))

    create = staticmethod(partition_star)

    # -- manifest facts ------------------------------------------------------
    @property
    def source(self) -> str:
        return self.manifest.source

    @property
    def n_chunks(self) -> int:
        return self.manifest.n_chunks

    @property
    def chunk_capacity(self) -> int:
        return self.manifest.chunk_capacity

    def fingerprint(self) -> str:
        return self.manifest.fingerprint()

    def chunk_path(self, i: int) -> str:
        return os.path.join(self.dirpath, _chunk_fname(i))

    # -- chunk IO ------------------------------------------------------------
    def load_chunk_arrays(self, i: int, verify: Optional[bool] = None
                          ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Host ``(columns, valid_words)`` of chunk ``i``; optionally check
        the payload against the manifest's content hash (corruption and
        torn-write detection for resumed runs)."""
        meta = self.manifest.chunks[i]
        cols, valid = load_columnar_arrays(self.chunk_path(i),
                                           mmap_mode=self.mmap_mode)
        if verify if verify is not None else self.verify:
            got = _chunk_hash(cols, valid)
            if got != meta.sha256:
                raise IOError(
                    f"chunk {i} content hash mismatch: manifest "
                    f"{meta.sha256[:12]}…, payload {got[:12]}… — the store "
                    "was modified or torn after partitioning")
        return cols, valid

    def read_chunk_into(self, i: int, out: Dict[str, np.ndarray]) -> None:
        """Read chunk ``i`` into ``out`` (column name / ``"__valid__"`` ->
        host buffer of ``chunk_capacity`` rows / words), straight from the
        file; with ``verify``, check the manifest's content hash."""
        read_columnar_into(self.chunk_path(i), out)
        if self.verify:
            cols = {k: v for k, v in out.items() if k != "__valid__"}
            got = _chunk_hash(cols, out["__valid__"].view(np.uint32))
            if got != self.manifest.chunks[i].sha256:
                raise IOError(
                    f"chunk {i} content hash mismatch: manifest "
                    f"{self.manifest.chunks[i].sha256[:12]}…, payload "
                    f"{got[:12]}… — the store was modified or torn after "
                    "partitioning")

    def chunk_table(self, i: int, verify: Optional[bool] = None,
                    device=None) -> ColumnarTable:
        """Chunk ``i`` as a ``ColumnarTable`` on ``device`` (None = CUDA)."""
        cols, valid = self.load_chunk_arrays(i, verify=verify)
        return ColumnarTable.from_columns(cols, valid=valid, device=device)

    def resident_tables(self, device=None) -> Dict[str, ColumnarTable]:
        """The dimension tables, loaded whole onto ``device``."""
        res_dir = os.path.join(self.dirpath, "resident")
        if not os.path.isdir(res_dir):
            return {}
        return load_star(res_dir, mmap_mode=self.mmap_mode, device=device)

    # -- integrity -----------------------------------------------------------
    def validate(self) -> None:
        """Structural manifest checks (payloads are checked per-load via
        ``verify``): alignment, chunk-file presence, row-count bounds.
        Plan-level alignment against a mesh is the analyzer's job (SP015)."""
        m = self.manifest
        if m.chunk_capacity <= 0 or m.chunk_capacity % WORD:
            raise ValueError(
                f"manifest chunk_capacity {m.chunk_capacity} is not a "
                f"positive multiple of {WORD}")
        for c in m.chunks:
            if c.rows > m.chunk_capacity:
                raise ValueError(f"chunk {c.index} claims {c.rows} rows > "
                                 f"capacity {m.chunk_capacity}")
            if not os.path.exists(self.chunk_path(c.index)):
                raise FileNotFoundError(f"chunk file missing: "
                                        f"{self.chunk_path(c.index)}")
