"""Columnar (de)serialization — the Parquet stand-in.

The port of ``repro.data.io``, in its file format: a file written by either
package loads in the other (``__valid__`` holds the packed validity words as
uint32; the port's int32 words are written as their uint32 bits).  Loads
that make tables put them on ``device`` (None = CUDA); the ``*_arrays``
functions stay on the host, and ``read_columnar_into`` reads a file's
members straight into caller-owned (e.g. pinned) host buffers.

The paper's storage story (Table 1): CSV exports are ~11x larger than the
columnar+compressed Parquet encoding.  Offline we persist ``ColumnarTable``s
as compressed ``.npz`` (column-major, zlib) and measure the same CSV-vs-
columnar ratio in ``benchmarks/table1_dataset.py``.

Out-of-core additions (the ``data.chunkstore`` substrate):

* ``compressed=False`` writes plain ``np.savez`` archives whose members are
  ZIP_STORED — raw ``.npy`` payloads at a fixed byte offset inside the zip.
* ``mmap_mode`` on the load side memory-maps those stored members in place
  (``np.memmap`` at the member's data offset), so slicing a 15 TB-class
  column for chunk partitioning reads only the touched pages instead of
  materializing the whole column and its slice copies — the host's peak
  memory stays ~one chunk, not 2x the table.  Deflated members cannot be
  mapped; they fall back to an eager decompress, loudly documented rather
  than silently doubling memory.
* ``load_columnar_arrays`` exposes the raw host arrays (no device transfer)
  for host-side consumers like the chunk partitioner.
"""
from __future__ import annotations

import io
import os
import warnings
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.columnar import ColumnarTable

__all__ = ["save_columnar", "save_columnar_arrays", "load_columnar",
           "load_columnar_arrays", "read_columnar_into", "save_star",
           "load_star", "csv_size_bytes", "columnar_size_bytes",
           "host_array", "host_words"]


def host_array(v) -> np.ndarray:
    """A column (tensor or array) as a host numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def host_words(valid) -> np.ndarray:
    """Validity as the file format holds it: packed words as uint32 (the
    port's int32 words by their bits); a bool row mask stays as it is."""
    a = host_array(valid)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def save_columnar_arrays(cols: Dict[str, np.ndarray], valid: np.ndarray,
                         path: str, compressed: bool = True) -> int:
    """Host-array writer behind ``save_columnar`` — the chunk partitioner
    streams mmap'd slices straight to disk through this, with no device
    round-trip.  Tensors are copied to the host first."""
    arrs = {f"col::{k}": host_array(v) for k, v in cols.items()}
    arrs["__valid__"] = host_words(valid)
    if compressed:
        np.savez_compressed(path, **arrs)
    else:
        np.savez(path, **arrs)
    p = path if path.endswith(".npz") else path + ".npz"
    return os.path.getsize(p)


def save_columnar(table: ColumnarTable, path: str,
                  compressed: bool = True) -> int:
    """Write a columnar ``.npz`` file; returns bytes on disk.

    ``__valid__`` is stored in the canonical packed uint32 bitset form
    (1 bit/row); ``load_columnar`` also accepts legacy files that stored a
    bool row mask.  ``compressed=False`` stores members raw (ZIP_STORED),
    which is what makes them memory-mappable on load."""
    return save_columnar_arrays(table.columns, table.valid, path,
                                compressed=compressed)


def _member_layout(path: str, info: zipfile.ZipInfo):
    """``(data offset, shape, fortran, dtype)`` of one ZIP_STORED ``.npy``
    member of an npz archive, or None when the member is compressed
    (deflated bytes cannot be read in place) or holds objects."""
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    with open(path, "rb") as f:
        # the central directory's header_offset points at the local file
        # header; its name/extra lengths (which may differ from the central
        # copy) give the member's data offset
        f.seek(info.header_offset)
        hdr = f.read(30)
        if len(hdr) < 30 or hdr[:4] != b"PK\x03\x04":
            return None
        fnlen = int.from_bytes(hdr[26:28], "little")
        extralen = int.from_bytes(hdr[28:30], "little")
        data_off = info.header_offset + 30 + fnlen + extralen
        f.seek(data_off)
        buf = io.BytesIO(f.read(min(info.file_size, 4096)))
    version = np.lib.format.read_magic(buf)
    read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                   (2, 0): np.lib.format.read_array_header_2_0}.get(version)
    if read_header is None:
        return None
    shape, fortran, dtype = read_header(buf)
    if dtype.hasobject:
        return None
    return data_off + buf.tell(), shape, fortran, dtype


def _mapped_member(path: str, info: zipfile.ZipInfo) -> Optional[np.ndarray]:
    """Memory-map one ZIP_STORED ``.npy`` member of an npz archive, or None
    when the member is compressed (deflated bytes cannot be mapped)."""
    layout = _member_layout(path, info)
    if layout is None:
        return None
    off, shape, fortran, dtype = layout
    return np.memmap(path, dtype=dtype, mode="r", offset=off, shape=shape,
                     order="F" if fortran else "C")


def read_columnar_into(path: str, out: Dict[str, np.ndarray]) -> None:
    """Read a columnar file's members into the caller's host buffers:
    ``out`` maps each column name (and ``"__valid__"``) to a C-contiguous
    array of the member's size and 4-byte dtype, e.g. the numpy view of a
    pinned tensor.  A stored member is read with one ``readinto`` from its
    offset in the file (no intermediate copy); a compressed one is
    decompressed and copied."""
    p = path if path.endswith(".npz") else path + ".npz"
    with zipfile.ZipFile(p) as z, open(p, "rb") as f, np.load(p) as arrs:
        for info in z.infolist():
            name = info.filename[:-4] if info.filename.endswith(".npy") \
                else info.filename
            key = name[5:] if name.startswith("col::") else name
            dst = out[key]
            layout = _member_layout(p, info)
            if layout is None or layout[2] or \
                    layout[1] != dst.shape or layout[3].itemsize != 4:
                np.copyto(dst, arrs[name].reshape(dst.shape),
                          casting="unsafe")
                continue
            f.seek(layout[0])
            view = memoryview(dst).cast("B")
            if f.readinto(view) != view.nbytes:
                raise IOError(f"{p}: member {name!r} is truncated")


def load_columnar_arrays(path: str, mmap_mode: Optional[str] = None,
                         mapped_sink: Optional[Dict[str, bool]] = None
                         ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Host-side load: ``(columns, valid)`` as numpy arrays, no device hop.

    With ``mmap_mode`` (e.g. ``"r"``), members written by
    ``save_columnar(compressed=False)`` come back as ``np.memmap`` views —
    zero bytes materialized until sliced.  Compressed members degrade to an
    eager read (np.load cannot map deflated payloads) — the degradation is
    *surfaced*, not silent: ``mapped_sink`` (when given) is filled with one
    ``member name -> mapped?`` flag per array, and the first degraded member
    of an archive warns (``RuntimeWarning``, once per file) so an
    out-of-core caller expecting lazy paging learns its peak host memory is
    about to be the whole table."""
    p = path if path.endswith(".npz") else path + ".npz"
    cols: Dict[str, np.ndarray] = {}
    valid: Optional[np.ndarray] = None
    mapped: Dict[str, np.ndarray] = {}
    if mmap_mode is not None:
        with zipfile.ZipFile(p) as z:
            for info in z.infolist():
                arr = _mapped_member(p, info)
                if arr is not None:
                    name = info.filename
                    mapped[name[:-4] if name.endswith(".npy") else name] = arr
    warned = False
    with np.load(p) as z:
        for k in z.files:
            arr = mapped.get(k)
            is_mapped = arr is not None
            if arr is None:
                arr = z[k]
                if mmap_mode is not None and not warned:
                    warnings.warn(
                        f"{p}: member {k!r} is compressed and cannot be "
                        "memory-mapped; falling back to an eager read "
                        "(write with compressed=False for lazy paging)",
                        RuntimeWarning, stacklevel=2)
                    warned = True
            if mapped_sink is not None:
                mapped_sink[k[5:] if k.startswith("col::") else k] = \
                    bool(is_mapped if mmap_mode is not None else False)
            if k.startswith("col::"):
                cols[k[5:]] = arr
            elif k == "__valid__":
                valid = arr
    return cols, valid


def load_columnar(path: str, mmap_mode: Optional[str] = None,
                  mapped_sink: Optional[Dict[str, bool]] = None,
                  device=None) -> ColumnarTable:
    """A columnar file as a table on ``device`` (None = CUDA)."""
    cols, valid = load_columnar_arrays(path, mmap_mode=mmap_mode,
                                       mapped_sink=mapped_sink)
    return ColumnarTable.from_columns(cols, valid=valid, device=device)


def save_star(tables: Dict[str, ColumnarTable], dirpath: str,
              compressed: bool = True) -> Dict[str, int]:
    """Persist a star schema (or any named table set) as one ``.npz`` per
    table under ``dirpath``; returns per-table bytes on disk.  The on-disk
    unit the cohort-query service loads a resident table version from (and
    the chunk partitioner streams its central table out of)."""
    os.makedirs(dirpath, exist_ok=True)
    return {name: save_columnar(t, os.path.join(dirpath, name),
                                compressed=compressed)
            for name, t in tables.items()}


def load_star(dirpath: str, mmap_mode: Optional[str] = None,
              device=None) -> Dict[str, ColumnarTable]:
    """Load every ``<name>.npz`` under ``dirpath`` as ``{name: table}`` on
    ``device`` (None = CUDA).  ``mmap_mode`` passes through to
    ``load_columnar`` — uncompressed stars map lazily instead of
    materializing every column eagerly before the copy to the device."""
    out: Dict[str, ColumnarTable] = {}
    for fname in sorted(os.listdir(dirpath)):
        if fname.endswith(".npz"):
            out[fname[:-4]] = load_columnar(os.path.join(dirpath, fname),
                                            mmap_mode=mmap_mode,
                                            device=device)
    return out


def csv_size_bytes(table: ColumnarTable) -> int:
    """Size of the equivalent CSV export (the paper's raw input format)."""
    data = table.to_numpy()
    buf = io.StringIO()
    names = list(data)
    buf.write(",".join(names) + "\n")
    n = len(next(iter(data.values()))) if data else 0
    for i in range(n):
        buf.write(",".join(str(data[c][i]) for c in names) + "\n")
    return len(buf.getvalue().encode())


def columnar_size_bytes(table: ColumnarTable, path_dir: str, name: str) -> int:
    return save_columnar(table, os.path.join(path_dir, name))
