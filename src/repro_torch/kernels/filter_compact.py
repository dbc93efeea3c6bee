"""B2 and B2b: order-preserving compaction of a table's columns by a packed
keep-mask (B2) or by a ``(n,) bool`` row mask (B2b).

``filter_compact_bits`` launches the CUDA kernels of
``csrc/filter_compact.cu`` (the port of
``repro/kernels/filter_compact.py:filter_compact_bits_blocks`` plus the
stitch in ``repro/kernels/ops.py:filter_compact``) over ALL given columns at
once; ``filter_compact_mask`` (the port of ``filter_compact_blocks``)
compacts by the byte mask in one pass, a single-pass scan with decoupled
look-back, then zeroes the tail.  ``filter_compact_plain`` and
``filter_compact_mask_plain`` are their plain PyTorch versions.  All leave
slots past the count at 0.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.core import bitset as _bs
from repro_torch.kernels import launch_counts, require_kernel_operand

__all__ = ["MAX_COLS", "filter_compact_plain", "filter_compact_bits",
           "filter_compact_mask_plain", "filter_compact_mask"]

MAX_COLS = 32          # column pointers per scatter launch (csrc COMPACT_MAX_COLS)
TILE_ROWS = 4096       # rows a block of the bool-mask compaction takes


class _CompactArgs(ctypes.Structure):
    _fields_ = [("inp", ctypes.c_void_p * MAX_COLS),
                ("out", ctypes.c_void_p * MAX_COLS),
                ("n_cols", ctypes.c_int32)]


def filter_compact_mask_plain(cols: Sequence[torch.Tensor],
                              mask: torch.Tensor
                              ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Compact every column by the ``(n,) bool`` row mask; returns
    ``(columns, count)``, slots past ``count`` zero."""
    n = mask.shape[0]
    cnt = mask.sum().to(torch.int32)
    idx = torch.argsort((~mask).to(torch.int8), stable=True)
    lane = torch.arange(n, device=mask.device)
    out = [torch.where(lane < cnt, c[idx], torch.zeros((), dtype=c.dtype,
                                                       device=c.device))
           for c in cols]
    return out, cnt


def filter_compact_plain(cols: Sequence[torch.Tensor], words: torch.Tensor
                         ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Compact every column by the packed keep-mask ``words`` (int32, the
    ``ceil(n/32)`` words of ``n`` rows, as the kernel's wrapper demands);
    returns ``(columns, count)``, slots past ``count`` zero."""
    n = cols[0].shape[0] if cols else 0
    _check_words(words, n)
    return filter_compact_mask_plain(cols, _bs.unpack(words, n))


def _check_words(words: torch.Tensor, n: int) -> None:
    if words.dtype != torch.int32:
        raise ValueError("filter_compact words must be int32 bit patterns")
    if words.shape != (_bs.n_words(n),):
        raise ValueError(f"filter_compact: {n} rows need {_bs.n_words(n)} "
                         f"words, got {tuple(words.shape)}")


def _check_columns(cols: Sequence[torch.Tensor], device) -> int:
    if not cols:
        raise ValueError("filter_compact needs at least one column")
    n = cols[0].shape[0]
    for c in cols:
        require_kernel_operand(c, "filter_compact column")
        if c.shape != (n,) or c.device != device:
            raise ValueError("filter_compact columns must share one length "
                             "and the mask's device")
    return n


def _column_args(cols, outs, lo: int) -> "_CompactArgs":
    """The column pointers of ``cols[lo:lo + MAX_COLS]`` and their outputs."""
    args = _CompactArgs()
    chunk = range(lo, min(lo + MAX_COLS, len(cols)))
    for k, j in enumerate(chunk):
        args.inp[k] = cols[j].data_ptr()
        args.out[k] = outs[j].data_ptr()
    args.n_cols = len(chunk)
    return args


def _scatter(lib, cols, outs, words, per_word, n, stream) -> torch.Tensor:
    """Offsets from the per-word counts, then B2's scatter of every column
    (up to ``MAX_COLS`` column pointers per launch); returns the count."""
    from repro_torch.kernels.build import check

    nw = words.shape[0]
    incl = torch.cumsum(per_word, 0, dtype=torch.int32)
    for lo in range(0, len(cols), MAX_COLS):
        status = lib.repro_compact_scatter(
            ctypes.byref(_column_args(cols, outs, lo)), words.data_ptr(),
            incl.data_ptr(), ctypes.c_longlong(n), ctypes.c_longlong(nw),
            stream)
        launch_counts["filter_compact"] += 1
        check(status, "filter_compact scatter")
    return incl[-1]


def filter_compact_bits(cols: Sequence[torch.Tensor], words: torch.Tensor
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Launch the compaction kernels on CUDA columns (int32/float32, equal
    length ``n``) and ``ceil(n/32)`` int32 keep words; returns ``(columns,
    count)`` with ``count`` a 0-d int32 device tensor."""
    from repro_torch.kernels.build import check, library

    require_kernel_operand(words, "filter_compact words")
    n = _check_columns(cols, words.device)
    _check_words(words, n)
    nw = _bs.n_words(n)
    outs = [torch.empty_like(c) for c in cols]
    if n == 0:
        return outs, torch.zeros((), dtype=torch.int32, device=words.device)
    lib = library()
    stream = torch.cuda.current_stream(words.device).cuda_stream
    per_word = torch.empty((nw,), dtype=torch.int32, device=words.device)
    check(lib.repro_word_popcount(words.data_ptr(), ctypes.c_longlong(nw),
                                  per_word.data_ptr(), stream),
          "filter_compact popcount")
    return outs, _scatter(lib, cols, outs, words, per_word, n, stream)


def filter_compact_mask(cols: Sequence[torch.Tensor], mask: torch.Tensor
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """B2b: launch the single-pass compaction on CUDA columns (int32/float32,
    equal length ``n``) and a ``(n,) bool`` CUDA row mask; returns
    ``(columns, count)`` with ``count`` a 0-d int32 device tensor."""
    from repro_torch.kernels.build import check, library

    require_kernel_operand(mask, "filter_compact mask", dtypes=(torch.bool,))
    n = _check_columns(cols, mask.device)
    if mask.shape != (n,):
        raise ValueError(f"filter_compact: {n} rows need a ({n},) mask, got "
                         f"{tuple(mask.shape)}")
    if n >= 2 ** 31:
        raise ValueError(f"filter_compact: {n} rows do not fit an int32 count")
    outs = [torch.empty_like(c) for c in cols]
    if n == 0:
        return outs, torch.zeros((), dtype=torch.int32, device=mask.device)
    count = torch.empty((), dtype=torch.int32, device=mask.device)
    lib = library()
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    vec16 = all(t.data_ptr() % 16 == 0 for t in (mask, *cols))
    n_tiles = -(-n // TILE_ROWS)
    for lo in range(0, len(cols), MAX_COLS):
        # the tile counter, then one (flag, count) status word per tile
        ws = torch.zeros((1 + n_tiles,), dtype=torch.int64, device=mask.device)
        status = lib.repro_mask_compact(
            ctypes.byref(_column_args(cols, outs, lo)), mask.data_ptr(),
            ctypes.c_longlong(n), count.data_ptr(), ws.data_ptr(), int(vec16),
            stream)
        launch_counts["filter_compact_mask"] += 1
        check(status, "filter_compact_mask")
    return outs, count
