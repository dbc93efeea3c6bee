"""B4: inclusive segmented scan — running (min, max, count), reset at flags.

``segmented_scan_kernel`` launches the CUDA kernel of
``csrc/segment_scan.cu``, a single pass with decoupled look-back (the port of
``repro/kernels/segment_scan.py:segmented_scan``);
``segmented_scan_plain`` is its plain PyTorch version.  Flags travel as
packed int32 words (``core.bitset`` layout), values as int32.

Row ``i`` gets the (min, max, count) of the run that begins at the last flag
at or before ``i``.  Where that run began before the start of ``i``'s
``block``-row block, or no flag precedes ``i``, the min is also clamped with
``fill[0]`` and the max with ``fill[1]``: the Pallas kernel shifts ``±2e9``
fills in at each block edge (``DEFAULT_FILL``), so its output depends on
``block`` for values beyond ``±2e9`` (ROADMAP C8).  ``EXACT_FILL`` turns the
clamp off, which makes the run aggregates equal ``segment_min/max/sum``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import bitset as _bs
from repro_torch.kernels import launch_counts, require_kernel_operand

__all__ = ["DEFAULT_BLOCK", "DEFAULT_FILL", "EXACT_FILL", "SCAN_TILE",
           "scan_workspace_words", "segmented_scan_plain",
           "segmented_scan_kernel"]

DEFAULT_BLOCK = 512
_BIG = 2_000_000_000
DEFAULT_FILL = (_BIG, -_BIG)                     # the Pallas kernel's fills
EXACT_FILL = (2 ** 31 - 1, -2 ** 31)             # no clamp
SCAN_TILE = 4096          # rows a block of the kernel (kTileRows)


def scan_workspace_words(n: int) -> int:
    """int32 words of the kernel's zeroed look-back workspace over ``n``
    rows: the tile counter (padded to 16 bytes), then each tile's aggregate
    and inclusive prefix as three self-validating 64-bit words each."""
    return 4 + 12 * -(-int(n) // SCAN_TILE)


def _check_args(words: torch.Tensor, vals: torch.Tensor, block: int) -> int:
    if vals.dim() != 1 or vals.dtype != torch.int32:
        raise ValueError(f"segmented_scan values must be a 1-d int32 tensor, "
                         f"got {tuple(vals.shape)} {vals.dtype}")
    n = vals.shape[0]
    if words.dtype != torch.int32 or words.shape != (_bs.n_words(n),):
        raise ValueError(f"segmented_scan: {n} rows need {_bs.n_words(n)} "
                         f"int32 flag words, got {tuple(words.shape)} "
                         f"{words.dtype}")
    if int(block) < 1:
        raise ValueError(f"segmented_scan block must be >= 1, got {block}")
    return n


def segmented_scan_plain(words: torch.Tensor, vals: torch.Tensor,
                         block: int = DEFAULT_BLOCK,
                         fill: Tuple[int, int] = DEFAULT_FILL):
    """``(min, max, count)`` per row with plain tensor ops.

    The run aggregates are running maxima of one int64 key per row, ``run id
    * 2**32`` plus the value (or its complement, for the min): a later run's
    keys exceed every earlier run's, so ``cummax`` restarts at each flag."""
    n = _check_args(words, vals, block)
    dev = vals.device
    flags = _bs.unpack(words, n)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    start = torch.cummax(torch.where(flags, rows, -1), 0).values if n else rows
    run = torch.cumsum(flags, 0, dtype=torch.int64) << 32
    v = vals.to(torch.int64)
    top = 2 ** 31 - 1
    run_max = (torch.cummax(run + v + 2 ** 31, 0).values - run) - 2 ** 31 \
        if n else v
    run_min = top - (torch.cummax(run + top - v, 0).values - run) if n else v
    crossed = start < (rows // int(block)) * int(block)
    lo, hi = fill
    mn = torch.where(crossed, torch.clamp(run_min, max=int(lo)), run_min)
    mx = torch.where(crossed, torch.clamp(run_max, min=int(hi)), run_max)
    cnt = rows - start + (start >= 0).to(torch.int64)  # no flag: rows + 1
    return mn.to(torch.int32), mx.to(torch.int32), cnt.to(torch.int32)


def segmented_scan_kernel(words: torch.Tensor, vals: torch.Tensor,
                          block: int = DEFAULT_BLOCK,
                          fill: Tuple[int, int] = DEFAULT_FILL):
    """Launch the scan on CUDA tensors; returns ``(min, max, count)``."""
    from repro_torch.kernels.build import check, library

    require_kernel_operand(words, "segmented_scan flags")
    require_kernel_operand(vals, "segmented_scan values")
    n = _check_args(words, vals, block)
    if words.device != vals.device:
        raise ValueError("segmented_scan flags and values must share a device")
    outs = [torch.empty_like(vals) for _ in range(3)]
    if n == 0:
        return tuple(outs)
    if n > 2 ** 31 - 1:
        raise ValueError(f"segmented_scan counts rows in int32: {n} rows")
    # the look-back's tile statuses, zeroed on the launch's stream
    ws = torch.zeros((scan_workspace_words(n),), dtype=torch.int32,
                     device=vals.device)
    lib = library()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    status = lib.repro_segmented_scan(
        words.data_ptr(), vals.data_ptr(), ctypes.c_longlong(n),
        ctypes.c_longlong(int(block)), int(fill[0]), int(fill[1]),
        ws.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
        outs[2].data_ptr(), int(vals.data_ptr() % 16 == 0), stream)
    launch_counts["segmented_scan"] += 1
    check(status, "segmented_scan")
    return tuple(outs)
