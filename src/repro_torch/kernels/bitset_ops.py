"""B3: cohort-bitset algebra fused with the popcount.

``bitset_op_popcount`` launches the CUDA kernel ``csrc/bitset_ops.cu``
(the port of ``repro/kernels/bitset_ops.py:bitset_op_popcount``);
``bitset_op_plain`` is its plain PyTorch version.  Words are int32 bit
patterns (``core.bitset`` layout).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitset as _bs
from repro_torch.kernels import launch_counts, require_kernel_operand

__all__ = ["OPS", "bitset_op_plain", "bitset_op_popcount"]

OPS = {"and": 0, "or": 1, "andnot": 2, "xor": 3}


def bitset_op_plain(a: torch.Tensor, b: torch.Tensor, op: str):
    """``(a OP b, popcount)`` with plain tensor ops."""
    r = {"and": lambda: a & b, "or": lambda: a | b,
         "andnot": lambda: a & ~b, "xor": lambda: a ^ b}[op]()
    return r, _bs.count(r)


def bitset_op_popcount(a: torch.Tensor, b: torch.Tensor, op: str):
    """Launch the fused kernel on CUDA words; returns ``(words, count)``
    with ``count`` a 0-d int32 device tensor."""
    from repro_torch.kernels.build import check, library

    if op not in OPS:
        raise ValueError(f"bitset op must be one of {sorted(OPS)}, got {op!r}")
    require_kernel_operand(a, "bitset_op a")
    require_kernel_operand(b, "bitset_op b")
    if a.shape != b.shape or a.dim() != 1 or a.dtype != torch.int32 \
            or b.dtype != torch.int32:
        raise ValueError(f"bitset_op needs two equal-length int32 word "
                         f"vectors, got {tuple(a.shape)} {a.dtype} and "
                         f"{tuple(b.shape)} {b.dtype}")
    n = a.shape[0]
    out = torch.empty_like(a)
    cnt = torch.zeros((1,), dtype=torch.int32, device=a.device)
    if n == 0:
        return out, cnt[0]
    lib = library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    status = lib.repro_bitset_op(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 ctypes.c_longlong(n), OPS[op],
                                 cnt.data_ptr(), stream)
    launch_counts["bitset_op"] += 1
    check(status, "bitset_op")
    return out, cnt[0]
