"""B3: cohort-bitset algebra fused with the popcount, a whole expression a
launch.

A program is a sequence of up to ``MAX_OPS`` ops ``(op, a, b)``, each
``op`` one of ``OPS``, over a list of up to ``MAX_LEAVES`` leaf word
vectors: operand ``k`` is leaf ``k`` below ``len(leaves)`` and the result
of op ``k - len(leaves)`` (an earlier op) from there.  Evaluating one gives
every op's words, ``(n_ops, n)``, and every op's population count, an
``(n_ops,)`` int32 vector.  ``bitset_expr_kernel`` launches the CUDA kernel
``csrc/bitset_ops.cu`` once (the port of
``repro/kernels/bitset_ops.py:bitset_op_popcount``, which does one op a
call); ``bitset_expr_plain`` is its plain PyTorch version.
``bitset_op_popcount``/``bitset_op_plain`` are the one-op program.  Words
are int32 bit patterns (``core.bitset`` layout).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core import bitset as _bs
from repro_torch.kernels import launch_counts, require_kernel_operand

__all__ = ["OPS", "MAX_LEAVES", "MAX_OPS", "check_program",
           "bitset_expr_plain", "bitset_expr_kernel", "bitset_op_plain",
           "bitset_op_popcount"]

OPS = {"and": 0, "or": 1, "andnot": 2, "xor": 3}
MAX_LEAVES = 8
MAX_OPS = 8
THREADS = 256          # the kernel's block (csrc/bitset_ops.cu)

Program = Tuple[Tuple[str, int, int], ...]


def check_program(program, n_leaves: int) -> Program:
    """``program`` as a tuple of ``(op, a, b)``; raises ValueError unless
    it has 1..MAX_OPS known ops over 1..MAX_LEAVES leaves, each operand a
    leaf or an earlier op."""
    prog = tuple((op, int(a), int(b)) for op, a, b in program)
    if not 1 <= len(prog) <= MAX_OPS or not 1 <= n_leaves <= MAX_LEAVES:
        raise ValueError(f"a bitset program takes 1-{MAX_OPS} ops over "
                         f"1-{MAX_LEAVES} leaves, got {len(prog)} ops over "
                         f"{n_leaves}")
    for j, (op, a, b) in enumerate(prog):
        if op not in OPS:
            raise ValueError(f"bitset op must be one of {sorted(OPS)}, "
                             f"got {op!r}")
        if not (0 <= a < n_leaves + j and 0 <= b < n_leaves + j):
            raise ValueError(f"op {j} reads ({a}, {b}): an operand must be "
                             f"one of the {n_leaves} leaves or an earlier op")
    return prog


def _apply(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return {"and": lambda: a & b, "or": lambda: a | b,
            "andnot": lambda: a & ~b, "xor": lambda: a ^ b}[op]()


def bitset_expr_plain(leaves: Sequence[torch.Tensor], program):
    """``(words (n_ops, n), counts (n_ops,) int32)`` of ``program`` over
    ``leaves`` with plain tensor ops."""
    prog = check_program(program, len(leaves))
    vals = list(leaves)
    for op, a, b in prog:
        vals.append(_apply(op, vals[a], vals[b]))
    outs = vals[len(leaves):]
    return torch.stack(outs), torch.stack([_bs.count(r) for r in outs])


class _ExprArgs(ctypes.Structure):
    # csrc/bitset_ops.cu:ExprArgs, field for field
    _fields_ = [("leaves", ctypes.c_void_p * MAX_LEAVES),
                ("outs", ctypes.c_void_p * MAX_OPS),
                ("counts", ctypes.c_void_p),
                ("partials", ctypes.c_void_p),
                ("n", ctypes.c_longlong),
                ("n_ops", ctypes.c_int),
                ("vec", ctypes.c_int),
                ("op", ctypes.c_byte * MAX_OPS),
                ("a", ctypes.c_byte * MAX_OPS),
                ("b", ctypes.c_byte * MAX_OPS)]


_LIMITS: Dict[Tuple[int, int], Tuple[int, int]] = {}


def _limits(device: torch.device, n_ops: int) -> Tuple[int, int]:
    """(SMs, co-resident blocks an SM) of the ``n_ops``-op kernel on
    ``device``, from the card's occupancy query (cached)."""
    from repro_torch.kernels.build import check, library

    key = (device.index if device.index is not None
           else torch.cuda.current_device(), n_ops)
    if key not in _LIMITS:
        sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            status = library().repro_bitset_expr_limits(
                n_ops, ctypes.byref(sms), ctypes.byref(per_sm))
        check(status, "bitset_expr limits")
        _LIMITS[key] = (sms.value, per_sm.value)
    return _LIMITS[key]


def expr_grid(items: int, sm_count: int, blocks_per_sm: int) -> int:
    """Blocks of the cooperative grid for ``items`` (uint4 items and tail
    words, or words): one item a thread, at least one block an SM where
    each gets a warp's work, never more than is co-resident."""
    return max(1, min(sm_count * blocks_per_sm,
                      max(-(-items // THREADS), min(sm_count,
                                                    -(-items // 32)))))


def bitset_expr_kernel(leaves: Sequence[torch.Tensor], program):
    """One launch of the program kernel over CUDA int32 leaves (equal
    lengths, 1-D, contiguous; any alignment); returns ``(words (n_ops, n),
    counts (n_ops,) int32)`` on the leaves' device.  Each row of ``words``
    is a contiguous view of one ``(n_ops, n)`` buffer, and ``counts`` a
    view of the scratch that also holds the per-block partials: a row or
    count kept alive keeps the whole buffer alive (``.clone()`` it to free
    the rest)."""
    from repro_torch.kernels.build import check, library

    prog = check_program(program, len(leaves))
    for i, t in enumerate(leaves):
        require_kernel_operand(t, f"bitset_expr leaf {i}",
                               dtypes=(torch.int32,))
    n = leaves[0].shape[0]
    device = leaves[0].device
    if any(t.dim() != 1 or t.shape[0] != n or t.device != device
           for t in leaves):
        raise ValueError(f"bitset_expr needs equal-length 1-D word vectors "
                         f"on one device, got "
                         f"{[(tuple(t.shape), str(t.device)) for t in leaves]}")
    n_ops = len(prog)
    stride = -(-n // 4) * 4                    # rows 16-byte aligned
    buf = torch.empty((n_ops, stride), dtype=torch.int32, device=device)
    words = buf[:, :n]
    if n == 0:
        return words, torch.zeros((n_ops,), dtype=torch.int32, device=device)
    vec = all(t.data_ptr() % 16 == 0 for t in (buf, *leaves))
    sms, per_sm = _limits(device, n_ops)
    grid = expr_grid(n // 4 + n % 4 if vec else n, sms, per_sm)
    # the counts, then one partial a (block, op): written outright
    scratch = torch.empty((n_ops * (1 + grid),), dtype=torch.int32,
                          device=device)
    args = _ExprArgs()
    for k, t in enumerate(leaves):
        args.leaves[k] = t.data_ptr()
    for j, (op, a, b) in enumerate(prog):
        args.outs[j] = buf[j].data_ptr()
        args.op[j] = OPS[op]
        # the kernel numbers results from MAX_LEAVES
        args.a[j], args.b[j] = (k if k < len(leaves)
                                else k - len(leaves) + MAX_LEAVES
                                for k in (a, b))
    args.counts = scratch.data_ptr()
    args.partials = scratch.data_ptr() + 4 * n_ops
    args.n = n
    args.n_ops = n_ops
    args.vec = int(vec)
    stream = torch.cuda.current_stream(device).cuda_stream
    status = library().repro_bitset_expr(ctypes.byref(args), grid, stream)
    launch_counts["bitset_op"] += 1
    check(status, "bitset_expr")
    return words, scratch[:n_ops]


def bitset_op_plain(a: torch.Tensor, b: torch.Tensor, op: str):
    """``(a OP b, popcount)`` with plain tensor ops."""
    if op not in OPS:
        raise ValueError(f"bitset op must be one of {sorted(OPS)}, got {op!r}")
    r = _apply(op, a, b)
    return r, _bs.count(r)


def bitset_op_popcount(a: torch.Tensor, b: torch.Tensor, op: str):
    """The one-op program on CUDA words: ``(words, count)`` with ``count``
    a 0-d int32 device tensor."""
    words, counts = bitset_expr_kernel((a, b), ((op, 0, 1),))
    return words[0], counts[0]
