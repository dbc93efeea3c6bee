"""B1: fused Expr predicate -> packed validity bitset.

The port of ``repro/kernels/predicate.py``.  A serialized Expr tree
(``Expr.to_param`` nested tuples — the object plan nodes carry) compiles
once, on the host, into a short typed register ``Program``: opcodes are
typed by jnp's promotion rules (``CMP_LT_F32``, ``CVT_I32_F32``,
``FLOORDIV_I32``, ...) and the program is cached on the param tree and the
operand dtypes.  Two engines run the same program:

  * ``csrc/predicate.cu`` — the CUDA interpreter, a persistent grid that
    runs the program a tile of rows at a time, the result packed by warp
    ballot (``predicate_bitset`` on CUDA tensors); ``schedule_program`` and
    ``plan_predicate_launch`` are its host-side planning, in plain Python;
  * ``run_program_plain`` — the plain PyTorch version, the same program as
    vectorized tensor ops (``predicate_bitset`` on CPU tensors).

Hoisted ``hlit``/``hisin`` values are kernel arguments, never program text,
so one build serves every Expr and every literal value.

This module also holds the jnp-compatible elementwise arithmetic
(``floordiv``/``remainder`` by zero, promotion against Python literals) that
the ``torch`` predicate engine (``study.expr``) shares with the program
interpreter.  Like XLA, every float32 arithmetic op and comparison flushes
denormals to a zero of their sign (on its inputs and on its result), and so
do whitelists and their probes (``flush_denormals``); ``%`` returns its
``fmod`` unflushed where XLA's ``rem`` does.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import operator as _op
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bitset as _bs
from repro_torch.kernels import (PREDICATE_ENGINES, launch_counts,
                                 require_kernel_operand)

__all__ = [
    "DEFAULT_BLOCK", "MAX_ISIN_VALUES", "PREDICATE_ENGINES", "OPCODES",
    "Program", "compilable", "compile_program", "resolve_engine",
    "PRED_THREADS", "PRED_ROWS", "PRED_TILE", "PredicateLaunch",
    "schedule_program", "plan_predicate_launch", "device_plan",
    "BITMAP_WORDS",
    "predicate_bitset", "predicate_bitset_plain", "run_program_plain",
    "binary_arith", "binary_cmp", "floordiv", "remainder", "value_kind",
    "flush_denormals", "isin_vmem_bytes",
]

# Stamped into plans as ``bitset_block``, exactly as the reference stamps it;
# the CUDA kernel's quantum is its own tile (``PRED_TILE``).
DEFAULT_BLOCK = 1024

# The reference's VMEM membership budget, kept so that the port's optimized
# plans (and the engine each predicate node is stamped with) stay identical
# to the reference's.  The CUDA kernel stages whitelists up to this length in
# shared memory and searches longer ones in global memory.
MAX_ISIN_VALUES = 1024

_NULL_INT = -2_147_483_648 + 1      # mirrors core.columnar.NULL_INT
_INT_MIN = -2_147_483_648

# param tags whose value is boolean — the program packs bits, so the tree
# ROOT must be one of these (interior arithmetic is unrestricted)
_BOOL_TAGS = frozenset({"cmp", "bool", "not", "isin", "hisin",
                        "isnull", "notnull"})
_ISIN_PAD = 8          # whitelists are tail-padded with their own max
_F32_TINY = float(np.finfo(np.float32).tiny)    # the least normal float32

# Budgets of the CUDA interpreter (csrc/predicate.cu); the host raises past
# them.
MAX_COLS, MAX_TABLES, MAX_LITS, MAX_INSTR, N_REGS = 16, 8, 16, 96, 16

# The kernel's tile: rows a thread (R) x PRED_THREADS, row = tile + r *
# PRED_THREADS + thread (kThreads, kWideRows, kNarrowRows in
# csrc/predicate.cu).  R is the first of PRED_ROWS at which the program's
# register file fits in shared memory.
PRED_THREADS, PRED_ROWS = 256, (16, 8)
PRED_TILE = PRED_THREADS * PRED_ROWS[0]
# Words of the bitmap an int whitelist staged in shared memory may become
# (kBitmapWords): the kernel builds it where the whitelist spans at most
# 32 x BITMAP_WORDS values
BITMAP_WORDS = 1024
# sm_90: dynamic shared memory the kernel may use a block (the card's 227 KB
# less 1 KB kept for its static shared memory, as repro_predicate_occupancy
# sets it), shared memory an SM holds, and what it reserves per block;
# threads an SM holds
SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVED = 232_448 - 1024, 233_472, 1024
THREADS_PER_SM = 2048
# Instr.flags (csrc/predicate.cu): operand a / b from its register-file slot
# (else from the previous instruction's result), result stored to its slot,
# operand a / b the uniform value in imm (a hoisted literal's index with
# _UNI_LIT), result negated, operand a loaded from column col
_A_SMEM, _B_SMEM, _STORE, _A_UNI, _B_UNI, _UNI_LIT, _NEG, _A_LOAD = \
    1, 2, 4, 8, 16, 32, 64, 128

OPCODES = {name: i for i, name in enumerate((
    "LOAD", "CONST", "LIT", "CVT_I32_F32",
    "ADD_I32", "SUB_I32", "MUL_I32", "FLOORDIV_I32", "MOD_I32",
    "ADD_F32", "SUB_F32", "MUL_F32", "FLOORDIV_F32", "MOD_F32",
    "CMP_EQ_I32", "CMP_NE_I32", "CMP_LT_I32", "CMP_LE_I32", "CMP_GT_I32",
    "CMP_GE_I32",
    "CMP_EQ_F32", "CMP_NE_F32", "CMP_LT_F32", "CMP_LE_F32", "CMP_GT_F32",
    "CMP_GE_F32",
    "AND", "OR", "NOT", "ISNULL_I32", "ISNULL_F32", "ISIN_I32", "ISIN_F32",
))}
_ARITH_SUFFIX = {"+": "ADD", "-": "SUB", "*": "MUL", "//": "FLOORDIV",
                 "%": "MOD"}
_CMP_SUFFIX = {"==": "EQ", "!=": "NE", "<": "LT", "<=": "LE", ">": "GT",
               ">=": "GE"}
_CMP_FNS = {"==": _op.eq, "!=": _op.ne, "<": _op.lt, "<=": _op.le,
            ">": _op.gt, ">=": _op.ge}
_PY_ARITH = {"+": _op.add, "-": _op.sub, "*": _op.mul, "//": _op.floordiv,
             "%": _op.mod}
_TORCH_DTYPE = {"i": torch.int32, "f": torch.float32, "b": torch.bool}


# ---------------------------------------------------------------------------
# engine selection
# ---------------------------------------------------------------------------
def resolve_engine(predicate_engine: Optional[str] = None,
                   engine: str = "torch", device=None) -> str:
    """Resolve the predicate engine of ``fused_mask``/``predicate`` nodes.

    ``"torch"``/``"cuda"`` are explicit; ``"auto"`` (or None) picks the CUDA
    bitset kernel when the executor engine is ``"cuda"`` or the data lies on
    a CUDA device, and torch mask algebra otherwise."""
    pe = predicate_engine or "auto"
    if pe not in PREDICATE_ENGINES:
        raise ValueError(f"predicate engine must be one of "
                         f"{PREDICATE_ENGINES}, got {pe!r}")
    if pe != "auto":
        return pe
    if engine == "cuda" or (device is not None
                            and torch.device(device).type == "cuda"):
        return "cuda"
    return "torch"


def _isin_sizes(p, out: list) -> None:
    if not isinstance(p, tuple) or not p:
        return
    if p[0] == "isin":
        out.append(len(p[2]))
        _isin_sizes(p[1], out)
        return
    if p[0] == "hisin":
        out.append(int(p[3]))
        _isin_sizes(p[1], out)
        return
    for x in p[1:]:
        _isin_sizes(x, out)


def compilable(expr_param) -> bool:
    """True when the serialized Expr compiles to the bitset kernel: a
    boolean-valued root and every whitelist within ``MAX_ISIN_VALUES`` (the
    reference's rule, kept so that plans stamp identical engines)."""
    if not (isinstance(expr_param, tuple) and len(expr_param) > 0
            and expr_param[0] in _BOOL_TAGS):
        return False
    sizes: list = []
    _isin_sizes(expr_param, sizes)
    return all(s <= MAX_ISIN_VALUES for s in sizes)


def isin_vmem_bytes(n_values: int, block: int = DEFAULT_BLOCK) -> int:
    """Bytes the reference's in-kernel membership broadcast needs for one
    whitelist of ``n_values`` entries (the (block x whitelist) int32
    intermediate plus the operand, tail-padded to ``_ISIN_PAD``).  The
    analyzer quotes it in SP008, as the reference's does."""
    n = max(int(n_values), 1)
    n_pad = n + (-n) % _ISIN_PAD
    return 4 * (block * n_pad + n_pad)


# ---------------------------------------------------------------------------
# jnp-compatible elementwise arithmetic
# ---------------------------------------------------------------------------
def flush_denormals(t: torch.Tensor) -> torch.Tensor:
    """XLA's float32 flush: a denormal becomes a zero of its sign (``-1e-40``
    gives ``-0.0``); other values, and tensors of other dtypes, pass."""
    if t.dtype != torch.float32:
        return t
    return torch.where(t.abs() < _F32_TINY, t * 0, t)


def _flush_np(a: np.ndarray) -> np.ndarray:
    if a.dtype != np.float32:
        return a
    return np.where(np.abs(a) < _F32_TINY, a * np.float32(0), a)


def _flushed(fn):
    """``fn`` on float32 operands as XLA runs it: inputs and result
    flushed."""
    def op(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32:
            return fn(x, y)
        return flush_denormals(fn(flush_denormals(x), flush_denormals(y)))
    return op


def value_kind(v) -> str:
    """'b' (bool), 'i' (int32) or 'f' (float32): the jnp type a tensor or a
    Python/numpy literal takes part in promotion as."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bool:
            return "b"
        return "f" if v.dtype.is_floating_point else "i"
    if isinstance(v, (bool, np.bool_)):
        return "b"
    if isinstance(v, (int, np.integer)):
        return "i"
    if isinstance(v, (float, np.floating)):
        return "f"
    raise TypeError(f"unsupported expression value {type(v).__name__}")


def _promote(ka: str, kb: str) -> str:
    if "f" in (ka, kb):
        return "f"
    if "i" in (ka, kb):
        return "i"
    return "b"


def _as_kind(v, kind: str, device) -> torch.Tensor:
    dt = _TORCH_DTYPE[kind]
    if isinstance(v, torch.Tensor):
        return v if v.dtype == dt else v.to(dt)
    if isinstance(v, np.generic):
        v = v.item()
    return torch.tensor(v, dtype=dt, device=device)


def _sign_f(v: torch.Tensor) -> torch.Tensor:
    # lax.sign on floats: -1, +1, the (signed) zero itself, NaN for NaN
    one = torch.ones_like(v)
    return torch.where(v > 0, one, torch.where(v < 0, -one, v))


def _fmod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact C ``fmod`` (XLA's ``rem``).  torch's vectorized CPU float fmod
    loses exactness for huge quotients (``1e30 % 3e-30`` gives NaN), so CPU
    floats go through numpy; CUDA's ``fmodf`` is exact."""
    if x.dtype.is_floating_point and x.device.type == "cpu":
        with np.errstate(invalid="ignore"):      # fmod(x, 0) is NaN
            return torch.from_numpy(np.asarray(np.fmod(x.numpy(), y.numpy())))
    return torch.fmod(x, y)


def floordiv(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.floor_divide`` on same-dtype int32 or float32 tensors.

    int32 follows XLA: ``x // 0 == -1`` before the floor adjustment (so
    ``5 // 0 == -2``), and ``INT_MIN // -1`` wraps.  float32 is jnp's
    ``_float_divmod``: ``(x - fmod(x, y)) / y`` adjusted and rounded half
    away from zero (``5.0 // 0.0`` is NaN), each step flushing denormals as
    XLA does."""
    if x.dtype.is_floating_point:
        ftz = flush_denormals
        y = ftz(y)                       # XLA's rem flushes its divisor only
        mod = ftz(_fmod(x, y))
        x = ftz(x)
        div = ftz(ftz(x - mod) / y)
        ind = (mod != 0) & (_sign_f(y) != _sign_f(mod))
        div = torch.where(ind, ftz(div - 1), div)
        t = torch.trunc(div)
        step = torch.where(div > 0, torch.ones_like(t), -torch.ones_like(t))
        return torch.where((div - t).abs() >= 0.5, t + step, t)
    zero = y == 0
    ovf = (x == _INT_MIN) & (y == -1)
    ys = torch.where(zero | ovf, torch.ones_like(y), y)
    q = torch.div(x, ys, rounding_mode="trunc")
    r = torch.fmod(x, ys)
    q = torch.where(zero, torch.full_like(q, -1), q)
    r = torch.where(zero, x, r)
    sel = (torch.sign(x) != torch.sign(y)) & (r != 0)
    return torch.where(sel, q - 1, q)


def remainder(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.remainder`` on same-dtype int32 or float32 tensors: the result
    takes the divisor's sign; an int32 zero divisor is replaced by one
    (``5 % 0 == 0``); float32 ``5.0 % 0.0`` is NaN, and a denormal result
    of ``fmod`` is kept where XLA keeps it."""
    if x.dtype.is_floating_point:
        # XLA's rem is an exact fmod of the raw dividend by the flushed
        # divisor, its result unflushed; the sign tests and the sum that
        # follow flush, so a denormal fmod comes back as it is
        yz = flush_denormals(y)
        t = _fmod(x, yz)
        tz = flush_denormals(t)
        plus = ((tz < 0) != (yz < 0)) & (tz != 0)
        return torch.where(plus, flush_denormals(tz + yz), t)
    y = torch.where(y == 0, torch.ones_like(y), y)
    ys = torch.where((x == _INT_MIN) & (y == -1), torch.ones_like(y), y)
    t = torch.fmod(x, ys)
    plus = ((t < 0) != (y < 0)) & (t != 0)
    return torch.where(plus, t + y, t)


_TENSOR_ARITH = {"+": _flushed(torch.add), "-": _flushed(torch.sub),
                 "*": _flushed(torch.mul), "//": floordiv, "%": remainder}
_OP_ARITH = {v: k for k, v in _ARITH_SUFFIX.items()}
_OP_CMP = {v: k for k, v in _CMP_SUFFIX.items()}


def _device_of(*vs):
    for v in vs:
        if isinstance(v, torch.Tensor):
            return v.device
    return None


def binary_arith(op: str, lhs, rhs):
    """``lhs OP rhs`` with jnp's promotion and jnp's ``//``/``%``.  Two
    Python literals combine with Python semantics (as in the reference)."""
    if not isinstance(lhs, torch.Tensor) and not isinstance(rhs, torch.Tensor):
        return _PY_ARITH[op](lhs, rhs)
    kind = _promote(value_kind(lhs), value_kind(rhs))
    if kind == "b":
        raise NotImplementedError(f"arithmetic {op!r} on two booleans")
    dev = _device_of(lhs, rhs)
    return _TENSOR_ARITH[op](_as_kind(lhs, kind, dev), _as_kind(rhs, kind, dev))


def binary_cmp(op: str, lhs, rhs):
    """``lhs OP rhs`` compared in jnp's promoted type (bools as ints),
    float32 denormals flushed."""
    if not isinstance(lhs, torch.Tensor) and not isinstance(rhs, torch.Tensor):
        return _CMP_FNS[op](lhs, rhs)
    kind = _promote(value_kind(lhs), value_kind(rhs))
    kind = "i" if kind == "b" else kind
    dev = _device_of(lhs, rhs)
    return _CMP_FNS[op](flush_denormals(_as_kind(lhs, kind, dev)),
                        flush_denormals(_as_kind(rhs, kind, dev)))


# ---------------------------------------------------------------------------
# Expr-param -> typed register program
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Program:
    """A typed register program for one Expr over given operand dtypes.

    ``instrs`` holds ``(opcode name, dst, a, b, imm, kind of dst)``; ``columns`` maps a
    column slot to its name; ``tables`` maps a whitelist slot to
    ``("static", sorted padded ndarray)`` or ``("vec", hoisted slot, kind)``;
    ``lits`` maps a literal slot to ``(hoisted slot, kind)``; ``result`` is
    the register holding the boolean outcome."""

    columns: Tuple[str, ...]
    instrs: Tuple[Tuple[str, int, int, int, int, str], ...]
    tables: Tuple[Tuple, ...]
    lits: Tuple[Tuple[int, str], ...]
    result: int
    device_tables: Dict = dataclasses.field(default_factory=dict,
                                            compare=False, hash=False)


def _bits_of(value, kind: str) -> int:
    """32-bit pattern of a literal, as a signed int32."""
    if kind == "f":
        u = struct.unpack("<I", struct.pack("<f", float(value)))[0]
    elif kind == "b":
        u = 1 if value else 0
    else:
        v = int(value)
        if not _INT_MIN <= v < 2 ** 31:
            raise OverflowError(f"literal {v} does not fit int32")
        u = v & 0xFFFFFFFF
    return u - 2 ** 32 if u >= 2 ** 31 else u


def referenced(expr_param: Tuple):
    """``(columns, hlit slots, hisin slots)`` an Expr reads, in first-use
    order (the operands its program needs)."""
    cols: List[str] = []
    lits: List[int] = []
    vecs: List[int] = []

    def walk(p):
        tag = p[0]
        if tag == "col" and p[1] not in cols:
            cols.append(p[1])
        elif tag == "hlit" and int(p[1]) not in lits:
            lits.append(int(p[1]))
        elif tag == "hisin" and int(p[3]) > 0 and int(p[2]) not in vecs:
            vecs.append(int(p[2]))
        if tag in ("cmp", "arith", "bool"):
            walk(p[2])
            walk(p[3])
        elif tag in ("not", "isnull", "notnull", "isin", "hisin"):
            walk(p[1])
    walk(expr_param)
    return tuple(cols), tuple(lits), tuple(vecs)


@functools.lru_cache(maxsize=512)
def compile_program(expr_param: Tuple, col_kinds: Tuple[Tuple[str, str], ...],
                    lit_kinds: Tuple[Tuple[int, str], ...] = (),
                    vec_kinds: Tuple[Tuple[int, str], ...] = ()) -> Program:
    """Compile a serialized Expr into a typed register ``Program``.

    ``col_kinds``/``lit_kinds``/``vec_kinds`` give the kind ('i'/'f'/'b') of
    each column, hoisted literal slot and hoisted whitelist slot.  Raises
    ``ValueError`` for a non-boolean root, an operation the interpreter does
    not type (bitwise logic on numbers, arithmetic on two booleans) or a
    program past the interpreter's budgets."""
    if not (isinstance(expr_param, tuple) and expr_param
            and expr_param[0] in _BOOL_TAGS):
        raise ValueError(
            f"cuda predicate engine needs a boolean-valued expression root, "
            f"got tag {expr_param[0]!r} (use the torch engine)")
    ckind = dict(col_kinds)
    lkind = dict(lit_kinds)
    vkind = dict(vec_kinds)
    columns: List[str] = []
    tables: List[Tuple] = []
    lits: List[Tuple[int, str]] = []
    instrs: List[Tuple[str, int, int, int, int, str]] = []
    free = list(range(N_REGS))

    def alloc() -> int:
        if not free:
            raise ValueError(f"predicate program needs more than {N_REGS} "
                             f"registers (use the torch engine)")
        free.sort()
        return free.pop(0)

    def release(v) -> None:
        if v[0] == "reg":
            free.append(v[1])

    def emit(op: str, kind: str, a: int = 0, b: int = 0, imm: int = 0) -> int:
        d = alloc()
        instrs.append((op, d, a, b, imm, kind))
        return d

    def materialize(v, kind: str) -> int:
        """Register holding ``v`` as ``kind`` (consumes ``v``)."""
        if v[0] == "py":
            return emit("CONST", kind, imm=_bits_of(v[1], kind))
        reg, vk = v[1], v[2]
        if kind == "f" and vk != "f":
            release(v)
            return emit("CVT_I32_F32", "f", a=reg)
        return reg       # b -> i is free: a bool register holds 0/1

    def kind_of(v) -> str:
        return value_kind(v[1]) if v[0] == "py" else v[2]

    def walk(p):
        tag = p[0]
        if tag == "col":
            name = p[1]
            if name not in columns:
                columns.append(name)
            return ("reg", emit("LOAD", ckind[name], imm=columns.index(name)),
                    ckind[name])
        if tag == "lit":
            return ("py", p[1])
        if tag == "hlit":
            slot = int(p[1])
            if (slot, lkind[slot]) not in lits:
                lits.append((slot, lkind[slot]))
            return ("reg", emit("LIT", lkind[slot],
                                imm=lits.index((slot, lkind[slot]))),
                    lkind[slot])
        if tag in ("cmp", "arith"):
            lv, rv = walk(p[2]), walk(p[3])
            if lv[0] == "py" and rv[0] == "py":
                fn = _CMP_FNS[p[1]] if tag == "cmp" else _PY_ARITH[p[1]]
                return ("py", fn(lv[1], rv[1]))
            kind = _promote(kind_of(lv), kind_of(rv))
            if tag == "arith" and kind == "b":
                raise ValueError(f"arithmetic {p[1]!r} on two booleans")
            kind = "i" if kind == "b" else kind
            a, b = materialize(lv, kind), materialize(rv, kind)
            for r in (a, b):
                free.append(r)
            suffix = "_F32" if kind == "f" else "_I32"
            if tag == "cmp":
                return ("reg", emit("CMP_" + _CMP_SUFFIX[p[1]] + suffix, "b",
                                    a, b), "b")
            return ("reg", emit(_ARITH_SUFFIX[p[1]] + suffix, kind, a, b), kind)
        if tag == "bool":
            lv, rv = walk(p[2]), walk(p[3])
            for v in (lv, rv):
                if kind_of(v) != "b":
                    raise ValueError("cuda predicate engine: '&'/'|' need "
                                     "boolean operands")
            if lv[0] == "py" and rv[0] == "py":
                return ("py", (lv[1] and rv[1]) if p[1] == "and"
                        else (lv[1] or rv[1]))
            a, b = materialize(lv, "b"), materialize(rv, "b")
            free.extend((a, b))
            return ("reg", emit("AND" if p[1] == "and" else "OR", "b", a, b),
                    "b")
        if tag == "not":
            v = walk(p[1])
            if kind_of(v) != "b":
                raise ValueError("cuda predicate engine: '~' needs a boolean "
                                 "operand")
            if v[0] == "py":
                return ("py", not v[1])
            release(v)
            return ("reg", emit("NOT", "b", v[1]), "b")
        if tag in ("isnull", "notnull"):
            v = walk(p[1])
            if v[0] == "py":
                x = v[1]
                null = (x != x) if isinstance(x, float) else x == _NULL_INT
                return ("py", bool(null) if tag == "isnull" else not null)
            if v[2] == "b":
                raise ValueError("null test on a boolean value")
            release(v)
            r = emit("ISNULL_F32" if v[2] == "f" else "ISNULL_I32", "b", v[1])
            if tag == "notnull":
                free.append(r)
                r = emit("NOT", "b", r)
            return ("reg", r, "b")
        if tag in ("isin", "hisin"):
            v = walk(p[1])
            if tag == "isin":
                vals = p[2]
                if not vals:
                    release(v)
                    return ("py", False)
                tkind = "f" if any(isinstance(c, float) for c in vals) else "i"
            else:
                slot, n = int(p[2]), int(p[3])
                if n == 0:
                    release(v)
                    return ("py", False)
                tkind = vkind[slot]
            if v[0] == "py":
                if tag == "hisin":
                    raise ValueError("hoisted whitelist probed by a literal")
                return ("py", any(v[1] == c for c in p[2]))
            kind = _promote("i" if v[2] == "b" else v[2], tkind)
            if tag == "isin":
                tbl = np.asarray(p[2], np.float32 if tkind == "f"
                                 else np.int32)
                tbl = np.sort(_flush_np(tbl.astype(np.float32 if kind == "f"
                                                   else np.int32)))
                pad = (-tbl.size) % _ISIN_PAD
                if pad:
                    tbl = np.concatenate([tbl, np.full(pad, tbl[-1],
                                                       tbl.dtype)])
                tables.append(("static", tbl))
            else:
                tables.append(("vec", slot, kind))
            a = materialize(v, kind)
            free.append(a)
            op = "ISIN_F32" if kind == "f" else "ISIN_I32"
            return ("reg", emit(op, "b", a, imm=len(tables) - 1), "b")
        raise ValueError(f"unknown Expr param tag {tag!r}")

    root = walk(expr_param)
    result = materialize(root, "b")
    if len(columns) > MAX_COLS or len(tables) > MAX_TABLES \
            or len(lits) > MAX_LITS or len(instrs) > MAX_INSTR:
        raise ValueError(
            f"predicate program past the interpreter's budget ({len(columns)} "
            f"columns, {len(tables)} whitelists, {len(lits)} literals, "
            f"{len(instrs)} instructions; limits {MAX_COLS}/{MAX_TABLES}/"
            f"{MAX_LITS}/{MAX_INSTR}); use the torch engine")
    return Program(tuple(columns), tuple(instrs), tuple(tables), tuple(lits),
                   result)


def _kinds(columns: Dict[str, torch.Tensor], expr_param: Tuple,
           params: Optional[Tuple[Sequence, Sequence]]):
    """Operand kinds for ``compile_program``, checking every operand
    exists."""
    names, lit_slots, vec_slots = referenced(expr_param)
    missing = [nm for nm in names if nm not in columns]
    if missing:
        raise KeyError(f"predicate reads absent column(s) {missing}")
    b_lits, b_vecs = params if params is not None else ((), ())
    if any(s >= len(b_lits) for s in lit_slots) or \
            any(s >= len(b_vecs) for s in vec_slots):
        raise RuntimeError(
            "expr has hoisted slot refs with no bound value; pass "
            "params=(lits, vecs) (see expr.bound_params)")
    col_kinds = tuple((nm, value_kind(columns[nm])) for nm in names)
    lit_kinds = tuple((s, value_kind(_scalar(b_lits[s]))) for s in lit_slots)
    vec_kinds = tuple((s, value_kind(_as_vector(b_vecs[s])))
                      for s in vec_slots)
    return col_kinds, lit_kinds, vec_kinds


def _as_vector(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def _scalar(v):
    """A bound hoisted literal as a Python scalar (a tensor is read back)."""
    return v.item() if isinstance(v, (torch.Tensor, np.ndarray, np.generic)) \
        else v


def _staged_vec(v, kind: str, device) -> torch.Tensor:
    """A hoisted whitelist as the program reads it: in ``kind``, denormals
    flushed, sorted and tail-padded with its own max."""
    t = flush_denormals(_as_vector(v).to(device=device,
                                         dtype=_TORCH_DTYPE[kind]))
    t = torch.sort(t).values
    pad = (-t.shape[0]) % _ISIN_PAD
    if pad:
        t = torch.cat([t, t[-1:].expand(pad)])
    return t.contiguous()


def _table_operands(prog: Program, vecs: Sequence, device) -> List[torch.Tensor]:
    out = []
    key = str(device)
    for i, spec in enumerate(prog.tables):
        if spec[0] == "static":
            cached = prog.device_tables.get((key, i))
            if cached is None:
                cached = torch.from_numpy(spec[1]).to(device)
                prog.device_tables[(key, i)] = cached
            out.append(cached)
        else:
            out.append(_staged_vec(vecs[spec[1]], spec[2], device))
    return out


# ---------------------------------------------------------------------------
# the plain version: the same program as tensor ops
# ---------------------------------------------------------------------------
def run_program_plain(prog: Program, columns: Dict[str, torch.Tensor],
                      n: int, params: Optional[Tuple[Sequence, Sequence]] = None
                      ) -> torch.Tensor:
    """Evaluate ``prog`` over ``columns`` with tensor ops; the ``(n,) bool``
    outcome (validity not applied)."""
    device = next(iter(columns.values())).device if columns else \
        torch.device("cpu")
    b_lits, b_vecs = params if params is not None else ((), ())
    tables = _table_operands(prog, b_vecs, device)
    regs: List = [None] * N_REGS
    i32, f32 = torch.int32, torch.float32

    def as_int(t):
        return t.to(i32) if t.dtype == torch.bool else t

    for op, d, a, b, imm, kind in prog.instrs:
        ra, rb = regs[a], regs[b]
        if op == "LOAD":
            out = columns[prog.columns[imm]]
        elif op == "CONST":
            out = torch.tensor(imm, dtype=i32, device=device)
            out = out.view(f32) if kind == "f" else \
                (out != 0) if kind == "b" else out
        elif op == "LIT":
            slot, lk = prog.lits[imm]
            out = torch.tensor(_scalar(b_lits[slot]), device=device).to(
                _TORCH_DTYPE[lk])
        elif op == "CVT_I32_F32":
            out = ra.to(f32)
        elif op.startswith(("ADD", "SUB", "MUL", "FLOORDIV", "MOD")):
            fn, suffix = op.rsplit("_", 1)
            x, y = (as_int(ra), as_int(rb)) if suffix == "I32" else (ra, rb)
            out = _TENSOR_ARITH[_OP_ARITH[fn]](x, y)
        elif op.startswith("CMP_"):
            fn = _CMP_FNS[_OP_CMP[op[4:6]]]
            out = fn(as_int(ra), as_int(rb)) if op.endswith("_I32") \
                else fn(flush_denormals(ra), flush_denormals(rb))
        elif op == "AND":
            out = ra & rb
        elif op == "OR":
            out = ra | rb
        elif op == "NOT":
            out = ~ra
        elif op == "ISNULL_I32":
            out = ra == _NULL_INT
        elif op == "ISNULL_F32":
            out = torch.isnan(ra)
        elif op in ("ISIN_I32", "ISIN_F32"):
            x = as_int(ra) if op == "ISIN_I32" else flush_denormals(ra)
            out = torch.isin(x, tables[imm])
        else:
            raise ValueError(f"unknown opcode {op}")
        regs[d] = out
    return torch.broadcast_to(regs[prog.result], (n,))


def predicate_bitset_plain(prog: Program, columns: Dict[str, torch.Tensor],
                           valid: torch.Tensor, capacity: int,
                           params=None):
    """Plain version of the kernel: ``(words, count)`` of ``valid & expr``."""
    mask = run_program_plain(prog, columns, capacity, params)
    mask = mask & _bs.unpack(valid, capacity)
    return _bs.pack(mask), mask.sum().to(torch.int32)


# ---------------------------------------------------------------------------
# the CUDA launch: scheduling and planning (plain Python), then the call
# ---------------------------------------------------------------------------
_NO_OPERAND = frozenset({"LOAD", "CONST", "LIT"})
_ONE_OPERAND = frozenset({"CVT_I32_F32", "NOT", "ISNULL_I32", "ISNULL_F32",
                          "ISIN_I32", "ISIN_F32"})
# ops that read both operands and leave imm free: one operand may instead be
# a uniform value (a CONST's bits or a hoisted literal) carried in imm
_TAKES_UNIFORM = frozenset(op for op in OPCODES
                           if op.startswith(("ADD", "SUB", "MUL", "FLOORDIV",
                                             "MOD", "CMP_"))
                           or op in ("AND", "OR"))
# ops whose result is a 0/1 boolean: a following NOT folds into them
_BOOL_RESULT = frozenset(op for op in OPCODES
                         if op.startswith(("CMP_", "ISNULL", "ISIN"))
                         or op in ("AND", "OR", "NOT"))


def schedule_program(prog: Program):
    """``(instrs, n_slots)``: ``prog`` as ``csrc/predicate.cu`` runs it.

    Each entry of ``instrs`` is ``(opcode, dst, a, b, imm, flags, col)``.
    On the program's dataflow:

      * an operand that a CONST or LIT produced becomes a uniform operand
        (``_A_UNI``/``_B_UNI``; ``imm`` holds the bits, or with ``_UNI_LIT``
        the literal's index);
      * a NOT right after the boolean op that is its only input folds into
        that op (``_NEG``);
      * a LOAD whose only reader is the next instruction, as its operand
        ``a``, folds into it (``_A_LOAD``: operand ``a`` is column ``col``);
      * what nothing reads any more goes (the result stays);
      * an operand that the previous instruction produced is read from
        registers; any other is read from a slot of the shared-memory
        register file (``_A_SMEM``/``_B_SMEM``, ``a``/``b`` name the slot),
        and its producer stores its result there (``_STORE``, ``dst``).

    Slots are reused once their value's last reader has run.  The program's
    result must be its last instruction's, and stays so."""
    instrs = prog.instrs
    if not instrs or instrs[-1][1] != prog.result:
        raise ValueError("predicate program must end in its result register")
    last_def: Dict[int, int] = {}
    nodes = []          # [op, imm, srcs (value ids), flags, col]
    for j, (op, d, a, b, imm, _kind) in enumerate(instrs):
        regs = () if op in _NO_OPERAND else \
            (a,) if op in _ONE_OPERAND else (a, b)
        srcs = []
        for reg in regs:
            if reg not in last_def:
                raise ValueError(f"predicate instruction {j} ({op}) reads "
                                 f"register {reg} before it is written")
            srcs.append(last_def[reg])
        nodes.append([op, imm, srcs, 0, 0])
        last_def[d] = j
    # uniform operands (b first: one imm field)
    for node in nodes:
        if node[0] not in _TAKES_UNIFORM:
            continue
        for pos, bit in ((1, _B_UNI), (0, _A_UNI)):
            src = nodes[node[2][pos]]
            if src[0] in ("CONST", "LIT"):
                node[1] = src[1]
                node[3] |= bit | (_UNI_LIT if src[0] == "LIT" else 0)
                node[2][pos] = None
                break

    def readers():
        count = [0] * len(nodes)
        for j in order:
            for src in nodes[j][2]:
                if src is not None:
                    count[src] += 1
        return count

    order = list(range(len(nodes)))          # the surviving instructions
    # NOT after its only input's boolean op: the op negates, the NOT goes
    uses = readers()
    for j in range(1, len(nodes)):
        op, _, srcs, _, _ = nodes[j]
        if op == "NOT" and srcs[0] == j - 1 and j - 1 in order \
                and nodes[j - 1][0] in _BOOL_RESULT and uses[j - 1] == 1:
            nodes[j - 1][3] ^= _NEG
            order.remove(j)
            for node in nodes:
                node[2] = [j - 1 if s == j else s for s in node[2]]
    # what nothing reads goes, bar the result (the last instruction)
    uses = readers()
    order = [j for j in order if uses[j] or j == order[-1]]
    # a LOAD read only by the next instruction, as its operand a, folds in
    uses = readers()
    for p in range(len(order) - 1):
        j, k = order[p], order[p + 1]
        if nodes[j][0] == "LOAD" and uses[j] == 1 and nodes[k][2] \
                and nodes[k][2][0] == j:
            nodes[k][2][0] = None
            nodes[k][3] |= _A_LOAD
            nodes[k][4] = nodes[j][1]
            nodes[j][0] = None
    order = [j for j in order if nodes[j][0] is not None]
    pos = {j: p for p, j in enumerate(order)}
    last_use: Dict[int, int] = {}
    for j in order:
        for k, src in enumerate(nodes[j][2]):
            if src is None:
                continue
            if pos[src] != pos[j] - 1:
                nodes[src][3] |= _STORE
                nodes[j][3] |= (_A_SMEM, _B_SMEM)[k]
            last_use[src] = max(last_use.get(src, -1), pos[j])
    # slots by liveness: a value's slot frees once its last reader ran
    slot: Dict[int, int] = {}
    free: List[int] = []
    n_slots = 0
    out = []
    for j in order:
        op, imm, srcs, flags, col = nodes[j]
        ab = [slot[src] if src is not None and flags & bit else 0
              for src, bit in zip(srcs + [None] * (2 - len(srcs)),
                                  (_A_SMEM, _B_SMEM))]
        for src in set(srcs):
            if src in slot and last_use[src] == pos[j]:
                free.append(slot[src])
        dst = 0
        if flags & _STORE:
            if free:
                free.sort()
                dst = free.pop(0)
            else:
                dst, n_slots = n_slots, n_slots + 1
            slot[j] = dst
        out.append((op, dst, ab[0], ab[1], imm, flags, col))
    return tuple(out), n_slots


@dataclasses.dataclass(frozen=True)
class PredicateLaunch:
    """How ``csrc/predicate.cu`` runs one program over ``n`` rows: the
    scheduled ``instrs`` and their ``n_slots`` register-file slots; each
    whitelist's word offset in shared memory (-1: searched in global
    memory), each int whitelist's bitmap area there (-1: none), and the
    words of both; ``rows`` a thread, so a ``tile`` of ``rows x
    PRED_THREADS`` rows; the dynamic shared memory a block; and a persistent
    grid of ``grid`` blocks (the card's SMs x ``blocks_per_sm``, at most one
    block a tile)."""

    instrs: Tuple[Tuple[str, int, int, int, int, int, int], ...]
    n_slots: int
    table_offsets: Tuple[int, ...]
    bitmap_offsets: Tuple[int, ...]
    table_words: int
    rows: int
    tile: int
    smem_bytes: int
    blocks_per_sm: int
    grid: int


def _resident_blocks(smem_bytes: int) -> int:
    """Blocks an sm_90 SM holds by threads and shared memory alone (the
    card's occupancy query also counts registers)."""
    return min(THREADS_PER_SM // PRED_THREADS,
               SMEM_PER_SM // (smem_bytes + SMEM_RESERVED))


def plan_predicate_launch(prog: Program, n: int, sm_count: int,
                          table_lens: Optional[Sequence[int]] = None,
                          occupancy=None) -> PredicateLaunch:
    """Plan the kernel's launch over ``n`` rows on a card of ``sm_count``
    SMs.  ``table_lens`` are the staged whitelists' lengths (default: the
    static ones, and ``MAX_ISIN_VALUES`` for each hoisted one);
    ``occupancy(rows, smem_bytes)`` gives the resident blocks per SM (the
    card's own query on the launch path; default: the thread and
    shared-memory limits of sm_90)."""
    instrs, n_slots = schedule_program(prog)
    if table_lens is None:
        table_lens = [spec[1].size if spec[0] == "static" else MAX_ISIN_VALUES
                      for spec in prog.tables]
    offsets, words = [], 0
    for length in table_lens:
        if length <= MAX_ISIN_VALUES:
            offsets.append(words)
            words += int(length)
        else:
            offsets.append(-1)
    bitmaps = []
    for spec, off in zip(prog.tables, offsets):
        is_int = spec[1].dtype == np.int32 if spec[0] == "static" \
            else spec[2] == "i"
        if off >= 0 and is_int:
            bitmaps.append(words)
            words += BITMAP_WORDS
        else:
            bitmaps.append(-1)
    fixed = ctypes.sizeof(_PredArgs) + 16 * (-(-words // 4))
    for rows in PRED_ROWS:
        tile = PRED_THREADS * rows
        smem = fixed + 4 * n_slots * tile
        if smem <= SMEM_PER_BLOCK:
            break
    else:
        raise ValueError(f"predicate program needs {smem} bytes of shared "
                         f"memory a block, past {SMEM_PER_BLOCK}")
    per_sm = int(occupancy(rows, smem) if occupancy is not None
                 else _resident_blocks(smem))
    if per_sm < 1:
        raise RuntimeError(f"predicate kernel cannot run with {smem} bytes "
                           f"of shared memory a block")
    tiles = -(-int(n) // tile)
    return PredicateLaunch(instrs, n_slots, tuple(offsets), tuple(bitmaps),
                           words, rows, tile, smem, per_sm,
                           max(1, min(tiles, int(sm_count) * per_sm)))


class _Instr(ctypes.Structure):
    _fields_ = [("op", ctypes.c_uint8), ("dst", ctypes.c_uint8),
                ("a", ctypes.c_uint8), ("b", ctypes.c_uint8),
                ("imm", ctypes.c_int32), ("flags", ctypes.c_int32),
                ("col", ctypes.c_int32)]


class _PredArgs(ctypes.Structure):
    _fields_ = [("cols", ctypes.c_void_p * MAX_COLS),
                ("tables", ctypes.c_void_p * MAX_TABLES),
                ("table_len", ctypes.c_int32 * MAX_TABLES),
                ("table_off", ctypes.c_int32 * MAX_TABLES),
                ("bitmap_off", ctypes.c_int32 * MAX_TABLES),
                ("lits", ctypes.c_uint32 * MAX_LITS),
                ("prog", _Instr * MAX_INSTR),
                ("n_instr", ctypes.c_int32),
                ("n_slots", ctypes.c_int32),
                ("table_words", ctypes.c_int32),
                ("n_cols", ctypes.c_int32)]


_OCCUPANCY: Dict[Tuple[int, int, int], int] = {}


def _occupancy(device: torch.device, rows: int, smem_bytes: int) -> int:
    """Resident blocks per SM of the ``rows``-row kernel at ``smem_bytes``,
    from the card's occupancy query (cached by device, rows and size)."""
    from repro_torch.kernels.build import check, library

    key = (device.index if device.index is not None
           else torch.cuda.current_device(), rows, smem_bytes)
    if key not in _OCCUPANCY:
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            status = library().repro_predicate_occupancy(
                rows, smem_bytes, ctypes.byref(per_sm), ctypes.byref(sms))
        check(status, "predicate_bitset occupancy")
        _OCCUPANCY[key] = per_sm.value
    return _OCCUPANCY[key]


def device_plan(prog: Program, n: int, device, params=None,
                tables: Optional[List[torch.Tensor]] = None
                ) -> PredicateLaunch:
    """The launch plan ``predicate_bitset`` uses for ``prog`` over ``n``
    rows on the CUDA ``device``: the card's SM count and occupancy."""
    device = torch.device(device)
    if tables is None:
        tables = _table_operands(prog, (params or ((), ()))[1], device)
    return plan_predicate_launch(
        prog, n, torch.cuda.get_device_properties(device).multi_processor_count,
        [t.shape[0] for t in tables],
        occupancy=functools.partial(_occupancy, device))


def _launch(prog: Program, columns: Dict[str, torch.Tensor],
            valid: torch.Tensor, capacity: int, params):
    from repro_torch.kernels.build import check, library

    require_kernel_operand(valid, "predicate valid words")
    if valid.dtype != torch.int32 or valid.shape != (_bs.n_words(capacity),):
        raise ValueError("predicate valid must be the table's int32 words")
    device = valid.device
    b_lits, b_vecs = params if params is not None else ((), ())
    args = _PredArgs()
    for k, name in enumerate(prog.columns):
        c = columns[name]
        require_kernel_operand(c, f"predicate column {name!r}")
        if c.shape != (capacity,) or c.device != device:
            raise ValueError(f"predicate column {name!r} must have "
                             f"{capacity} rows on {device}")
        args.cols[k] = c.data_ptr()
    keep = _table_operands(prog, b_vecs, device)   # outlive the launch
    plan = device_plan(prog, capacity, device, tables=keep)
    for k, t in enumerate(keep):
        args.tables[k] = t.data_ptr()
        args.table_len[k] = t.shape[0]
        args.table_off[k] = plan.table_offsets[k]
        args.bitmap_off[k] = plan.bitmap_offsets[k]
    for k in range(len(keep), MAX_TABLES):
        args.table_off[k] = args.bitmap_off[k] = -1
    for k, (slot, kind) in enumerate(prog.lits):
        args.lits[k] = _bits_of(_scalar(b_lits[slot]), kind) & 0xFFFFFFFF
    for k, (op, d, a, b, imm, flags, col) in enumerate(plan.instrs):
        args.prog[k] = _Instr(OPCODES[op], d, a, b, imm, flags, col)
    args.n_instr = len(plan.instrs)
    args.n_slots = plan.n_slots
    args.table_words = plan.table_words
    args.n_cols = len(prog.columns)
    words = torch.empty((_bs.n_words(capacity),), dtype=torch.int32,
                        device=device)
    cnt = torch.zeros((1,), dtype=torch.int32, device=device)
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    status = lib.repro_predicate_bitset(
        ctypes.byref(args), valid.data_ptr(), ctypes.c_longlong(capacity),
        plan.rows, plan.grid, plan.smem_bytes, words.data_ptr(), cnt.data_ptr(),
        stream)
    launch_counts["predicate_bitset"] += 1
    check(status, "predicate_bitset")
    return words, cnt[0]


def predicate_bitset(columns: Dict[str, torch.Tensor], valid: torch.Tensor, *,
                     expr_param: Tuple, capacity: Optional[int] = None,
                     params: Optional[Tuple[Sequence, Sequence]] = None):
    """Fused predicate -> packed bitset over a table's columns.

    ``valid`` is the table's packed int32 words (or a ``(n,) bool`` mask,
    packed at the boundary).  Returns ``(words, count)`` of ``valid & expr``
    — ``count`` a 0-d int32 tensor.  CUDA operands launch the kernel; CPU
    operands run the plain version.  ``params`` is the bound ``(lits,
    vecs)`` pair backing hoisted slot refs."""
    if valid.dtype == torch.bool:
        capacity = int(valid.shape[0])
        valid = _bs.pack(valid)
    elif capacity is None:
        names = referenced(expr_param)[0]
        if not names:
            raise ValueError("packed valid needs an explicit capacity when "
                             "the predicate reads no columns")
        capacity = int(columns[names[0]].shape[0])
    kinds = _kinds(columns, expr_param, params)
    prog = compile_program(expr_param, *kinds)
    if capacity == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=valid.device),
                torch.zeros((), dtype=torch.int32, device=valid.device))
    if valid.device.type == "cuda":
        return _launch(prog, columns, valid, capacity, params)
    return predicate_bitset_plain(prog, columns, valid, capacity, params)
