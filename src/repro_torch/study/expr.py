"""Typed column-expression IR: the ``col()``/``Expr`` DSL.

The port of ``repro.study.expr``.  Serialized Exprs (``to_param``) are
identical to the reference's, so plans built in either package hash and
compare alike.  Evaluation (``evaluate``/``mask``, the ``torch`` predicate
engine) follows jnp's semantics, not torch's: promotion against Python
literals, ``//`` and ``%`` by zero, NaN membership (see
``kernels.predicate.binary_arith``).

SCALPEL3's pitch is "sharp interactive control of data processing through
legible code": extraction concepts are declarative queries the engine can
*analyze*, not opaque callables.  This module is the analyzable predicate
layer of the Plan IR:

  * ``col("BEN_NIR_PSA") >= 18`` builds an ``Expr`` tree (comparisons,
    arithmetic, set membership, null tests, ``&``/``|``/``~`` combinators);
  * Expr trees serialize to hashable nested tuples (``to_param``), so they
    ride plan nodes (``predicate``/``fused_mask``) through hash-consing and
    the executor's runner cache unchanged;
  * every predicate-ish plan op (``drop_nulls``, ``value_filter``,
    ``fused_mask``, ``slice_time`` bounds) re-expresses as an ``Expr`` via
    ``node_predicate`` — one evaluation semantics for the whole IR;
  * ``Expr.required_columns()`` is what the optimizer's column-pruning pass
    propagates backwards through the flatten joins into the star scans;
  * ``fused_predicate`` compiles a fused node's accumulated conjuncts into a
    single Expr, evaluated as ONE pass over the projected columns (by torch
    mask algebra or the CUDA predicate kernel).

Null semantics are deliberately "raw" for comparisons/arithmetic (sentinel
values compare like any other value, as in the fixed-width SoA encoding);
``is_null()``/``not_null()`` are the explicit sentinel tests — mirroring how
the eager mask algebra has always behaved.

The module also hosts the ``CohortExpr`` layer: a recursive-descent parser
for cohort algebra strings (``"(exposed & base) - fractured"``) with real
operator precedence (``&`` binds tighter than ``|``/``-``) and parentheses,
lowered by ``Study.cohort`` onto the same plan machinery.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import operator as _op
import threading
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch

from repro_torch.core.columnar import ColumnarTable, NULL_INT, is_null
from repro_torch.kernels.predicate import (binary_arith, binary_cmp,
                                          flush_denormals, value_kind)

_NULL_SENTINEL_INT = NULL_INT

__all__ = [
    "Expr", "Col", "Lit", "col", "lit", "all_of", "any_of",
    "expr_from_param", "fused_predicate", "node_predicate",
    "param_conjuncts", "const_fold_param",
    "HoistedLit", "HoistedIsIn", "bound_params", "current_bound_params",
    "CohortRef", "CohortCombine", "CohortParseError", "parse_cohort_expr",
]


# ---------------------------------------------------------------------------
# Expr trees
# ---------------------------------------------------------------------------
_CMP_FNS = {"==": _op.eq, "!=": _op.ne, "<": _op.lt, "<=": _op.le,
            ">": _op.gt, ">=": _op.ge}
_ARITH_FNS = {"+": _op.add, "-": _op.sub, "*": _op.mul,
              "//": _op.floordiv, "%": _op.mod}


def _coerce(v: Any) -> "Expr":
    if isinstance(v, Expr):
        return v
    if isinstance(v, (bool, int, float, np.integer, np.floating)):
        return Lit(v)
    raise TypeError(f"cannot use {type(v).__name__} in a column expression; "
                    f"wrap columns with col(...) and use scalar literals")


class Expr:
    """Base of the expression tree.  Build with ``col()``/``lit()`` and the
    overloaded operators; combine predicates with ``&``/``|``/``~`` (never
    Python's ``and``/``or``, which cannot be overloaded)."""

    __slots__ = ()
    # value-semantics __eq__ builds a node, so identity hashing would be
    # incoherent — Exprs are deliberately unhashable (plans store to_param()).
    __hash__ = None

    def __setstate__(self, state):
        # unpickling (a study sent to a spawned rank) sets the immutable
        # slots as the constructors do
        for d in (state if isinstance(state, tuple) else (state,)):
            for k, v in (d or {}).items():
                object.__setattr__(self, k, v)

    # -- comparisons ---------------------------------------------------------
    def __eq__(self, other):  # type: ignore[override]
        return Cmp("==", self, _coerce(other))

    def __ne__(self, other):  # type: ignore[override]
        return Cmp("!=", self, _coerce(other))

    def __lt__(self, other):
        return Cmp("<", self, _coerce(other))

    def __le__(self, other):
        return Cmp("<=", self, _coerce(other))

    def __gt__(self, other):
        return Cmp(">", self, _coerce(other))

    def __ge__(self, other):
        return Cmp(">=", self, _coerce(other))

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, other):
        return Arith("+", self, _coerce(other))

    def __radd__(self, other):
        return Arith("+", _coerce(other), self)

    def __sub__(self, other):
        return Arith("-", self, _coerce(other))

    def __rsub__(self, other):
        return Arith("-", _coerce(other), self)

    def __mul__(self, other):
        return Arith("*", self, _coerce(other))

    def __rmul__(self, other):
        return Arith("*", _coerce(other), self)

    def __floordiv__(self, other):
        return Arith("//", self, _coerce(other))

    def __rfloordiv__(self, other):
        return Arith("//", _coerce(other), self)

    def __mod__(self, other):
        return Arith("%", self, _coerce(other))

    def __rmod__(self, other):
        return Arith("%", _coerce(other), self)

    # -- boolean combinators -------------------------------------------------
    def __and__(self, other):
        return BoolOp("and", self, _coerce(other))

    def __rand__(self, other):
        return BoolOp("and", _coerce(other), self)

    def __or__(self, other):
        return BoolOp("or", self, _coerce(other))

    def __ror__(self, other):
        return BoolOp("or", _coerce(other), self)

    def __invert__(self):
        return Not(self)

    def __bool__(self):
        raise TypeError("Expr has no truth value; use & | ~ to combine "
                        "predicates (not and/or/not)")

    # -- predicate sugar -----------------------------------------------------
    def isin(self, values: Iterable) -> "Expr":
        """Set membership against a static whitelist (SQL ``IN``)."""
        return IsIn(self, tuple(values))

    def is_null(self) -> "Expr":
        """Sentinel-encoded null test (see ``columnar.is_null``)."""
        return NullTest(self, negate=False)

    def not_null(self) -> "Expr":
        return NullTest(self, negate=True)

    def between(self, lo, hi) -> "Expr":
        """Half-open range test ``lo <= self < hi`` (slice_time semantics)."""
        return (self >= lo) & (self < hi)

    # -- analysis ------------------------------------------------------------
    def required_columns(self) -> frozenset:
        """Every column this expression reads — the unit the optimizer's
        column-pruning pass propagates backwards through joins."""
        raise NotImplementedError

    def to_param(self) -> Tuple:
        """Hashable nested-tuple serialization for plan-node params."""
        raise NotImplementedError

    def evaluate(self, table: ColumnarTable):
        """Naive per-node evaluation over a table (the reference semantics;
        the fused path must agree bit-for-bit — see tests/test_expr.py)."""
        raise NotImplementedError

    def mask(self, table: ColumnarTable) -> torch.Tensor:
        """Row-filter mask: the expression's boolean value AND row validity.

        This is the ``torch`` engine — the per-row expansion here is packed
        back into the table's bitset validity at the constructor boundary;
        the ``cuda`` engine emits packed words directly and never takes it."""
        return table.valid_bool() & self.evaluate(table)


class Col(Expr):
    __slots__ = ("name",)

    def __init__(self, name: str):
        object.__setattr__(self, "name", str(name))

    def __setattr__(self, *a):  # immutable value object
        raise AttributeError("Expr nodes are immutable")

    def required_columns(self):
        return frozenset((self.name,))

    def to_param(self):
        return ("col", self.name)

    def evaluate(self, table):
        return table.columns[self.name]

    def __repr__(self):
        return self.name


class Lit(Expr):
    __slots__ = ("value",)

    def __init__(self, value):
        object.__setattr__(self, "value", value)

    def __setattr__(self, *a):
        raise AttributeError("Expr nodes are immutable")

    def required_columns(self):
        return frozenset()

    def to_param(self):
        return ("lit", self.value)

    def evaluate(self, table):
        return self.value

    def __repr__(self):
        return repr(self.value)


class _Binary(Expr):
    __slots__ = ("op", "lhs", "rhs")
    _tag = ""

    def __init__(self, op: str, lhs: Expr, rhs: Expr):
        object.__setattr__(self, "op", op)
        object.__setattr__(self, "lhs", lhs)
        object.__setattr__(self, "rhs", rhs)

    def __setattr__(self, *a):
        raise AttributeError("Expr nodes are immutable")

    def required_columns(self):
        return self.lhs.required_columns() | self.rhs.required_columns()

    def to_param(self):
        return (self._tag, self.op, self.lhs.to_param(), self.rhs.to_param())


class Cmp(_Binary):
    __slots__ = ()
    _tag = "cmp"

    def evaluate(self, table):
        return binary_cmp(self.op, self.lhs.evaluate(table),
                          self.rhs.evaluate(table))

    def __repr__(self):
        return f"({self.lhs!r} {self.op} {self.rhs!r})"


class Arith(_Binary):
    __slots__ = ()
    _tag = "arith"

    def evaluate(self, table):
        return binary_arith(self.op, self.lhs.evaluate(table),
                            self.rhs.evaluate(table))

    def __repr__(self):
        return f"({self.lhs!r} {self.op} {self.rhs!r})"


class BoolOp(_Binary):
    __slots__ = ()
    _tag = "bool"

    def evaluate(self, table):
        l, r = self.lhs.evaluate(table), self.rhs.evaluate(table)
        return (l & r) if self.op == "and" else (l | r)

    def __repr__(self):
        sym = "&" if self.op == "and" else "|"
        return f"({self.lhs!r} {sym} {self.rhs!r})"


class Not(Expr):
    __slots__ = ("x",)

    def __init__(self, x: Expr):
        object.__setattr__(self, "x", x)

    def __setattr__(self, *a):
        raise AttributeError("Expr nodes are immutable")

    def required_columns(self):
        return self.x.required_columns()

    def to_param(self):
        return ("not", self.x.to_param())

    def evaluate(self, table):
        return ~self.x.evaluate(table)

    def __repr__(self):
        return f"~{self.x!r}"


class IsIn(Expr):
    __slots__ = ("x", "values")

    def __init__(self, x: Expr, values: Tuple):
        object.__setattr__(self, "x", x)
        object.__setattr__(self, "values", tuple(values))

    def __setattr__(self, *a):
        raise AttributeError("Expr nodes are immutable")

    def required_columns(self):
        return self.x.required_columns()

    def to_param(self):
        return ("isin", self.x.to_param(), self.values)

    def evaluate(self, table):
        v = self.x.evaluate(table)
        if not self.values:  # empty whitelist matches nothing
            return _no_match(v)
        dt = np.float32 if any(isinstance(c, float) for c in self.values) \
            else np.int32
        return _isin(v, torch.from_numpy(np.asarray(self.values, dt)))

    def __repr__(self):
        vs = (list(self.values) if len(self.values) <= 4
              else f"<{len(self.values)} values>")
        return f"{self.x!r} in {vs}"


class NullTest(Expr):
    __slots__ = ("x", "negate")

    def __init__(self, x: Expr, negate: bool):
        object.__setattr__(self, "x", x)
        object.__setattr__(self, "negate", bool(negate))

    def __setattr__(self, *a):
        raise AttributeError("Expr nodes are immutable")

    def required_columns(self):
        return self.x.required_columns()

    def to_param(self):
        return ("notnull" if self.negate else "isnull", self.x.to_param())

    def evaluate(self, table):
        v = self.x.evaluate(table)
        m = is_null(v if isinstance(v, torch.Tensor) else torch.tensor(v))
        return ~m if self.negate else m

    def __repr__(self):
        return f"{self.x!r} is {'not ' if self.negate else ''}null"


def _no_match(v) -> torch.Tensor:
    """All-False membership of ``v`` (an empty whitelist matches nothing)."""
    if isinstance(v, torch.Tensor):
        return torch.zeros(v.shape, dtype=torch.bool, device=v.device)
    return torch.tensor(False)


def _isin(v, table: torch.Tensor) -> torch.Tensor:
    """``jnp.isin``: both sides promoted to one type (bools count as ints),
    float32 denormals flushed as XLA compares them; a NaN probe is never a
    member."""
    if not isinstance(v, torch.Tensor):
        v = torch.tensor(v)
    kv = "i" if value_kind(v) == "b" else value_kind(v)
    kt = value_kind(table)
    dt = torch.float32 if "f" in (kv, kt) else torch.int32
    return torch.isin(flush_denormals(v.to(dt)),
                      flush_denormals(table.to(device=v.device, dtype=dt)))


# ---------------------------------------------------------------------------
# hoisted literals (plan normalization)
# ---------------------------------------------------------------------------
# Binding stack for hoisted literal slots.  ``normalize.normalize`` rewrites
# ``("lit", v)`` / ``("isin", x, values)`` leaves into slot references so
# structurally-equal plans from different tenants serialize identically; the
# actual values are passed to the plan runner as arguments and bound here for
# the duration of one evaluation.  The stack is consulted synchronously while
# the executor evaluates the plan; it is thread-LOCAL so that concurrent
# evaluations on different threads each see only their own bindings.
_BOUND_LOCAL = threading.local()


def _bound_stack() -> List[Tuple[Sequence, Sequence]]:
    stack = getattr(_BOUND_LOCAL, "stack", None)
    if stack is None:
        stack = _BOUND_LOCAL.stack = []
    return stack


@contextlib.contextmanager
def bound_params(lits: Sequence, vecs: Sequence):
    """Bind the literal/whitelist vectors hoisted-Expr slots read from.

    ``lits[i]`` backs ``HoistedLit(slot=i)`` (a scalar, possibly traced);
    ``vecs[j]`` backs ``HoistedIsIn(slot=j)`` (a 1-D whitelist array)."""
    stack = _bound_stack()
    stack.append((tuple(lits), tuple(vecs)))
    try:
        yield
    finally:
        stack.pop()


def current_bound_params() -> Optional[Tuple[Sequence, Sequence]]:
    """The innermost ``bound_params`` binding on this thread, or None.  The
    executor hands this to the CUDA predicate kernel so hoisted slots
    become kernel arguments (``kernels.predicate`` stays import-light — it
    never reads this module's state itself)."""
    stack = _bound_stack()
    return stack[-1] if stack else None


def _bound(kind: int, slot: int):
    stack = _bound_stack()
    if not stack:
        raise RuntimeError(
            "hoisted Expr evaluated outside expr.bound_params(...); "
            "normalized plans need their literal vector bound at execution")
    vec = stack[-1][kind]
    if slot >= len(vec):
        raise IndexError(f"hoisted slot {slot} out of range "
                         f"({len(vec)} bound)")
    return vec[slot]


class HoistedLit(Expr):
    """A scalar literal hoisted out of the plan into params slot ``slot``.

    Serializes as ``("hlit", slot)`` — no value — so plans differing only in
    literal values share one structural key (and one compiled executable);
    the value arrives as a traced scalar via ``bound_params``."""

    __slots__ = ("slot",)

    def __init__(self, slot: int):
        object.__setattr__(self, "slot", int(slot))

    def __setattr__(self, *a):
        raise AttributeError("Expr nodes are immutable")

    def required_columns(self):
        return frozenset()

    def to_param(self):
        return ("hlit", self.slot)

    def evaluate(self, table):
        return _bound(0, self.slot)

    def __repr__(self):
        return f"?{self.slot}"


class HoistedIsIn(Expr):
    """Set membership against a hoisted whitelist (params slot ``slot``).

    The whitelist *size* and element kind stay structural (``n``,
    ``isfloat`` — they fix the traced vector's shape/dtype); the member
    values travel in the params vector.  An empty whitelist matches nothing,
    mirroring ``IsIn``."""

    __slots__ = ("x", "slot", "n", "isfloat")

    def __init__(self, x: Expr, slot: int, n: int, isfloat: bool):
        object.__setattr__(self, "x", x)
        object.__setattr__(self, "slot", int(slot))
        object.__setattr__(self, "n", int(n))
        object.__setattr__(self, "isfloat", bool(isfloat))

    def __setattr__(self, *a):
        raise AttributeError("Expr nodes are immutable")

    def required_columns(self):
        return self.x.required_columns()

    def to_param(self):
        return ("hisin", self.x.to_param(), self.slot, self.n, self.isfloat)

    def evaluate(self, table):
        v = self.x.evaluate(table)
        if self.n == 0:  # empty whitelist matches nothing
            return _no_match(v)
        vec = _bound(1, self.slot)
        return _isin(v, vec if isinstance(vec, torch.Tensor)
                     else torch.as_tensor(np.asarray(vec)))

    def __repr__(self):
        return f"{self.x!r} in ?set{self.slot}<{self.n}>"


# ---------------------------------------------------------------------------
# factories / combinators
# ---------------------------------------------------------------------------
def col(name: str) -> Col:
    """Reference a table column by name — the DSL entry point."""
    return Col(name)


def lit(value) -> Lit:
    return Lit(value)


def all_of(*exprs: Expr) -> Expr:
    """Conjunction of one or more predicates (left-assoc ``&`` fold)."""
    if not exprs:
        raise ValueError("all_of needs at least one expression")
    return functools.reduce(_op.and_, exprs)


def any_of(*exprs: Expr) -> Expr:
    if not exprs:
        raise ValueError("any_of needs at least one expression")
    return functools.reduce(_op.or_, exprs)


# ---------------------------------------------------------------------------
# (de)serialization + node re-expression
# ---------------------------------------------------------------------------
def expr_from_param(p: Tuple) -> Expr:
    """Rebuild an Expr tree from its ``to_param()`` nested-tuple form."""
    tag = p[0]
    if tag == "col":
        return Col(p[1])
    if tag == "lit":
        return Lit(p[1])
    if tag == "cmp":
        return Cmp(p[1], expr_from_param(p[2]), expr_from_param(p[3]))
    if tag == "arith":
        return Arith(p[1], expr_from_param(p[2]), expr_from_param(p[3]))
    if tag == "bool":
        return BoolOp(p[1], expr_from_param(p[2]), expr_from_param(p[3]))
    if tag == "not":
        return Not(expr_from_param(p[1]))
    if tag == "isin":
        return IsIn(expr_from_param(p[1]), p[2])
    if tag == "hlit":
        return HoistedLit(p[1])
    if tag == "hisin":
        return HoistedIsIn(expr_from_param(p[1]), p[2], p[3], p[4])
    if tag == "isnull":
        return NullTest(expr_from_param(p[1]), negate=False)
    if tag == "notnull":
        return NullTest(expr_from_param(p[1]), negate=True)
    raise ValueError(f"unknown Expr param tag {tag!r}")


def as_param(e: Union[Expr, Tuple]) -> Tuple:
    """Accept an Expr or an already-serialized param; return the param."""
    if isinstance(e, Expr):
        return e.to_param()
    if isinstance(e, tuple):
        expr_from_param(e)  # validate
        return e
    raise TypeError(f"expected Expr or serialized param, got {type(e).__name__}")


def required_columns_of_param(p: Tuple) -> frozenset:
    return expr_from_param(p).required_columns()


def fused_predicate(null_cols: Sequence[str] = (),
                    filters: Sequence[Tuple[str, Tuple]] = (),
                    exprs: Sequence[Tuple] = ()) -> Optional[Expr]:
    """Compile a fused_mask node's accumulated conjuncts — legacy null
    columns, legacy (col, codes) whitelists, and serialized Exprs — into ONE
    Expr, so the executor evaluates a single mask function per scan branch
    (one pass over the projected columns)."""
    parts = [col(c).not_null() for c in null_cols]
    parts += [col(c).isin(codes) for c, codes in filters]
    parts += [expr_from_param(e) for e in exprs]
    if not parts:
        return None
    return all_of(*parts)


def node_predicate(node) -> Optional[Expr]:
    """Re-express any predicate-ish plan node as an Expr (the canonical
    view): ``predicate``/``drop_nulls``/``value_filter``/``fused_mask`` and
    the bounds of ``slice_time``.  Returns None for non-predicate ops."""
    op = node.op
    if op == "predicate":
        return expr_from_param(node.get("expr"))
    if op == "drop_nulls":
        return all_of(*[col(c).not_null() for c in node.get("cols")])
    if op == "value_filter":
        return col(node.get("col")).isin(node.get("codes"))
    if op == "fused_mask":
        return fused_predicate(node.get("null_cols") or (),
                               node.get("filters") or (),
                               node.get("exprs") or ())
    if op == "slice_time":
        return col(node.get("col")).between(node.get("lo"), node.get("hi"))
    return None


def render_param(p: Tuple) -> str:
    """Compact human-readable form for OperationLog entries."""
    return repr(expr_from_param(p))


def param_conjuncts(p: Tuple) -> Tuple[Tuple, ...]:
    """Split a serialized Expr into its top-level AND conjuncts.

    The static analyzer reasons conjunct-by-conjunct (interval intersection,
    constant folding): ``(a < 3) & (a > 5) & b.not_null()`` yields three
    parts.  Non-conjunction roots come back as a single-element tuple."""
    if isinstance(p, tuple) and p and p[0] == "bool" and p[1] == "and":
        return param_conjuncts(p[2]) + param_conjuncts(p[3])
    return (p,)


def const_fold_param(p: Tuple):
    """Evaluate a serialized Expr that touches no columns or hoisted slots.

    Returns the folded Python value, or ``None`` when the result depends on
    runtime data (column refs, hoisted slots, unsupported folds).  Boolean
    connectives only fold over boolean operands — predicate algebra on raw
    ints is left to the runtime's bitwise semantics.  ``isin`` over an empty
    whitelist folds to ``False`` regardless of its operand: no value is ever
    a member of the empty set (the analyzer's always-false check rides on
    this)."""
    tag = p[0]
    if tag == "lit":
        return p[1]
    if tag == "cmp":
        l, r = const_fold_param(p[2]), const_fold_param(p[3])
        if l is None or r is None:
            return None
        try:
            return bool(_CMP_FNS[p[1]](l, r))
        except TypeError:
            return None
    if tag == "arith":
        l, r = const_fold_param(p[2]), const_fold_param(p[3])
        if l is None or r is None:
            return None
        try:
            return _ARITH_FNS[p[1]](l, r)
        except (TypeError, ZeroDivisionError):
            return None
    if tag == "bool":
        l, r = const_fold_param(p[2]), const_fold_param(p[3])
        l = l if isinstance(l, bool) else None
        r = r if isinstance(r, bool) else None
        if p[1] == "and":
            if l is False or r is False:
                return False
            if l is True and r is True:
                return True
        else:
            if l is True or r is True:
                return True
            if l is False and r is False:
                return False
        return None
    if tag == "not":
        x = const_fold_param(p[1])
        return (not x) if isinstance(x, bool) else None
    if tag == "isin":
        if len(p[2]) == 0:
            return False
        x = const_fold_param(p[1])
        if x is None:
            return None
        try:
            return any(x == v for v in p[2])
        except TypeError:
            return None
    if tag in ("isnull", "notnull"):
        x = const_fold_param(p[1])
        if x is None:
            return None
        null = (isinstance(x, float) and x != x) or x == _NULL_SENTINEL_INT
        return null if tag == "isnull" else not null
    return None  # col, hlit, hisin: runtime-dependent


# ---------------------------------------------------------------------------
# CohortExpr: cohort-algebra strings with precedence + parentheses
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CohortRef:
    """A named study output used as a cohort operand."""

    name: str


@dataclasses.dataclass(frozen=True)
class CohortCombine:
    """Binary cohort algebra: ``&`` (∩), ``|`` (∪), ``-`` (\\)."""

    op: str
    left: Union["CohortRef", "CohortCombine"]
    right: Union["CohortRef", "CohortCombine"]


class CohortParseError(ValueError):
    """A cohort-algebra syntax error with character position.

    ``offset`` is the 0-based character offset of the offending token in the
    submitted string (the string's end for truncated expressions); the
    message carries a caret snippet so wire-level errors (``SPEC-012``) point
    at the exact character.  Subclasses ``ValueError`` so every pre-existing
    caller's ``except ValueError`` keeps working."""

    def __init__(self, reason: str, expr: str, offset: int) -> None:
        self.reason = reason
        self.expr_text = expr
        self.offset = int(offset)
        caret = "\n  " + expr + "\n  " + " " * self.offset + "^"
        super().__init__(
            f"{reason} at offset {self.offset} in cohort expression{caret}")


def _tokenize_cohort(expr: str):
    """Whitespace-first tokenizer with paren peeling.  Operand names keep
    every non-paren character (so legacy names like ``drug_purchases[cip13]``
    or hyphenated names survive); operators must be whitespace-separated,
    exactly as in the historical flat grammar; parentheses may abut names.
    Returns ``(token, offset)`` pairs — offsets index into ``expr`` so parse
    errors can point at the offending character."""
    toks = []
    k = 0
    for raw in expr.split():
        k = expr.index(raw, k)                   # offset of this word
        i, j = 0, len(raw)
        while i < j and raw[i] == "(":
            toks.append(("(", k + i))
            i += 1
        trail = []
        while j > i and raw[j - 1] == ")":
            j -= 1
            trail.append((")", k + j))
        if i < j:
            toks.append((raw[i:j], k + i))
        toks.extend(reversed(trail))
        k += len(raw)
    return toks


def parse_cohort_expr(expr: str) -> Union[CohortRef, CohortCombine]:
    """Recursive-descent parser for cohort algebra strings.

    Grammar (``&`` binds tighter than ``|`` and ``-``; both levels are
    left-associative, so legacy flat expressions like
    ``"exposed & base - fractured"`` parse to the identical
    ``((exposed ∩ base) \\ fractured)``)::

        expr := term (("|" | "-") term)*
        term := atom ("&" atom)*
        atom := NAME | "(" expr ")"

    Syntax errors raise ``CohortParseError`` (a ``ValueError``) carrying the
    character offset and a caret snippet.
    """
    toks = _tokenize_cohort(expr)
    end = len(expr)
    if not toks:
        raise CohortParseError("empty cohort expression", expr, 0)
    pos = [0]

    def peek():
        return toks[pos[0]][0] if pos[0] < len(toks) else None

    def here():
        return toks[pos[0]][1] if pos[0] < len(toks) else end

    def take():
        t = peek()
        pos[0] += 1
        return t

    def parse_atom():
        at = here()
        t = take()
        if t == "(":
            node = parse_union()
            if peek() != ")":
                raise CohortParseError("unbalanced parentheses", expr, here())
            take()
            return node
        if t is None or t in ("&", "|", "-", ")"):
            raise CohortParseError(
                f"expected cohort name, got {t!r}", expr, at)
        return CohortRef(t)

    def parse_inter():
        node = parse_atom()
        while peek() == "&":
            take()
            node = CohortCombine("&", node, parse_atom())
        return node

    def parse_union():
        node = parse_inter()
        while peek() in ("|", "-"):
            node = CohortCombine(take(), node, parse_inter())
        return node

    node = parse_union()
    if pos[0] != len(toks):
        raise CohortParseError(
            f"unexpected token {peek()!r}", expr, here())
    return node
