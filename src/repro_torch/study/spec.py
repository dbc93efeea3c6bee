"""Declarative study front end: wire-format specs that compile to ``Study``.

The port of ``repro.study.spec``: the same schema, ``SPEC-nnn`` codes, JSON
paths, messages and hints, compiled onto the port's ``Study``.  Nothing here
touches a device.

SCALPEL3's pitch is studies as legible, reproducible artifacts.  This module
is the layer that makes a study *data*: a versioned JSON/dict schema
(cf. Conquery's declarative query format) covering concept extraction,
predicate trees, cohort algebra, flatten directives and feature exports —
compiled onto the exact same ``Study`` builder Python callers use, so a spec
and its hand-written equivalent produce bit-identical plans, results and
cache keys.

Three entry points:

  * ``validate_spec(spec)`` — strict structural validation.  Every problem
    is reported as a ``SpecIssue`` with a stable ``SPEC-nnn`` code, a
    JSON-style ``path`` to the offending field, and a fix hint; validation
    happens entirely *before* plan construction.
  * ``compile_spec(spec) -> Study`` — validate, then replay the spec onto a
    ``Study``; raises ``SpecValidationError`` (never builds a plan) when
    validation fails.
  * ``spec_from_study(study) -> spec`` — the inverse, serialized from the
    builder's declarative recipe log, so existing Python studies (and the
    plan goldens) round-trip into public wire artifacts:
    ``compile_spec(spec_from_study(s))`` rebuilds the identical plan.

``error_payload(exc)`` renders any admission failure — spec validation,
``SPnnn`` analyzer findings, runtime surprises — as the service's structured
wire payload ``{"status": "invalid", "errors": [...]}``; a traceback never
crosses the wire.

Spec shape (see README "Declarative study specs" for the reference table)::

    {"spec_version": 1,
     "n_patients": 1000,
     "window": [14600, 15695],                   # optional
     "schema": [{"star": "DCIR", ...}],          # optional flatten directives
     "concepts": [{"kind": "extract", ...},      # ordered declarations
                  {"kind": "patients"},
                  {"kind": "transform", ...},
                  {"kind": "filter", ...},
                  {"kind": "concat", ...}],
     "cohorts": {"base": "extract_patients",     # ordered algebra strings
                 "final": "(exposed & base) - fractured"},
     "flow": ["base", "final"],                  # optional
     "outputs": [{"kind": "featurize", ...}]}    # optional
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.extraction import Extractor
from repro_torch.core.schema import DCIR_SCHEMA, HAD_SCHEMA, IR_IMB_SCHEMA, \
    PMSI_MCO_SCHEMA, SSR_SCHEMA
from repro_torch.study.api import Study
from repro_torch.study.expr import CohortParseError, CohortCombine, \
    CohortRef, _ARITH_FNS, _CMP_FNS, as_param, expr_from_param, \
    parse_cohort_expr

__all__ = [
    "SPEC_VERSION", "SPEC_CODES", "STAR_SCHEMAS",
    "SpecIssue", "SpecValidationError",
    "validate_spec", "compile_spec", "spec_from_study",
    "expr_to_dict", "expr_dict_to_param", "error_payload",
]

SPEC_VERSION = 1

# star schemas addressable from the wire, by name.  Registration is what
# makes a schema spec-expressible: ``spec_from_study`` refuses studies built
# over unregistered ad-hoc stars rather than emit a spec that cannot compile.
STAR_SCHEMAS = {s.name: s for s in (
    DCIR_SCHEMA, PMSI_MCO_SCHEMA, SSR_SCHEMA, HAD_SCHEMA, IR_IMB_SCHEMA)}

# stable wire-error vocabulary (mirrors analyze.DIAGNOSTIC_CODES for SPnnn).
# Codes are append-only: tools and tenants match on them.
SPEC_CODES: Mapping[str, str] = {
    "SPEC-001": "spec root is not a JSON object",
    "SPEC-002": "spec_version missing or unsupported",
    "SPEC-003": "unknown field",
    "SPEC-004": "required field missing",
    "SPEC-005": "field has the wrong type or value",
    "SPEC-006": "unknown star schema",
    "SPEC-007": "unknown transform function",
    "SPEC-008": "duplicate output name",
    "SPEC-009": "reference to an undefined output",
    "SPEC-010": "malformed expression node",
    "SPEC-011": "bad literal (expected int/float/bool)",
    "SPEC-012": "cohort algebra syntax error",
    "SPEC-013": "bad enumeration value",
    "SPEC-014": "incomplete time-slice directive",
    "SPEC-429": "service queue is full",
    "SPEC-900": "internal error while serving a wire request",
}


@dataclasses.dataclass(frozen=True)
class SpecIssue:
    """One validation finding: stable code + JSON path + message + hint."""

    code: str
    path: str
    message: str
    hint: str = ""

    def as_dict(self) -> Dict[str, str]:
        return {"code": self.code, "path": self.path,
                "message": self.message, "hint": self.hint}

    def __str__(self) -> str:
        return f"{self.code} at {self.path or '$'}: {self.message}"


class SpecValidationError(ValueError):
    """Raised by ``compile_spec`` when validation finds any issue."""

    def __init__(self, issues: Sequence[SpecIssue]) -> None:
        self.issues = list(issues)
        super().__init__("; ".join(str(i) for i in self.issues))


# ---------------------------------------------------------------------------
# expression trees: wire dicts <-> Expr params
# ---------------------------------------------------------------------------
_EXPR_FIELDS = {
    "col": ("name",), "lit": ("value",),
    "cmp": ("cmp", "lhs", "rhs"), "arith": ("arith", "lhs", "rhs"),
    "and": ("lhs", "rhs"), "or": ("lhs", "rhs"), "not": ("x",),
    "isin": ("x", "values"), "is_null": ("x",), "not_null": ("x",),
}
_SCALARS = (bool, int, float)


def expr_to_dict(param: Tuple) -> Dict[str, Any]:
    """Serialize an Expr param (``to_param()`` tuple) as a wire dict."""
    tag = param[0]
    if tag == "col":
        return {"op": "col", "name": param[1]}
    if tag == "lit":
        return {"op": "lit", "value": _py_scalar(param[1])}
    if tag == "cmp":
        return {"op": "cmp", "cmp": param[1],
                "lhs": expr_to_dict(param[2]), "rhs": expr_to_dict(param[3])}
    if tag == "arith":
        return {"op": "arith", "arith": param[1],
                "lhs": expr_to_dict(param[2]), "rhs": expr_to_dict(param[3])}
    if tag == "bool":
        return {"op": param[1],
                "lhs": expr_to_dict(param[2]), "rhs": expr_to_dict(param[3])}
    if tag == "not":
        return {"op": "not", "x": expr_to_dict(param[1])}
    if tag == "isin":
        return {"op": "isin", "x": expr_to_dict(param[1]),
                "values": [_py_scalar(v) for v in param[2]]}
    if tag == "isnull":
        return {"op": "is_null", "x": expr_to_dict(param[1])}
    if tag == "notnull":
        return {"op": "not_null", "x": expr_to_dict(param[1])}
    raise ValueError(f"Expr tag {tag!r} is not wire-expressible "
                     f"(hoisted slots are an internal plan form)")


def expr_dict_to_param(d: Mapping[str, Any]) -> Tuple:
    """Rebuild the Expr param from its wire dict (assumes validated)."""
    op = d["op"]
    if op == "col":
        return ("col", d["name"])
    if op == "lit":
        return ("lit", d["value"])
    if op == "cmp":
        return ("cmp", d["cmp"], expr_dict_to_param(d["lhs"]),
                expr_dict_to_param(d["rhs"]))
    if op == "arith":
        return ("arith", d["arith"], expr_dict_to_param(d["lhs"]),
                expr_dict_to_param(d["rhs"]))
    if op in ("and", "or"):
        return ("bool", op, expr_dict_to_param(d["lhs"]),
                expr_dict_to_param(d["rhs"]))
    if op == "not":
        return ("not", expr_dict_to_param(d["x"]))
    if op == "isin":
        return ("isin", expr_dict_to_param(d["x"]), tuple(d["values"]))
    if op == "is_null":
        return ("isnull", expr_dict_to_param(d["x"]))
    if op == "not_null":
        return ("notnull", expr_dict_to_param(d["x"]))
    raise ValueError(f"unknown expression op {op!r}")


def _py_scalar(v: Any) -> Any:
    """numpy scalars -> plain Python, so specs are json.dumps-able."""
    if isinstance(v, bool) or v is None:
        return v
    if isinstance(v, int):
        return int(v)
    if isinstance(v, float):
        return float(v)
    if hasattr(v, "item"):             # np.int32 / 0-d tensors ...
        return v.item()
    return v


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------
class _Issues:
    """Collector with path bookkeeping."""

    def __init__(self) -> None:
        self.items: List[SpecIssue] = []

    def add(self, code: str, path: str, message: str, hint: str = "") -> None:
        self.items.append(SpecIssue(code, path, message,
                                    hint or SPEC_CODES.get(code, "")))


def _is_str(v: Any) -> bool:
    return isinstance(v, str)


def _is_int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _check_keys(d: Mapping, allowed: Sequence[str], required: Sequence[str],
                path: str, iss: _Issues) -> bool:
    ok = True
    for k in d:
        if k not in allowed:
            iss.add("SPEC-003", f"{path}.{k}" if path else str(k),
                    f"unknown field {k!r}",
                    f"allowed fields: {', '.join(allowed)}")
            ok = False
    for k in required:
        if k not in d:
            iss.add("SPEC-004", f"{path}.{k}" if path else str(k),
                    f"required field {k!r} is missing")
            ok = False
    return ok


def _check_expr(d: Any, path: str, iss: _Issues) -> None:
    if not isinstance(d, Mapping):
        iss.add("SPEC-010", path, "expression node must be an object "
                f"with an 'op' field, got {type(d).__name__}")
        return
    op = d.get("op")
    if op not in _EXPR_FIELDS:
        iss.add("SPEC-010", f"{path}.op", f"unknown expression op {op!r}",
                f"one of: {', '.join(sorted(_EXPR_FIELDS))}")
        return
    if not _check_keys(d, ("op",) + _EXPR_FIELDS[op], _EXPR_FIELDS[op],
                       path, iss):
        return
    if op == "col" and not _is_str(d["name"]):
        iss.add("SPEC-005", f"{path}.name", "column name must be a string")
    elif op == "lit" and not isinstance(d["value"], _SCALARS):
        iss.add("SPEC-011", f"{path}.value",
                f"literal must be int/float/bool, got "
                f"{type(d['value']).__name__}")
    elif op == "cmp":
        if d["cmp"] not in _CMP_FNS:
            iss.add("SPEC-013", f"{path}.cmp",
                    f"unknown comparison {d['cmp']!r}",
                    f"one of: {', '.join(_CMP_FNS)}")
        _check_expr(d["lhs"], f"{path}.lhs", iss)
        _check_expr(d["rhs"], f"{path}.rhs", iss)
    elif op == "arith":
        if d["arith"] not in _ARITH_FNS:
            iss.add("SPEC-013", f"{path}.arith",
                    f"unknown arithmetic op {d['arith']!r}",
                    f"one of: {', '.join(_ARITH_FNS)}")
        _check_expr(d["lhs"], f"{path}.lhs", iss)
        _check_expr(d["rhs"], f"{path}.rhs", iss)
    elif op in ("and", "or"):
        _check_expr(d["lhs"], f"{path}.lhs", iss)
        _check_expr(d["rhs"], f"{path}.rhs", iss)
    elif op in ("not", "is_null", "not_null"):
        _check_expr(d["x"], f"{path}.x", iss)
    elif op == "isin":
        _check_expr(d["x"], f"{path}.x", iss)
        vs = d["values"]
        if not isinstance(vs, (list, tuple)):
            iss.add("SPEC-005", f"{path}.values",
                    "isin values must be a list")
        else:
            for i, v in enumerate(vs):
                if not _is_num(v):
                    iss.add("SPEC-011", f"{path}.values[{i}]",
                            f"whitelist value must be int/float, got "
                            f"{type(v).__name__}")


_EXTRACTOR_REQ = ("name", "source", "category", "value_col", "start_col")
_EXTRACTOR_OPT = ("end_col", "group_col", "weight_col", "null_cols",
                  "codes", "distinct", "where")


def _check_extractor(d: Any, path: str, iss: _Issues) -> None:
    if not isinstance(d, Mapping):
        iss.add("SPEC-005", path, "extractor must be an object")
        return
    if not _check_keys(d, _EXTRACTOR_REQ + _EXTRACTOR_OPT, _EXTRACTOR_REQ,
                       path, iss):
        return
    for k in ("name", "source", "value_col", "start_col"):
        if not _is_str(d[k]):
            iss.add("SPEC-005", f"{path}.{k}", f"{k} must be a string")
    if not _is_int(d["category"]) or d["category"] < 0:
        iss.add("SPEC-005", f"{path}.category",
                "category must be a non-negative integer "
                "(see core.events.Category)")
    for k in ("end_col", "group_col", "weight_col"):
        if d.get(k) is not None and not _is_str(d[k]):
            iss.add("SPEC-005", f"{path}.{k}", f"{k} must be a string or null")
    for k in ("null_cols", "distinct"):
        v = d.get(k, [])
        if not isinstance(v, (list, tuple)) or \
                not all(_is_str(c) for c in v):
            iss.add("SPEC-005", f"{path}.{k}",
                    f"{k} must be a list of column names")
    codes = d.get("codes")
    if codes is not None:
        if not isinstance(codes, (list, tuple)):
            iss.add("SPEC-005", f"{path}.codes",
                    "codes must be a list of numbers or null")
        else:
            for i, v in enumerate(codes):
                if not _is_num(v):
                    iss.add("SPEC-011", f"{path}.codes[{i}]",
                            f"whitelist code must be int/float, got "
                            f"{type(v).__name__}")
    if d.get("where") is not None:
        _check_expr(d["where"], f"{path}.where", iss)


_FLATTEN_DEFAULTS: Dict[str, Any] = {
    "name": None, "time_slices": None, "time_column": None, "t0": None,
    "t1": None, "expand_capacity": None, "expand_slack": 1.5,
    "exchange": True, "partitioned_on": None, "keep": None,
}

_CONCEPT_FIELDS = {
    "extract": (("extractor",), ("name", "compact")),
    "patients": ((), ("source", "name")),
    "transform": (("fn", "inputs"), ("name", "kwargs")),
    "concat": (("name", "inputs"), ()),
    "filter": (("source", "where"), ("name",)),
}

_ROOT_FIELDS = ("spec_version", "n_patients", "window", "description",
                "schema", "concepts", "cohorts", "flow", "outputs")


def _cohort_refs(tree) -> List[str]:
    if isinstance(tree, CohortRef):
        return [tree.name]
    assert isinstance(tree, CohortCombine)
    return _cohort_refs(tree.left) + _cohort_refs(tree.right)


def validate_spec(spec: Any) -> List[SpecIssue]:
    """Strict structural validation; returns every finding (never raises).

    An empty list means ``compile_spec`` will build the Study without
    touching plan construction error paths.  The validator is two-phase
    free: names are checked against *previously declared* outputs, in spec
    order, exactly as ``Study`` resolves them."""
    iss = _Issues()
    if not isinstance(spec, Mapping):
        iss.add("SPEC-001", "", f"spec must be a JSON object, got "
                f"{type(spec).__name__}")
        return iss.items
    _check_keys(spec, _ROOT_FIELDS, (), "", iss)
    ver = spec.get("spec_version")
    if ver != SPEC_VERSION:
        iss.add("SPEC-002", "spec_version",
                f"spec_version must be {SPEC_VERSION}, got {ver!r}")
    n = spec.get("n_patients")
    if n is None:
        iss.add("SPEC-004", "n_patients",
                "required field 'n_patients' is missing")
    elif not _is_int(n) or n <= 0:
        iss.add("SPEC-005", "n_patients",
                f"n_patients must be a positive integer, got {n!r}")
    win = spec.get("window")
    if win is not None and (not isinstance(win, (list, tuple))
                            or len(win) != 2
                            or not all(_is_int(x) for x in win)):
        iss.add("SPEC-005", "window",
                f"window must be [start_day, end_day] integers, got {win!r}")
    if "description" in spec and not _is_str(spec["description"]):
        iss.add("SPEC-005", "description", "description must be a string")

    defined: Dict[str, str] = {}       # name -> kind (table|events|cohort)

    def declare(name: Any, kind: str, path: str) -> None:
        if not _is_str(name) or not name:
            iss.add("SPEC-005", path, "output name must be a non-empty "
                    f"string, got {name!r}")
            return
        if name in defined:
            iss.add("SPEC-008", path, f"duplicate output name {name!r}")
            return
        defined[name] = kind

    def require_ref(name: Any, path: str, kinds: Optional[Tuple[str, ...]]
                    = None) -> None:
        if not _is_str(name):
            iss.add("SPEC-005", path, f"reference must be a string, "
                    f"got {name!r}")
        elif name not in defined:
            iss.add("SPEC-009", path, f"reference to undefined output "
                    f"{name!r}", f"defined so far: "
                    f"{', '.join(sorted(defined)) or '(none)'}")
        elif kinds is not None and defined[name] not in kinds:
            iss.add("SPEC-005", path, f"{name!r} is a "
                    f"{defined[name]} output; expected one of "
                    f"{'/'.join(kinds)}")

    # -- schema (flatten directives) ----------------------------------------
    schema = spec.get("schema", [])
    if not isinstance(schema, (list, tuple)):
        iss.add("SPEC-005", "schema",
                "schema must be a list of flatten directives")
        schema = []
    for i, f in enumerate(schema):
        path = f"schema[{i}]"
        if not isinstance(f, Mapping):
            iss.add("SPEC-005", path, "flatten directive must be an object")
            continue
        if not _check_keys(f, ("star",) + tuple(_FLATTEN_DEFAULTS),
                           ("star",), path, iss):
            continue
        star = f.get("star")
        if star not in STAR_SCHEMAS:
            iss.add("SPEC-006", f"{path}.star",
                    f"unknown star schema {star!r}",
                    f"registered: {', '.join(sorted(STAR_SCHEMAS))}")
            continue
        for k in ("time_slices", "t0", "t1", "expand_capacity"):
            if f.get(k) is not None and not _is_int(f[k]):
                iss.add("SPEC-005", f"{path}.{k}", f"{k} must be an integer")
        for k in ("name", "time_column", "partitioned_on"):
            if f.get(k) is not None and not _is_str(f[k]):
                iss.add("SPEC-005", f"{path}.{k}", f"{k} must be a string")
        for k in ("exchange", "keep"):
            if f.get(k) is not None and not isinstance(f[k], bool):
                iss.add("SPEC-005", f"{path}.{k}", f"{k} must be a boolean")
        if f.get("expand_slack") is not None and not _is_num(
                f["expand_slack"]):
            iss.add("SPEC-005", f"{path}.expand_slack",
                    "expand_slack must be a number")
        if f.get("time_slices"):
            missing = [k for k in ("time_column", "t0", "t1")
                       if f.get(k) is None]
            if missing:
                iss.add("SPEC-014", path,
                        f"time_slices needs {', '.join(missing)}",
                        "temporal slicing requires time_column, t0 and t1")
        declare(f.get("name") or star, "table", path)

    # -- concepts -----------------------------------------------------------
    concepts = spec.get("concepts", [])
    if not isinstance(concepts, (list, tuple)):
        iss.add("SPEC-005", "concepts", "concepts must be a list")
        concepts = []
    for i, c in enumerate(concepts):
        path = f"concepts[{i}]"
        if not isinstance(c, Mapping):
            iss.add("SPEC-005", path, "concept must be an object")
            continue
        kind = c.get("kind")
        if kind not in _CONCEPT_FIELDS:
            iss.add("SPEC-013", f"{path}.kind",
                    f"unknown concept kind {kind!r}",
                    f"one of: {', '.join(sorted(_CONCEPT_FIELDS))}")
            continue
        req, opt = _CONCEPT_FIELDS[kind]
        if not _check_keys(c, ("kind",) + req + opt, req, path, iss):
            continue
        if kind == "extract":
            _check_extractor(c["extractor"], f"{path}.extractor", iss)
            if c.get("compact") is not None and not isinstance(
                    c["compact"], bool):
                iss.add("SPEC-005", f"{path}.compact",
                        "compact must be a boolean")
            ex_name = c.get("name")
            if ex_name is None and isinstance(c["extractor"], Mapping):
                ex_name = c["extractor"].get("name")
            declare(ex_name, "events", path)
        elif kind == "patients":
            if c.get("source") is not None and not _is_str(c["source"]):
                iss.add("SPEC-005", f"{path}.source",
                        "source must be a string")
            declare(c.get("name", "extract_patients"), "table", path)
        elif kind == "transform":
            fn = c.get("fn")
            from repro_torch.study import executor as _executor
            if not _is_str(fn) or fn not in _executor.TRANSFORMS:
                iss.add("SPEC-007", f"{path}.fn",
                        f"unknown transform {fn!r}",
                        f"registered: "
                        f"{', '.join(sorted(_executor.TRANSFORMS))}")
            inputs = c.get("inputs")
            if not isinstance(inputs, (list, tuple)) or not inputs:
                iss.add("SPEC-005", f"{path}.inputs",
                        "inputs must be a non-empty list of output names")
            else:
                for j, nm in enumerate(inputs):
                    require_ref(nm, f"{path}.inputs[{j}]",
                                ("table", "events"))
            kw = c.get("kwargs", {})
            if not isinstance(kw, Mapping) or \
                    not all(_is_str(k) for k in kw):
                iss.add("SPEC-005", f"{path}.kwargs",
                        "kwargs must be an object with string keys")
            else:
                clash = sorted(set(kw) & {"fn", "inputs", "name"})
                if clash:
                    iss.add("SPEC-005", f"{path}.kwargs",
                            f"kwargs may not override reserved "
                            f"parameter(s): {', '.join(clash)}",
                            "set fn/inputs/name on the concept itself")
            declare(c.get("name", fn if _is_str(fn) else None),
                    "events", path)
        elif kind == "concat":
            inputs = c.get("inputs")
            if not isinstance(inputs, (list, tuple)) or not inputs:
                iss.add("SPEC-005", f"{path}.inputs",
                        "inputs must be a non-empty list of output names")
            else:
                for j, nm in enumerate(inputs):
                    require_ref(nm, f"{path}.inputs[{j}]",
                                ("table", "events"))
            declare(c.get("name"), "events", path)
        elif kind == "filter":
            src = c.get("source")
            require_ref(src, f"{path}.source", ("table", "events"))
            _check_expr(c["where"], f"{path}.where", iss)
            nm = c.get("name")
            if nm is None and _is_str(src):
                nm = f"{src}_filtered"
            # src may be any JSON value (require_ref only records the
            # issue); hash it only when it is a usable key.
            src_kind = defined.get(src, "events") if _is_str(src) \
                else "events"
            declare(nm, src_kind, path)

    # -- cohorts ------------------------------------------------------------
    cohorts = spec.get("cohorts", {})
    if not isinstance(cohorts, Mapping):
        iss.add("SPEC-005", "cohorts",
                "cohorts must be an object of name -> algebra string")
        cohorts = {}
    for name, alg in cohorts.items():
        path = f"cohorts.{name}"
        if not _is_str(alg):
            iss.add("SPEC-005", path,
                    f"cohort algebra must be a string, got {alg!r}")
            declare(name, "cohort", path)
            continue
        try:
            tree = parse_cohort_expr(alg)
        except CohortParseError as e:
            iss.add("SPEC-012", path, str(e),
                    "operators are whitespace-separated; parentheses group")
            declare(name, "cohort", path)
            continue
        for ref in _cohort_refs(tree):
            require_ref(ref, path)
        declare(name, "cohort", path)

    # -- flow ---------------------------------------------------------------
    flow = spec.get("flow")
    if flow is not None:
        if not isinstance(flow, (list, tuple)) or not flow:
            iss.add("SPEC-005", "flow",
                    "flow must be a non-empty list of cohort names")
        else:
            for j, nm in enumerate(flow):
                require_ref(nm, f"flow[{j}]")

    # -- outputs (feature exports) ------------------------------------------
    outputs = spec.get("outputs", [])
    if not isinstance(outputs, (list, tuple)):
        iss.add("SPEC-005", "outputs", "outputs must be a list")
        outputs = []
    for i, o in enumerate(outputs):
        path = f"outputs[{i}]"
        if not isinstance(o, Mapping):
            iss.add("SPEC-005", path, "output directive must be an object")
            continue
        if o.get("kind") != "featurize":
            iss.add("SPEC-013", f"{path}.kind",
                    f"unknown output kind {o.get('kind')!r}",
                    "only 'featurize' outputs are defined")
            continue
        if not _check_keys(o, ("kind", "name", "cohort", "feature_kind",
                               "patients", "kwargs"),
                           ("name", "cohort"), path, iss):
            continue
        require_ref(o["cohort"], f"{path}.cohort")
        fk = o.get("feature_kind", "dense")
        if fk not in ("dense", "tokens"):
            iss.add("SPEC-013", f"{path}.feature_kind",
                    f"feature_kind must be dense|tokens, got {fk!r}")
        if o.get("patients") is not None:
            require_ref(o["patients"], f"{path}.patients", ("table",))
        kw = o.get("kwargs", {})
        if not isinstance(kw, Mapping) or not all(_is_str(k) for k in kw):
            iss.add("SPEC-005", f"{path}.kwargs",
                    "kwargs must be an object with string keys")
        else:
            clash = sorted(set(kw) & {"name", "cohort", "kind",
                                      "feature_kind", "patients"})
            if clash:
                iss.add("SPEC-005", f"{path}.kwargs",
                        f"kwargs may not override reserved "
                        f"parameter(s): {', '.join(clash)}",
                        "set them on the output directive itself")
        declare(o.get("name"), "feature", path)
    return iss.items


# ---------------------------------------------------------------------------
# compile: spec -> Study
# ---------------------------------------------------------------------------
def _extractor_from_dict(d: Mapping[str, Any]) -> Extractor:
    where = d.get("where")
    codes = d.get("codes")
    return Extractor(
        name=d["name"], source=d["source"], category=int(d["category"]),
        value_col=d["value_col"], start_col=d["start_col"],
        end_col=d.get("end_col"), group_col=d.get("group_col"),
        weight_col=d.get("weight_col"),
        null_cols=tuple(d.get("null_cols", ())),
        codes=None if codes is None else tuple(codes),
        distinct=tuple(d.get("distinct", ())),
        where=None if where is None
        else expr_from_param(expr_dict_to_param(where)))


def compile_spec(spec: Mapping[str, Any]) -> Study:
    """Validate ``spec`` and replay it onto a ``Study``.

    Raises ``SpecValidationError`` (with every ``SpecIssue``) on any
    validation finding — plan construction is never reached with a bad
    spec.  A compiled spec is indistinguishable from the equivalent
    hand-written builder chain: same plan, same optimizer cache key, same
    service admission path."""
    issues = validate_spec(spec)
    if issues:
        raise SpecValidationError(issues)
    window = spec.get("window")
    s = Study(n_patients=spec["n_patients"],
              window=tuple(window) if window else (0, 2_000_000_000))
    for f in spec.get("schema", []):
        kw = {k: f[k] for k in _FLATTEN_DEFAULTS if k in f}
        s.flatten(STAR_SCHEMAS[f["star"]], **kw)
    for c in spec.get("concepts", []):
        kind = c["kind"]
        if kind == "extract":
            ex = _extractor_from_dict(c["extractor"])
            s.extract(ex, name=c.get("name") or ex.name,
                      compact=c.get("compact", True))
        elif kind == "patients":
            s.patients(source=c.get("source", "IR_BEN"),
                       name=c.get("name", "extract_patients"))
        elif kind == "transform":
            s.transform(c["fn"], *c["inputs"],
                        name=c.get("name") or c["fn"],
                        **dict(c.get("kwargs", {})))
        elif kind == "concat":
            s.concat(c["name"], *c["inputs"])
        elif kind == "filter":
            s.filter(c["source"],
                     expr_from_param(expr_dict_to_param(c["where"])),
                     name=c.get("name"))
    for name, alg in spec.get("cohorts", {}).items():
        s.cohort(name, alg)
    if spec.get("flow"):
        s.flow(*spec["flow"])
    for o in spec.get("outputs", []):
        s.featurize(o["name"], cohort=o["cohort"],
                    kind=o.get("feature_kind", "dense"),
                    patients=o.get("patients"),
                    **dict(o.get("kwargs", {})))
    return s


# ---------------------------------------------------------------------------
# inverse: Study -> spec
# ---------------------------------------------------------------------------
def _extractor_to_dict(ex: Extractor) -> Dict[str, Any]:
    d: Dict[str, Any] = {
        "name": ex.name, "source": ex.source, "category": int(ex.category),
        "value_col": ex.value_col, "start_col": ex.start_col,
    }
    if ex.end_col is not None:
        d["end_col"] = ex.end_col
    if ex.group_col is not None:
        d["group_col"] = ex.group_col
    if ex.weight_col is not None:
        d["weight_col"] = ex.weight_col
    if ex.null_cols:
        d["null_cols"] = list(ex.null_cols)
    if ex.codes is not None:
        d["codes"] = [_py_scalar(v) for v in ex.codes]
    if ex.distinct:
        d["distinct"] = list(ex.distinct)
    if ex.where is not None:
        d["where"] = expr_to_dict(as_param(ex.where))
    return d


def spec_from_study(study: Study) -> Dict[str, Any]:
    """Serialize a builder-constructed ``Study`` as a wire spec.

    Reads the builder's declarative recipe log, so only studies built
    through the public ``Study`` methods serialize; ``source()``-bound
    tables (runtime data, not declarations) and unregistered ad-hoc star
    schemas raise ``ValueError``.  Sections are grouped in canonical order
    (schema, concepts, cohorts, flow, outputs) — round-tripping is exact
    (identical plans) whenever declarations are grouped that way, which
    every spec-compiled study is by construction."""
    spec: Dict[str, Any] = {"spec_version": SPEC_VERSION,
                            "n_patients": study.n_patients}
    if study._window != (0, 2_000_000_000):
        spec["window"] = list(study._window)
    schema: List[Dict[str, Any]] = []
    concepts: List[Dict[str, Any]] = []
    cohorts: Dict[str, str] = {}
    flow: Optional[List[str]] = None
    outputs: List[Dict[str, Any]] = []
    for step, kw in study._recipe:
        if step == "source":
            raise ValueError(
                f"study binds runtime table {kw['name']!r} via source(); "
                f"bound tables are data, not declarations — pass them to "
                f"run() instead to make the study spec-expressible")
        if step == "flatten":
            sch = kw["schema"]
            if STAR_SCHEMAS.get(sch.name) is not sch:
                raise ValueError(
                    f"star schema {sch.name!r} is not registered in "
                    f"spec.STAR_SCHEMAS; only registered schemas are "
                    f"wire-expressible")
            f: Dict[str, Any] = {"star": sch.name}
            for k, default in _FLATTEN_DEFAULTS.items():
                if kw[k] != default:
                    f[k] = kw[k]
            schema.append(f)
        elif step == "extract":
            c: Dict[str, Any] = {"kind": "extract", "name": kw["name"],
                                 "extractor": _extractor_to_dict(
                                     kw["extractor"])}
            if kw["compact"] is not True:
                c["compact"] = kw["compact"]
            concepts.append(c)
        elif step == "patients":
            c = {"kind": "patients"}
            if kw["source"] != "IR_BEN":
                c["source"] = kw["source"]
            if kw["name"] != "extract_patients":
                c["name"] = kw["name"]
            concepts.append(c)
        elif step == "transform":
            c = {"kind": "transform", "fn": kw["fn"],
                 "inputs": list(kw["inputs"])}
            if kw["name"] != kw["fn"]:
                c["name"] = kw["name"]
            if kw["kwargs"]:
                c["kwargs"] = {k: _py_list(v)
                               for k, v in kw["kwargs"].items()}
            concepts.append(c)
        elif step == "concat":
            concepts.append({"kind": "concat", "name": kw["name"],
                             "inputs": list(kw["inputs"])})
        elif step == "filter":
            concepts.append({"kind": "filter", "source": kw["source"],
                             "where": expr_to_dict(as_param(kw["where"])),
                             "name": kw["name"]})
        elif step == "cohort":
            cohorts[kw["name"]] = kw["expr"]
        elif step == "flow":
            flow = list(kw["names"])
        elif step == "featurize":
            o: Dict[str, Any] = {"kind": "featurize", "name": kw["name"],
                                 "cohort": kw["cohort"],
                                 "feature_kind": kw["kind"]}
            if kw["patients"] is not None:
                o["patients"] = kw["patients"]
            if kw["kwargs"]:
                o["kwargs"] = {k: _py_list(v)
                               for k, v in kw["kwargs"].items()}
            outputs.append(o)
    if schema:
        spec["schema"] = schema
    if concepts:
        spec["concepts"] = concepts
    if cohorts:
        spec["cohorts"] = cohorts
    if flow:
        spec["flow"] = flow
    if outputs:
        spec["outputs"] = outputs
    return spec


def _py_list(v: Any) -> Any:
    """JSON-friendly form for transform/featurize kwargs values."""
    if isinstance(v, (list, tuple, range)):
        return [_py_list(x) for x in v]
    return _py_scalar(v)


# ---------------------------------------------------------------------------
# wire error payloads
# ---------------------------------------------------------------------------
def error_payload(exc: BaseException) -> List[Dict[str, Any]]:
    """Render any admission/serving failure as structured wire errors.

    ``SpecValidationError`` -> one entry per ``SpecIssue`` (code + path);
    ``PlanValidationError`` -> one entry per error-severity ``Diagnostic``
    (``SPnnn`` code + plan node id); anything else -> a single ``SPEC-900``
    entry naming only the exception *type* — messages of unexpected
    exceptions (and tracebacks) never reach a tenant."""
    if isinstance(exc, SpecValidationError):
        return [i.as_dict() for i in exc.issues]
    from repro_torch.study.analyze import PlanValidationError
    if isinstance(exc, PlanValidationError):
        return [{"code": d.code, "node": d.node, "message": d.message,
                 "hint": d.hint} for d in exc.diagnostics
                if d.severity == "error"] or \
               [{"code": d.code, "node": d.node, "message": d.message,
                 "hint": d.hint} for d in exc.diagnostics]
    return [{"code": "SPEC-900",
             "message": f"internal error ({type(exc).__name__}) while "
                        f"serving the request",
             "hint": "the request was rejected; no partial state was kept"}]
