"""Plan normalization: canonical form for cross-tenant executable sharing.

The port of ``repro.study.normalize``.  The executor's runner cache keys on
``Plan.key()`` — the full node tuple — so two tenants asking the *same
question with different constants* ("dispenses of drug 17" vs "drug 23")
get two runners: the literals are baked into the node params.  ``normalize`` rewrites an optimized plan into a
canonical form where that no longer happens:

  * **literal hoisting** — every ``("lit", v)`` leaf and every ``("isin", x,
    values)`` whitelist inside predicate exprs is replaced by a slot
    reference (``("hlit", i)`` / ``("hisin", x, j, n, isfloat)``); the values
    move into a params vector (``NormalPlan.lits`` / ``.vecs``) passed to the
    runner as *arguments* (``expr.bound_params``; ``device_params`` puts them
    on the card).  Only
    shape-bearing constants stay structural: whitelist sizes, ``slice_time``
    bounds (they feed the capacity planner) and planned capacities.
  * **alpha-renaming** — tenant-chosen labels are stripped (node ``name``
    params dropped, output names rewritten ``o0, o1, ...`` in canonical
    order).  Column refs are *not* renamed: every tenant queries the same
    resident star schema, so column names are shared vocabulary, not
    tenant-local naming.
  * **stable node ordering** — nodes re-emit in a deterministic order
    (post-order DFS from the outputs, outputs visited by structural hash),
    so builder-order differences between equivalent studies disappear.
  * **conjunct canonicalization** — a ``fused_mask``'s legacy ``null_cols``/
    ``filters`` conjuncts are folded into its ``exprs`` list (in the exact
    order ``expr.fused_predicate`` evaluates them), so equal predicates
    serialize equally regardless of how they were built.

Hoisted predicates keep the ``cuda`` engine: B1 (``csrc/predicate.cu``)
takes hoisted literals as kernel *operands* (uniform 32-bit values, sorted
whitelist vectors staged in shared memory), so a normalized plan gets
cross-tenant sharing of one runner AND the fused kernel.  Demotion to
``"torch"`` is the exception — it happens only when the hoisted form is not
kernel-compilable (oversized ``isin`` whitelist, non-boolean root), and
``NormalPlan.demoted`` records exactly those nodes.

The module also provides the service's subgraph identity: ``cut_points``
picks the structurally cacheable nodes (scan/predicate/join prefixes) and
``subgraph_hashes`` content-hashes each node's subtree *with the literal
values resolved back in*, so a cache hit means "this exact computation over
this exact table version".
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.columnar import resolve_device
from repro_torch.study.plan import Node, Plan, PlanBuilder, PREDICATE_OPS

__all__ = ["NormalPlan", "normalize", "device_params", "params_signature",
           "cut_points", "subgraph_hashes", "CACHEABLE_OPS", "CUT_OPS"]


# ---------------------------------------------------------------------------
# expr-param rewriting helpers
# ---------------------------------------------------------------------------
_EXPR_KEYS = ("expr",)        # params holding ONE serialized Expr
_EXPRS_KEYS = ("exprs",)      # params holding a tuple of serialized Exprs


def _isfloat(values: Sequence) -> bool:
    return any(isinstance(c, float) for c in values)


def _scrub_expr(p: Tuple) -> Tuple:
    """Literal-free view of an expr param (for structural hashing): values
    are dropped, shape-bearing facts (whitelist size/kind) kept."""
    tag = p[0]
    if tag == "lit":
        return ("lit?",)
    if tag == "isin":
        return ("isin?", _scrub_expr(p[1]), len(p[2]), _isfloat(p[2]))
    if tag in ("cmp", "arith", "bool"):
        return (tag, p[1], _scrub_expr(p[2]), _scrub_expr(p[3]))
    if tag in ("not", "isnull", "notnull"):
        return (tag, _scrub_expr(p[1]))
    if tag == "hisin":
        return ("hisin", _scrub_expr(p[1]), p[2], p[3], p[4])
    return p  # col / hlit — already value-free


def _hoist_expr(p: Tuple, lits: List, vecs: List) -> Tuple:
    """Rewrite an expr param: literals -> slot refs, values appended to the
    growing ``lits``/``vecs`` vectors (depth-first, left-to-right — the slot
    order is part of the canonical form)."""
    tag = p[0]
    if tag == "lit":
        lits.append(p[1])
        return ("hlit", len(lits) - 1)
    if tag == "isin":
        inner = _hoist_expr(p[1], lits, vecs)
        vecs.append(tuple(p[2]))
        return ("hisin", inner, len(vecs) - 1, len(p[2]), _isfloat(p[2]))
    if tag in ("cmp", "arith", "bool"):
        return (tag, p[1], _hoist_expr(p[2], lits, vecs),
                _hoist_expr(p[3], lits, vecs))
    if tag in ("not", "isnull", "notnull"):
        return (tag, _hoist_expr(p[1], lits, vecs))
    return p  # col — nothing to hoist; hlit/hisin pass through untouched


def _has_hoisted(p: Tuple) -> bool:
    if not isinstance(p, tuple):
        return False
    if p and p[0] in ("hlit", "hisin"):
        return True
    return any(_has_hoisted(x) for x in p)


class _ParamView:
    """Minimal Node stand-in (``.op`` + ``.get``) so ``expr.node_predicate``
    can re-express a *candidate* hoisted node before it is emitted."""

    def __init__(self, op: str, params: Dict[str, Any]):
        self.op = op
        self._p = params

    def get(self, k: str, default=None):
        return self._p.get(k, default)


def _kernel_compilable(op: str, params: Dict[str, Any]) -> bool:
    """Post-hoisting engine feasibility: hoisted literals are B1 operands,
    so a hoisted predicate stays on the cuda engine whenever its combined
    Expr still compiles (boolean root, membership budget — hoisted
    whitelists count their structural ``n``)."""
    from repro_torch.kernels import predicate as _pk
    from repro_torch.study.expr import node_predicate

    e = node_predicate(_ParamView(op, params))
    return e is not None and _pk.compilable(e.to_param())


def _resolve_expr(p: Tuple, lits: Sequence, vecs: Sequence) -> Tuple:
    """Inverse of hoisting (for content hashing): slot refs -> concrete
    values."""
    tag = p[0]
    if tag == "hlit":
        return ("lit", lits[p[1]])
    if tag == "hisin":
        return ("isin", _resolve_expr(p[1], lits, vecs), tuple(vecs[p[2]]))
    if tag == "isin":
        return ("isin", _resolve_expr(p[1], lits, vecs), p[2])
    if tag in ("cmp", "arith", "bool"):
        return (tag, p[1], _resolve_expr(p[2], lits, vecs),
                _resolve_expr(p[3], lits, vecs))
    if tag in ("not", "isnull", "notnull"):
        return (tag, _resolve_expr(p[1], lits, vecs))
    return p


def _canonical_param_items(node: Node) -> List[Tuple[str, Any]]:
    """Node params with tenant labels removed and fused_mask conjuncts folded
    into ``exprs`` (mirroring ``expr.fused_predicate``'s evaluation order:
    null tests, whitelist filters, then exprs)."""
    items = [(k, v) for k, v in node.params if k != "name"]
    if node.op == "fused_mask":
        d = dict(items)
        exprs = []
        exprs += [("notnull", ("col", c)) for c in (d.get("null_cols") or ())]
        exprs += [("isin", ("col", c), tuple(codes))
                  for c, codes in (d.get("filters") or ())]
        exprs += list(d.get("exprs") or ())
        d["exprs"] = tuple(exprs)
        d["null_cols"] = ()
        d["filters"] = ()
        items = sorted(d.items())
    return items


# ---------------------------------------------------------------------------
# normal form
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NormalPlan:
    """A canonicalized plan plus the values normalization hoisted out of it.

    ``plan.key()`` is the sharing unit: every structurally-equal query maps
    to the same canonical plan, whatever its literals or labels.  ``lits``/
    ``vecs`` carry this query's concrete values in slot order; ``node_map``
    links original node ids to canonical ones (many-to-one — label stripping
    can hash-cons formerly distinct nodes together) and ``out_map`` links
    original output names to their ``oN`` aliases."""

    plan: Plan
    lits: Tuple
    vecs: Tuple[Tuple, ...]
    node_map: Tuple[Tuple[int, int], ...]
    out_map: Tuple[Tuple[str, str], ...]
    # canonical node ids whose predicate engine normalization demoted
    # cuda -> torch.  Hoisted literals ride the kernel as operands, so this
    # is the EXCEPTION: only hoisted predicates the kernel cannot take
    # (oversized whitelist / non-boolean root) appear here; the analyzer's
    # SP008 diagnostic predicts them.
    demoted: Tuple[int, ...] = ()

    def orig_to_canon(self) -> Dict[int, int]:
        return dict(self.node_map)


# the reference's names of the port's predicate engines: the structural
# hashes that order a canonical plan read them, so that the port's canonical
# plans (node order, output names, slot order) are the reference's
_REF_ENGINE = {"torch": "jnp", "cuda": "pallas"}


def _structural_hashes(plan: Plan) -> List[str]:
    hs: List[str] = []
    for node in plan.nodes:
        items = []
        for k, v in _canonical_param_items(node):
            if k in _EXPR_KEYS and v is not None:
                v = _scrub_expr(v)
            elif k in _EXPRS_KEYS and v is not None:
                v = tuple(_scrub_expr(e) for e in v)
            elif k == "engine":
                v = _REF_ENGINE.get(v, v)
            items.append((k, v))
        blob = repr((node.op, tuple(items), tuple(hs[j] for j in node.inputs)))
        hs.append(hashlib.sha1(blob.encode()).hexdigest())
    return hs


def normalize(plan: Plan) -> NormalPlan:
    """Canonicalize an (optimized) plan for executable sharing.

    Expects concrete literals (plans from ``Study.optimized_plan``); already-
    hoisted slot refs pass through untouched, so feeding a canonical plan
    back in is harmless but not a supported identity."""
    hs = _structural_hashes(plan)
    b = PlanBuilder()
    lits: List = []
    vecs: List[Tuple] = []
    new_id: Dict[int, int] = {}
    demoted: set = set()

    def emit(i: int) -> int:
        if i in new_id:
            return new_id[i]
        node = plan.nodes[i]
        ins = [emit(j) for j in node.inputs]
        params: Dict[str, Any] = {}
        for k, v in _canonical_param_items(node):
            if k in _EXPR_KEYS and v is not None:
                v = _hoist_expr(v, lits, vecs)
            elif k in _EXPRS_KEYS and v is not None:
                v = tuple(_hoist_expr(e, lits, vecs) for e in v)
            params[k] = v
        hoisted = (node.op in PREDICATE_OPS
                   and params.get("engine") == "cuda"
                   and any(_has_hoisted(v) for k, v in params.items()
                           if k in _EXPR_KEYS + _EXPRS_KEYS
                           and v is not None))
        demote = hoisted and not _kernel_compilable(node.op, params)
        if demote:
            # hoisted literals are kernel operands, so demotion is the
            # exception: only hoisted predicates the kernel still cannot
            # take (oversized whitelist, non-boolean root) go to the
            # value-generic torch engine
            params["engine"] = "torch"
            params.pop("bitset_block", None)
            params.pop("bitset_word", None)
        nid = b.add(node.op, ins, **params)
        if demote:
            demoted.add(nid)
        new_id[i] = nid
        return nid

    # visit outputs in structural order (orig name only tie-breaks between
    # scrub-identical subtrees, where either order yields the same structure)
    out_map: List[Tuple[str, str]] = []
    for k, (name, i) in enumerate(
            sorted(plan.outputs, key=lambda o: (hs[o[1]], o[0]))):
        canon_name = f"o{k}"
        b.set_output(canon_name, emit(i))
        out_map.append((name, canon_name))
    return NormalPlan(plan=b.build(), lits=tuple(lits), vecs=tuple(vecs),
                      node_map=tuple(sorted(new_id.items())),
                      out_map=tuple(sorted(out_map)),
                      demoted=tuple(sorted(demoted)))


# ---------------------------------------------------------------------------
# device binding
# ---------------------------------------------------------------------------
def _lit_dtype(v) -> torch.dtype:
    if isinstance(v, bool):
        return torch.bool
    if isinstance(v, float):
        return torch.float32
    return torch.int32


def device_params(nplan: NormalPlan, device=None) -> Tuple[Tuple, Tuple]:
    """The ``(lits, vecs)`` argument tuples for a normalized plan on
    ``device`` (None = CUDA), in canonical dtypes (0-d int32/float32/bool
    scalars, 1-D int32/float32 whitelists — what ``Lit``/``IsIn`` evaluation
    promotes to, so normalized results stay bit-identical)."""
    dev = resolve_device(device)
    lits = tuple(torch.tensor(v, dtype=_lit_dtype(v), device=dev)
                 for v in nplan.lits)
    vecs = tuple(
        torch.from_numpy(np.asarray(v, np.float32 if _isfloat(v)
                                    else np.int32)).to(dev)
        for v in nplan.vecs)
    return lits, vecs


def params_signature(lits: Sequence, vecs: Sequence) -> Tuple:
    """Shape/dtype fingerprint of bound params — part of the executor's
    runner key, so changing a literal *value* never builds a new runner but
    changing the params *spec* (different slot count/kind) does."""
    return (tuple(str(getattr(x, "dtype", type(x).__name__)) for x in lits),
            tuple((len(v), str(getattr(v, "dtype", ""))) for v in vecs))


# ---------------------------------------------------------------------------
# subgraph identity (the service's result cache)
# ---------------------------------------------------------------------------
# ops whose value is a pure function of resident tables + the node subtree —
# safe to serve from a cross-tenant cache.  transform/conform/compact/concat
# stay out: cheap, or carrying realization-facing params not worth hashing.
CACHEABLE_OPS = frozenset({
    "scan", "scan_star", "select", "predicate", "drop_nulls", "value_filter",
    "fused_mask", "lookup_join", "expand_join", "exchange", "slice_time",
    "key_count", "dedupe",
})
# boundary ops worth materializing a cache entry at (heavy compute whose
# output many tenants share: predicate bitsets, join results, dedupes)
CUT_OPS = frozenset({
    "predicate", "fused_mask", "lookup_join", "expand_join", "slice_time",
    "key_count", "dedupe",
})


def cut_points(plan: Plan) -> Tuple[int, ...]:
    """Node ids eligible for subgraph caching: every node whose transitive
    subtree is cacheable and whose own op is a cut boundary.  Purely
    structural — all queries sharing a canonical plan share cut points."""
    ok: List[bool] = []
    for node in plan.nodes:
        ok.append(node.op in CACHEABLE_OPS and all(ok[j] for j in node.inputs))
    return tuple(i for i, node in enumerate(plan.nodes)
                 if ok[i] and node.op in CUT_OPS)


def subgraph_hashes(nplan: NormalPlan, salt: Tuple = ()) -> Tuple[str, ...]:
    """Content hash of every node's subtree with literal values resolved
    back in — equal hash ⇒ identical computation over the same sources.
    ``salt`` carries run-scoped identity (table version, engines,
    n_patients, optimizer version).  The port's params name its own engines,
    so its hashes differ from the reference's while partitioning the nodes
    alike."""
    hs: List[str] = []
    for node in nplan.plan.nodes:
        items = []
        for k, v in node.params:
            if k in _EXPR_KEYS and v is not None:
                v = _resolve_expr(v, nplan.lits, nplan.vecs)
            elif k in _EXPRS_KEYS and v is not None:
                v = tuple(_resolve_expr(e, nplan.lits, nplan.vecs) for e in v)
            items.append((k, v))
        blob = repr((salt, node.op, tuple(items),
                     tuple(hs[j] for j in node.inputs)))
        hs.append(hashlib.sha256(blob.encode()).hexdigest())
    return tuple(hs)
