"""Spans and byte counts that the benchmark puts around the program's entry
points in a traced run (``--trace 1``); nothing is installed otherwise.

Each wrapper opens a ``torch.profiler.record_function`` range:

- ``pb.study``: ``Study.run``;
- ``pb.plan_body``: ``executor.run_plan_body`` (the plan's nodes);
- ``pb.node.<op>``: each ``executor._eval_node`` call, by the node's op;
  ``pb.node.cohort_group`` for the cuda engine's grouped cohort algebra;
- ``pb.node.featurize_dense`` / ``pb.node.featurize_tokens``: the
  ``FeatureDriver`` exports;
- ``pb.launch.<entry>``: each call into the port's kernel library (its
  kernels have no host launch in the trace; ``trace.py`` places them by
  these calls).

Beside the ranges, each node call leaves a record of the bytes its
operation needs at its boundary: each input byte it must read once and each
output byte it must write once, whatever reads them again.  Counts of rows
stay 0-d tensors until the window has closed, so that recording adds no
wait on the card.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

from torch.profiler import record_function

JOIN_OPS = ("lookup_join", "expand_join", "key_count")
PREDICATE_OPS = ("predicate", "fused_mask", "drop_nulls", "value_filter")


def _itemsizes(cols) -> int:
    return sum(c.element_size() for c in cols)


def _words(t) -> int:
    return int(t.valid.numel() * t.valid.element_size())


class Recorder:
    """What the wrappers saw: one record a node call, in call order."""

    def __init__(self):
        self.nodes: List[Dict] = []

    def node(self, op: str, fixed: int, per_row: int = 0, rows=None):
        """``fixed`` bytes, plus ``per_row`` bytes for each of ``rows``
        (a 0-d tensor read after the window)."""
        self.nodes.append({"op": op, "fixed": fixed, "per_row": per_row,
                           "rows": rows})

    def node_bytes(self) -> List[Dict]:
        out = []
        for r in self.nodes:
            rows = 0 if r["rows"] is None else int(r["rows"])
            out.append({"op": r["op"],
                        "bytes": r["fixed"] + r["per_row"] * rows})
        return out


def _node_bytes(rec: Recorder, node, ins, out) -> None:
    """The bytes a node's operation needs at its boundary."""
    op = node.op
    if op in JOIN_OPS:
        left, right = ins
        lk = left.columns[node.get("left_key")]
        fixed = lk.numel() * lk.element_size() + _words(left) + \
            sum(c.numel() * c.element_size() for c in right.columns.values()) \
            + _words(right)
        if op == "key_count":
            rec.node(op, fixed)
            return
        table = out[0]
        added = [c for k, c in table.columns.items() if k not in left.columns]
        rec.node(op, fixed, _itemsizes(added), table.count)
    elif op in PREDICATE_OPS:
        from repro_torch.study import expr as _expr

        t = ins[0]
        e = _expr.node_predicate(node)
        if e is None:
            return
        read = [t.columns[c] for c in e.required_columns() if c in t.columns]
        rec.node(op, t.capacity * _itemsizes(read) + 2 * _words(t))
    elif op == "compact":
        t = ins[0]
        per = _itemsizes(t.columns.values())
        rec.node(op, _words(t), 2 * per, t.count)


class _Library:
    """The loaded kernel library, each entry point called inside a
    ``pb.launch.<entry>`` range."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not name.startswith("repro_"):
            return fn

        def call(*a):
            with record_function(f"pb.launch.{name}"):
                return fn(*a)
        return call


@contextlib.contextmanager
def installed(rec: Recorder):
    """Wrap the program's entry points for the duration of the block."""
    from repro_torch.core import feature_driver
    from repro_torch.kernels import build
    from repro_torch.study import api, executor

    saved = []

    def patch(owner, name, make):
        orig = getattr(owner, name)
        saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def eval_node(orig):
        def wrapper(node, ins, *a, **kw):
            with record_function(f"pb.node.{node.op}"):
                out = orig(node, ins, *a, **kw)
            _node_bytes(rec, node, ins, out)
            return out
        return wrapper

    def ranged(label):
        def make(orig):
            def wrapper(*a, **kw):
                with record_function(label):
                    return orig(*a, **kw)
            return wrapper
        return make

    def featurize(kind):
        def make(orig):
            def wrapper(self, *a, **kw):
                with record_function(f"pb.node.featurize_{kind}"):
                    out = orig(self, *a, **kw)
                ev = self.cohort.events
                cols = ("patient_id", "start", "end", "value",
                        "weight" if kind == "dense" else "category")
                per = _itemsizes([ev.columns[c] for c in cols])
                written = sum(x.numel() * x.element_size() for x in (
                    out if isinstance(out, tuple) else (out,)))
                rec.node(f"featurize_{kind}", written + _words(ev), per,
                         ev.count)
                return out
            return wrapper
        return make

    patch(executor, "_eval_node", eval_node)
    patch(executor, "_eval_group", ranged("pb.node.cohort_group"))
    patch(executor, "run_plan_body", ranged("pb.plan_body"))
    patch(api.Study, "run", ranged("pb.study"))
    patch(feature_driver.FeatureDriver, "dense_features", featurize("dense"))
    patch(feature_driver.FeatureDriver, "token_sequences",
          featurize("tokens"))
    lib = build._STATE["lib"]
    if lib is not None:
        build._STATE["lib"] = _Library(lib)
    try:
        yield rec
    finally:
        build._STATE["lib"] = lib
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)
