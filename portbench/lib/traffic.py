"""The one traffic generator: a mix is a data file, read here.

A mix file (``portbench/traffic/<mix>.json``) names the query shapes with
their weights and how each shape's literals are drawn; one client sends
its next query when the last one has finished (a closed loop).  A cell's
file (``portbench/workloads/<cell>.json``) may override any key of the mix
under ``params``.

Every seed gets the same work in another order: literal sizes cycle through
a seeded permutation of the mix's size list, and shapes through seeded
turns of their weights.  Only which codes are drawn, and the order, depend
on the seed.

Literal kinds:

- ``subset``: ``size`` distinct codes of ``range(universe)``, sorted;
- ``run``: ``size`` consecutive codes starting at a drawn offset;
- ``int``: one whole number from ``choices`` (cycled like sizes).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np

from portbench.lib.data import seed64

ROOT = Path(__file__).resolve().parent.parent


def load_mix(name: str, params: Dict = None) -> Dict:
    mix = json.loads((ROOT / "traffic" / f"{name}.json").read_text())
    mix.update(params or {})
    return mix


class _Cycle:
    """Values of a list in seeded permutations, one after another."""

    def __init__(self, values, rng: np.random.Generator):
        self.values, self.rng, self.order = list(values), rng, []

    def next(self):
        if not self.order:
            self.order = list(self.rng.permutation(len(self.values)))
        return self.values[self.order.pop()]


class Draws:
    """The literals of one shape, drawn in turn."""

    def __init__(self, spec: Dict, rng: np.random.Generator):
        self.spec, self.rng = spec, rng
        self.cycles = {k: _Cycle(v.get("sizes", v.get("choices")), rng)
                       for k, v in spec.get("literals", {}).items()}

    def query(self) -> Dict:
        q = {"shape": self.spec["shape"]}
        for k, lit in self.spec.get("literals", {}).items():
            v = self.cycles[k].next()
            if lit["kind"] == "subset":
                codes = self.rng.choice(int(lit["universe"]), size=int(v),
                                        replace=False)
                q[k] = sorted(int(c) for c in codes)
            elif lit["kind"] == "run":
                lo = int(self.rng.integers(0, int(lit["universe"]) - int(v) + 1))
                q[k] = list(range(lo, lo + int(v)))
            elif lit["kind"] == "int":
                q[k] = int(v)
            else:
                raise ValueError(f"unknown literal kind {lit['kind']!r}")
        return q


def closed_queries(mix: Dict, seed: int) -> Iterator[Dict]:
    """The closed loop's endless query stream: shapes in seeded turns of
    their weights, literals from their draws."""
    rng = np.random.default_rng([seed64(seed), 6, 664])
    draws = [Draws(s, rng) for s in mix["shapes"]]
    turn = [i for i, s in enumerate(mix["shapes"])
            for _ in range(int(s.get("weight", 1)))]
    cycle = _Cycle(turn, rng)
    while True:
        yield draws[cycle.next()].query()


def warmup_queries(mix: Dict, seed: int) -> List[Dict]:
    """``warmup_per_shape`` queries of each shape, literals of their own.
    Set to the longest size list, it meets every size once, so that the
    allocator has grown to what the window's queries need."""
    rng = np.random.default_rng([seed64(seed), 7, 7])
    out = []
    for s in mix["shapes"]:
        d = Draws(s, rng)
        out += [d.query() for _ in range(int(mix.get("warmup_per_shape", 1)))]
    return out
