"""Seeded-defect plan fixtures: one deliberately-broken plan per analyzer
diagnostic code.

The port of ``repro.study.defects``.  Each builder returns ``(plan,
analyze_kwargs)`` — some defects only manifest against a bound table
environment (unknown sources, dtype mismatches, misaligned capacities), so
the kwargs carry the tables/shard context the analyzer needs.  Fixture
tables are made on ``device`` (None = CUDA; the tests pass ``"cpu"``).

Also hosts ``golden_studies()`` — the example-pipeline mirrors that the
plan goldens pin (``tests/goldens``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import torch

from repro_torch.core.columnar import ColumnarTable
from repro_torch.kernels.predicate import MAX_ISIN_VALUES
from repro_torch.study import optimizer as _opt
from repro_torch.study.expr import _NULL_SENTINEL_INT, col, lit
from repro_torch.study.plan import Plan, PlanBuilder

__all__ = ["DEFECTS", "build_defect", "all_defects", "golden_studies"]


def _table(device, n: int = 64, dtype=torch.int32,
           cols=("x",)) -> ColumnarTable:
    return ColumnarTable.from_columns(
        {c: torch.arange(n, dtype=dtype) for c in cols}, device=device)


def _scan(b: PlanBuilder, cols=("x",)) -> int:
    return b.scan_star("EV", star="synthetic", columns=tuple(cols))


def _out(b: PlanBuilder, nid: int, name: str = "out") -> Plan:
    b.set_output(name, b.compact(nid))
    return b.build()


def _sp001(device) -> Tuple[Plan, Dict[str, Any]]:
    b = PlanBuilder()
    t = b.scan("MISSING_SOURCE")
    return _out(b, t), {"tables": {"EV": _table(device)}}


def _sp002(device) -> Tuple[Plan, Dict[str, Any]]:
    b = PlanBuilder()
    t = _scan(b, cols=("a", "b"))
    t = b.select(t, ("a",))                      # drops b ...
    t = b.predicate(t, col("b") > 0)             # ... then reads it
    return _out(b, t), {}


def _sp003(device) -> Tuple[Plan, Dict[str, Any]]:
    b = PlanBuilder()
    t = _scan(b)
    t = b.predicate(t, (col("x") < 3) & (col("x") > 5))
    return _out(b, t), {}


def _sp004(device) -> Tuple[Plan, Dict[str, Any]]:
    b = PlanBuilder()
    t = _scan(b)
    t = b.predicate(t, (col("x") >= 0) & (lit(2) < 3))
    return _out(b, t), {}


def _sp005(device) -> Tuple[Plan, Dict[str, Any]]:
    b = PlanBuilder()
    t = _scan(b)
    t = b.predicate(t, col("x").isin([_NULL_SENTINEL_INT, 5]))
    return _out(b, t), {}


def _sp006(device) -> Tuple[Plan, Dict[str, Any]]:
    b = PlanBuilder()
    left = b.scan("L")
    right = b.scan("R")
    t = b.lookup_join(left, right, left_key="pid", right_key="pid",
                      prefix="r_")
    tables = {"L": _table(device, cols=("pid", "v")),
              "R": _table(device, dtype=torch.float32, cols=("pid", "w"))}
    return _out(b, t), {"tables": tables}


def _sp007(device) -> Tuple[Plan, Dict[str, Any]]:
    b = PlanBuilder()
    left = _scan(b, cols=("pid", "v"))
    right = b.scan_star("DIM", columns=("pid", "w"))
    t = b.expand_join(left, right, left_key="pid", right_key="pid",
                      capacity=100, prefix="d_")     # 100 % 64 != 0
    return _out(b, t), {"n_shards": 2}


def _sp008(device) -> Tuple[Plan, Dict[str, Any]]:
    # an isin whitelist past the kernel's membership budget, force-stamped
    # cuda (the optimizer would refuse the stamp): the one shape that still
    # demotes to torch when served, hoisted literals being kernel operands
    from repro_torch.study.expr import as_param

    b = PlanBuilder()
    t = _scan(b)
    t = b.add("predicate", (t,),
              expr=as_param(col("x").isin(range(MAX_ISIN_VALUES + 1))),
              engine="cuda", bitset_block=1024, bitset_word="uint32")
    return _out(b, t), {}


def _sp009(device) -> Tuple[Plan, Dict[str, Any]]:
    b = PlanBuilder()
    t = _scan(b)
    t = b.predicate(t, col("x") > 5)
    plan = _out(b, t)
    # stamp the cuda engine the way the optimizer does; the inline literal
    # 5 is what normalize() hoists into a slot that rides as a kernel
    # operand (the node keeps cuda when served)
    return _opt.assign_engines(plan, predicate_engine="cuda"), {}


def _sp010(device) -> Tuple[Plan, Dict[str, Any]]:
    b = PlanBuilder()
    a = b.scan("A")
    c = b.scan("B")
    t = b.concat((a, c))
    tables = {"A": _table(device, n=50),
              "B": _table(device, n=50)}         # 50 % 32 != 0
    return _out(b, t), {"tables": tables}


def _sp011(device) -> Tuple[Plan, Dict[str, Any]]:
    b = PlanBuilder()
    left = _scan(b, cols=("pid", "v"))
    right = b.scan_star("DIM", columns=("pid", "w"))
    t = b.expand_join(left, right, left_key="pid", right_key="pid",
                      capacity=None, prefix="d_")
    return _out(b, t), {}


def _sp012(device) -> Tuple[Plan, Dict[str, Any]]:
    b = PlanBuilder()
    a = _scan(b)
    c = _scan(b, cols=("y",))
    t = b.cohort_op("&", a, c, name="bad")           # tables are not cohorts
    b.set_output("bad", t)
    return b.build(), {}


def _sp013(device) -> Tuple[Plan, Dict[str, Any]]:
    b = PlanBuilder()
    t = _scan(b)
    t = b.add("frobnicate", (t,))
    return _out(b, t), {}


def _sp014(device) -> Tuple[Plan, Dict[str, Any]]:
    plan, kwargs = _sp003(device)                    # contradictory mask ...
    return plan, kwargs                              # ... named output rides it


def _sp015(device) -> Tuple[Plan, Dict[str, Any]]:
    # a fine plan over a manifest whose chunk capacity splits validity words
    b = PlanBuilder()
    t = _scan(b)
    return _out(b, t), {"chunk_capacity": 100}       # 100 % 32 != 0


DEFECTS: Mapping[str, Callable[[Any], Tuple[Plan, Dict[str, Any]]]] = {
    "SP001": _sp001, "SP002": _sp002, "SP003": _sp003, "SP004": _sp004,
    "SP005": _sp005, "SP006": _sp006, "SP007": _sp007, "SP008": _sp008,
    "SP009": _sp009, "SP010": _sp010, "SP011": _sp011, "SP012": _sp012,
    "SP013": _sp013, "SP014": _sp014, "SP015": _sp015,
}


def build_defect(code: str, device=None) -> Tuple[Plan, Dict[str, Any]]:
    """The seeded-defect plan (and analyzer kwargs, tables on ``device``)
    for one diagnostic code."""
    return DEFECTS[code](device)


def all_defects(device=None):
    """Yield ``(code, plan, analyze_kwargs)`` for every seeded defect."""
    for code, mk in DEFECTS.items():
        plan, kwargs = mk(device)
        yield code, plan, kwargs


# ---------------------------------------------------------------------------
# golden example studies (mirrors of examples/quickstart.py and
# examples/cohort_study.py, same shapes the plan goldens pin)
# ---------------------------------------------------------------------------
def golden_studies() -> Dict[str, Any]:
    from repro_torch.core import DCIR_SCHEMA, diagnoses, drug_dispenses, \
        hospital_stays, medical_acts_dcir, medical_acts_pmsi
    from repro_torch.study.api import Study

    quickstart = (Study(n_patients=1_000)
                  .flatten(DCIR_SCHEMA)
                  .extract(drug_dispenses(), name="drug_purchases")
                  .extract(medical_acts_dcir(codes=list(range(30))),
                           name="acts")
                  .patients("IR_BEN")
                  .cohort("base", "extract_patients")
                  .cohort("drugged", "drug_purchases")
                  .cohort("final", "drugged & base - acts")
                  .flow("base", "drugged", "final"))

    study_end = 14_600 + 3 * 365
    cohort_study = (Study(n_patients=2_000, window=(14_600, study_end))
                    .patients("IR_BEN")
                    .extract(drug_dispenses(), name="drug_purchases")
                    .extract(drug_dispenses()
                             .filtered(col("cip13").isin(range(65))
                                       & col("execution_date")
                                       .between(14_600, study_end)),
                             name="prevalent_drugs")
                    .extract(medical_acts_dcir(), name="acts")
                    .extract(medical_acts_pmsi(), name="hospital_acts")
                    .extract(diagnoses(), name="diagnoses")
                    .extract(hospital_stays(), name="stays")
                    .transform("exposures", "drug_purchases",
                               name="exposures", purview_days=60)
                    .concat("all_acts", "acts", "hospital_acts")
                    .transform("fractures", "all_acts", "diagnoses",
                               name="fractures",
                               fracture_act_codes=list(range(30)),
                               fracture_diag_codes=list(range(40)))
                    .transform("follow_up", "extract_patients",
                               "drug_purchases", name="follow_up",
                               study_end=study_end)
                    .cohort("base", "extract_patients")
                    .cohort("exposed", "exposures")
                    .cohort("fractured", "fractures")
                    .cohort("final", "(exposed & base) - fractured")
                    .flow("base", "exposed", "final")
                    .featurize("X", cohort="final", kind="dense",
                               n_buckets=36, bucket_days=31, n_features=128)
                    .featurize("tokens", cohort="final", kind="tokens",
                               seq_len=256))
    return {"quickstart": quickstart, "cohort_study": cohort_study}
