"""The declarative front end of the port (``repro_torch.study.spec`` and
``Study._recipe``) against the reference's, exactly.

Pure host code, so everything here is compared for equality: the recipe
log, wire specs of the two example studies against
``tests/goldens/*_spec.json``, ``compile_spec`` of those goldens rebuilding
``tests/goldens/*_plan*.json`` (engine names through ``ENGINE_NAMES``),
round trips of fuzzed specs (raw plans node for node with the reference's),
every mutation's ``SpecIssue`` list (code, path, message, hint),
``error_payload`` for a spec error, an ``SPnnn`` rejection and a runtime
error, the expression wire form and the cohort parser's positions.
"""
import json
import os
import random

import pytest

from repro.study import Study as RStudy
from repro.study import compile_spec as r_compile_spec
from repro.study import spec_from_study as r_spec_from_study
from repro.study import validate_spec as r_validate_spec
from repro.study.analyze import PlanValidationError as RPlanValidationError
from repro.study.analyze import analyze as r_analyze
from repro.study.defects import golden_studies as r_golden_studies
from repro.study.expr import as_param as r_as_param
from repro.study.expr import col as r_col
from repro.study.fuzz import gen_valid_spec as r_gen_valid_spec
from repro.study.fuzz import mutate_spec as r_mutate_spec
from repro.study.spec import error_payload as r_error_payload
from repro.study.spec import expr_to_dict as r_expr_to_dict
from repro_torch.kernels import ENGINE_NAMES
from repro_torch.study import (PlanValidationError, SPEC_CODES,
                               SpecValidationError, Study, analyze, col,
                               compile_spec, error_payload, spec_from_study,
                               validate_spec)
from repro_torch.study.defects import golden_studies
from repro_torch.study.expr import CohortParseError, as_param, \
    parse_cohort_expr
from repro_torch.study.fuzz import MUTATIONS, gen_valid_spec, mutate_spec
from repro_torch.study.spec import (STAR_SCHEMAS, expr_dict_to_param,
                                    expr_to_dict)
from test_plan_goldens import plan_snapshot

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
NAMES = ["quickstart", "cohort_study"]


def _golden_spec(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}_spec.json")) as f:
        return json.load(f)


def _recipe_view(study, as_param_fn=as_param):
    """The recipe log with builder objects as comparable values: schemas by
    name, extractors as their wire dicts, Exprs as params."""
    from repro.study.spec import _extractor_to_dict as r_to_dict
    from repro_torch.study.spec import _extractor_to_dict

    to_dict = _extractor_to_dict if as_param_fn is as_param else r_to_dict
    out = []
    for step, kw in study._recipe:
        v = {}
        for k, x in kw.items():
            if k == "schema":
                x = x.name
            elif k == "extractor":
                x = to_dict(x)
            elif k == "where":
                x = as_param_fn(x)
            v[k] = x
        out.append((step, v))
    return out


def _plan_view(plan):
    return ([(n.op, n.inputs, n.params) for n in plan.nodes],
            tuple(plan.outputs))


# ---------------------------------------------------------------------------
# the recipe log and the golden spec files
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_recipe_matches_reference(name):
    got = _recipe_view(golden_studies()[name])
    assert got == _recipe_view(r_golden_studies()[name], r_as_param)
    assert [s for s, _ in got][:1] in (["flatten"], ["patients"])


def test_recipe_records_filter_and_source():
    t = {"x": None}
    s = (Study(n_patients=4).source("T", t)
         .patients("T", name="p")
         .filter("p", col("gender") == 1, name="women"))
    r = (RStudy(n_patients=4).source("T", t)
         .patients("T", name="p")
         .filter("p", r_col("gender") == 1, name="women"))
    assert _recipe_view(s) == _recipe_view(r, r_as_param)
    with pytest.raises(ValueError, match="data, not declarations"):
        spec_from_study(s)


@pytest.mark.parametrize("name", NAMES)
def test_golden_spec_files(name):
    spec = spec_from_study(golden_studies()[name])
    golden = _golden_spec(name)
    assert json.loads(json.dumps(spec)) == golden
    assert spec == r_spec_from_study(r_golden_studies()[name])
    assert validate_spec(golden) == []


@pytest.mark.parametrize("name", NAMES)
def test_compile_spec_rebuilds_golden_plans(name):
    """``compile_spec`` of a golden spec rebuilds the golden optimized plans
    (kernel engine; and the torch engine's golden for the quickstart), and
    the inverse is a fixpoint."""
    study = compile_spec(_golden_spec(name))
    goldens = [(f"{name}_plan.json", "cuda")]
    if name == "quickstart":
        goldens.append(("quickstart_plan_jnp.json", "torch"))
    for fname, peng in goldens:
        with open(os.path.join(GOLDEN_DIR, fname)) as f:
            want = json.load(f)
        for node in want["nodes"]:
            if "engine" in node["params"]:
                node["params"]["engine"] = ENGINE_NAMES[
                    node["params"]["engine"]]
        got = plan_snapshot(study.optimized_plan(predicate_engine=peng,
                                                 device="cpu"))
        assert json.loads(json.dumps(got, sort_keys=True)) == want, fname
        assert (study.optimized_plan(predicate_engine=peng,
                                     device="cpu").key()
                == golden_studies()[name].optimized_plan(
                    predicate_engine=peng, device="cpu").key())
    assert spec_from_study(study) == _golden_spec(name)


@pytest.mark.parametrize("seed", range(6))
def test_round_trip_fuzzed_specs_match_reference_plans(seed):
    """A fuzzed spec compiles to the reference's raw plan node for node, and
    spec -> Study -> spec is a fixpoint."""
    spec = gen_valid_spec(random.Random(seed))
    assert validate_spec(spec) == []
    study = compile_spec(spec)
    assert _plan_view(study.plan()) == _plan_view(r_compile_spec(spec).plan())
    spec2 = spec_from_study(study)
    assert spec2 == r_spec_from_study(r_compile_spec(spec))
    assert compile_spec(spec2).plan().key() == study.plan().key()
    assert spec_from_study(compile_spec(spec2)) == spec2


def test_star_schemas_are_the_reference_names():
    from repro.study.spec import STAR_SCHEMAS as R_STAR

    assert sorted(STAR_SCHEMAS) == sorted(R_STAR)
    from repro.study.spec import SPEC_CODES as R_CODES

    assert dict(SPEC_CODES) == dict(R_CODES)


# ---------------------------------------------------------------------------
# the rejection matrix, issue for issue
# ---------------------------------------------------------------------------
def _issues(issues):
    return [i.as_dict() for i in issues]


@pytest.mark.parametrize("idx", range(len(MUTATIONS)))
def test_mutation_issues_match_reference(idx):
    code, mutated = mutate_spec(gen_valid_spec(random.Random(idx)), idx,
                                random.Random(idx))
    r_code, r_mutated = r_mutate_spec(r_gen_valid_spec(random.Random(idx)),
                                      idx, random.Random(idx))
    assert (code, mutated) == (r_code, r_mutated)
    got = validate_spec(mutated)
    assert _issues(got) == _issues(r_validate_spec(mutated))
    assert any(i.code == code for i in got)
    with pytest.raises(SpecValidationError) as ei:
        compile_spec(mutated)
    errs = error_payload(ei.value)
    assert errs == r_error_payload(_ref_spec_error(mutated))
    json.dumps(errs)


def _ref_spec_error(spec):
    from repro.study.spec import SpecValidationError as RSpecValidationError

    with pytest.raises(RSpecValidationError) as ei:
        r_compile_spec(spec)
    return ei.value


@pytest.mark.parametrize("spec", [
    "not an object",
    {"spec_version": 1, "n_patients": 4,
     "concepts": [{"kind": "filter", "source": ["a"],
                   "where": {"op": "cmp", "cmp": "<",
                             "lhs": {"op": "col", "name": "start"},
                             "rhs": {"op": "lit", "value": 1}}}]},
    {"spec_version": 1, "n_patients": 8,
     "concepts": [
         {"kind": "patients", "name": "p"},
         {"kind": "transform", "fn": "exposures", "inputs": ["p"],
          "kwargs": {"name": "boom", "fn": "x"}}],
     "cohorts": {"base": "p"},
     "outputs": [{"kind": "featurize", "name": "f", "cohort": "base",
                  "kwargs": {"cohort": "base", "kind": "tokens"}}]},
    {"spec_version": 1, "n_patients": 8, "window": [1],
     "schema": [{"star": "DCIR", "time_slices": 2, "keep": 3}],
     "concepts": [{"kind": "extract", "extractor": {
         "name": "e", "source": "DCIR", "category": -1, "value_col": 3,
         "start_col": "s", "codes": ["x"], "null_cols": [1],
         "where": {"op": "isin", "x": {"op": "col", "name": "a"},
                   "values": [1, "b"]}}}],
     "cohorts": {"c": "e & & e", "d": 5}, "flow": [],
     "outputs": [{"kind": "featurize", "name": "X", "cohort": "zz",
                  "feature_kind": "sparse"}]},
], ids=["root", "unhashable-source", "reserved-kwargs", "many"])
def test_validation_findings_match_reference(spec):
    assert _issues(validate_spec(spec)) == _issues(r_validate_spec(spec))


def test_cohort_parse_error_position():
    with pytest.raises(CohortParseError) as ei:
        parse_cohort_expr("base & ( other")
    assert ei.value.offset == len("base & ( other")
    assert "^" in str(ei.value)
    spec = gen_valid_spec(random.Random(3))
    spec["cohorts"]["bad"] = "base & & base"
    (issue,) = [i for i in validate_spec(spec) if i.code == "SPEC-012"]
    assert issue.path == "cohorts.bad"
    assert "offset 7" in issue.message and "^" in issue.message
    assert _issues(validate_spec(spec)) == _issues(r_validate_spec(spec))


# ---------------------------------------------------------------------------
# error payloads and the expression wire form
# ---------------------------------------------------------------------------
def _contradiction(S, schema, acts, c):
    return (S(n_patients=50).flatten(schema)
            .extract(acts(), name="acts")
            .filter("acts", (c("value") < 3) & (c("value") > 5), name="x")
            .cohort("got", "x"))


def test_error_payload_matches_reference():
    # a spec error
    spec = {"spec_version": 2, "n_patients": 0, "frob": 1}
    with pytest.raises(SpecValidationError) as ei:
        compile_spec(spec)
    assert error_payload(ei.value) == r_error_payload(_ref_spec_error(spec))
    # an SPnnn analyzer rejection (provably-empty filter)
    from repro.core import DCIR_SCHEMA as R_DCIR
    from repro.core import medical_acts_dcir as r_acts
    from repro_torch.core import DCIR_SCHEMA, medical_acts_dcir

    plan = _contradiction(Study, DCIR_SCHEMA, medical_acts_dcir,
                          col).optimized_plan(predicate_engine="torch",
                                              device="cpu")
    r_plan = _contradiction(RStudy, R_DCIR, r_acts, r_col).optimized_plan(
        predicate_engine="jnp")
    got = error_payload(PlanValidationError(analyze(plan)))
    want = r_error_payload(RPlanValidationError(r_analyze(r_plan)))
    assert [e["code"] for e in got] == ["SP003"]
    assert got == want
    # a runtime error: the type only, never the message
    errs = error_payload(RuntimeError("secret /etc/shadow state"))
    assert errs == r_error_payload(RuntimeError("secret /etc/shadow state"))
    assert "secret" not in json.dumps(errs)


def test_expr_wire_round_trip_matches_reference():
    exprs = [
        ((col("a") + 1 < col("b") * 2) & ~col("c").isin([1, 2, 3]),
         (r_col("a") + 1 < r_col("b") * 2) & ~r_col("c").isin([1, 2, 3])),
        (col("x").is_null() | (col("y") != 0.5),
         r_col("x").is_null() | (r_col("y") != 0.5)),
        ((col("d") // 7 % 2 >= 1) & col("e").not_null(),
         (r_col("d") // 7 % 2 >= 1) & r_col("e").not_null()),
    ]
    for e, r in exprs:
        p = as_param(e)
        assert p == r_as_param(r)
        d = json.loads(json.dumps(expr_to_dict(p)))
        assert d == r_expr_to_dict(r_as_param(r))
        assert expr_dict_to_param(d) == p
