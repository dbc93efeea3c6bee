"""The paper's cohort study (``examples/cohort_study.py``, tasks (a)-(g))
through both packages.

One numpy-seeded SNDS star, flattened by the port, crosses over to both
packages as the same numpy arrays; the whole study plan — patients, six
extractors, exposures, fractures, follow-up, cohort algebra, flow and both
featurizes — runs in the reference (jit) and in the port on the CPU, under
both engine pairs.  Compared exactly: the optimized plan node for node,
events (every slot), cohort words, flow, the OperationLog (without ``ts``),
the design matrix (its weights are integer dispense counts, so every cell's
float32 sum is exact in any order), tokens and mask, ``feature_checks`` and
the integer statistics with the reports built from them.  The statistics
that sum float32 values (``FLOAT_SUM_STATS``) may add in another order and
agree to ``RTOL``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as R
from repro.study import Study as RStudy
from repro.study import col as rcol
import repro_torch.core as T
from repro_torch.data import synthetic as psyn
from repro_torch.interop import tables_to_numpy
from repro_torch.kernels import launch_counts
from repro_torch.study import Study, col
from test_torch_study import ENGINE_PAIRS, _map_engines, assert_same_plan, \
    assert_same_table, assert_cuda_cohort_groups

N_PATIENTS = 500
END = 14_600 + 3 * 365
FLOAT_SUM_STATS = ("age_mean", "age_at_first_event", "weight_total")
RTOL = 1e-6          # float32 sums of a few hundred terms in another order
STAT_COHORTS = ("exposed", "fractured", "final")


def cohort_study(S, C, c):
    """The plan of ``examples/cohort_study.py``, over package ``C``."""
    return (S(n_patients=N_PATIENTS, window=(14_600, END))
            .patients("IR_BEN")
            .extract(C.drug_dispenses(), name="drug_purchases")
            .extract(C.drug_dispenses()
                     .filtered(c("cip13").isin(range(65))
                               & c("execution_date").between(14_600, END)),
                     name="prevalent_drugs")
            .extract(C.medical_acts_dcir(), name="acts")
            .extract(C.medical_acts_pmsi(), name="hospital_acts")
            .extract(C.diagnoses(), name="diagnoses")
            .extract(C.hospital_stays(), name="stays")
            .transform("exposures", "drug_purchases", name="exposures",
                       purview_days=60)
            .concat("all_acts", "acts", "hospital_acts")
            .transform("fractures", "all_acts", "diagnoses", name="fractures",
                       fracture_act_codes=list(range(30)),
                       fracture_diag_codes=list(range(40)))
            .transform("follow_up", "extract_patients", "drug_purchases",
                       name="follow_up", study_end=END)
            .cohort("base", "extract_patients")
            .cohort("exposed", "exposures")
            .cohort("fractured", "fractures")
            .cohort("final", "(exposed & base) - fractured")
            .flow("base", "exposed", "final")
            .featurize("X", cohort="final", kind="dense",
                       n_buckets=36, bucket_days=31, n_features=128)
            .featurize("tokens", cohort="final", kind="tokens", seq_len=256))


@pytest.fixture(scope="module")
def star():
    dcir, pmsi = psyn.generate_snds(
        psyn.SyntheticConfig(n_patients=N_PATIENTS, seed=42), device="cpu")
    port = {"DCIR": T.flatten_star(T.DCIR_SCHEMA, dcir)[0],
            "PMSI_MCO": T.flatten_star(T.PMSI_MCO_SCHEMA, pmsi)[0],
            "IR_BEN": dcir["IR_BEN"]}
    ref = {name: R.ColumnarTable(
        {k: jnp.asarray(v) for k, v in t["columns"].items()},
        jnp.asarray(t["valid"]), jnp.int32(t["count"]), t["capacity"])
        for name, t in tables_to_numpy(port).items()}
    return ref, port


@pytest.fixture(scope="module", params=ENGINE_PAIRS,
                ids=["torch-xla", "cuda-pallas"])
def runs(request, star):
    eng, peng, r_eng, r_peng = request.param
    ref, port = star
    want = cohort_study(RStudy, R, rcol).run(dict(ref), engine=r_eng,
                                             predicate_engine=r_peng)
    before = dict(launch_counts)
    got = cohort_study(Study, T, col).run(dict(port), engine=eng,
                                          predicate_engine=peng, device="cpu")
    assert launch_counts == before       # CPU tensors never launch kernels
    return want, got, request.param


def test_cuda_engine_runs_each_cohort_expression_as_one_group(
        runs, star, monkeypatch):
    """``(exposed & base) - fractured`` is one group of two ops; every
    cohort node's words and count match the torch engine and the
    reference."""
    want, got, _ = runs
    from repro_torch.study.executor import cohort_groups

    assert [len(ms) for ms in cohort_groups(got.plan).values()] == [2]
    assert_cuda_cohort_groups(want, got.plan, star[1], N_PATIENTS,
                              monkeypatch)


def test_optimized_plan_matches_reference(runs):
    want, got, (eng, peng, r_eng, r_peng) = runs
    assert_same_plan(want.plan, got.plan)
    assert_same_plan(
        cohort_study(RStudy, R, rcol).optimized_plan(engine=r_eng,
                                                     predicate_engine=r_peng),
        cohort_study(Study, T, col).optimized_plan(engine=eng,
                                                   predicate_engine=peng))
    assert got.plan.count_ops()["transform"] == 3


def test_events_match_reference(runs):
    want, got, _ = runs
    assert sorted(want.events) == sorted(got.events)
    for name in want.events:
        assert_same_table(want.events[name], got.events[name], name)
    assert int(got.events["exposures"].count) > 0
    assert int(got.events["fractures"].count) > 0


def test_cohorts_and_flow_match_reference(runs):
    want, got, _ = runs
    assert sorted(want.cohorts) == sorted(got.cohorts)
    for name, c in want.cohorts.items():
        np.testing.assert_array_equal(
            got.cohorts[name].subjects.numpy().view(np.uint32),
            np.asarray(c.subjects), err_msg=name)
        assert got.cohorts[name].description == c.description
        assert got.cohorts[name].window == c.window
    assert got.flow.flowchart() == want.flow.flowchart()
    assert got.cohorts["final"].subject_count() > 0


def test_operation_log_matches_reference(runs):
    want, got, _ = runs
    strip = [{k: (_map_engines(v) if k == "params" else v)
              for k, v in e.items() if k != "ts"} for e in want.log.entries]
    assert [{k: v for k, v in e.items() if k != "ts"}
            for e in got.log.entries] == strip
    ops = [e["op"] for e in got.log.entries]
    assert ops[-2:] == ["featurize:X", "featurize:tokens"]


def test_design_matrix_matches_reference(runs):
    want, got, _ = runs
    X = got.features["X"]
    assert tuple(X.shape) == (N_PATIENTS, 36, 128)
    # the weights are whole dispense counts: every cell is an exact sum
    w = got.events["exposures"].columns["weight"].numpy()
    assert (w == np.round(w)).all()
    np.testing.assert_array_equal(X.numpy(), np.asarray(want.features["X"]))
    assert float(X.sum()) > 0


def test_tokens_match_reference(runs):
    want, got, _ = runs
    (toks, mask), (rtoks, rmask) = got.features["tokens"], \
        want.features["tokens"]
    assert tuple(toks.shape) == (N_PATIENTS, 256)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(rtoks))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))


def test_feature_checks_match_reference(runs):
    want, got, _ = runs
    assert got.feature_checks == want.feature_checks
    assert got.feature_checks["X"]["events_total"] > 0


def _assert_stats_close(a, b, what):
    assert a.keys() == b.keys(), what
    for name in a:
        if name in FLOAT_SUM_STATS:
            assert a[name].keys() == b[name].keys(), (what, name)
            for k in a[name]:
                np.testing.assert_allclose(b[name][k], a[name][k], rtol=RTOL,
                                           err_msg=f"{what}.{name}.{k}")
        else:
            assert b[name] == a[name], (what, name)


def test_stats_match_reference(runs):
    want, got, _ = runs
    rp, pp = want.events["extract_patients"], got.events["extract_patients"]
    for name in STAT_COHORTS:
        _assert_stats_close(R.stats.compute(want.cohorts[name], rp),
                            T.stats.compute(got.cohorts[name], pp), name)
    for rs, ps in zip(want.flow.steps, got.flow.steps):
        assert T.stats.distribution_by_gender_age_bucket(ps, pp) == \
            R.stats.distribution_by_gender_age_bucket(rs, rp)


def test_reports_match_reference(runs):
    """Reports built only from exact statistics agree character for
    character."""
    want, got, _ = runs
    rp, pp = want.events["extract_patients"], got.events["extract_patients"]
    names = [n for n in T.stats.STATISTICS if n not in FLOAT_SUM_STATS]
    assert sorted(T.stats.STATISTICS) == sorted(R.stats.STATISTICS)
    for name in STAT_COHORTS:
        assert T.stats.report(got.cohorts[name], pp, names=names) == \
            R.stats.report(want.cohorts[name], rp, names=names)


def test_study_surface_errors():
    s = Study(n_patients=N_PATIENTS).extract(T.drug_dispenses(), name="d")
    with pytest.raises(ValueError, match="unknown transform"):
        s.transform("no_such_transform", "d")
    with pytest.raises(ValueError, match="dense|tokens"):
        s.featurize("X", cohort="d", kind="sparse")
    with pytest.raises(ValueError, match="unknown study output"):
        s.transform("exposures", "missing")
