"""The port's differential spec fuzzer (``repro_torch.study.fuzz``) against
the reference's.

The generator and the mutation catalog are copies: one seed must give the
reference's spec dict.  ``results_equal`` holds the port's results (torch
engine, CPU) against the reference's under jnp and under its Pallas
predicate kernel in interpret mode, raw columns and validity words
included.  On the CPU the oracle runs the torch and chunked arms, says so,
and gates SP003 plans at the chunked preflight; ``run_corpus`` agrees with
the reference's structural corpus.
"""
import random

import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticConfig, generate_dcir
from repro.study import compile_spec as r_compile_spec
from repro.study.fuzz import MUTATIONS as R_MUTATIONS
from repro.study.fuzz import gen_valid_spec as r_gen_valid_spec
from repro.study.fuzz import run_corpus as r_run_corpus
from repro_torch.data import partition_star
from repro_torch.interop import tables_from_numpy
from repro_torch.study import compile_spec
from repro_torch.study.fuzz import (MUTATIONS, differential_arms,
                                    gen_valid_spec, results_equal,
                                    run_corpus, run_spec_differential)

N_PAT = 200


@pytest.fixture(scope="module")
def stars(tmp_path_factory):
    ref = generate_dcir(SyntheticConfig(n_patients=N_PAT, seed=0))
    star = {name: {"columns": {k: np.asarray(v)
                               for k, v in t.columns.items()},
                   "valid": np.asarray(t.valid), "count": int(t.count),
                   "capacity": t.capacity} for name, t in ref.items()}
    port = tables_from_numpy(star, device="cpu")
    n_flows = int(port["ER_PRS"].count)
    cap = max(32, ((n_flows // 3) // 32 + 1) * 32)
    store = partition_star(port, str(tmp_path_factory.mktemp("fuzz")
                                     / "store"), source="ER_PRS",
                           chunk_capacity=cap)
    return ref, port, store


@pytest.mark.parametrize("seed", range(20))
def test_gen_valid_spec_matches_reference(seed):
    assert gen_valid_spec(random.Random(seed)) == \
        r_gen_valid_spec(random.Random(seed))
    assert gen_valid_spec(random.Random(seed), n_patients=200_000) == \
        r_gen_valid_spec(random.Random(seed), n_patients=200_000)


def test_mutation_catalog_matches_reference():
    assert [c for c, _ in MUTATIONS] == [c for c, _ in R_MUTATIONS]


@pytest.mark.parametrize("seed", [1, 5, 7, 15])
def test_results_equal_holds_port_against_reference(stars, seed):
    """One spec through both packages: the port's torch engine equals the
    reference under jnp and under its Pallas kernel (interpret mode), raw
    columns and validity words included."""
    ref, port, _ = stars
    spec = gen_valid_spec(random.Random(seed))
    got = compile_spec(spec).run(dict(port), predicate_engine="torch",
                                 device="cpu")
    for peng in ("jnp", "pallas"):
        want = r_compile_spec(spec).run(dict(ref), predicate_engine=peng)
        assert results_equal(got, want, layout=True) is None, peng
    assert results_equal(got, got, layout=False) is None


def test_results_equal_reports_a_difference(stars):
    _, port, _ = stars
    spec = gen_valid_spec(random.Random(0))
    a = compile_spec(spec).run(dict(port), device="cpu")
    b = compile_spec(spec).run(dict(port), device="cpu")
    name = sorted(a.events)[0]
    t = b.events[name]
    col = sorted(t.columns)[0]
    t.columns[col] = t.columns[col].clone()
    t.columns[col][-1] += 1               # a slot past the count
    assert results_equal(a, b, layout=False) is None
    assert results_equal(a, b, layout=True) == f"events.{name}.{col}: " \
                                               f"values differ"
    cohort = sorted(b.cohorts)[0]
    b.cohorts[cohort].subjects = torch.zeros_like(
        b.cohorts[cohort].subjects)
    assert results_equal(a, b, layout=False).startswith(f"cohort {cohort}")


@pytest.mark.parametrize("seed", [0, 5, 2, 57])
def test_differential_on_the_cpu_runs_torch_and_chunked(stars, seed):
    """The CPU oracle's arms are torch and chunked (the cuda arm needs the
    card); an SP003 plan (seeds 2 and 57) is refused by the chunked
    preflight instead of run."""
    _, port, store = stars
    spec = gen_valid_spec(random.Random(seed))
    delta, st = run_spec_differential(spec, dict(port), store, N_PAT,
                                      device="cpu")
    assert delta is None
    assert st.arms == ("torch", "chunked") == differential_arms("cpu")
    assert st.chunk_gated == (seed in (2, 57))
    assert bool(st.sp003) == st.chunk_gated


def test_run_corpus_on_the_cpu_matches_reference_structure():
    """A 12-spec corpus: 6 valid specs executed on the CPU's two arms, 6
    mutations each rejected with its code — the same rejections, by code,
    as the reference's corpus of the same seed."""
    report = run_corpus(n=12, seed=0, n_patients=N_PAT, device="cpu")
    assert report.ok, report.summary()
    assert report.arms == ("torch", "chunked")
    assert "the cuda arm needs a CUDA device" in report.summary()
    assert report.to_json()["arms"] == ["torch", "chunked"]
    want = r_run_corpus(n=12, seed=0, n_patients=N_PAT, execute=False)
    assert (report.n_valid, report.n_mutated, report.rejected_by_code) == \
        (want.n_valid, want.n_mutated, want.rejected_by_code)
    structural = run_corpus(n=12, seed=0, n_patients=N_PAT, execute=False)
    assert structural.ok and structural.arms == ()
