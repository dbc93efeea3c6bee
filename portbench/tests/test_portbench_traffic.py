"""The traffic generator: the same seed gives the same queries; every seed
gets the same set of sizes."""
import collections
import itertools

import pytest

from portbench.lib import traffic

SEEDS = (0, 7, 2 ** 31 + 5, 2 ** 40 + 3)


@pytest.mark.parametrize("mix", ["batch", "cohort"])
def test_closed_stream_is_the_seeds(mix):
    m = traffic.load_mix(mix)
    a = list(itertools.islice(traffic.closed_queries(m, 2 ** 33 + 1), 40))
    b = list(itertools.islice(traffic.closed_queries(m, 2 ** 33 + 1), 40))
    c = list(itertools.islice(traffic.closed_queries(m, 2 ** 33 + 2), 40))
    assert a == b and a != c
    assert traffic.warmup_queries(m, 5) == traffic.warmup_queries(m, 5)
    assert traffic.warmup_queries(m, 5) != a[:len(traffic.warmup_queries(m, 5))]


@pytest.mark.parametrize("mix", ["batch", "cohort"])
def test_closed_sizes_are_the_same_set_for_every_seed(mix):
    m = traffic.load_mix(mix)
    lits = m["shapes"][0]["literals"]
    period = 1
    for lit in lits.values():
        period = period * len(lit.get("sizes", lit.get("choices"))) // \
            __import__("math").gcd(period, len(lit.get("sizes", lit.get("choices"))))
    sets = []
    for seed in SEEDS:
        qs = list(itertools.islice(traffic.closed_queries(m, seed), period))
        sets.append({k: collections.Counter(
            len(q[k]) if isinstance(q[k], list) else q[k] for q in qs)
            for k in lits})
    assert all(s == sets[0] for s in sets)


def test_subset_literals_are_distinct_codes_in_range():
    m = traffic.load_mix("batch")
    for q in itertools.islice(traffic.closed_queries(m, 11), 50):
        assert len(set(q["drug_codes"])) == len(q["drug_codes"])
        assert 0 <= min(q["drug_codes"]) and max(q["drug_codes"]) < 16289
        assert max(q["act_codes"]) < 7000
