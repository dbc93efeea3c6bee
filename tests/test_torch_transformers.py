"""The ten registered transformers against the reference, every slot.

Inputs come from one numpy-seeded SNDS star, flattened and extracted by the
port (``test_torch_study.py`` holds those steps against the reference), and
cross over to both packages as the same numpy arrays.  Each transform's output table is
compared exactly — valid rows, packed validity words, counts and the slots
past ``count`` (``ColumnarTable.compact`` fills them with the last row's
values) — under both port engines: ``torch`` (segment reductions) and
``cuda`` (``exposures``' folds through the segmented-scan kernel's plain
version on CPU tensors).  Hand-built tables cover empty and full inputs,
dates beyond ±2e9 and NULL dates, whose int32 differences wrap inside the
reference's washout scan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.transformers as rtr
from repro.core import ColumnarTable as RTable
from repro_torch.core import DCIR_SCHEMA, PMSI_MCO_SCHEMA, ColumnarTable, \
    NULL_INT, diagnoses, drug_dispenses, flatten_star, medical_acts_dcir, \
    medical_acts_pmsi, patients
from repro_torch.core import transformers as ptr
from repro_torch.data import synthetic as psyn
from repro_torch.interop import tables_to_numpy
from repro_torch.kernels import launch_counts
from repro_torch.study import TRANSFORMS
from test_torch_study import assert_same_table

N_PATIENTS = 400
END = 14_600 + 3 * 365
ENGINES = ("torch", "cuda")


@pytest.fixture(scope="module")
def inputs():
    cfg = psyn.SyntheticConfig(n_patients=N_PATIENTS, seed=3)
    dcir, pmsi = psyn.generate_snds(cfg, device="cpu")
    fd, _ = flatten_star(DCIR_SCHEMA, dcir)
    fp, _ = flatten_star(PMSI_MCO_SCHEMA, pmsi)
    port = {"drugs": drug_dispenses()(fd), "acts": medical_acts_dcir()(fd),
            "hacts": medical_acts_pmsi()(fp), "diags": diagnoses()(fp),
            "patients": patients(dcir["IR_BEN"])}
    port["all_acts"] = ColumnarTable.concat([port["acts"], port["hacts"]])
    ref = {name: RTable({k: jnp.asarray(v) for k, v in t["columns"].items()},
                        jnp.asarray(t["valid"]), jnp.int32(t["count"]),
                        t["capacity"])
           for name, t in tables_to_numpy(port).items()}
    return ref, port


_MEMO = {}


def _reference(key, fn, args, kwargs):
    """The reference's output, jit-compiled once and kept for both engines."""
    if key not in _MEMO:
        _MEMO[key] = jax.jit(lambda *t: fn(*t, **kwargs))(*args)
    return _MEMO[key]


def _both(rows):
    """One numpy table as a (reference, port) pair."""
    cols = {k: np.asarray(v, np.float32 if k == "weight" else np.int32)
            for k, v in rows.items() if k != "valid"}
    valid = np.asarray(rows["valid"], bool)
    return (RTable.from_columns({k: jnp.asarray(v) for k, v in cols.items()},
                                valid=jnp.asarray(valid)),
            ColumnarTable.from_columns(cols, valid=valid, device="cpu"))


def _events(pid, value, start, valid, end=None):
    n = len(pid)
    return _both({"patient_id": pid, "category": np.full(n, 1),
                  "group_id": np.zeros(n), "value": value,
                  "weight": np.ones(n), "start": start,
                  "end": np.full(n, NULL_INT) if end is None else end,
                  "valid": valid})


def test_registry_matches_reference():
    from repro.study import TRANSFORMS as R_TRANSFORMS

    assert sorted(TRANSFORMS) == sorted(R_TRANSFORMS)
    for name, (_, wants) in R_TRANSFORMS.items():
        assert TRANSFORMS[name][1] == wants, name


CASES = {
    "observation_period": (("drugs",), {}),
    "follow_up": (("patients", "drugs"), {"study_end": END, "delay_days": 30}),
    "trackloss": (("drugs",), {"gap_days": 60}),
    "exposures": (("drugs",), {"purview_days": 60}),
    "exposures_min2": (("drugs",), {"purview_days": 30, "min_dispenses": 2}),
    "fractures": (("all_acts", "diags"),
                  {"fracture_act_codes": list(range(30)),
                   "fracture_diag_codes": list(range(40))}),
    "fractures_w0": (("all_acts", "diags"),
                     {"fracture_act_codes": list(range(30)),
                      "fracture_diag_codes": list(range(40)),
                      "n_sites": 3, "washout_days": 0}),
    "drug_prescriptions": (("drugs",), {"refill_days": 30}),
    "drug_interactions": (("drugs",), {"window_days": 30}),
    "bladder_cancer": (("acts", "diags"),
                       {"act_codes": (1, 2, 3), "diag_codes": (4, 5)}),
    "infarctus": (("diags",), {"diag_codes": (10, 11, 12)}),
    "heart_failure": (("diags",), {}),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_transform_matches_reference(inputs, case, engine):
    ref, port = inputs
    fn_name = case.split("_min2")[0].split("_w0")[0]
    args, kw = CASES[case]
    rfn, pfn = getattr(rtr, fn_name), getattr(ptr, fn_name)
    rkw, pkw = dict(kw), dict(kw)
    if TRANSFORMS[fn_name][1]:
        rkw["n_patients"] = pkw["n_patients"] = N_PATIENTS
    if fn_name in ("exposures", "drug_prescriptions"):
        pkw["engine"] = engine
    want = _reference(case, rfn, [ref[a] for a in args], rkw)
    before = dict(launch_counts)
    got = pfn(*[port[a] for a in args], **pkw)
    assert launch_counts == before       # CPU tensors never launch kernels
    assert int(want.count) > 0, case
    assert_same_table(want, got, case)


@pytest.mark.parametrize("engine", ENGINES)
def test_unlimited_exposures(inputs, engine):
    ref, port = inputs
    rfu = _reference("follow_up_no_delay", rtr.follow_up,
                     [ref["patients"], ref["drugs"]],
                     {"n_patients": N_PATIENTS, "study_end": END})
    pfu = ptr.follow_up(port["patients"], port["drugs"], N_PATIENTS, END)
    assert_same_table(rfu, pfu, "follow_up")
    want = _reference(
        "unlimited", lambda d, fu: rtr.exposures(
            d, N_PATIENTS, limited=False, follow_up_events=fu),
        [ref["drugs"], rfu], {})
    got = ptr.exposures(port["drugs"], N_PATIENTS, limited=False,
                        follow_up_events=pfu, engine=engine)
    assert_same_table(want, got, "unlimited")


EXPOSURE_TABLES = {
    # (patient, drug, start, valid)
    "no_valid_rows": ([0, 1, 2, 3], [1, 1, 2, 2], [10, 20, 30, 40],
                      [False] * 4),
    "all_valid": ([0, 0, 0, 1, 1], [5, 5, 5, 5, 6], [10, 50, 200, 10, 10],
                  [True] * 5),
    "extreme_dates": ([0, 0, 0, 0, 1, 1, 2, 2, 2],
                      [3, 3, 3, 3, 4, 4, 9, 9, 9],
                      [2_100_000_000, 2_100_000_010, 2**31 - 1, NULL_INT,
                       -2_100_000_000, -2_099_999_990, 5, 6, 7],
                      [True, True, True, True, True, True, True, False, True]),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", sorted(EXPOSURE_TABLES))
def test_exposures_edge_tables(case, engine):
    """Empty segments, no tail of invalid rows, and dates beyond the ±2e9
    masking of the reference's segment folds, where its tail segment takes
    the clamp."""
    pid, val, start, valid = (np.asarray(x) for x in EXPOSURE_TABLES[case])
    rt, pt = _events(pid, val, start, valid)
    for purview in (0, 60, 2**31 - 1):
        want = _reference((case, purview), rtr.exposures, [rt],
                          {"n_patients": 4, "purview_days": purview})
        got = ptr.exposures(pt, 4, purview_days=purview, engine=engine)
        assert_same_table(want, got, f"{case}/{purview}")


@pytest.mark.parametrize("washout", [-5, 0, 1, 90, 2**31 - 1])
def test_fractures_washout_wraps_like_the_reference(washout):
    """NULL and extreme dates make the reference's int32 date differences
    wrap; the frontier walk keeps exactly the rows its scan keeps."""
    rng = np.random.default_rng(washout % 97)
    n = 60
    pid = rng.integers(0, 3, n)
    val = rng.integers(0, 4, n)
    start = rng.choice(np.array([NULL_INT, -2_000_000_000, -5, 0, 3, 40, 100,
                                 95, 2_000_000_000, 2**31 - 1, 14_700],
                                np.int64), n)
    valid = rng.random(n) < 0.9
    ra, pa = _events(pid, val, start, valid)
    rd, pd = _events(pid[::-1].copy(), val, start[::-1].copy(), valid)
    kw = {"fracture_act_codes": [0, 1, 2], "fracture_diag_codes": [1, 3],
          "n_sites": 2, "washout_days": washout}
    want = jax.jit(lambda a, d: rtr.fractures(a, d, **kw))(ra, rd)
    got = ptr.fractures(pa, pd, **kw)
    assert_same_table(want, got, f"washout={washout}")
