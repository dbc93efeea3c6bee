"""Port foundations against the reference: ``core.bitset``, every ported
``ColumnarTable`` op and the synthetic generators.

The same numpy-seeded inputs go through ``repro`` (JAX) and ``repro_torch``
(PyTorch, CPU); every comparison is exact — columns bit for bit (NaNs
included), packed validity words as uint32, counts and capacities.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bitset as rbs
from repro.core.columnar import ColumnarTable as RTable
from repro.data import synthetic as rsyn
from repro_torch.core import bitset as pbs
from repro_torch.core.columnar import NULL_INT, ColumnarTable
from repro_torch.data import synthetic as psyn
from repro_torch.interop import tables_from_numpy, tables_to_numpy

SIZES = (0, 1, 31, 32, 33, 1025)


def _bits(a: np.ndarray) -> np.ndarray:
    """Bit patterns of a column, so that NaNs compare equal."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _star_of(ref_tables) -> dict:
    return {name: {"columns": {k: np.asarray(v) for k, v in t.columns.items()},
                   "valid": np.asarray(t.valid), "count": int(t.count),
                   "capacity": t.capacity}
            for name, t in ref_tables.items()}


def _port(rt: RTable) -> ColumnarTable:
    return tables_from_numpy({"t": _star_of({"t": rt})["t"]}, device="cpu")["t"]


def assert_same_table(rt: RTable, pt: ColumnarTable) -> None:
    assert pt.capacity == rt.capacity
    assert int(pt.count) == int(rt.count)
    np.testing.assert_array_equal(pt.valid.numpy().view(np.uint32),
                                  np.asarray(rt.valid))
    assert sorted(pt.columns) == sorted(rt.columns)
    for k in rt.columns:
        np.testing.assert_array_equal(_bits(pt.columns[k].numpy()),
                                      _bits(np.asarray(rt.columns[k])),
                                      err_msg=k)


def _rand_cols(rng, n: int) -> dict:
    a = rng.integers(-5, 15, n).astype(np.int32)
    a[rng.random(n) < 0.25] = NULL_INT
    x = rng.normal(size=n).astype(np.float32)
    x[rng.random(n) < 0.2] = np.nan
    return {"id": np.arange(n, dtype=np.int32), "a": a,
            "b": rng.integers(-3, 4, n).astype(np.int32), "x": x}


def _pair(n: int, seed: int = 0):
    rng = np.random.default_rng(seed + n)
    cols = _rand_cols(rng, n)
    valid = rng.random(n) < 0.7
    rt = RTable.from_columns(cols, valid=jnp.asarray(valid))
    return rt, _port(rt), rng


# ---------------------------------------------------------------------------
# core.bitset
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", SIZES)
def test_pack_unpack_count(n):
    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.5
    rw = np.asarray(rbs.pack(jnp.asarray(mask)))
    pw = pbs.pack(torch.from_numpy(mask))
    assert pw.dtype == torch.int32
    np.testing.assert_array_equal(pw.numpy().view(np.uint32), rw)
    assert pbs.unpack(pw, n).numpy().tolist() == mask.tolist()
    assert pbs.unpack_np(pw.numpy(), n).tolist() == mask.tolist()
    assert int(pbs.count(pw)) == int(rbs.count(jnp.asarray(rw)))
    assert pbs.popcount(pw).numpy().tolist() == \
        [bin(int(w)).count("1") for w in rw]


@pytest.mark.parametrize("n", SIZES)
def test_first_n_and_bit_at(n):
    for cnt in sorted({0, n // 2, n}):
        np.testing.assert_array_equal(
            pbs.first_n(cnt, n).numpy().view(np.uint32),
            np.asarray(rbs.first_n(cnt, n)))
        np.testing.assert_array_equal(
            pbs.first_n(torch.tensor(cnt, dtype=torch.int32), n).numpy()
            .view(np.uint32), np.asarray(rbs.first_n(cnt, n)))
    if n:
        rng = np.random.default_rng(n)
        words = rng.integers(0, 2 ** 32, pbs.n_words(n), dtype=np.uint64) \
            .astype(np.uint32)
        idx = rng.integers(0, n, 50).astype(np.int32)
        got = pbs.bit_at(torch.from_numpy(words.view(np.int32)),
                         torch.from_numpy(idx))
        want = rbs.bit_at(jnp.asarray(words), jnp.asarray(idx))
        assert got.numpy().tolist() == np.asarray(want).tolist()


# ---------------------------------------------------------------------------
# ColumnarTable ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", SIZES)
def test_from_columns_forms(n):
    rng = np.random.default_rng(n)
    cols = _rand_cols(rng, n)
    mask = rng.random(n) < 0.6
    words = np.asarray(rbs.pack(jnp.asarray(mask)))
    if n:
        words = words | np.uint32(0xFFFFFFFF) << np.uint32(n % 32) \
            if n % 32 else words       # dirty tail bits must be cleared
    for valid_ref, valid_port in ((None, None),
                                  (jnp.asarray(mask), torch.from_numpy(mask)),
                                  (jnp.asarray(words), words)):
        rt = RTable.from_columns(cols, valid=valid_ref)
        pt = ColumnarTable.from_columns(cols, valid=valid_port, device="cpu")
        assert_same_table(rt, pt)


@pytest.mark.parametrize("n", SIZES)
def test_filter_and_drop_nulls(n):
    rt, pt, rng = _pair(n)
    mask = rng.random(n) < 0.5
    assert_same_table(rt.filter(jnp.asarray(mask)),
                      pt.filter(torch.from_numpy(mask)))
    packed = rbs.pack(jnp.asarray(mask))
    assert_same_table(rt.filter(packed),
                      pt.filter(pbs.pack(torch.from_numpy(mask))))
    assert_same_table(rt.drop_nulls(["a", "x"]), pt.drop_nulls(["a", "x"]))
    assert_same_table(rt.drop_nulls([]), pt.drop_nulls([]))


@pytest.mark.parametrize("n", SIZES)
def test_compact_slots_past_count_hold_clamped_rows(n):
    rt, pt, _ = _pair(n)
    assert_same_table(rt.compact(), pt.compact())


@pytest.mark.parametrize("n", SIZES)
def test_sort_by_stable_invalid_sink(n):
    rt, pt, _ = _pair(n)
    assert_same_table(rt.sort_by(["b"]), pt.sort_by(["b"]))
    assert_same_table(rt.sort_by(["b", "a", "x"]), pt.sort_by(["b", "a", "x"]))
    assert_same_table(rt.sort_by(["x"]), pt.sort_by(["x"]))


@pytest.mark.parametrize("n", SIZES)
def test_take_select_shrink_pad(n):
    rt, pt, rng = _pair(n)
    assert_same_table(rt.select(["a", "x"]), pt.select(["a", "x"]))
    if n:
        idx = rng.integers(0, n, 2 * n + 3).astype(np.int32)
        iv = rng.random(idx.size) < 0.8
        assert_same_table(rt.take(jnp.asarray(idx), jnp.asarray(iv)),
                          pt.take(torch.from_numpy(idx), torch.from_numpy(iv)))
        assert_same_table(rt.take(jnp.asarray(idx)),
                          pt.take(torch.from_numpy(idx)))
    c_r, c_p = rt.compact(), pt.compact()
    for cap in (0, n // 2, n, n + 7):
        assert_same_table(c_r.shrink_to(cap), c_p.shrink_to(cap))
    for cap in (n, n + 1, n + 40):
        assert_same_table(rt.pad_to(cap), pt.pad_to(cap))


@pytest.mark.parametrize("n", SIZES)
def test_concat_aligned_and_ragged(n):
    rt, pt, _ = _pair(n)
    rt2, pt2, _ = _pair(64, seed=5)
    assert_same_table(RTable.concat([rt2, rt]),
                      ColumnarTable.concat([pt2, pt]))      # word-aligned
    assert_same_table(RTable.concat([rt, rt2, rt]),
                      ColumnarTable.concat([pt, pt2, pt]))  # ragged
    ref_np, port_np = rt.to_numpy(), pt.to_numpy()
    for k in ref_np:
        np.testing.assert_array_equal(_bits(port_np[k]), _bits(ref_np[k]))


def test_empty_and_device_move():
    spec = {"a": np.int32, "x": np.float32}
    assert_same_table(RTable.empty(spec, 40),
                      ColumnarTable.empty(spec, 40, device="cpu"))
    rt, pt, _ = _pair(33)
    assert_same_table(rt, pt.to("cpu"))


# ---------------------------------------------------------------------------
# data: the same seed gives the same arrays
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gen", ["dcir", "pmsi", "ssr", "had", "ir_imb"])
def test_synthetic_arrays_identical(gen):
    cfg_r = rsyn.SyntheticConfig(n_patients=300, seed=3)
    cfg_p = psyn.SyntheticConfig(n_patients=300, seed=3)
    ref = getattr(rsyn, f"generate_{gen}")(cfg_r)
    port = getattr(psyn, f"{gen}_arrays")(cfg_p)
    assert sorted(ref) == sorted(port)
    for name, rt in ref.items():
        assert sorted(rt.columns) == sorted(port[name])
        for k, v in rt.columns.items():
            a = port[name][k]
            assert a.dtype == np.asarray(v).dtype, (name, k)
            np.testing.assert_array_equal(_bits(a), _bits(np.asarray(v)))
    tables = getattr(psyn, f"generate_{gen}")(cfg_p, device="cpu")
    for name, rt in ref.items():
        assert_same_table(rt, tables[name])


def test_interop_round_trip():
    ref = rsyn.generate_dcir(rsyn.SyntheticConfig(n_patients=50, seed=1))
    star = _star_of({k: t.filter(jnp.asarray(
        np.arange(t.capacity) % 3 != 0)) for k, t in ref.items()})
    port = tables_from_numpy(star, device="cpu")
    back = tables_to_numpy(port)
    for name, t in star.items():
        assert back[name]["count"] == t["count"]
        assert back[name]["capacity"] == t["capacity"]
        np.testing.assert_array_equal(back[name]["valid"], t["valid"])
        assert back[name]["valid"].dtype == np.uint32
        for k, v in t["columns"].items():
            np.testing.assert_array_equal(_bits(back[name]["columns"][k]),
                                          _bits(v))


# ---------------------------------------------------------------------------
# cohort subject bitsets: jax's scatter(mode="drop") after index
# normalization, which torch's indexing does not do by itself
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_patients", [1, 31, 33, 100])
def test_bitset_from_indices_drops_out_of_range(n_patients):
    from repro.core.cohort import Bitset as RBitset
    from repro_torch.core.cohort import Bitset

    rng = np.random.default_rng(n_patients)
    idx = rng.integers(-n_patients - 3, n_patients + 3, 200).astype(np.int32)
    idx[:3] = [NULL_INT, -1, n_patients]
    valid = rng.random(200) < 0.7
    want = np.asarray(RBitset.from_indices(jnp.asarray(idx),
                                           jnp.asarray(valid), n_patients))
    got = Bitset.from_indices(torch.from_numpy(idx), torch.from_numpy(valid),
                              n_patients)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    packed = pbs.pack(torch.from_numpy(valid))
    got_packed = Bitset.from_indices(torch.from_numpy(idx), packed, n_patients)
    np.testing.assert_array_equal(got_packed.numpy().view(np.uint32), want)
