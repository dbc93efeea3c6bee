"""B5 (the shuffle's plan) and B2b (compaction by a bool mask) — their
plain versions against the reference.

* ``hash_partition_plan``: the port's plain version, bit for bit, against
  ``repro.kernels.ref.hash_partition_plan_ref`` and the Pallas kernel in
  interpret mode (``repro.kernels.ops.hash_partition_plan``) over the chip
  battery's sweep at small ``n``: destinations 1-64, blocks 256/512/1024,
  ragged lengths, invalid rows and negative keys.
* ``core.flattening.hash_partition`` under both engines against the
  reference's: send buffers, validity and overflow (a roomy and an
  overflowing capacity).
* ``ops.filter_compact`` with bool masks against the reference's, slots
  past the count included — it used to read any mask as packed words and
  return a wrong answer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ColumnarTable as RTable
from repro.core import flattening as rfl
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.core import ColumnarTable, NULL_INT
from repro_torch.core import bitset as _bs
from repro_torch.core import flattening as pfl
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels import filter_compact as fc
from repro_torch.kernels import hash_partition as hp

DESTS = (1, 2, 4, 8, 15, 64)
BLOCKS = (256, 512, 1024)


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    keys[rng.random(n) < 0.05] = NULL_INT
    keys[: min(n, 8)] = [0, -1, 1, 2 ** 31 - 1, -2 ** 31, 7, 7, 7][: min(n, 8)]
    return keys, rng.random(n) < 0.8


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n_dest", DESTS)
def test_plan_plain_matches_reference_and_pallas(n_dest, block):
    n = 2 * block + 37                               # ragged last block
    keys, valid = _keys(n, n_dest * block)
    before = dict(launch_counts)
    dest, rank, hist = ops.hash_partition_plan(
        torch.from_numpy(keys),
        _bs.pack(torch.from_numpy(valid)).view(torch.uint32), n_dest,
        block=block)
    assert launch_counts == before             # CPU tensors launch nothing
    pad = (-n) % block
    kp = jnp.asarray(np.concatenate([keys, np.zeros(pad, np.int32)]))
    vp = jnp.asarray(np.concatenate([valid, np.zeros(pad, bool)]))
    rd, rr, rh = rref.hash_partition_plan_ref(kp, vp, n_dest, block)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(rd)[:n])
    np.testing.assert_array_equal(rank.numpy(), np.asarray(rr)[:n])
    np.testing.assert_array_equal(hist.numpy(), np.asarray(rh))
    pd, pr, ph = rops.hash_partition_plan(jnp.asarray(keys),
                                          jnp.asarray(valid), n_dest,
                                          block=block, interpret=True)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(pd))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(pr))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(ph))
    assert int(hist.sum()) == int(valid.sum())


def test_plan_takes_packed_words_and_refuses_a_mask():
    """Packed words go in under the ``torch.uint32`` tag; a row mask of any
    other dtype is the reference's form and gives the same plan; untagged
    int32 words are a row mask of the wrong length and are refused, as are
    wrong-length words in the plain version."""
    keys, valid = _keys(1000, 1)
    k = torch.from_numpy(keys)
    words = _bs.pack(torch.from_numpy(valid))
    a = ops.hash_partition_plan(k, words.view(torch.uint32), 4)
    b = ops.hash_partition_plan(k, ColumnarTable.from_columns(
        {"k": keys}, valid=valid, device="cpu").valid.view(torch.uint32), 4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for mask in (valid, valid.astype(np.int8) * 3, valid.astype(np.int32)):
        for x, y in zip(a, ops.hash_partition_plan(k, torch.from_numpy(mask),
                                                   4)):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="mask"):
        ops.hash_partition_plan(k, words, 4)
    with pytest.raises(ValueError, match="validity words"):
        hp.hash_partition_plan_plain(k, words[:-1], 4)
    d, r, h = ops.hash_partition_plan(torch.zeros(0, dtype=torch.int32),
                                      torch.zeros(0, dtype=torch.uint32), 3)
    assert d.shape == r.shape == (0,) and h.shape == (0, 3)


@pytest.mark.parametrize("n_dest, block", [(0, 512), (769, 512), (4, 100),
                                           (4, 2048)])
def test_plan_refuses_what_the_kernel_cannot_hold(n_dest, block):
    with pytest.raises(ValueError):
        ops.hash_partition_plan(torch.zeros(64, dtype=torch.int32),
                                torch.full((2,), -1, dtype=torch.int32)
                                .view(torch.uint32), n_dest, block=block)
    assert hp.max_dest(512) == 768 and hp.max_dest(1024) == 384


def _tables(n, seed):
    keys, valid = _keys(n, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=n).astype(np.float32)
    x[rng.random(n) < 0.1] = np.nan
    cols = {"k": keys, "x": x,
            "v": rng.integers(-9, 9, n).astype(np.int32)}
    return (RTable.from_columns({c: jnp.asarray(v) for c, v in cols.items()},
                                valid=jnp.asarray(valid)),
            ColumnarTable.from_columns(cols, valid=valid, device="cpu"))


@pytest.mark.parametrize("per", [700, 150], ids=["roomy", "overflowing"])
@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("n_shards", [4, 3])
def test_hash_partition_matches_reference(engine, per, n_shards):
    rt, pt = _tables(1500, n_shards)
    want_cols, want_valid, want_ovf = rfl.hash_partition(rt, "k", n_shards,
                                                         per)
    got_cols, got_valid, got_ovf = pfl.hash_partition(pt, "k", n_shards, per,
                                                      engine=engine)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert int(got_ovf) == int(want_ovf)
    assert (int(want_ovf) > 0) == (per == 150)
    for c, w in want_cols.items():
        g = got_cols[c].numpy()
        assert g.shape == (n_shards, per)
        np.testing.assert_array_equal(g.view(np.int32),
                                      np.asarray(w).view(np.int32),
                                      err_msg=c)


def test_hash_partition_refuses_an_unknown_engine():
    _, pt = _tables(64, 0)
    with pytest.raises(ValueError, match="unknown engine"):
        pfl.hash_partition(pt, "k", 2, 64, engine="pallas")


def _masks():
    rng = np.random.default_rng(5)
    return {
        "ten_rows": (np.arange(10, dtype=np.int32),
                     np.array([1, 0, 1, 1, 0, 0, 1, 0, 0, 1], bool)),
        "all_false": (np.arange(300, dtype=np.int32), np.zeros(300, bool)),
        "all_true": (np.arange(300, dtype=np.int32), np.ones(300, bool)),
        "ragged": (rng.integers(-99, 99, 1031).astype(np.int32),
                   rng.random(1031) < 0.4),
        "float_nan": (np.where(rng.random(517) < 0.2, np.nan,
                               rng.normal(size=517)).astype(np.float32),
                      rng.random(517) < 0.6),
        "int8_mask": (np.arange(77, dtype=np.int32),
                      (rng.random(77) < 0.5).astype(np.int8) * 3),
        "one_row": (np.array([42], np.int32), np.array([True])),
    }


@pytest.mark.parametrize("case", list(_masks()))
def test_filter_compact_bool_mask_matches_reference(case):
    vals, mask = _masks()[case]
    want, wcnt = rops.filter_compact(jnp.asarray(vals), jnp.asarray(mask),
                                     interpret=True)
    before = dict(launch_counts)
    got, cnt = ops.filter_compact(torch.from_numpy(vals),
                                  torch.from_numpy(mask))
    assert launch_counts == before
    assert int(cnt) == int(wcnt) == int(mask.astype(bool).sum())
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


def test_filter_compact_still_reads_int32_masks_as_words():
    """Packed words are read as words only under the ``torch.uint32`` tag
    (the reference's uint32 words); an int32 ``(n,)`` mask is a row mask, as
    in the reference, where reading it as words gave count 0 instead of 3.
    The plain version refuses words of the wrong length."""
    vals = torch.arange(40, dtype=torch.int32)
    mask = torch.zeros(40, dtype=torch.bool)
    mask[[3, 33, 39]] = True
    words = ColumnarTable.from_columns({"v": vals}, valid=mask,
                                       device="cpu").valid
    got, cnt = ops.filter_compact(vals, words.view(torch.uint32))
    assert int(cnt) == 3 and got[:4].tolist() == [3, 33, 39, 0]
    got, cnt = ops.filter_compact(vals, mask.to(torch.int32))
    assert int(cnt) == 3 and got[:4].tolist() == [3, 33, 39, 0]
    with pytest.raises(ValueError, match="mask"):
        ops.filter_compact(vals, mask[:39])
    with pytest.raises(ValueError, match="mask"):
        ops.filter_compact(vals, words)          # untagged: a short row mask
    with pytest.raises(ValueError, match="words"):
        fc.filter_compact_plain([vals], words[:1])


def _c10_case(kind, n, seed):
    rng = np.random.default_rng(seed)
    keep = rng.random(n) < 0.45
    if kind == "words":
        return keep, np.asarray(RTable.from_columns(
            {"v": jnp.zeros(n, jnp.int32)}, valid=jnp.asarray(keep)).valid)
    dtype = {"bool": bool, "int8": np.int8, "int32": np.int32}[kind]
    return keep, keep.astype(dtype) * (1 if kind == "bool" else -3)


def _port_mask(m):
    t = torch.from_numpy(np.ascontiguousarray(m))
    return t.view(torch.uint32) if m.dtype == np.uint32 else t


C10_KINDS = ["bool", "int8", "int32", "words"]


@pytest.mark.parametrize("kind", C10_KINDS)
def test_filter_compact_masks_match_reference(kind):
    """Row masks of every dtype, and tagged packed words, through both
    packages' ``ops.filter_compact``: the same values and count."""
    n = 1031
    keep, m = _c10_case(kind, n, 3)
    vals = np.random.default_rng(4).integers(-99, 99, n).astype(np.int32)
    want, wcnt = rops.filter_compact(jnp.asarray(vals), jnp.asarray(m),
                                     interpret=True)
    got, cnt = ops.filter_compact(torch.from_numpy(vals), _port_mask(m))
    assert int(cnt) == int(wcnt) == int(keep.sum())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", C10_KINDS)
def test_hash_partition_plan_masks_match_reference(kind):
    """Row masks of every dtype, and tagged packed words, through the
    port's ``ops.hash_partition_plan``, against the reference's plan of
    the same rows (which takes a row mask)."""
    n = 1100
    keep, m = _c10_case(kind, n, 5)
    keys, _ = _keys(n, 6)
    want = rops.hash_partition_plan(jnp.asarray(keys), jnp.asarray(
        m if kind != "words" else keep), 8, block=256, interpret=True)
    got = ops.hash_partition_plan(torch.from_numpy(keys), _port_mask(m), 8,
                                  block=256)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
