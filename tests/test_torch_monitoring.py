"""``ColumnarTable.monitoring_stats`` against the reference's: the row
count, the uint32 modular key sum and the key xor over the valid rows, on
both validity forms (a bool row mask and packed words), exactly.

The same numpy-seeded columns (NULL_INT keys and negative values included,
whose 32-bit patterns wrap) and masks go through ``repro`` (JAX) and
``repro_torch`` (PyTorch, CPU)."""
import numpy as np
import pytest

import jax.numpy as jnp

from repro.core.bitset import pack
from repro.core.columnar import ColumnarTable as RTable
from repro_torch.core.columnar import NULL_INT, ColumnarTable

SIZES = (0, 1, 31, 33, 100, 1025)


def _inputs(n: int, seed: int):
    rng = np.random.RandomState(seed)
    vals = rng.randint(-2 ** 31, 2 ** 31 - 1, size=n, dtype=np.int64)
    vals = vals.astype(np.int32)
    vals[rng.rand(n) < 0.2] = int(NULL_INT)
    return vals, rng.rand(n) < 0.6


def _ref(vals, mask, packed: bool):
    valid = pack(jnp.asarray(mask)) if packed else np.asarray(mask, bool)
    return RTable.from_columns({"a": vals, "b": vals * 3}, valid=valid)


def _port(vals, mask, packed: bool):
    valid = np.asarray(_ref(vals, mask, True).valid).view(np.uint32) \
        if packed else mask
    return ColumnarTable.from_columns({"a": vals, "b": vals * 3},
                                      valid=valid, device="cpu")


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
@pytest.mark.parametrize("n", SIZES)
def test_monitoring_stats_match_the_reference(n, packed):
    vals, mask = _inputs(n, seed=n)
    want = _ref(vals, mask, packed).monitoring_stats("a")
    got = _port(vals, mask, packed).monitoring_stats("a")
    assert set(got) == set(want) == {"rows", "key_sum", "key_xor"}
    for k in want:
        assert int(got[k]) == int(np.asarray(want[k]).astype(np.int64)), k
    assert int(got["rows"]) == int(mask.sum())


def test_checksums_are_order_independent():
    vals, mask = _inputs(257, seed=3)
    perm = np.random.RandomState(4).permutation(257)
    a = _port(vals, mask, False).monitoring_stats("b")
    b = _port(vals[perm], mask[perm], False).monitoring_stats("b")
    for k in a:
        assert int(a[k]) == int(b[k]), k
