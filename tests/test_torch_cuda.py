"""The port's CUDA kernels on the card, each against its plain PyTorch
version, bit for bit.  Marked ``cuda``: skipped where no CUDA device is
present; run them on the GPU machine with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitset as bs
from repro_torch.core.columnar import NULL_INT
from repro_torch.core import ColumnarTable
from repro_torch.core import transformers as tr
from repro_torch.kernels import bitset_ops, filter_compact, launch_counts
from repro_torch.kernels import predicate as pk
from repro_torch.kernels import segment_scan as ss
from repro_torch.study import col

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cols(n, device):
    rng = np.random.default_rng(n)
    a = rng.integers(-5, 15, n).astype(np.int32)
    a[rng.random(n) < 0.25] = NULL_INT
    x = rng.normal(size=n).astype(np.float32)
    x[rng.random(n) < 0.2] = np.nan
    cols = {"a": torch.from_numpy(a), "x": torch.from_numpy(x),
            "b": torch.from_numpy(rng.integers(-5, 15, n).astype(np.int32))}
    valid = bs.pack(torch.from_numpy(rng.random(n) < 0.85))
    return ({k: v.to(device) for k, v in cols.items()}, valid.to(device))


@pytest.mark.parametrize("n", [1, 33, 100_003])
def test_predicate_kernel_matches_plain(device, n):
    cols, valid = _cols(n, device)
    e = (~((col("a") < 0) | col("x").is_null())
         & (col("a").isin([3, 4, 5]) | (col("b") // 0 == -2)))
    param = e.to_param()
    before = launch_counts["predicate_bitset"]
    words, cnt = pk.predicate_bitset(cols, valid, expr_param=param,
                                     capacity=n)
    assert launch_counts["predicate_bitset"] == before + 1
    prog = pk.compile_program(param, *pk._kinds(cols, param, None))
    pw, pc = pk.predicate_bitset_plain(prog, cols, valid, n)
    assert torch.equal(words, pw) and int(cnt) == int(pc)


@pytest.mark.parametrize("n", [1, 33, 100_003])
def test_filter_compact_kernel_matches_plain(device, n):
    cols, valid = _cols(n, device)
    cs = [cols["a"], cols["x"], cols["b"]]
    got, cnt = filter_compact.filter_compact_bits(cs, valid)
    want, wcnt = filter_compact.filter_compact_plain(cs, valid)
    assert int(cnt) == int(wcnt)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("op", ["and", "or", "andnot", "xor"])
def test_bitset_op_kernel_matches_plain(device, op):
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.integers(-2**31, 2**31, 10_001, dtype=np.int64)
                         .astype(np.int32)).to(device)
    b = torch.from_numpy(rng.integers(-2**31, 2**31, 10_001, dtype=np.int64)
                         .astype(np.int32)).to(device)
    got, cnt = bitset_ops.bitset_op_popcount(a, b, op)
    want, wcnt = bitset_ops.bitset_op_plain(a, b, op)
    assert torch.equal(got, want) and int(cnt) == int(wcnt)


@pytest.mark.parametrize("fill", ["default", "exact"])
def test_segmented_scan_kernel_matches_plain(device, fill):
    rng = np.random.default_rng(3)
    n = 100_003
    flags = bs.pack(torch.from_numpy(rng.random(n) < 0.01).to(device))
    vals = torch.from_numpy(rng.choice(
        np.array([2**31 - 1, -2**31, 2_100_000_000, -2_100_000_000, 0, 9]),
        n).astype(np.int32)).to(device)
    f = ss.DEFAULT_FILL if fill == "default" else ss.EXACT_FILL
    for block in (32, 512):
        got = ss.segmented_scan_kernel(flags, vals, block, f)
        want = ss.segmented_scan_plain(flags, vals, block, f)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_exposures_on_cuda_launch_the_segmented_scan(device):
    """``exposures`` on CUDA data under the cuda engine folds through B4 and
    equals the torch engine's segment reductions on the same card."""
    rng = np.random.default_rng(4)
    n = 50_000
    cols = {"patient_id": rng.integers(0, 2_000, n).astype(np.int32),
            "category": np.ones(n, np.int32), "group_id": np.zeros(n, np.int32),
            "value": rng.integers(0, 20, n).astype(np.int32),
            "weight": np.ones(n, np.float32),
            "start": rng.integers(14_600, 15_700, n).astype(np.int32),
            "end": np.zeros(n, np.int32)}
    t = ColumnarTable.from_columns(cols, valid=rng.random(n) < 0.9,
                                   device=device)
    before = launch_counts["segmented_scan"]
    got = tr.exposures(t, 2_000, purview_days=60, engine="cuda")
    assert launch_counts["segmented_scan"] == before + 1
    want = tr.exposures(t, 2_000, purview_days=60, engine="torch")
    assert torch.equal(got.valid, want.valid)
    for k in want.columns:
        assert torch.equal(got.columns[k].view(torch.int32),
                           want.columns[k].view(torch.int32)), k
