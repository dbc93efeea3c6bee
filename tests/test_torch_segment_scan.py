"""B4, the segmented scan: the port's plain version against the reference's
Pallas kernel in interpret mode (``repro.kernels.ops.segmented_scan``), bit
for bit, at the sizes of ``tests/test_kernels.py`` and with values beyond
the kernel's ±2e9 block-edge fills, where its output depends on ``block``
(ROADMAP C8).  On CPU tensors the wrapper runs the plain version and
launches nothing; the kernel itself is held against it on the card
(``test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.core import bitset as bs
from repro_torch.kernels import launch_counts, ops, ref
from repro_torch.kernels import segment_scan as ss

# values around and beyond the reference kernel's ±2e9 fills
EXTREMES = np.array([2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1, 2_000_000_000,
                     -2_000_000_000, 2_100_000_000, -2_100_000_000, 0, 7],
                    np.int64)


def _compare(flags: np.ndarray, vals: np.ndarray, block: int) -> None:
    want = rops.segmented_scan(jnp.asarray(flags), jnp.asarray(vals),
                               block=block, interpret=True)
    before = dict(launch_counts)
    got = ops.segmented_scan(torch.from_numpy(flags), torch.from_numpy(vals),
                             block=block)
    assert launch_counts == before
    for w, g, what in zip(want, got, ("min", "max", "count")):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)


@pytest.mark.parametrize("n,block", [(512, 512), (2048, 512), (700, 128),
                                     (128, 128), (96, 32)])
def test_plain_matches_pallas_sweep(n, block):
    rng = np.random.default_rng(n + block)
    flags = rng.random(n) < 0.08
    flags[0] = True
    _compare(flags, rng.integers(0, 10 ** 6, n).astype(np.int32), block)


@pytest.mark.parametrize("kind", ["all", "first", "none", "sparse"])
def test_plain_matches_pallas_flag_patterns(kind):
    n, block = 700, 64
    rng = np.random.default_rng(5)
    flags = {"all": np.ones(n, bool), "first": np.arange(n) == 0,
             "none": np.zeros(n, bool),
             "sparse": rng.random(n) < 0.004}[kind]
    _compare(flags, rng.integers(-50, 50, n).astype(np.int32), block)


@pytest.mark.parametrize("block", [32, 128])
def test_block_edge_clamp_with_extreme_values(block):
    """Runs crossing a block edge are clamped with the ±2e9 fills, which
    the sequential oracle ``segmented_scan_ref`` does only before the first
    flag: the port follows the kernel, not the oracle."""
    n = 300
    rng = np.random.default_rng(block)
    flags = rng.random(n) < 0.02
    flags[0] = True
    vals = rng.choice(EXTREMES, n).astype(np.int32)
    # two runs across a block edge, all above and all below the fills
    flags[:2 * block + 16] = False
    flags[[0, block + 8]] = True
    vals[:block + 8] = 2_100_000_000
    vals[block + 8:2 * block + 16] = -2_100_000_000
    _compare(flags, vals, block)
    oracle = rref.segmented_scan_ref(jnp.asarray(flags), jnp.asarray(vals))
    got = ops.segmented_scan(torch.from_numpy(flags), torch.from_numpy(vals),
                             block=block)
    assert not all((g.numpy() == np.asarray(o)).all()
                   for g, o in zip(got, oracle))


def test_exact_fill_gives_run_aggregates():
    """With ``EXACT_FILL`` the run-end rows carry each run's exact min, max
    and length whatever ``block`` is."""
    n = 1000
    rng = np.random.default_rng(11)
    flags = rng.random(n) < 0.03
    vals = rng.choice(EXTREMES, n).astype(np.int32)
    run = np.cumsum(flags)
    ends = np.r_[run[1:] != run[:-1], True]
    for block in (32, 512):
        mn, mx, ct = ops.segmented_scan(torch.from_numpy(flags),
                                        torch.from_numpy(vals), block=block,
                                        fill=ss.EXACT_FILL)
        for r in np.unique(run):
            rows = np.flatnonzero(run == r)
            end = rows[-1]
            assert ends[end]
            assert mn[end] == vals[rows].min() and mx[end] == vals[rows].max()
            assert ct[end] == len(rows)


def test_ops_and_plain_entry_points_agree():
    n = 333
    rng = np.random.default_rng(2)
    flags = torch.from_numpy(rng.random(n) < 0.1)
    vals = torch.from_numpy(rng.integers(0, 99, n).astype(np.int32))
    a = ops.segmented_scan(flags, vals, block=64)
    b = ref.segmented_scan_plain(bs.pack(flags), vals, 64)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_bad_operands_raise():
    vals = torch.zeros(40, dtype=torch.int32)
    with pytest.raises(ValueError, match="words"):
        ss.segmented_scan_plain(torch.zeros(1, dtype=torch.int32), vals)
    with pytest.raises(ValueError, match="int32"):
        ss.segmented_scan_plain(torch.zeros(2, dtype=torch.int32),
                                vals.to(torch.int64))
    with pytest.raises(ValueError, match="block"):
        ss.segmented_scan_plain(torch.zeros(2, dtype=torch.int32), vals, 0)
    with pytest.raises(ValueError, match="CUDA"):
        ss.segmented_scan_kernel(torch.zeros(2, dtype=torch.int32), vals)


@pytest.mark.parametrize("block", [1, 7, 32, 512, 4099])
@pytest.mark.parametrize("pattern", ["random", "none", "first", "all"])
def test_exact_scan_clamped_at_the_output(block, pattern):
    """What the single-pass kernel computes: the exact scan (EXACT_FILL),
    then row i clamped with the fills where no flag precedes it or its run
    began, at row i - count + 1, before i's block start.  That is the
    blocked scan bit for bit, at any block size, on or off the kernel's
    tiles."""
    rng = np.random.default_rng(block)
    n = 3 * ss.SCAN_TILE + 77
    flags = {"random": rng.random(n) < 0.01, "none": np.zeros(n, bool),
             "first": np.arange(n) == 0, "all": np.ones(n, bool)}[pattern]
    words = bs.pack(torch.from_numpy(flags))
    vals = torch.from_numpy(rng.choice(EXTREMES, n).astype(np.int32))
    mn, mx, cnt = ss.segmented_scan_plain(words, vals, block, ss.EXACT_FILL)
    rows = torch.arange(n, dtype=torch.int64)
    seen = torch.cumsum(torch.from_numpy(flags), 0) > 0
    crossed = ~seen | (rows - cnt + 1 < rows // block * block)
    lo, hi = ss.DEFAULT_FILL
    want = ss.segmented_scan_plain(words, vals, block, ss.DEFAULT_FILL)
    assert torch.equal(torch.where(crossed, mn.clamp(max=lo), mn), want[0])
    assert torch.equal(torch.where(crossed, mx.clamp(min=hi), mx), want[1])
    assert torch.equal(cnt, want[2])


@pytest.mark.parametrize("n", [1, ss.SCAN_TILE, ss.SCAN_TILE + 1, 9_600_000])
def test_scan_workspace_words(n):
    """The tile counter's 16 bytes, then two 24-byte records a tile."""
    tiles = -(-n // ss.SCAN_TILE)
    assert ss.scan_workspace_words(n) * 4 == 16 + 48 * tiles
