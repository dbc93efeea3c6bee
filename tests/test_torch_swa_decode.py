"""B6's decode route, split-KV flash-decoding: the host's split plan, and
the split and combine kernels' arithmetic in PyTorch
(``partials_plain`` / ``combine_partials_plain``) against B6's plain
version (1e-6 in fp32: the same sums, in another order and base of the
exponential) and against the reference's Pallas kernel in interpret mode
at ``test_torch_swa_attention.py``'s tolerances, over ring decode,
full-cache decode with a window, ``kv_len = 0`` and GQA groups 1/4/8.  The
kernels themselves are held against the plain version on the card
(``test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import swa_attention as rswa
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels import swa_attention as swa

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, Hq, Hkv, Sq, Skv, D, dtype):
    """The same values in both packages (bf16 rounded once, in jnp)."""
    rng = np.random.default_rng(seed)
    arrs = [jnp.asarray(rng.normal(size=s), JNP[dtype]) for s in
            ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    ts = [torch.from_numpy(np.array(a, np.float32)).to(TORCH[dtype])
          for a in arrs]
    return arrs, ts


def _splits(begin, end, plan):
    start, chunk, n = plan
    return [(start + s * chunk, min(start + (s + 1) * chunk, end))
            for s in range(n)]


# begin, end, B * Hkv, SMs
PLANS = [(0, 4096, 32, 132), (0, 4097, 32, 132), (4095, 8192, 8, 132),
         (0, 17, 32, 132), (0, 64, 1, 132), (63, 64, 2, 132),
         (100, 1000, 1, 132), (3, 5000, 700, 132), (0, 4096, 32, 16),
         (5, 5, 4, 132), (7, 3, 4, 132)]


@pytest.mark.parametrize("begin,end,n_bkv,sms", PLANS)
def test_plan_covers_the_range_in_chunks_of_64(begin, end, n_bkv, sms):
    start, chunk, n = plan = swa.plan_decode_splits(begin, end, n_bkv, sms)
    if end <= begin:
        assert n == 0
        return
    assert start % 64 == 0 and start <= begin < start + 64
    assert chunk % 64 == 0 and chunk > 0
    parts = _splits(begin, end, plan)
    # consecutive, every split non-empty, the last one ends at end
    assert all(lo < hi for lo, hi in parts)
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    assert parts[-1][1] == end and parts[0][0] == start
    # as many blocks as fill the SMs, unless the range has fewer tiles
    tiles = -(-(end - start) // 64)
    want = swa.BLOCKS_PER_SM * sms
    assert n * n_bkv >= min(want, tiles * n_bkv)
    if end - start <= 64:
        assert n == 1


def test_plan_at_the_batchers_shape():
    """4 slots x 8 KV heads over a full 4,096-slot ring on 132 SMs."""
    start, chunk, n = swa.plan_decode_splits(0, 4096, 32, 132)
    assert start == 0 and (n - 1) * chunk < 4096 <= n * chunk
    assert n * 32 >= 2 * 132


def test_window_edge_falls_inside_a_chunk():
    begin, end = swa.decode_key_range(1, True, 4096, 8000, 8192)
    assert (begin, end) == (3905, 8001)
    start, chunk, n = swa.plan_decode_splits(begin, end, 8, 132)
    assert start == 3904 and start < begin
    assert swa.decode_key_range(1, False, 0, 9000, 17) == (0, 17)
    assert swa.decode_key_range(2, True, 0, -5, 30) == (0, -3)


# B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len
DECODE = [
    (4, 8, 2, 1, 256, 16, False, 0, 9000, 256),      # ring, full (group 4)
    (2, 8, 2, 1, 256, 16, False, 0, 9000, 77),       # ring, kv_len ragged
    (2, 4, 4, 1, 192, 32, True, 0, 150, 192),        # full cache, group 1
    (1, 8, 1, 1, 320, 16, True, 100, 250, 320),      # window, group 8
    (2, 8, 2, 4, 256, 16, True, 64, 130, 256),       # 16 rows, window
    (2, 8, 2, 1, 128, 16, False, 0, 9000, 0),        # kv_len = 0
    (1, 6, 2, 5, 64, 16, True, 0, -3, 64),           # rows before key 0
]


def _plain_route(tq, tk, tv, kw, plan=None):
    m, l, o = swa.partials_plain(tq, tk, tv, plan=plan, **kw)
    return swa.combine_partials_plain(m, l, o, tq.shape[1], tq.shape[2],
                                      tq.dtype)


@pytest.mark.parametrize("case", DECODE)
def test_split_and_combine_match_plain_fp32(case):
    B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len = case
    _, (tq, tk, tv) = _inputs(Skv + Sq, B, Hq, Hkv, Sq, Skv, D, "float32")
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    want = swa.flash_swa_attention_plain(tq, tk, tv, **kw)
    begin, end = swa.decode_key_range(Sq, causal, window, q_offset, kv_len)
    # the default plan (one split per 64 keys here) and one big chunk
    for plan in (None, (begin // 64 * 64, 1 << 20, int(end > begin))):
        got = _plain_route(tq, tk, tv, kw, plan)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    if end <= begin:
        assert swa.plan_decode_splits(begin, end, B * Hkv)[2] == 0
        assert torch.count_nonzero(got) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE)
def test_split_and_combine_match_pallas(case, dtype):
    B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len = case
    (q, k, v), (tq, tk, tv) = _inputs(Skv + Sq, B, Hq, Hkv, Sq, Skv, D, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    got = _plain_route(tq, tk, tv, kw)
    assert got.dtype == TORCH[dtype]
    want = rswa.flash_swa_attention(q, k, v, bq=Sq, bk=32, interpret=True,
                                    **kw)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_empty_splits_add_nothing():
    """A split whose rows see no key (m = -inf, l = 0) leaves the result as
    it is, and a row whose splits are all empty is exactly 0."""
    _, (tq, tk, tv) = _inputs(1, 1, 4, 2, 1, 256, 16, "float32")
    kw = dict(causal=True, window=40, q_offset=200, kv_len=256)
    begin, end = swa.decode_key_range(1, True, 40, 200, 256)
    m, l, o = swa.partials_plain(tq, tk, tv, plan=(0, 64, 4), **kw)
    assert (begin, end) == (161, 201)
    # split 0 (keys 0-63) sees nothing; splits 2 and 3 see keys 161-200
    assert torch.isinf(m[:, :, 0]).all() and (l[:, :, 0] == 0).all()
    assert (l[:, :, 2:] > 0).all()
    got = swa.combine_partials_plain(m, l, o, 4, 1, torch.float32)
    torch.testing.assert_close(
        got, swa.flash_swa_attention_plain(tq, tk, tv, **kw), rtol=0,
        atol=1e-6)
    none = swa.combine_partials_plain(torch.full_like(m, float("-inf")),
                                      torch.zeros_like(l), o, 4, 1,
                                      torch.float32)
    assert torch.count_nonzero(none) == 0


def test_decode_calls_on_cpu_launch_nothing():
    """On CPU tensors the decode shapes run the plain version: no count
    moves, the decode route's included."""
    _, (tq, tk, tv) = _inputs(2, 4, 32, 8, 1, 128, 80, "bfloat16")
    before = dict(launch_counts)
    out = ops.flash_attention(tq, tk, tv, causal=False, q_offset=500,
                              kv_len=100)
    assert launch_counts == before and out.shape == tq.shape
    assert "flash_decode" in launch_counts
