"""The tile walks of B6's fp32 kernels (``csrc/swa_attention.cu``'s
``flash_f32``, ``csrc/swa_backward.cu``'s ``bwd_dq`` and ``bwd_dkdv``),
through their Python twins, against the plain version's mask, in pure
Python and numpy.

Rows are a KV head's (query position, head of the group) pairs,
position-major, as the kernels order them.  Over ragged ``Sq`` and
``kv_len``, windows, query offsets (negative ones included), groups of 1
and 3 and ``causal=False``, at every head dim's tile plan: a forward or dq
block walks exactly the key tiles where one of its rows sees a key, each
``FULL`` exactly where every row of the block sees every key of the tile
(the kernels then evaluate no mask) and ``EDGE`` elsewhere; a dkdv block
walks consecutive row tiles that hold every row that sees one of its keys
and no tile without one, ``FULL`` exactly where the tile is whole and every
pair is visible.  The card holds the twins to the kernels' own plans
(``f32_kernel_tiles``; ``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest

from repro_torch.kernels import swa_attention as swa

SKV = 400
WALK_CASES = [(Sq, kv_len, causal, window, q_offset, group)
              for Sq in (1, 130, 300)
              for kv_len in (0, 77, 333)
              for causal in (True, False)
              for window in (0, 50, 200)
              for q_offset in (None, -8, 270)
              for group in (1, 3)]


def _visible(Sq, group, causal, window, q_offset, kv_len):
    """(group * Sq, SKV) bool: row r (position r // group) sees key j."""
    qpos = q_offset + (np.arange(Sq * group) // group)[:, None]
    kpos = np.arange(SKV)[None, :]
    vis = np.broadcast_to(kpos < kv_len, (Sq * group, SKV))
    if causal:
        vis = vis & (kpos <= qpos)
    if window > 0:
        vis = vis & (kpos > qpos - window)
    return vis


def _blocks(vis, bm, bn):
    """(any, all) over each (bm-row block, bn-key tile): rows past the end
    count as seeing every key for ``all`` and none for ``any``; keys past
    SKV as unseen."""
    rows = vis.shape[0]
    pr, pk = -rows % bm, -SKV % bn
    anyv = np.pad(vis, ((0, pr), (0, pk)))
    allv = np.pad(np.pad(vis, ((0, 0), (0, pk))), ((0, pr), (0, 0)),
                  constant_values=True)
    shape = (anyv.shape[0] // bm, bm, anyv.shape[1] // bn, bn)
    return (anyv.reshape(shape).any(axis=(1, 3)),
            allv.reshape(shape).all(axis=(1, 3)))


def _check_key_walks(bm, bn):
    n_full = n_edge = 0
    for Sq, kv_len, causal, window, q_offset, group in WALK_CASES:
        qo = kv_len - Sq if q_offset is None else q_offset
        vis = _visible(Sq, group, causal, window, qo, kv_len)
        anyv, allv = _blocks(vis, bm, bn)
        for blk, r0 in enumerate(range(0, Sq * group, bm)):
            walked = dict(swa.f32_key_tiles(r0, bm, bn, Sq * group, group,
                                            causal, window, qo, kv_len))
            assert sorted(walked) == list(np.flatnonzero(anyv[blk]))
            for t, cls in walked.items():
                assert cls == (swa.FULL if allv[blk, t] else swa.EDGE)
                n_full += cls == swa.FULL
                n_edge += cls == swa.EDGE
    assert n_full and n_edge


@pytest.mark.parametrize("D", swa.HEAD_DIMS)
def test_f32_forward_walk_matches_the_plain_mask(D):
    """The fp32 forward's blocks (``f32_forward_tiles(D)``) walk exactly
    the visible key tiles, classed as the kernel masks them."""
    _check_key_walks(*swa.f32_forward_tiles(D))


@pytest.mark.parametrize("D", swa.HEAD_DIMS)
def test_f32_dq_walk_matches_the_plain_mask(D):
    """The fp32 backward's dq blocks (``f32_backward_tiles(D)[:2]``) walk
    exactly the visible key tiles, classed as the kernel masks them."""
    _check_key_walks(*swa.f32_backward_tiles(D)[:2])


@pytest.mark.parametrize("D", swa.HEAD_DIMS)
def test_f32_dkdv_walk_matches_the_plain_mask(D):
    """The fp32 backward's dkdv blocks (``f32_backward_tiles(D)[2:]``) walk
    consecutive row tiles covering every row that sees one of their keys,
    none without one, ``FULL`` exactly where the tile is whole and every
    pair visible."""
    keys, bm = swa.f32_backward_tiles(D)[2:]
    n_full = 0
    for Sq, kv_len, causal, window, q_offset, group in WALK_CASES:
        qo = kv_len - Sq if q_offset is None else q_offset
        vis = np.pad(_visible(Sq, group, causal, window, qo, kv_len),
                     ((0, 0), (0, -SKV % keys)))
        for k0 in range(0, SKV, keys):
            cols = vis[:, k0:k0 + keys]
            seen = np.flatnonzero(cols.any(axis=1))
            walked = swa.f32_dkdv_tiles(k0, keys, bm, Sq, group, causal,
                                        window, qo, kv_len)
            if not len(seen):
                assert walked == []
                continue
            assert walked[0][0] <= seen[0] and walked[-1][1] > seen[-1]
            assert walked[-1][1] <= Sq * group
            for (r0, r1, cls), nxt in zip(walked, walked[1:] + [None]):
                assert 0 < r1 - r0 <= bm
                assert nxt is None or nxt[0] == r1 == r0 + bm
                tile = cols[r0:r1]
                assert tile.any()
                full = r1 - r0 == bm and tile.all()
                assert cls == (swa.FULL if full else swa.EDGE)
                n_full += full
    assert n_full
