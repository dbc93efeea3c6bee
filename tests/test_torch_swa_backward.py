"""B6's backward (the port's ``flash_swa_attention_backward_plain`` and the
``FlashAttention`` autograd Function) on the CPU.

The plain backward is held against ``jax.grad`` of the reference's own
attention (``repro.models.layers.sdpa``, the function the reference
differentiates when it trains) and against torch autograd through B6's
plain forward, over causal, windowed, non-causal and cross attention, GQA
groups of 1-4, ``kv_len`` masking, negative and positive query offsets and
rows that see no key.  Tolerances: 2e-5 of each gradient's largest |value|
in fp32 (the reference sums in another order; the gradients reach ~10).

The forward's log-sum-exp (``flash_swa_attention_plain(...,
return_lse=True)``, which the kernels write for the backward) is held
against ``jax.nn.logsumexp`` of the same masked, scaled scores, the plain
backward fed it against the plain backward without it and against
``jax.grad``, and the bf16 backward kernel's tile walks
(``backward_dq_tiles``, ``backward_dkdv_tiles``) against the plain mask."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import swa_attention as swa

# (B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len)
CASES = [
    (2, 4, 2, 37, 37, 16, True, 0, None, None),      # causal, GQA 2
    (1, 4, 1, 40, 40, 32, True, 7, None, None),      # window, MQA
    (2, 2, 2, 19, 19, 16, False, 0, None, None),     # bidirectional
    (1, 4, 4, 30, 12, 16, False, 0, 0, None),        # cross, Sq > Skv
    (2, 8, 2, 9, 50, 32, False, 0, 0, 41),           # cross, kv_len
    (1, 8, 2, 6, 64, 16, True, 0, 50, 60),           # decode-like offset
    (1, 4, 2, 25, 25, 16, False, 6, 0, None),        # window, no causal
]
# rows that see no key: kv_len 0, and queries before the first key
EMPTY_CASES = [
    (1, 4, 2, 7, 20, 16, False, 0, 0, 0),
    (2, 4, 2, 12, 12, 16, True, 0, -5, None),
    (1, 4, 1, 20, 20, 32, True, 3, -8, 15),
]
TOL = 2e-5


def _inputs(case, seed):
    B, Hq, Hkv, Sq, Skv, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D),
                      (B, Hq, Sq, D))]


def _kw(case):
    causal, window, q_offset, kv_len = case[6:]
    return dict(causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len)


def _close(got, want, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        top = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= TOL * top, (what, name,
                                                  np.abs(g - w).max(), top)


def _plain_bwd(q, k, v, do, case):
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = swa.flash_swa_attention_plain(tq, tk, tv, **_kw(case))
    return [x.numpy() for x in swa.flash_swa_attention_backward_plain(
        tq, tk, tv, o, tdo, **_kw(case))]


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_grad_of_reference_sdpa(case):
    """The reference's sdpa takes (B, S, H, D) and absolute query
    positions; its gradients, transposed back, equal the plain backward's."""
    B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len = case
    q, k, v, do = _inputs(case, 0)
    kv = Skv if kv_len is None else kv_len
    off = kv - Sq if q_offset is None else q_offset
    pos = jnp.broadcast_to(off + jnp.arange(Sq, dtype=jnp.int32), (B, Sq))
    kvl = None if kv_len is None else jnp.full((B,), kv_len, jnp.int32)

    def f(q_, k_, v_):
        out = RL.sdpa(q_, k_, v_, causal=causal, window=window,
                      q_positions=pos, kv_valid_len=kvl)
        return jnp.sum(out * jnp.asarray(do.transpose(0, 2, 1, 3)
                                         .reshape(B, Sq, Hq * D)))

    t = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))  # noqa: E731
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(t(q), t(k), t(v))
    want = [np.asarray(w).transpose(0, 2, 1, 3) for w in want]
    _close(_plain_bwd(q, k, v, do, case), want, case)


def _safe_attention(q, k, v, case):
    """Dense masked attention in float64 whose rows with no visible key are
    0 with a 0 gradient (B6's convention; autograd through the plain
    forward's ``where(den > 0, o / den, 0)`` gives NaN there)."""
    B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len = case
    kv = Skv if kv_len is None else kv_len
    off = kv - Sq if q_offset is None else q_offset
    g = Hq // Hkv
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    qpos = off + torch.arange(Sq)[:, None]
    kpos = torch.arange(Skv)[None, :]
    mask = (kpos < kv).expand(Sq, Skv)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk) / D ** 0.5
    s = s.masked_fill(~mask, -1e300)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    den = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p / den.clamp_min(1e-300), vv)


@pytest.mark.parametrize("case", CASES + EMPTY_CASES)
def test_plain_backward_matches_autograd(case):
    q, k, v, do = _inputs(case, 1)
    leaves = [torch.from_numpy(x).double().requires_grad_(True)
              for x in (q, k, v)]
    out = _safe_attention(*leaves, case)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(do).double())
    got = _plain_bwd(q, k, v, do, case)
    _close(got, [w.numpy() for w in want], case)
    if case in EMPTY_CASES:
        # a row with no visible key gets exactly zero gradient
        B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len = case
        kv = Skv if kv_len is None else kv_len
        off = kv - Sq if q_offset is None else q_offset
        empty = [i for i in range(Sq) if kv == 0 or (
            causal and off + i < 0)]
        assert empty and not np.any(got[0][:, :, empty])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_function_on_cpu(dtype):
    """``ops.flash_attention`` records ``FlashAttention`` where an input
    requires grad (its gradients are the plain backward's, in the inputs'
    dtype), plain tensors stay off the tape, and nothing launches a
    kernel on the CPU."""
    case = CASES[0]
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _inputs(case, 2))
    before = dict(launch_counts)
    assert ops.flash_attention(q, k, v, **_kw(case)).grad_fn is None
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, **_kw(case))
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, do)
    # the forward keeps its log-sum-exp and the backward reads it
    o, lse = swa.flash_swa_attention_plain(q, k, v, return_lse=True,
                                           **_kw(case))
    want = kref.attention_bwd_ref(q, k, v, o, do, lse=lse, **_kw(case))
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert torch.equal(g, w)
    assert launch_counts == before


def test_backward_refuses_mismatched_gradient():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(CASES[0], 3))
    o = swa.flash_swa_attention_plain(q, k, v)
    with pytest.raises(ValueError, match="dout"):
        swa.flash_swa_attention_backward_plain(q, k, v, o, do[:, :, :5])
    with pytest.raises(ValueError, match="CUDA"):
        swa.flash_swa_attention_backward(q, k, v, o, do)


def _masked_scores(q, k, case):
    """The scaled scores with hidden keys at -inf, (B, Hq, Sq, Skv), numpy."""
    B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len = case
    kv = Skv if kv_len is None else kv_len
    off = kv - Sq if q_offset is None else q_offset
    qpos = off + np.arange(Sq)[:, None]
    kpos = np.arange(Skv)[None, :]
    vis = (kpos < kv) & np.ones((Sq, 1), bool)
    if causal:
        vis &= kpos <= qpos
    if window > 0:
        vis &= kpos > qpos - window
    kk = np.repeat(k, Hq // Hkv, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q, kk) / np.float32(D ** 0.5)
    return np.where(vis, s, -np.inf).astype(np.float32), vis


@pytest.mark.parametrize("case", CASES + EMPTY_CASES)
def test_plain_lse_matches_jax_logsumexp(case):
    """Each row's log-sum-exp equals ``jax.nn.logsumexp`` of its masked,
    scaled scores (fp32, 1e-6), and is exactly 0 for a row that sees no
    key (the kernels' convention; logsumexp gives -inf there)."""
    q, k, v, _ = _inputs(case, 4)
    out, lse = swa.flash_swa_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), return_lse=True,
        **_kw(case))
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    s, vis = _masked_scores(q, k, case)
    want = np.asarray(jax.nn.logsumexp(jnp.asarray(s), axis=-1))
    seen = np.broadcast_to(vis.any(axis=-1), lse.shape)
    got = lse.numpy()
    np.testing.assert_allclose(got[seen], want[seen], rtol=1e-6, atol=1e-6)
    assert not np.any(got[~seen])
    if case in EMPTY_CASES:
        assert (~seen).any()


@pytest.mark.parametrize("case", CASES + EMPTY_CASES)
def test_plain_backward_given_lse_matches_without(case):
    """Fed the forward's log-sum-exp, the plain backward gives the
    gradients it gives without it (P = exp(s - lse) against the softmax;
    1e-6 of each gradient's largest |value|), and rows that see no key
    still get exactly 0."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(case, 5))
    o, lse = swa.flash_swa_attention_plain(q, k, v, return_lse=True,
                                           **_kw(case))
    got = swa.flash_swa_attention_backward_plain(q, k, v, o, do, lse=lse,
                                                 **_kw(case))
    want = swa.flash_swa_attention_backward_plain(q, k, v, o, do,
                                                  **_kw(case))
    for g, w in zip(got, want):
        top = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= 1e-6 * top
        assert not g[(w == 0).all(dim=-1)].any()


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_given_lse_matches_jax_grad(case):
    """The plain backward fed the forward's log-sum-exp against ``jax.grad``
    of the reference's sdpa (2e-5, as without it)."""
    B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len = case
    q, k, v, do = _inputs(case, 0)
    kv = Skv if kv_len is None else kv_len
    off = kv - Sq if q_offset is None else q_offset
    pos = jnp.broadcast_to(off + jnp.arange(Sq, dtype=jnp.int32), (B, Sq))
    kvl = None if kv_len is None else jnp.full((B,), kv_len, jnp.int32)

    def f(q_, k_, v_):
        out = RL.sdpa(q_, k_, v_, causal=causal, window=window,
                      q_positions=pos, kv_valid_len=kvl)
        return jnp.sum(out * jnp.asarray(do.transpose(0, 2, 1, 3)
                                         .reshape(B, Sq, Hq * D)))

    t = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))  # noqa: E731
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(t(q), t(k), t(v))
    want = [np.asarray(w).transpose(0, 2, 1, 3) for w in want]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = swa.flash_swa_attention_plain(tq, tk, tv, return_lse=True,
                                           **_kw(case))
    got = swa.flash_swa_attention_backward_plain(tq, tk, tv, o, tdo, lse=lse,
                                                 **_kw(case))
    _close([x.numpy() for x in got], want, case)


def _plain_mask(Sq, Skv, causal, window, q_offset, kv_len):
    """The plain forward's mask, read off its output: q = 0 gives every
    visible key the same weight and v = the identity puts key j's weight
    in column j."""
    q = torch.zeros(1, 1, Sq, Skv)
    eye = torch.eye(Skv)[None, None]
    out = swa.flash_swa_attention_plain(q, eye, eye, causal=causal,
                                        window=window, q_offset=q_offset,
                                        kv_len=kv_len)
    return (out[0, 0] > 0).numpy()


WALK_CASES = [(Sq, kv_len, causal, window, q_offset)
              for Sq in (1, 130, 300)
              for kv_len in (0, 77, 333)
              for causal in (True, False)
              for window in (0, 50, 200)
              for q_offset in (None, -8, 270)]


def _check_class(cls, tile):
    if not tile.any():
        assert cls == swa.SKIP
        return 0
    assert cls == (swa.FULL if tile.all() else swa.EDGE)
    return 1 if cls == swa.FULL else 2


@pytest.mark.parametrize("D", [80, 128, 256])
def test_backward_tile_walks_match_the_plain_mask(D):
    """The bf16 backward kernel's walks against the plain mask over ragged
    ``Sq`` and ``kv_len``, windows, offsets and ``causal=False``: a dq block
    (``BWD_DQ_ROWS`` rows) walks exactly the key tiles where one of its
    rows sees a key, a dkdv block (``backward_dkdv_keys(D)`` keys, 64 to a
    consumer) walks every row tile where a row sees one of its keys; each
    walked pair is SKIP where no pair is visible, FULL where every pair is
    (rows past ``Sq`` count as unseen) and EDGE elsewhere."""
    Skv, kb = 400, swa.backward_dq_keys(D)
    bm, keys = swa.backward_dkdv_rows(D), swa.backward_dkdv_keys(D)
    seen = set()
    for Sq, kv_len, causal, window, q_offset in WALK_CASES:
        qo = kv_len - Sq if q_offset is None else q_offset
        vis = _plain_mask(Sq, Skv, causal, window, qo, kv_len)
        pad = np.pad(vis, ((0, -Sq % max(bm, swa.BWD_DQ_ROWS)),
                           (0, -Skv % 128)))
        for q0 in range(0, Sq, swa.BWD_DQ_ROWS):
            rows = vis[q0:q0 + swa.BWD_DQ_ROWS]
            walked = dict(swa.backward_dq_tiles(q0, Sq, D, causal, window,
                                                qo, kv_len))
            for t in range(pad.shape[1] // kb):
                tile = rows[:, t * kb:(t + 1) * kb]
                if t not in walked:
                    assert not tile.any()
                    continue
                seen.add(("dq", _check_class(walked[t], tile)))
        for k0 in range(0, Skv, keys):
            walked = dict(swa.backward_dkdv_tiles(k0, Sq, D, causal, window,
                                                  qo, kv_len))
            assert sorted(walked) == list(range(min(walked, default=0),
                                                max(walked, default=-1) + 1))
            starts = (k0, k0 + 64) if keys == 128 else (k0, k0)
            for t in range(-(-Sq // bm)):
                for c, s in enumerate(starts):
                    tile = pad[t * bm:(t + 1) * bm, s:s + 64]
                    if t not in walked:
                        assert not tile.any()
                        continue
                    cls = walked[t][c]
                    assert cls == swa.backward_dkdv_class(
                        t * bm, bm, s, 64, Sq, causal, window, qo, kv_len)
                    seen.add(("dkdv", _check_class(cls, tile)))
    # a 64-key block walks no tile that none of its keys sees
    assert {("dq", 1), ("dq", 2), ("dkdv", 1), ("dkdv", 2)} <= seen
    assert (("dkdv", 0) in seen) == (keys == 128)
