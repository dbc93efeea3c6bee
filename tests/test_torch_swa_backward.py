"""B6's backward (the port's ``flash_swa_attention_backward_plain`` and the
``FlashAttention`` autograd Function) on the CPU.

The plain backward is held against ``jax.grad`` of the reference's own
attention (``repro.models.layers.sdpa``, the function the reference
differentiates when it trains) and against torch autograd through B6's
plain forward, over causal, windowed, non-causal and cross attention, GQA
groups of 1-4, ``kv_len`` masking, negative and positive query offsets and
rows that see no key.  Tolerances: 2e-5 of each gradient's largest |value|
in fp32 (the reference sums in another order; the gradients reach ~10)."""
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
    o = swa.flash_swa_attention_plain(q, k, v, **_kw(case))
    want = kref.attention_bwd_ref(q, k, v, o, do, **_kw(case))
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
