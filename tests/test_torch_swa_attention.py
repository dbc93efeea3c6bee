"""B6, flash attention: the port's plain version against the reference's
Pallas kernel in interpret mode (``repro.kernels.ops.flash_attention``) and
against its dense oracle (``repro.kernels.ref.attention_ref``), over the
sweep of ``tests/test_kernels.py``, plus the decode offsets, the ring-buffer
mode (``causal=False``, ``kv_len < Skv``), rows with no visible key, head
dims 240 and 256, and the bf16 prefill kernel's tile classes
(``prefill_tiles``) against the plain version's mask.
Tolerances are the reference's own: 2e-5 in fp32, 2e-2 in bf16 (the sums
run in another order).  On CPU tensors the wrapper runs the plain version
and launches nothing; the kernel is held against it on the card
(``test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels import swa_attention as rswa
from repro_torch.kernels import launch_counts, ops, ref
from repro_torch.kernels import swa_attention as swa

SWEEP = [
    (2, 4, 2, 128, 128, 64, True, 0),
    (1, 8, 2, 256, 256, 64, True, 64),
    (2, 4, 4, 1, 384, 64, True, 0),        # decode
    (1, 4, 1, 1, 512, 128, True, 128),     # decode + window
    (2, 2, 2, 96, 96, 32, False, 0),       # bidirectional + padding
    (1, 2, 1, 80, 160, 32, True, 0),       # Sq != Skv (chunked prefill)
]
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


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window", SWEEP)
def test_plain_matches_pallas_and_oracle(B, Hq, Hkv, Sq, Skv, D, causal,
                                         window, dtype):
    (q, k, v), (tq, tk, tv) = _inputs(Sq + Skv + D, B, Hq, Hkv, Sq, Skv, D,
                                      dtype)
    before = dict(launch_counts)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert launch_counts == before and got.dtype == TORCH[dtype]
    pallas = rops.flash_attention(q, k, v, causal=causal, window=window,
                                  bq=64, bk=64, interpret=True)
    _close(got, pallas, dtype)
    _close(got, rref.attention_ref(q, k, v, causal=causal, window=window),
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_offset,window", [(0, 0), (37, 0), (95, 0),
                                             (95, 16), (64, 8)])
def test_decode_offsets_match_pallas(q_offset, window, dtype):
    """Full-cache decode: one or a few queries at ``q_offset``, the causal
    mask hiding the slots not yet written."""
    B, Hq, Hkv, Skv, D = 2, 4, 2, 96, 16
    for Sq in (1, 3):
        (q, k, v), (tq, tk, tv) = _inputs(q_offset + Sq, B, Hq, Hkv, Sq, Skv,
                                          D, dtype)
        got = ref.attention_ref(tq, tk, tv, causal=True, window=window,
                                q_offset=q_offset)
        want = rswa.flash_swa_attention(q, k, v, causal=True, window=window,
                                        q_offset=q_offset, kv_len=Skv, bq=Sq,
                                        bk=32, interpret=True)
        _close(got, want, dtype)


@pytest.mark.parametrize("kv_len", [1, 5, 16, 37, 64])
def test_ring_mode_matches_pallas(kv_len):
    """The ring-buffer decode of the model: no causal or window mask, keys
    at or past ``kv_len`` never attended."""
    B, Hq, Hkv, Skv, D = 2, 8, 2, 64, 16
    (q, k, v), (tq, tk, tv) = _inputs(kv_len, B, Hq, Hkv, 1, Skv, D,
                                      "float32")
    got = swa.flash_swa_attention_plain(tq, tk, tv, causal=False, window=0,
                                        q_offset=1000, kv_len=kv_len)
    want = rswa.flash_swa_attention(q, k, v, causal=False, window=0,
                                    q_offset=1000, kv_len=kv_len, bq=1, bk=16,
                                    interpret=True)
    _close(got, want, "float32")
    # the same as dense attention over the first kv_len slots
    dense = ref.attention_ref(tq, tk[:, :, :kv_len], tv[:, :, :kv_len],
                              causal=False)
    torch.testing.assert_close(got, dense, rtol=2e-5, atol=2e-5)


def test_rows_with_no_visible_key_are_zero():
    """Queries before the first key (negative offset), or with every key
    past kv_len, output 0 — the kernel's convention, and the oracle's."""
    B, Hq, Hkv, Sq, Skv, D = 1, 2, 1, 8, 32, 16
    (q, k, v), (tq, tk, tv) = _inputs(3, B, Hq, Hkv, Sq, Skv, D, "float32")
    got = swa.flash_swa_attention_plain(tq, tk, tv, causal=True, window=4,
                                        q_offset=-4)
    want = rswa.flash_swa_attention(q, k, v, causal=True, window=4,
                                    q_offset=-4, kv_len=Skv, bq=8, bk=16,
                                    interpret=True)
    _close(got, want, "float32")
    assert torch.count_nonzero(got[:, :, :4]) == 0
    assert torch.count_nonzero(got[:, :, 4:]) > 0
    none = swa.flash_swa_attention_plain(tq, tk, tv, causal=False, kv_len=0)
    assert torch.count_nonzero(none) == 0


def test_bad_arguments_raise():
    q = torch.zeros(1, 3, 4, 16)
    k = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(q, k, k)
    q = torch.zeros(1, 4, 4, 16)
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, k, k, kv_len=5)
    with pytest.raises(ValueError, match="dtypes differ"):
        ops.flash_attention(q, k.double(), k.double())


# gemma3-12b's head dim (and 256): a local layer's window crossing tiles, a
# global causal layer, a decode offset, and the ring mode
WIDE = [
    (1, 4, 2, 40, 48, True, 16, None, None),
    (1, 2, 1, 33, 48, True, 0, None, None),
    (1, 4, 2, 3, 64, True, 24, 50, 64),
    (1, 2, 2, 3, 32, False, 0, 700, 19),
]


@pytest.mark.parametrize("D", [240, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,causal,window,q_offset,kv_len",
                         WIDE)
def test_wide_head_dims_match_pallas(B, Hq, Hkv, Sq, Skv, causal, window,
                                     q_offset, kv_len, D, dtype):
    """Head dims 240 and 256, which the kernels now take: the plain version
    against the Pallas kernel in interpret mode."""
    (q, k, v), (tq, tk, tv) = _inputs(Sq + D, B, Hq, Hkv, Sq, Skv, D, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    got = ops.flash_attention(tq, tk, tv, **kw)
    want = rswa.flash_swa_attention(
        q, k, v, causal=causal, window=window,
        q_offset=Skv - Sq if q_offset is None else q_offset,
        kv_len=Skv if kv_len is None else kv_len, bq=Sq, bk=16,
        interpret=True)
    _close(got, want, dtype)
    assert D in swa.HEAD_DIMS


def _plain_visible(Sq, Skv, causal, window, q_offset, kv_len):
    """The plain version's mask, read off its output: q = 0 gives every
    visible key the same weight, and v = the identity (D = Skv) puts key
    j's weight in column j, so column j > 0 exactly where j is visible."""
    q = torch.zeros(1, 1, Sq, Skv)
    eye = torch.eye(Skv)[None, None]
    out = swa.flash_swa_attention_plain(q, eye, eye, causal=causal,
                                        window=window, q_offset=q_offset,
                                        kv_len=kv_len)
    return (out[0, 0] > 0).numpy()


TILE_CASES = [(Sq, kv_len, causal, window, q_offset)
              for Sq in (1, 130, 300)
              for kv_len in (0, 77, 300, 333)
              for causal in (True, False)
              for window in (0, 1, 50, 200)
              for q_offset in (None, -8, 270)]


@pytest.mark.parametrize("D", [80, 240])
def test_prefill_tile_classes_match_the_plain_mask(D):
    """``prefill_tiles`` (the bf16 prefill kernel's walk) against the plain
    version's mask over ragged ``Sq`` and ``kv_len``, windows, offsets and
    ``causal=False``: the walked tiles are exactly those where some row sees
    a key, FULL exactly where every row sees every key, EDGE elsewhere."""
    Skv, bn = 400, swa.prefill_keys_per_tile(D)
    n_edge = n_full = 0
    for Sq, kv_len, causal, window, q_offset in TILE_CASES:
        qo = kv_len - Sq if q_offset is None else q_offset
        vis = _plain_visible(Sq, Skv, causal, window, qo, kv_len)
        vis = np.pad(vis, ((0, 0), (0, -Skv % bn)))
        for q0 in range(0, Sq, swa.PREFILL_ROWS):
            rows = vis[q0:q0 + swa.PREFILL_ROWS]
            walked = dict(swa.prefill_tiles(q0, Sq, D, causal, window, qo,
                                            kv_len))
            for t in range(vis.shape[1] // bn):
                tile = rows[:, t * bn:(t + 1) * bn]
                cls = walked.get(t, swa.SKIP)
                assert cls == swa.prefill_tile_class(
                    qo + q0, qo + q0 + rows.shape[0] - 1, t * bn, bn, causal,
                    window, kv_len)
                if not tile.any():
                    assert cls == swa.SKIP
                elif tile.all():
                    assert cls == swa.FULL
                    n_full += 1
                else:
                    assert cls == swa.EDGE
                    n_edge += 1
    assert n_full > 0 and n_edge > 0


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version: a CPU tensor is
    refused before anything is built."""
    q = torch.zeros(1, 4, 4, 16)
    k = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        swa.flash_swa_attention(q, k, k)
