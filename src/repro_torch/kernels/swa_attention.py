"""B6: flash attention forward — GQA, causal and sliding-window masks, a
decode offset and KV-length masking.

``flash_swa_attention`` launches the CUDA kernel of
``csrc/swa_attention.cu`` (the port of
``repro/kernels/swa_attention.py:flash_swa_attention``);
``flash_swa_attention_plain`` is its plain PyTorch version.  Both take the
reference's layout, q ``(B, Hq, Sq, D)`` and k, v ``(B, Hkv, Skv, D)``, and
its conventions: query row ``i`` sits at position ``q_offset + i`` (default
``kv_len - Sq``) and reads KV head ``h // (Hq // Hkv)``; key ``j`` is
visible when ``j < kv_len`` (default ``Skv``), ``j <= qpos`` (``causal``)
and ``j > qpos - window`` (``window > 0``); scores are scaled by
``D**-0.5``, all arithmetic is fp32, the output has the input's dtype, and a
row with no visible key is 0.

The kernel takes element strides, so transposed views of the model's
``(B, S, H, D)`` tensors and caches go in without a copy; its output has
q's strides.

A call whose GQA group times ``Sq`` is at most ``DECODE_ROWS`` (every
decode step of the models) takes the decode route, split-KV
flash-decoding (``csrc/swa_decode.cu``): ``plan_decode_splits`` cuts the
visible key range into chunks of a multiple of ``DECODE_KEYS`` keys, one
block per (split, batch, KV head) writes fp32 partials (running max, sum,
unnormalised output), and a second launch combines them (and, given an
``lse`` buffer, writes each row's log-sum-exp, below).
``partials_plain`` and ``combine_partials_plain`` repeat that arithmetic in
PyTorch.  Larger calls (prefill) run ``csrc/swa_prefill.cu`` in bf16 (TMA
loads, ``wgmma`` products, warp-specialised; ``prefill_tile_class`` repeats
its sorting of (query tile, key tile) pairs into skipped, full and edge
tiles) and ``csrc/swa_attention.cu`` in fp32 (CUDA cores, register-blocked
products over a ``cp.async`` ring; ``f32_forward_tiles`` and
``f32_key_tiles`` repeat its tiles and walk).  Both routes take head dims
``HEAD_DIMS``; bf16 operands need 16-byte aligned bases and strides that
are multiples of 8 elements (TMA's rule), else the call raises.

The log-sum-exp (LSE): given an ``lse`` buffer, ``(B, Hq, Sq)`` fp32, either
route writes each row's natural log-sum-exp of its scaled visible scores, 0
for a row with no visible key; the decode route's combine kernel writes it
from the max and sum it already holds, so a decode call stays on the decode
route.  A sequence-sharded decode (``models.layers``) combines the ranks'
partial rows with it (``ops.flash_attention(..., return_lse=True)``).

The gradient: ``FlashAttention`` (a ``torch.autograd.Function``) runs the
forward above with an ``lse`` buffer.  Its backward, ``flash_swa_attention_backward``, reads that LSE and launches
two kernels on CUDA tensors (dQ, then dK and dV; no atomics): bf16 runs
``csrc/swa_backward_bf16.cu`` on the tensor cores (TMA, ``wgmma``;
``backward_dq_tiles`` and ``backward_dkdv_tiles`` repeat its walks, and
``backward_kernel_tiles`` reads its tile plan from the library), fp32
``csrc/swa_backward.cu`` on the CUDA cores (``f32_backward_tiles``,
``f32_key_tiles`` and ``f32_dkdv_tiles`` repeat its tiles and walks;
``f32_kernel_tiles`` reads both fp32 kernels' plan from the library).  The
fp32 kernels count their launches under ``flash_attention_f32`` and
``flash_attention_bwd_f32`` too.  On CPU tensors both directions
run their plain versions (``flash_swa_attention_plain(...,
return_lse=True)``, ``flash_swa_attention_backward_plain(..., lse=)``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import launch_counts, require_kernel_operand

__all__ = ["HEAD_DIMS", "DECODE_ROWS", "DECODE_KEYS", "PREFILL_ROWS",
           "flash_swa_attention", "flash_swa_attention_plain",
           "flash_swa_attention_backward",
           "flash_swa_attention_backward_plain", "FlashAttention",
           "decode_key_range", "plan_decode_splits", "partials_plain",
           "combine_partials_plain", "prefill_keys_per_tile",
           "prefill_tile_class", "prefill_tiles", "BWD_DQ_ROWS",
           "backward_dq_keys", "backward_dkdv_keys", "backward_dkdv_rows",
           "backward_dq_tiles", "backward_dkdv_class", "backward_dkdv_tiles",
           "backward_kernel_tiles", "f32_forward_tiles",
           "f32_backward_tiles", "f32_key_tiles", "f32_dkdv_tiles",
           "f32_kernel_tiles"]

HEAD_DIMS = (16, 32, 64, 80, 96, 128, 240, 256)  # every route's instantiations
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_MAX_BH = 65535                          # B * Hkv rides grid.y
_PLAIN_CHUNK = 1 << 28                   # score elements per plain-version step
DECODE_ROWS = 16          # group * Sq rows per KV head on the decode route
DECODE_KEYS = 64          # split chunks are multiples of this many keys
PREFILL_ROWS = 128        # query rows (of one head) a bf16 prefill block takes
SKIP, FULL, EDGE = 0, 1, 2  # classes of a (query tile, key tile) pair
BWD_DQ_ROWS = 128         # query rows a block of the bf16 backward's dq launch
BLOCKS_PER_SM = 2         # the split plan fills the card this many times
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def _check_args(q, k, v, window, q_offset, kv_len) -> Tuple[int, int]:
    """Validate shapes and masks; returns ``(q_offset, kv_len)`` with the
    reference's defaults filled in."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Skv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (batch, head dim, or Hq "
                         f"not a multiple of Hkv)")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: q, k, v dtypes differ "
                         f"({q.dtype}, {k.dtype}, {v.dtype})")
    if int(window) < 0:
        raise ValueError(f"flash_attention window must be >= 0, got {window}")
    kv_len = Skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= Skv:
        raise ValueError(f"flash_attention kv_len {kv_len} outside [0, {Skv}]")
    q_offset = kv_len - Sq if q_offset is None else int(q_offset)
    return q_offset, kv_len


def flash_swa_attention_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0, q_offset: Optional[int] = None,
                              kv_len: Optional[int] = None,
                              return_lse: bool = False, out_dtype=None):
    """Dense masked fp32 softmax attention, a block of query rows at a time
    (so that the scores of one step stay under ``_PLAIN_CHUNK`` elements).
    With ``return_lse``, returns ``(out, lse)``: each row's log-sum-exp of
    its scaled visible scores, ``(B, Hq, Sq)`` fp32, 0 for a row with no
    visible key (the kernels' convention).  The output is in ``out_dtype``
    (default q's)."""
    q_offset, kv_len = _check_args(q, k, v, window, q_offset, kv_len)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    dev = q.device
    qf = q.float().reshape(B, Hkv, g, Sq, D)
    kf, vf = k.float(), v.float()
    scale = 1.0 / D ** 0.5
    out = torch.empty((B, Hkv, g, Sq, D), dtype=torch.float32, device=dev)
    lse = torch.empty((B, Hkv, g, Sq), dtype=torch.float32, device=dev)
    kpos = torch.arange(Skv, device=dev)
    step = max(1, _PLAIN_CHUNK // max(1, B * Hq * Skv))
    for lo in range(0, Sq, step):
        hi = min(lo + step, Sq)
        qpos = q_offset + torch.arange(lo, hi, device=dev)[:, None]
        mask = (kpos < kv_len)[None, :].expand(hi - lo, Skv)
        if causal:
            mask = mask & (kpos[None, :] <= qpos)
        if window > 0:
            mask = mask & (kpos[None, :] > qpos - window)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf[:, :, :, lo:hi], kf) * scale
        s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(s - m)
        den = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
        out[:, :, :, lo:hi] = torch.where(den > 0, o / den,
                                          torch.zeros_like(o))
        lse[:, :, :, lo:hi] = torch.where(
            den > 0, m + torch.log(den), torch.zeros_like(den))[..., 0]
    out = out.reshape(B, Hq, Sq, D).to(out_dtype or q.dtype)
    return (out, lse.reshape(B, Hq, Sq)) if return_lse else out


def decode_key_range(Sq: int, causal: bool, window: int, q_offset: int,
                     kv_len: int) -> Tuple[int, int]:
    """Keys ``[begin, end)`` that some query row of a call can see (as
    ``key_range`` in ``csrc/swa_attention.cu``); empty when ``end <=
    begin``."""
    begin = max(0, q_offset - window + 1) if window > 0 else 0
    end = min(kv_len, q_offset + Sq) if causal else kv_len
    return begin, end


def plan_decode_splits(begin: int, end: int, n_bkv: int,
                       sm_count: int = 132) -> Tuple[int, int, int]:
    """``(start, chunk, splits)``: split ``s`` takes keys ``[start + s *
    chunk, min(start + (s + 1) * chunk, end))``.  ``start`` is ``begin``
    rounded down to ``DECODE_KEYS`` and ``chunk`` a multiple of it, the
    largest for which the ``n_bkv * splits`` blocks (one per split, batch
    and KV head) number at least ``BLOCKS_PER_SM`` per SM (or one split per
    ``DECODE_KEYS`` keys, where the range has fewer); an empty range has
    no split."""
    if end <= begin:
        return 0, DECODE_KEYS, 0
    start = begin // DECODE_KEYS * DECODE_KEYS
    tiles = -(-(end - start) // DECODE_KEYS)
    want = max(1, -(-BLOCKS_PER_SM * sm_count // max(1, n_bkv)))
    per = max(1, tiles // want)
    return start, per * DECODE_KEYS, -(-tiles // per)


def prefill_keys_per_tile(D: int) -> int:
    """Keys a tile of the bf16 prefill kernel: 128, or 64 above D = 128
    (where the output alone takes 120-128 registers a thread)."""
    return 64 if D > 128 else 128


def prefill_tile_class(qlo: int, qhi: int, k0: int, keys: int, causal: bool,
                       window: int, kv_len: int) -> int:
    """The bf16 prefill kernel's class of the pair (query rows at positions
    ``[qlo, qhi]``, keys ``[k0, k0 + keys)``), as
    ``csrc/swa_prefill.cu:prefill_tile_class`` computes it: ``SKIP`` when no
    row sees a key, ``FULL`` when every row sees every key (the kernel then
    masks nothing), else ``EDGE`` (the causal diagonal, the window's lower
    edge or ``kv_len`` crosses the tile)."""
    khi = min(k0 + keys, kv_len) - 1             # last key that exists
    if khi < k0 or (causal and k0 > qhi) or (window > 0
                                              and khi <= qlo - window):
        return SKIP
    kend = k0 + keys - 1
    if kend < kv_len and (not causal or kend <= qlo) and (
            window == 0 or k0 > qhi - window):
        return FULL
    return EDGE


def prefill_tiles(q0: int, Sq: int, D: int, causal: bool, window: int,
                  q_offset: int, kv_len: int):
    """``[(key tile, class), ...]`` that the bf16 prefill block of the
    query tile starting at row ``q0`` walks: the tiles of
    ``decode_key_range``'s keys for its rows, in order."""
    return _key_tiles(q0, PREFILL_ROWS, prefill_keys_per_tile(D), Sq, causal,
                      window, q_offset, kv_len)


def backward_dq_keys(D: int) -> int:
    """Keys a tile of the bf16 backward's dq launch: 64, or 32 above
    D = 128 (where dQ alone takes 120-128 registers a thread).  A twin of
    ``BwdCfg::BN`` in ``csrc/swa_backward_bf16.cu``, held to it on the card
    through ``backward_kernel_tiles``."""
    return 32 if D > 128 else 64


def backward_dq_tiles(q0: int, Sq: int, D: int, causal: bool, window: int,
                      q_offset: int, kv_len: int):
    """``[(key tile, class), ...]`` that the bf16 backward's dq block of
    the ``BWD_DQ_ROWS`` query rows from ``q0`` walks (tiles of
    ``backward_dq_keys(D)`` keys; ``csrc/swa_backward_bf16.cu:
    bwd_dq_wgmma``): it masks the ``EDGE`` ones."""
    return _key_tiles(q0, BWD_DQ_ROWS, backward_dq_keys(D), Sq, causal,
                      window, q_offset, kv_len)


def _key_tiles(q0, block_rows, bn, Sq, causal, window, q_offset, kv_len):
    rows = min(q0 + block_rows, Sq) - q0
    qlo = q_offset + q0
    begin, end = decode_key_range(rows, causal, window, qlo, kv_len)
    if end <= begin:
        return []
    return [(t, prefill_tile_class(qlo, qlo + rows - 1, t * bn, bn, causal,
                                   window, kv_len))
            for t in range(begin // bn, -(-end // bn))]


def backward_dkdv_keys(D: int) -> int:
    """Keys a block of the bf16 backward's dkdv launch: 128, 64 to each
    consumer warpgroup, or 64 above D = 128, where both warpgroups take the
    same keys and split d (dK and dV of 64 keys would take 240-256
    registers a thread).  A twin of ``BwdCfg::KEYS``, held to it on the card
    through ``backward_kernel_tiles``."""
    return 64 if D > 128 else 128


def backward_dkdv_rows(D: int) -> int:
    """Query rows a tile of the bf16 backward's dkdv launch: 64, or 32 from
    D = 128 on (where dK and dV alone take 128 registers a thread).  A twin
    of ``BwdCfg::BM``, held to it on the card through
    ``backward_kernel_tiles``."""
    return 32 if D > 96 else 64


def backward_dkdv_class(p0: int, rows: int, k0: int, keys: int, Sq: int,
                        causal: bool, window: int, q_offset: int,
                        kv_len: int) -> int:
    """The class of the pair (query rows ``[p0, p0 + rows)`` of a head,
    keys ``[k0, k0 + keys)``) in the dkdv launch: ``prefill_tile_class`` of
    the rows below ``Sq``, and ``EDGE`` for a ``FULL`` tile that runs past
    ``Sq`` (its missing rows are masked).  The kernel masks every pair that
    is not ``FULL``."""
    last = min(p0 + rows, Sq) - 1
    if last < p0:
        return SKIP
    cls = prefill_tile_class(q_offset + p0, q_offset + last, k0, keys, causal,
                             window, kv_len)
    return EDGE if cls == FULL and p0 + rows > Sq else cls


def backward_dkdv_tiles(k0: int, Sq: int, D: int, causal: bool, window: int,
                        q_offset: int, kv_len: int):
    """``[(row tile, (class of consumer 0's 64 keys, class of consumer
    1's)), ...]`` that the bf16 backward's dkdv block of the
    ``backward_dkdv_keys(D)`` keys from ``k0`` walks for each head of the
    group (``csrc/swa_backward_bf16.cu:bwd_dkdv_wgmma``): the row tiles from
    the first position that can see one of its keys to the last.  Consumer
    c's keys start at ``k0 + 64 c`` (``k0`` for both above D = 128)."""
    bm, keys = backward_dkdv_rows(D), backward_dkdv_keys(D)
    k_last = min(k0 + keys, kv_len) - 1
    if k_last < k0:
        return []
    p_lo = max(0, k0 - q_offset) if causal else 0
    p_hi = min(Sq - 1, k_last + window - 1 - q_offset) if window > 0 \
        else Sq - 1
    if p_hi < p_lo:
        return []
    starts = (k0, k0 + 64) if keys == 128 else (k0, k0)
    return [(t, tuple(backward_dkdv_class(t * bm, bm, s, 64, Sq, causal,
                                          window, q_offset, kv_len)
                      for s in starts))
            for t in range(p_lo // bm, p_hi // bm + 1)]


def backward_kernel_tiles(D: int) -> Tuple[int, int, int, int]:
    """The bf16 backward kernel's own tile plan at head dim ``D``, read from
    the built library (``repro_flash_attention_bwd_bf16_tiles``, from
    ``BwdCfg``): (query rows of a dq block, keys of a dq tile, keys of a
    dkdv block, query rows of a dkdv tile).  The Python twins must give
    ``(BWD_DQ_ROWS, backward_dq_keys(D), backward_dkdv_keys(D),
    backward_dkdv_rows(D))``; needs the CUDA toolchain."""
    from repro_torch.kernels.build import check, library

    tiles = (ctypes.c_int * 4)()
    check(library().repro_flash_attention_bwd_bf16_tiles(D, tiles),
          "flash_attention backward tiles")
    return tuple(tiles)


def f32_forward_tiles(D: int) -> Tuple[int, int]:
    """(query rows of a block, keys of a tile) of the fp32 forward kernel
    (``csrc/simt_f32.cuh:FwdCfg``): 128 rows (8 a thread) by 32 keys up to
    D = 96, 64 by 32 from 128 on (O's registers).  Rows are a KV head's
    (position, head of the group) pairs, position-major.  Held to the
    kernel on the card through ``f32_kernel_tiles``."""
    return (128 if D < 128 else 64), 32


def f32_backward_tiles(D: int) -> Tuple[int, int, int, int]:
    """(query rows of a dq block, keys of a dq tile, keys of a dkdv block,
    query rows of a dkdv tile) of the fp32 backward
    (``csrc/simt_f32.cuh:DqCfg``, ``KvCfg``): dq 64 rows by 64 keys up to
    D = 80, by 32 from 96 on; dkdv 64 keys up to 96, 32 from 128 on, by
    tiles of 64 rows.  Held to the kernel on the card through
    ``f32_kernel_tiles``."""
    return 64, (64 if D < 96 else 32), (64 if D < 128 else 32), 64


def f32_key_tiles(r0: int, block_rows: int, keys: int, rows: int,
                  group: int, causal: bool, window: int, q_offset: int,
                  kv_len: int):
    """``[(key tile, class), ...]`` that an fp32 forward or dq block walks:
    the block of ``block_rows`` rows from row ``r0`` of a KV head's ``rows``
    (= group * Sq, position-major), tiles of ``keys`` keys over
    ``decode_key_range`` of its positions, classed by
    ``prefill_tile_class`` (the kernels evaluate a mask on the ``EDGE``
    ones; the dq kernel also on a block cut short by ``rows``)."""
    r1 = min(r0 + block_rows, rows)
    if r1 <= r0:
        return []
    qlo, qhi = q_offset + r0 // group, q_offset + (r1 - 1) // group
    begin, end = decode_key_range(qhi - qlo + 1, causal, window, qlo, kv_len)
    if end <= begin:
        return []
    return [(t, prefill_tile_class(qlo, qhi, t * keys, keys, causal, window,
                                   kv_len))
            for t in range(begin // keys, -(-end // keys))]


def f32_dkdv_tiles(k0: int, keys: int, block_rows: int, Sq: int, group: int,
                   causal: bool, window: int, q_offset: int, kv_len: int):
    """``[(first row, end row, class), ...]`` that the fp32 backward's dkdv
    block of the ``keys`` keys from ``k0`` walks: tiles of ``block_rows``
    rows (a KV head's (position, head) pairs, position-major) from the
    first row whose position can see one of its keys to the last, the last
    tile cut short there; a tile cut short is ``EDGE`` (its missing rows
    are masked)."""
    k_last = min(k0 + keys, kv_len) - 1
    if k_last < k0:
        return []
    p_lo = max(0, k0 - q_offset) if causal else 0
    p_hi = min(Sq - 1, k_last + window - 1 - q_offset) if window > 0 \
        else Sq - 1
    if p_hi < p_lo:
        return []
    r_begin, r_end = p_lo * group, (p_hi + 1) * group
    out = []
    for r0 in range(r_begin, r_end, block_rows):
        r1 = min(r0 + block_rows, r_end)
        cls = prefill_tile_class(q_offset + r0 // group,
                                 q_offset + (r1 - 1) // group, k0, keys,
                                 causal, window, kv_len)
        out.append((r0, r1, EDGE if r1 - r0 < block_rows else cls))
    return out


def f32_kernel_tiles(D: int) -> Tuple[int, ...]:
    """The fp32 kernels' own tile plan at head dim ``D``, read from the
    built library (``repro_flash_f32_tiles``): ``f32_backward_tiles(D) +
    f32_forward_tiles(D)`` when the twins hold; needs the CUDA toolchain."""
    from repro_torch.kernels.build import check, library

    tiles = (ctypes.c_int * 6)()
    check(library().repro_flash_f32_tiles(D, tiles), "flash_attention fp32 "
          "tiles")
    return tuple(tiles)


def _rows(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """(B, Hq, Sq, D) -> (B, Hkv, group * Sq, D), rows position-major (row
    r is query r // group of head r % group of the KV head's group), as the
    decode kernel orders them."""
    B, Hq, Sq, D = x.shape
    return (x.reshape(B, Hkv, Hq // Hkv, Sq, D).transpose(2, 3)
            .reshape(B, Hkv, Hq // Hkv * Sq, D))


def partials_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   q_offset: Optional[int] = None,
                   kv_len: Optional[int] = None,
                   plan: Optional[Tuple[int, int, int]] = None):
    """The decode route's split kernel in PyTorch: ``(m, l, o)`` per (batch,
    KV head, split, row), fp32, with ``m`` the row's largest score over the
    split's visible keys in the log2 domain (``-inf`` when it sees none),
    ``l`` the sum of ``exp2(score - m)`` and ``o`` their weighted sum of
    ``v`` rows (``(..., D)``).  ``plan`` defaults to
    ``plan_decode_splits``'s."""
    q_offset, kv_len = _check_args(q, k, v, window, q_offset, kv_len)
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    begin, end = decode_key_range(Sq, causal, window, q_offset, kv_len)
    start, chunk, splits = plan or plan_decode_splits(begin, end, B * Hkv)
    group = Hq // Hkv
    R = group * Sq
    dev = q.device
    qr = _rows(q.float(), Hkv)
    qpos = q_offset + torch.arange(R, device=dev) // group
    scale = torch.tensor(_LOG2E / D ** 0.5, dtype=torch.float32).item()
    m = torch.full((B, Hkv, splits, R), float("-inf"), device=dev)
    l = torch.zeros((B, Hkv, splits, R), device=dev)
    o = torch.zeros((B, Hkv, splits, R, D), device=dev)
    for s in range(splits):
        kb = start + s * chunk
        ke = min(kb + chunk, end)
        kpos = torch.arange(kb, ke, device=dev)
        vis = (kpos < kv_len)[None, :].expand(R, ke - kb)
        if causal:
            vis = vis & (kpos[None, :] <= qpos[:, None])
        if window > 0:
            vis = vis & (kpos[None, :] > qpos[:, None] - window)
        x = torch.einsum("bhrd,bhkd->bhrk", qr, k[:, :, kb:ke].float()) * scale
        x = x.masked_fill(~vis, float("-inf"))
        ms = x.amax(dim=-1)
        p = torch.where(vis, torch.exp2(x - torch.where(
            torch.isinf(ms), torch.zeros_like(ms), ms)[..., None]),
            torch.zeros_like(x))
        m[:, :, s] = ms
        l[:, :, s] = p.sum(dim=-1)
        o[:, :, s] = torch.einsum("bhrk,bhkd->bhrd", p, v[:, :, kb:ke].float())
    return m, l, o


def combine_partials_plain(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                           Hq: int, Sq: int, dtype, return_lse: bool = False):
    """The decode route's combine kernel in PyTorch: rescale each split by
    ``exp2(m_s - max m)`` (a split with ``m = -inf`` adds nothing), sum,
    divide by the rescaled sum; a row whose sums are all 0 is 0.  Returns
    ``(B, Hq, Sq, D)`` in ``dtype``; with ``return_lse``, ``(out, lse)``:
    each row's natural log-sum-exp ``(max m + log2 sum) * ln 2``, ``(B, Hq,
    Sq)`` fp32, 0 for a row that sees no key (the kernel's convention)."""
    B, Hkv, splits, R, D = o.shape
    if splits:
        M = m.amax(dim=2, keepdim=True)
        M = torch.where(torch.isinf(M), torch.zeros_like(M), M)
        wt = torch.where(torch.isinf(m), torch.zeros_like(m),
                         torch.exp2(m - M))
        den = (wt * l).sum(dim=2)
        num = (wt[..., None] * o).sum(dim=2)
        out = torch.where(den[..., None] > 0,
                          num / torch.where(den > 0, den, 1.0)[..., None],
                          torch.zeros_like(num))
        lse = torch.where(den > 0, (M[:, :, 0] + torch.log2(
            torch.where(den > 0, den, 1.0))) * _LN2, torch.zeros_like(den))
    else:
        out = torch.zeros((B, Hkv, R, D), device=o.device)
        lse = torch.zeros((B, Hkv, R), device=o.device)
    out = (out.reshape(B, Hkv, Sq, Hq // Hkv, D).transpose(2, 3)
           .reshape(B, Hq, Sq, D).to(dtype))
    if not return_lse:
        return out
    return out, (lse.reshape(B, Hkv, Sq, Hq // Hkv).transpose(2, 3)
                 .reshape(B, Hq, Sq))


def _flash_decode(lib, q, k, v, out, lse, causal, window, q_offset, kv_len,
                  stream) -> None:
    """Launch the decode route: the split kernel over
    ``plan_decode_splits``'s plan and the combine kernel into ``out`` (q's
    type or fp32; and each row's log-sum-exp into ``lse`` unless it is
    None)."""
    from repro_torch.kernels.build import check

    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    begin, end = decode_key_range(Sq, causal, window, q_offset, kv_len)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    start, chunk, splits = plan_decode_splits(begin, end, B * Hkv, sms)
    part = torch.empty((max(1, B * Hq * Sq * splits * (D + 2)),),
                       dtype=torch.float32, device=q.device)
    vec16 = all(t.data_ptr() % 16 == 0 and all(
        st % 4 == 0 for st, n in zip(t.stride()[:3], t.shape) if n > 1)
        for t in (k, v))
    st = [ctypes.c_longlong(s) for t in (q, k, v, out) for s in t.stride()[:3]]
    status = lib.repro_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *st,
        B, Hq, Hkv, Sq, D, int(bool(causal)), int(window),
        ctypes.c_longlong(q_offset), kv_len, start, chunk, splits, end,
        part.data_ptr(), None if lse is None else lse.data_ptr(), int(vec16),
        int(q.dtype == torch.bfloat16), int(out.dtype == torch.float32),
        stream)
    launch_counts["flash_decode"] += 1
    if lse is not None:
        launch_counts["flash_decode_lse"] += 1
    check(status, "flash_attention decode")


def _check_lse(lse: torch.Tensor, q: torch.Tensor, what: str) -> None:
    B, Hq, Sq = q.shape[:3]
    if not (isinstance(lse, torch.Tensor) and lse.shape == (B, Hq, Sq)
            and lse.dtype == torch.float32 and lse.is_contiguous()
            and lse.device == q.device):
        raise ValueError(f"{what}: lse must be a contiguous float32 tensor "
                         f"of shape {(B, Hq, Sq)} on {q.device}")


def flash_swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: Optional[int] = None,
                        kv_len: Optional[int] = None,
                        lse: Optional[torch.Tensor] = None,
                        out_dtype=None) -> torch.Tensor:
    """Launch B6 on CUDA tensors (the decode route when ``group * Sq <=
    DECODE_ROWS``, else the prefill kernels); returns ``(B, Hq, Sq, D)`` in
    q's dtype.  ``lse``, a ``(B, Hq, Sq)`` fp32 buffer, receives each row's
    log-sum-exp (``flash_swa_attention_plain``'s convention) on either
    route.  ``out_dtype=torch.float32``: the output in fp32 (the decode
    route writes its fp32 sums unrounded; the prefill kernels' output is
    converted)."""
    from repro_torch.kernels.build import check, library

    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        require_kernel_operand(t, f"flash_attention {name}",
                               dtypes=KERNEL_DTYPES, contiguous=False)
    q_offset, kv_len = _check_args(q, k, v, window, q_offset, kv_len)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {D} is not one of "
                         f"{HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must share a device")
    if B * Hkv > _MAX_BH:
        raise ValueError(f"flash_attention kernel: B * Hkv = {B * Hkv} > "
                         f"{_MAX_BH}")
    if lse is not None:
        _check_lse(lse, q, "flash_attention")
    out = torch.empty_like(q)        # q's strides where q is dense
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out")):
        if not _loadable(t):
            raise ValueError(
                f"flash_attention kernel: {name} needs unit stride on d and "
                f"{16 if bf16 else 4}-byte aligned rows, got strides "
                f"{t.stride()}")
    if B == 0 or Sq == 0:
        return out
    lib = library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if (Hq // Hkv) * Sq <= DECODE_ROWS:
        if out_dtype is not None and out_dtype != q.dtype:
            if out_dtype != torch.float32:
                raise ValueError(f"flash_attention: out_dtype {out_dtype} "
                                 f"is neither q's type nor float32")
            out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
        launch_counts["flash_attention"] += 1
        _flash_decode(lib, q, k, v, out, lse, causal, window, q_offset,
                      kv_len, stream)
        return out
    st = [ctypes.c_longlong(s) for t in (q, k, v, out) for s in t.stride()[:3]]
    status = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *st,
        B, Hq, Hkv, Sq, Skv, D, int(bool(causal)), int(window),
        ctypes.c_longlong(q_offset), kv_len,
        int(bf16), None if lse is None else lse.data_ptr(), stream)
    launch_counts["flash_attention"] += 1
    if not bf16:
        launch_counts["flash_attention_f32"] += 1
    check(status, "flash_attention")
    return out if out_dtype is None else out.to(out_dtype)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------
def _check_grad_args(q, o, do) -> None:
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention backward: o {tuple(o.shape)} and "
                         f"dout {tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if not (o.dtype == do.dtype == q.dtype):
        raise ValueError(f"flash_attention backward: q, o, dout dtypes differ "
                         f"({q.dtype}, {o.dtype}, {do.dtype})")


def flash_swa_attention_backward_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        do: torch.Tensor, *, causal: bool = True, window: int = 0,
        q_offset: Optional[int] = None, kv_len: Optional[int] = None,
        lse: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of ``flash_swa_attention_plain`` at ``(q, k, v)``
    for the output gradient ``do``, given the forward's output ``o``: the
    explicit fp32 formulas, a block of query rows at a time.  With P the
    masked softmax and ``Delta = sum_d do * o`` per row, ``dS = P (do v^T -
    Delta)``, ``dq = dS k / sqrt(D)``, ``dk = dS^T q / sqrt(D)`` and ``dv =
    P^T do``, dk and dv summed over each KV head's group; a row with no
    visible key gets 0.  Given the forward's ``lse`` (``(B, Hq, Sq)``, as
    ``flash_swa_attention_plain(..., return_lse=True)`` returns it), P is
    ``exp(s - lse)`` over the visible keys, as the kernels compute it;
    else the softmax of the scores.  Gradients in the inputs' dtype."""
    q_offset, kv_len = _check_args(q, k, v, window, q_offset, kv_len)
    _check_grad_args(q, o, do)
    if lse is not None:
        _check_lse(lse, q, "flash_attention backward")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    dev = q.device
    qf = q.float().reshape(B, Hkv, g, Sq, D)
    of = o.float().reshape(B, Hkv, g, Sq, D)
    gf = do.float().reshape(B, Hkv, g, Sq, D)
    kf, vf = k.float(), v.float()
    scale = 1.0 / D ** 0.5
    dq = torch.empty((B, Hkv, g, Sq, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Hkv, Skv, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Hkv, Skv, D), dtype=torch.float32, device=dev)
    kpos = torch.arange(Skv, device=dev)
    step = max(1, _PLAIN_CHUNK // max(1, B * Hq * Skv))
    for lo in range(0, Sq, step):
        hi = min(lo + step, Sq)
        qpos = q_offset + torch.arange(lo, hi, device=dev)[:, None]
        mask = (kpos < kv_len)[None, :].expand(hi - lo, Skv)
        if causal:
            mask = mask & (kpos[None, :] <= qpos)
        if window > 0:
            mask = mask & (kpos[None, :] > qpos - window)
        qc, gc = qf[:, :, :, lo:hi], gf[:, :, :, lo:hi]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kf) * scale
        s = s.masked_fill(~mask, float("-inf"))
        if lse is None:
            m = s.amax(dim=-1, keepdim=True)
            m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
            p = torch.exp(s - m)
            den = p.sum(dim=-1, keepdim=True)
            p = torch.where(den > 0, p / den, torch.zeros_like(p))
        else:        # a row with no visible key: every score is -inf, p 0
            p = torch.exp(s - lse.reshape(B, Hkv, g, Sq)[:, :, :, lo:hi,
                                                         None])
        dp = torch.einsum("bhgqd,bhkd->bhgqk", gc, vf)
        delta = (gc * of[:, :, :, lo:hi]).sum(dim=-1, keepdim=True)
        ds = p * (dp - delta)
        dq[:, :, :, lo:hi] = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
        dk += torch.einsum("bhgqk,bhgqd->bhkd", ds, qc) * scale
        dv += torch.einsum("bhgqk,bhgqd->bhkd", p, gc)
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _grad_like(t: torch.Tensor) -> torch.Tensor:
    """An output buffer of t's shape and dtype, in t's strides where t is
    dense with unit stride on d (a transposed view's gradient then goes back
    through the transpose without a copy)."""
    out = torch.empty_like(t)
    return out if out.stride(-1) == 1 else torch.empty(
        t.shape, dtype=t.dtype, device=t.device)


def _loadable(t: torch.Tensor) -> bool:
    """Whether the kernels can load t as it lies: unit stride on d, and for
    bf16 a 16-byte aligned base and strides that are multiples of 8
    elements on axes longer than 1 (bf16 tiles move by TMA or in 16-byte
    vectors, fp32 ones element by element)."""
    elems, nbytes = (8, 16) if t.dtype == torch.bfloat16 else (1, 4)
    return t.stride(-1) == 1 and t.data_ptr() % nbytes == 0 and not any(
        st % elems for st, n in zip(t.stride()[:3], t.shape) if n > 1)


def flash_swa_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        do: torch.Tensor, *, lse: Optional[torch.Tensor] = None,
        causal: bool = True, window: int = 0, q_offset: Optional[int] = None,
        kv_len: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch B6's backward on CUDA tensors, given the forward's output
    ``o`` and log-sum-exp ``lse`` (``flash_swa_attention(..., lse=)``; the
    call raises without it); returns ``(dq, dk, dv)`` in the inputs' dtype.
    bf16 runs ``csrc/swa_backward_bf16.cu`` (tensor cores; operands that
    TMA cannot load are copied first), fp32 ``csrc/swa_backward.cu`` (CUDA
    cores; an operand without unit stride on d is copied first).  A launch
    error raises."""
    from repro_torch.kernels.build import check, library

    for t, name in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "dout")):
        require_kernel_operand(t, f"flash_attention backward {name}",
                               dtypes=KERNEL_DTYPES, contiguous=False)
    q_offset, kv_len = _check_args(q, k, v, window, q_offset, kv_len)
    _check_grad_args(q, o, do)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention backward kernel: head dim {D} is "
                         f"not one of {HEAD_DIMS}")
    if len({t.device for t in (q, k, v, o, do)}) != 1:
        raise ValueError("flash_attention backward: operands must share a "
                         "device")
    _check_lse(lse, q, "flash_attention backward")
    if B * Hkv > _MAX_BH:
        raise ValueError(f"flash_attention backward kernel: B * Hkv = "
                         f"{B * Hkv} > {_MAX_BH}")
    # autograd's dout may be any view
    q, k, v, o, do = (t if _loadable(t) else t.contiguous()
                      for t in (q, k, v, o, do))
    dq, dk, dv = _grad_like(q), _grad_like(k), _grad_like(v)
    if B == 0 or Sq == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # each row's Delta = sum_d dout o, written by the first launch
    delta = torch.empty((B * Hq * Sq,), dtype=torch.float32,
                        device=q.device)
    st = [ctypes.c_longlong(s) for t in (q, k, v, o, do, dq, dk, dv)
          for s in t.stride()[:3]]
    ptrs = [t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv, lse, delta)]
    tail = [B, Hq, Hkv, Sq, Skv, D, int(bool(causal)), int(window),
            ctypes.c_longlong(q_offset), kv_len]
    lib = library()
    launch = (lib.repro_flash_attention_bwd_bf16 if q.dtype == torch.bfloat16
              else lib.repro_flash_attention_bwd)
    status = launch(*ptrs, *st, *tail,
                    torch.cuda.current_stream(q.device).cuda_stream)
    launch_counts["flash_attention_bwd"] += 1
    if q.dtype == torch.float32:
        launch_counts["flash_attention_bwd_f32"] += 1
    check(status, "flash_attention backward")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """B6 under autograd: the forward launches ``flash_swa_attention`` with
    an ``lse`` buffer (its plain version, ``return_lse=True``, on CPU
    tensors) and saves q, k, v, the output and the LSE (4 bytes a query row
    and head: 2 MiB a layer of h2o-danube-1.8b at 2 x 8,192 tokens; under
    remat the checkpoint's rerun of the forward writes it again); the
    backward launches ``flash_swa_attention_backward`` on CUDA tensors and
    runs ``flash_swa_attention_backward_plain`` on CPU tensors, both with
    that LSE.  ``FlashAttention.apply(q, k, v, causal, window, q_offset,
    kv_len)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_len):
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  kv_len=kv_len)
        if q.device.type == "cuda":
            lse = torch.empty(q.shape[:3], dtype=torch.float32,
                              device=q.device)
            out = flash_swa_attention(q, k, v, lse=lse, **kw)
        else:
            out, lse = flash_swa_attention_plain(q, k, v, return_lse=True,
                                                 **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_swa_attention_backward if do.device.type == "cuda" \
            else flash_swa_attention_backward_plain
        dq, dk, dv = bwd(q, k, v, out, do.to(q.dtype), lse=lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None
