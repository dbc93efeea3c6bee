"""Public wrappers around the CUDA kernels.

Each wrapper takes the kernel for CUDA tensors and the kernel's plain
PyTorch version for CPU tensors, chosen by the device of the data alone: a
CUDA tensor launches the kernel or raises, and nothing falls back.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import bitset as _bs
from repro_torch.kernels import bitset_ops as _bo
from repro_torch.kernels import filter_compact as _fc
from repro_torch.kernels import hash_partition as _hp
from repro_torch.kernels import segment_scan as _ss
from repro_torch.kernels import swa_attention as _swa
from repro_torch.kernels.predicate import predicate_bitset  # noqa: F401 (re-export)

__all__ = ["filter_compact", "filter_compact_table", "bitset_op",
           "bitset_expr", "segmented_scan", "predicate_bitset", "flash_attention",
           "hash_partition_plan"]


def filter_compact_table(columns: Dict[str, torch.Tensor], words: torch.Tensor
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Compact every column of a table by its packed keep-mask in one pass;
    returns ``(columns, count)`` with slots past ``count`` zero (the
    reference's ``ops.filter_compact`` semantics, column by column)."""
    names = list(columns)
    cols = [columns[n] for n in names]
    if words.device.type == "cuda":
        out, cnt = _fc.filter_compact_bits(cols, words)
    else:
        out, cnt = _fc.filter_compact_plain(cols, words)
    return dict(zip(names, out)), cnt


def filter_compact(vals: torch.Tensor, mask: torch.Tensor):
    """Compact ``vals[mask]`` to the front; returns ``(vals, count)``, slots
    past ``count`` zero.

    The mask's dtype chooses, as the reference's does: a ``torch.uint32``
    mask is the packed ``ceil(n/32)``-word keep-mask (the reference's uint32
    words, B2; a table's int32 ``valid`` words go in as
    ``valid.view(torch.uint32)``), and every other dtype (``bool``,
    ``int8``, ``int32``, ...) is a ``(n,)`` row mask read as ``mask != 0``
    (the reference's ``mask.astype(bool)``, B2b)."""
    if mask.dtype == torch.uint32:
        out, cnt = filter_compact_table({"v": vals}, mask.view(torch.int32))
        return out["v"], cnt
    mask = _row_mask(mask, vals.shape[0], "filter_compact")
    if mask.device.type == "cuda":
        out, cnt = _fc.filter_compact_mask([vals], mask)
    else:
        out, cnt = _fc.filter_compact_mask_plain([vals], mask)
    return out[0], cnt


def _row_mask(mask: torch.Tensor, n: int, what: str) -> torch.Tensor:
    """A ``(n,)`` row mask of any dtype as bool (``mask != 0``)."""
    if mask.shape != (n,):
        raise ValueError(f"{what}: {n} rows need a ({n},) mask (or packed "
                         f"torch.uint32 words), got {tuple(mask.shape)}")
    return mask if mask.dtype == torch.bool else mask != 0


def hash_partition_plan(keys: torch.Tensor, valid: torch.Tensor,
                        n_dest: int, block: int = _hp.DEFAULT_BLOCK):
    """Shuffle plan: ``(dest (n,), rank-within-block (n,), hist
    (ceil(n/block), n_dest))``.  ``valid`` is, as in ``filter_compact``,
    packed ``torch.uint32`` words (a table's ``valid.view(torch.uint32)``)
    or a ``(n,)`` row mask of any other dtype (the reference's form), which
    is packed first."""
    if valid.dtype == torch.uint32:
        words = valid.view(torch.int32)
    else:
        words = _bs.pack(_row_mask(valid, keys.shape[0],
                                   "hash_partition_plan"))
    if keys.device.type == "cuda":
        return _hp.hash_partition_plan_kernel(keys, words, n_dest, block)
    return _hp.hash_partition_plan_plain(keys, words, n_dest, block)


def bitset_op(a: torch.Tensor, b: torch.Tensor, op: str):
    """Fused bitwise op + total popcount (the one-op program of
    ``bitset_expr``); returns ``(words, count)``, ``count`` 0-d int32."""
    if a.device.type == "cuda":
        return _bo.bitset_op_popcount(a, b, op)
    return _bo.bitset_op_plain(a, b, op)


def bitset_expr(leaves, program):
    """A program of up to 8 bitwise ops over up to 8 leaf word vectors
    (``kernels.bitset_ops``) in one launch; returns ``(words (n_ops, n),
    counts (n_ops,) int32)``."""
    if leaves[0].device.type == "cuda":
        return _bo.bitset_expr_kernel(leaves, program)
    return _bo.bitset_expr_plain(leaves, program)


def segmented_scan(flags: torch.Tensor, vals: torch.Tensor, block: int = 512,
                   fill: Tuple[int, int] = _ss.DEFAULT_FILL):
    """Inclusive segmented (min, max, count) scan; ``(n,) bool`` flags start
    runs.  The default ``fill`` is the reference kernel's (its ``±2e9`` clamp
    at block edges); ``segment_scan.EXACT_FILL`` gives exact run aggregates."""
    words = _bs.pack(flags.to(torch.bool))
    if vals.device.type == "cuda":
        return _ss.segmented_scan_kernel(words, vals, block, fill)
    return _ss.segmented_scan_plain(words, vals, block, fill)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: Optional[int] = None,
                    kv_len: Optional[int] = None, return_lse: bool = False,
                    out_dtype=None):
    """Flash attention (GQA, causal, sliding window) in the reference's
    ``(B, H, S, D)`` layout; ``q_offset`` defaults to ``kv_len - Sq`` and
    ``kv_len`` (keys at or past it are never attended) to ``Skv``.  Where
    autograd records (grad mode on, an input that requires grad) the call
    goes through ``swa_attention.FlashAttention``, whose backward is B6's
    backward kernel on CUDA tensors (its plain version on CPU tensors).
    ``return_lse`` (not under autograd) returns ``(out, lse)``, each row's
    log-sum-exp ``(B, Hq, Sq)`` fp32, 0 for a row that sees no key, from
    either of B6's routes, the output in ``out_dtype`` (default q's;
    ``torch.float32``: the decode route's sums unrounded)."""
    records = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                           or v.requires_grad)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    if return_lse:
        if records:
            raise ValueError("flash_attention(return_lse=True) is for calls "
                             "autograd does not record")
        if q.device.type != "cuda":
            return _swa.flash_swa_attention_plain(q, k, v, return_lse=True,
                                                  out_dtype=out_dtype, **kw)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        return _swa.flash_swa_attention(q, k, v, lse=lse, out_dtype=out_dtype,
                                        **kw), lse
    if records:
        return _swa.FlashAttention.apply(q, k, v, causal, window, q_offset,
                                         kv_len)
    if q.device.type == "cuda":
        return _swa.flash_swa_attention(q, k, v, **kw)
    return _swa.flash_swa_attention_plain(q, k, v, **kw)
