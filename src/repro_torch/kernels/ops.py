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
           "segmented_scan", "predicate_bitset", "flash_attention",
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

    As the reference dispatches on the mask's dtype: an int32 ``mask`` is
    the packed ``ceil(n/32)``-word keep-mask (the reference's uint32 words,
    B2); any other dtype is a ``(n,)`` row mask read as bool (the
    reference's ``mask.astype(bool)``, B2b)."""
    if mask.dtype == torch.int32:
        out, cnt = filter_compact_table({"v": vals}, mask)
        return out["v"], cnt
    mask = mask.to(torch.bool)
    if mask.shape != vals.shape[:1]:
        raise ValueError(f"filter_compact: {vals.shape[0]} rows need a "
                         f"({vals.shape[0]},) mask, got {tuple(mask.shape)}")
    if mask.device.type == "cuda":
        out, cnt = _fc.filter_compact_mask([vals], mask)
    else:
        out, cnt = _fc.filter_compact_mask_plain([vals], mask)
    return out[0], cnt


def hash_partition_plan(keys: torch.Tensor, valid: torch.Tensor,
                        n_dest: int, block: int = _hp.DEFAULT_BLOCK):
    """Shuffle plan: ``(dest (n,), rank-within-block (n,), hist
    (ceil(n/block), n_dest))``.  ``valid`` is the table's packed int32
    validity words (a row mask raises ``TypeError``: ``bitset.pack`` it)."""
    if valid.dtype != torch.int32:
        raise TypeError(f"valid must be packed int32 validity words, got "
                        f"{valid.dtype}")
    if keys.device.type == "cuda":
        return _hp.hash_partition_plan_kernel(keys, valid, n_dest, block)
    return _hp.hash_partition_plan_plain(keys, valid, n_dest, block)


def bitset_op(a: torch.Tensor, b: torch.Tensor, op: str):
    """Fused bitwise op + total popcount; returns ``(words, count)``."""
    if a.device.type == "cuda":
        return _bo.bitset_op_popcount(a, b, op)
    return _bo.bitset_op_plain(a, b, op)


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
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Flash attention (GQA, causal, sliding window) in the reference's
    ``(B, H, S, D)`` layout; ``q_offset`` defaults to ``kv_len - Sq`` and
    ``kv_len`` (keys at or past it are never attended) to ``Skv``."""
    if q.device.type == "cuda":
        return _swa.flash_swa_attention(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset, kv_len=kv_len)
    return _swa.flash_swa_attention_plain(q, k, v, causal=causal,
                                          window=window, q_offset=q_offset,
                                          kv_len=kv_len)
