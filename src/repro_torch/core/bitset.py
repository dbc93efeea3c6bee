"""Packed row-validity bitset: ONE layout shared by the whole port.

Row/subject ``i`` lives at word ``i // 32``, bit ``i % 32`` (LSB-first) — the
layout of ``repro.core.bitset``, which the CUDA kernels (``kernels/``) read
and write directly.  Words are carried as ``torch.int32`` bit patterns:
torch's ``uint32`` lacks ``~``, ``>>``, ``<<`` and ``%`` on the CPU, while
int32 has them all and stores the identical 32 bits.  Compare words with the
reference through ``.cpu().numpy().view(np.uint32)``.

Invariant: bits at positions >= the logical length are always ZERO ("tail
bits clear"); word-wise consumers (AND/OR/ANDNOT, popcount) rely on it.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "WORD_BITS", "n_words", "pack", "unpack", "unpack_np", "count",
    "popcount", "first_n", "bit_at", "is_packed", "to_int32",
]

WORD_BITS = 32
_M32 = 0xFFFFFFFF


def n_words(n_bits: int) -> int:
    """Words needed to hold ``n_bits`` bits."""
    return (int(n_bits) + WORD_BITS - 1) // WORD_BITS


def is_packed(valid) -> bool:
    """True when ``valid`` is a packed word tensor (int32) rather than a
    per-row bool mask."""
    return isinstance(valid, torch.Tensor) and valid.dtype == torch.int32


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """Wrap an int64 tensor holding 32-bit patterns into int32 (mod 2**32)."""
    x = x & _M32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def pack(mask: torch.Tensor) -> torch.Tensor:
    """Pack a ``(n,) bool`` row mask into ``ceil(n/32)`` int32 words, tail
    bits clear."""
    n = mask.shape[0]
    pad = (-n) % WORD_BITS
    m = torch.nn.functional.pad(mask.to(torch.int64), (0, pad))
    weights = torch.ones((), dtype=torch.int64, device=mask.device) << \
        torch.arange(WORD_BITS, dtype=torch.int64, device=mask.device)
    return to_int32((m.reshape(-1, WORD_BITS) * weights).sum(dim=1))


def unpack(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Expand packed words back to a ``(n_bits,) bool`` row mask."""
    lanes = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[:, None] >> lanes[None, :]) & 1
    return bits.to(torch.bool).reshape(-1)[:n_bits]


def unpack_np(words: np.ndarray, n_bits: int) -> np.ndarray:
    """Host-side ``unpack`` (numpy; accepts int32 or uint32 words)."""
    w = np.asarray(words).view(np.uint32) if np.asarray(words).dtype == \
        np.int32 else np.asarray(words, np.uint32)
    bits = (w[:, None] >> np.arange(WORD_BITS, dtype=np.uint32)[None, :]) & 1
    return bits.astype(bool).reshape(-1)[:n_bits]


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count (SWAR over int64), as int32."""
    w = words.to(torch.int64) & _M32
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return (((w * 0x01010101) & _M32) >> 24).to(torch.int32)


def count(words: torch.Tensor) -> torch.Tensor:
    """Total population count (0-d int32 tensor)."""
    return popcount(words).sum().to(torch.int32)


def first_n(cnt, capacity: int, device=None) -> torch.Tensor:
    """Packed form of ``arange(capacity) < cnt``, computed word-wise.

    ``cnt`` is an int or a 0-d tensor (no host sync); ``device`` defaults to
    the tensor's.  Requires ``cnt <= capacity``."""
    if isinstance(cnt, torch.Tensor):
        device = cnt.device if device is None else device
        cnt = cnt.to(device=device, dtype=torch.int64)
    base = torch.arange(n_words(capacity), dtype=torch.int64,
                        device=device) * WORD_BITS
    rem = torch.clamp(cnt - base, 0, WORD_BITS)
    part = (torch.ones_like(rem) << torch.clamp(rem, max=WORD_BITS - 1)) - 1
    return to_int32(torch.where(rem >= WORD_BITS, _M32, part))


def bit_at(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gathered bit test ``mask[idx]`` straight from the packed words."""
    i = idx.to(torch.int64)
    w = words[i >> 5]
    return ((w >> (i & 31).to(torch.int32)) & 1).to(torch.bool)
