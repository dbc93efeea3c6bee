"""B5: the shuffle's plan — per row a destination shard, the row's rank
among its block's rows bound for the same destination, and per-block
histograms.

``hash_partition_plan_kernel`` launches ``csrc/hash_partition.cu`` (the port
of ``repro/kernels/hash_partition.py:hash_partition_plan``) on a CUDA key
column and the table's packed validity words;
``hash_partition_plan_plain`` is its plain PyTorch version.  Both return
``(dest (n,), rank (n,), hist (ceil(n/block), n_dest))``, int32: invalid
rows get ``dest = n_dest`` and rank 0 and are counted in no histogram.
``hash_dest`` is the hash itself, shared with the ``torch`` engine's
argsort route in ``core.flattening.hash_partition``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import bitset as _bs
from repro_torch.kernels import launch_counts, require_kernel_operand

__all__ = ["DEFAULT_BLOCK", "MUL", "max_dest", "hash_dest",
           "hash_partition_plan_plain", "hash_partition_plan_kernel"]

DEFAULT_BLOCK = 512
MUL = 0x9E3779B1
_M32 = 0xFFFFFFFF
_SMEM_BYTES = 48 * 1024        # per-warp histograms: (block/32) x n_dest ints


def max_dest(block: int) -> int:
    """The most destinations the kernel's shared memory holds at ``block``."""
    return _SMEM_BYTES // (4 * (block // 32))


def hash_dest(keys: torch.Tensor, valid: torch.Tensor,
              n_dest: int) -> torch.Tensor:
    """``((k * 0x9E3779B1) ^ (>> 16)) % n_dest`` over the keys' uint32
    patterns (negative int32 keys wrap), ``n_dest`` where ``valid`` (a
    ``(n,) bool`` mask) is False; int32.  In int64 with the product split
    at 16 bits, since torch's CPU uint32 has no ``*`` or ``%``."""
    k = keys.to(torch.int64) & _M32
    h = ((k & 0xFFFF) * MUL + ((((k >> 16) * MUL) & 0xFFFF) << 16)) & _M32
    h = h ^ (h >> 16)
    return torch.where(valid, h % n_dest, n_dest).to(torch.int32)


def _check_args(n_dest: int, block: int) -> None:
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"hash_partition block must be a multiple of 32 in "
                         f"[32, 1024], got {block}")
    if not 1 <= n_dest <= max_dest(block):
        raise ValueError(f"hash_partition: n_dest must be in [1, "
                         f"{max_dest(block)}] at block {block}, got {n_dest}")


def _check_words(keys: torch.Tensor, words: torch.Tensor) -> None:
    n = keys.shape[0]
    if keys.dim() != 1 or words.dtype != torch.int32 \
            or words.shape != (_bs.n_words(n),) or words.device != keys.device:
        raise ValueError(f"hash_partition: {n} keys need {_bs.n_words(n)} "
                         f"int32 validity words on their device, got "
                         f"{words.dtype} {tuple(words.shape)}")


def hash_partition_plan_plain(keys: torch.Tensor, words: torch.Tensor,
                              n_dest: int, block: int = DEFAULT_BLOCK
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dest, in-block rank, per-block histogram) from the keys and packed
    validity ``words``.  The rank is a row's place among the rows of its
    (block, dest) group in a stable sort on that pair."""
    _check_args(n_dest, block)
    _check_words(keys, words)
    n = keys.shape[0]
    dev = keys.device
    valid = _bs.unpack(words, n)
    dest = hash_dest(keys, valid, n_dest)
    n_blocks = -(-n // block)
    blk = torch.arange(n, dtype=torch.int64, device=dev) // block
    group = blk * (n_dest + 1) + dest.to(torch.int64)
    order = torch.argsort(group, stable=True)
    gs = group[order].contiguous()
    first = torch.searchsorted(gs, gs, side="left")
    rank = torch.empty((n,), dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, dtype=torch.int64, device=dev) - first
    rank = torch.where(valid, rank, 0).to(torch.int32)
    cell = (blk * n_dest + dest.to(torch.int64))[valid]
    hist = torch.bincount(cell, minlength=n_blocks * n_dest)
    return dest, rank, hist.to(torch.int32).reshape(n_blocks, n_dest)


def hash_partition_plan_kernel(keys: torch.Tensor, words: torch.Tensor,
                               n_dest: int, block: int = DEFAULT_BLOCK
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Launch B5 on a CUDA int32 key column and its ``ceil(n/32)`` int32
    validity words."""
    from repro_torch.kernels.build import check, library

    _check_args(n_dest, block)
    require_kernel_operand(keys, "hash_partition keys", dtypes=(torch.int32,))
    require_kernel_operand(words, "hash_partition words",
                           dtypes=(torch.int32,))
    _check_words(keys, words)
    n = keys.shape[0]
    n_blocks = -(-n // block)
    dev = keys.device
    dest = torch.empty((n,), dtype=torch.int32, device=dev)
    rank = torch.empty((n,), dtype=torch.int32, device=dev)
    hist = torch.empty((n_blocks, n_dest), dtype=torch.int32, device=dev)
    if n == 0:
        return dest, rank, hist
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = library().repro_hash_partition(
        keys.data_ptr(), words.data_ptr(), ctypes.c_longlong(n), n_dest,
        block, dest.data_ptr(), rank.data_ptr(), hist.data_ptr(), stream)
    launch_counts["hash_partition_plan"] += 1
    check(status, "hash_partition_plan")
    return dest, rank, hist
