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
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import launch_counts, require_kernel_operand

__all__ = ["HEAD_DIMS", "flash_swa_attention", "flash_swa_attention_plain"]

HEAD_DIMS = (16, 32, 64, 80, 128)        # the kernel's instantiations
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_MAX_BH = 65535                          # B * Hkv rides grid.y
_PLAIN_CHUNK = 1 << 28                   # score elements per plain-version step


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
                              kv_len: Optional[int] = None) -> torch.Tensor:
    """Dense masked fp32 softmax attention, a block of query rows at a time
    (so that the scores of one step stay under ``_PLAIN_CHUNK`` elements)."""
    q_offset, kv_len = _check_args(q, k, v, window, q_offset, kv_len)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    dev = q.device
    qf = q.float().reshape(B, Hkv, g, Sq, D)
    kf, vf = k.float(), v.float()
    scale = 1.0 / D ** 0.5
    out = torch.empty((B, Hkv, g, Sq, D), dtype=torch.float32, device=dev)
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
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def flash_swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: Optional[int] = None,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Launch B6 on CUDA tensors; returns ``(B, Hq, Sq, D)`` in q's dtype."""
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
    out = torch.empty_like(q)        # q's strides where q is dense
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    # bf16 tiles move in 16-byte vectors, fp32 ones element by element
    bf16 = q.dtype == torch.bfloat16
    elems, nbytes = (8, 16) if bf16 else (1, 4)
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out")):
        if t.stride(-1) != 1 or t.data_ptr() % nbytes or any(
                st % elems for st, n in zip(t.stride()[:3], t.shape) if n > 1):
            raise ValueError(
                f"flash_attention kernel: {name} needs unit stride on d and "
                f"{nbytes}-byte aligned rows, got strides {t.stride()}")
    if B == 0 or Sq == 0:
        return out
    st = [ctypes.c_longlong(s) for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *st,
        B, Hq, Hkv, Sq, Skv, D, int(bool(causal)), int(window),
        ctypes.c_longlong(q_offset), kv_len,
        int(bf16), stream)
    launch_counts["flash_attention"] += 1
    check(status, "flash_attention")
    return out
