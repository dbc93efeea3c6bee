"""Cross-pod gradient compression: int8 quantization with error feedback
(the port of ``repro/train/grad_compression.py``).

Per-tensor symmetric int8 with scale ``max(max |x|, 1e-12) / 127``, rounded
half to even as ``jnp.round`` rounds.  ``compress_grads_crosspod``
quantizes and dequantizes every gradient (the information the cross-pod
reduction moves); ``psum_compressed`` moves real int8 payloads over a
``torch.distributed`` group, where the reference names a mesh axis: an
int32 sum of the payloads and a MAX of the scales.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.interop import tree_map

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress_step",
           "compress_grads_crosspod", "psum_compressed", "psum_rank"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8; returns ``(q, scale)``, scale fp32."""
    xf = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_step(g: torch.Tensor, err: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback step: compress ``g + err``; returns
    ``(decompressed, new_err)``."""
    target = g.to(torch.float32) + err
    q, s = quantize_int8(target)
    deq = dequantize_int8(q, s)
    return deq, target - deq


def compress_grads_crosspod(grads: Any, pod_axis=None) -> Any:
    """Quantize-dequantize every gradient leaf (back in its dtype), so the
    cross-pod all-reduce carries int8-equivalent information."""
    def qdq(g):
        q, s = quantize_int8(g)
        return dequantize_int8(q, s).to(g.dtype)

    return tree_map(qdq, grads)


def psum_compressed(g: torch.Tensor, group) -> torch.Tensor:
    """Sum ``g`` over the ranks of ``group`` with an int8 payload: every
    rank quantizes, the int32 payloads are summed (exact at pod counts)
    and the scales reduced by MAX (a conservative shared scale); returns
    the fp32 ``sum(q) * max(scale)``."""
    from repro_torch.distributed import comm

    q, s = quantize_int8(g)
    total = comm.all_reduce_sum(q.to(torch.int32), group)
    scale = comm.all_reduce_max(s.reshape(1), group)[0]
    return total.to(torch.float32) * scale


def psum_rank(group, device, arrays) -> np.ndarray:
    """Rank function for ``distributed.launch.spawn``: ``psum_compressed``
    of this rank's entry of ``arrays`` (numpy, one a rank)."""
    rank = dist.get_rank(group)
    g = torch.from_numpy(np.asarray(arrays[rank])).to(device)
    return psum_compressed(g, group).cpu().numpy()
