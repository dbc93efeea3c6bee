"""Cross-pod gradient compression: int8 quantization with error feedback
(the port of ``repro/train/grad_compression.py``).

Per-tensor symmetric int8 with scale ``max(max |x|, 1e-12) / 127``, rounded
half to even as ``jnp.round`` rounds.  ``compress_grads_crosspod``
quantizes and dequantizes every gradient (the information the cross-pod
reduction moves); ``psum_compressed`` moves real int8 payloads over a
``torch.distributed`` group, where the reference names a mesh axis: an
int32 sum of the payloads and a MAX of the scales.

The reference quantizes each logical tensor with one scale.  A rank of a
sharded step holds blocks: given the mesh and the leaves' specs,
``compress_grads_crosspod`` takes each sharded leaf's scale from the
largest |value| over all its blocks (one MAX all-reduce over the axes the
leaves are sharded on), so every rank quantizes its block as the logical
tensor would be; a replicated leaf's scale is the one its rank holds.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress_step",
           "compress_grads_crosspod", "logical_tops", "psum_compressed",
           "psum_rank", "crosspod_rank"]


def quantize_int8(x: torch.Tensor, top: torch.Tensor = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8; returns ``(q, scale)``, scale fp32.
    ``top``: the logical tensor's largest |value| where ``x`` is a block
    of it (default: ``x``'s own)."""
    xf = x.to(torch.float32)
    if top is None:
        top = torch.max(torch.abs(xf))
    scale = torch.clamp(top, min=1e-12) / 127.0
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


def compress_grads_crosspod(grads: Any, mesh=None, specs: Any = None,
                            tops: list = None) -> Any:
    """Quantize-dequantize every gradient leaf (back in its dtype), so the
    cross-pod all-reduce carries int8-equivalent information.  With a
    ``mesh`` and the leaves' ``specs`` (a tree of spec tuples, as
    ``distributed.sharding.param_shardings`` gives), each leaf is this
    rank's block of a logical tensor, quantized with that tensor's scale.
    The reference's ``pod_axis`` is not taken: the reduction over the pod
    axis is the step's (``train_step.reduce_grads``).  ``tops``: the
    leaves' ``logical_tops``, where the caller has them."""
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten

    leaves = tree_leaves(grads)
    if tops is None:
        tops = logical_tops(grads, mesh, specs)

    def qdq(g, top):
        q, s = quantize_int8(g, top)
        return dequantize_int8(q, s).to(g.dtype)

    return tree_unflatten(grads, [qdq(g, t) for g, t in zip(leaves, tops)])


def logical_tops(grads: Any, mesh=None, specs: Any = None) -> list:
    """Each leaf's largest |value| (fp32), in ``tree_leaves``' order; with
    a ``mesh`` and ``specs``, a sharded leaf's over all its blocks (one MAX
    all-reduce of the stacked values over each set of axes the leaves are
    sharded on, in one order on every rank)."""
    from repro_torch.train.optimizer import tree_leaves

    tops = [torch.max(torch.abs(g.to(torch.float32)))
            for g in tree_leaves(grads)]
    if mesh is None or specs is None:
        return tops
    from repro_torch.distributed import comm
    from repro_torch.distributed.sharding import axes_of, spec_leaves

    by_axes = {}
    for i, spec in enumerate(spec_leaves(grads, specs)):
        axes = tuple(a for a in mesh.axis_names
                     if any(a in axes_of(e) for e in spec))
        if axes:
            by_axes.setdefault(axes, []).append(i)
    for axes, idx in sorted(by_axes.items()):
        top = comm.all_reduce_max(torch.stack([tops[i] for i in idx]),
                                  mesh.group_of(*axes))
        for i, t in zip(idx, top.unbind(0)):
            tops[i] = t
    return tops


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


def crosspod_rank(group, device, shape, arrays, specs) -> Any:
    """Rank function for ``distributed.launch.spawn``: the blocks of the
    logical numpy ``arrays`` under ``specs`` (name -> spec tuple) on a
    (pod, data, model) mesh of ``shape``, compressed as a sharded step
    compresses them; on the mesh's first rank the logical results
    (gathered, numpy) and every rank's scale of each leaf."""
    from repro_torch.distributed import comm, launch, sharding

    mesh = launch.make_mesh(group, shape)
    blocks = {k: sharding.own_block(torch.from_numpy(np.asarray(v)).to(
        device), specs[k], mesh) for k, v in arrays.items()}
    tops = logical_tops(blocks, mesh, dict(specs))
    out = compress_grads_crosspod(blocks, tops=tops)
    scales = {k: comm.all_gather_cat(
        (torch.clamp(t, min=1e-12) / 127.0).reshape(1), mesh.group)
        for k, t in zip(sorted(blocks), tops)}
    whole = sharding.gather_tree(out, dict(specs), mesh)
    if dist.get_rank(group) != 0:
        return None
    return {"out": {k: v.cpu().numpy() for k, v in whole.items()},
            "scales": {k: v.cpu().numpy() for k, v in scales.items()}}
