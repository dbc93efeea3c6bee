"""The collectives of the sharded study path over a ``torch.distributed``
process group: the exchange's all-to-all, the sums of counts, stats and
cohort bitsets, and the gather of a sharded table where a caller asks for
the whole of it (``ShardedTable.gather``).

The group's backend decides the transport.  NCCL takes CUDA tensors
directly.  Gloo moves host tensors only for these collectives, and it is
what several ranks sharing one card must use (NCCL refuses two ranks on one
device), so under gloo a CUDA tensor is staged through pinned host memory
around the collective.  That is the collective's transport, not a fallback:
every kernel still runs on the card.  ``stats`` counts the collectives (in
all and by kind; ``objects`` are the small pickled host objects the sharded
query service agrees on) and the staging's bytes and host seconds
(``reset_stats`` sets them to 0).
"""
from __future__ import annotations

import time
import torch
import torch.distributed as dist

__all__ = ["world_size", "group_key", "all_to_all", "all_reduce_sum",
           "all_reduce_max",
           "all_gather_cat", "all_gather_object", "broadcast_object",
           "stats", "reset_stats"]

stats = {"collectives": 0, "all_to_all": 0, "all_reduce": 0,
         "all_gather": 0, "objects": 0, "staged_bytes": 0, "staging_s": 0.0}


def reset_stats() -> None:
    stats.update(collectives=0, all_to_all=0, all_reduce=0, all_gather=0,
                 objects=0, staged_bytes=0, staging_s=0.0)


def _count(kind: str) -> None:
    stats["collectives"] += 1
    stats[kind] += 1


def world_size(group) -> int:
    """The shard count of a process group (raises TypeError for anything
    else passed as a mesh)."""
    if not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"mesh must be a torch.distributed process group, "
                        f"got {type(group).__name__}")
    return dist.get_world_size(group)


def group_key(group) -> tuple:
    """The group's size and global ranks, for cache keys (the reference
    keys its executables on the mesh's content)."""
    return (dist.get_world_size(group),
            tuple(dist.get_process_group_ranks(group)))


def _staged(x: torch.Tensor, group) -> bool:
    return x.device.type == "cuda" and dist.get_backend(group) != "nccl"


def all_gather_object(obj, group) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank (the
    sharded query service's agreement on admission and cache decisions)."""
    _count("objects")
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj, group, src: int = 0):
    """The picklable ``obj`` of the group's rank ``src``, on every rank."""
    _count("objects")
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src),
                               group=group)
    return box[0]


def _to_host(x: torch.Tensor) -> torch.Tensor:
    t0 = time.perf_counter()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    stats["staging_s"] += time.perf_counter() - t0
    stats["staged_bytes"] += x.numel() * x.element_size()
    return host


def _to_device(host: torch.Tensor, device) -> torch.Tensor:
    t0 = time.perf_counter()
    out = host.to(device)
    stats["staging_s"] += time.perf_counter() - t0
    stats["staged_bytes"] += host.numel() * host.element_size()
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``recv[s] = send_s[me]`` over the leading axis, which has one slot
    per rank (``jax.lax.all_to_all(x, axis, 0, 0)``)."""
    _count("all_to_all")
    x = x.contiguous()
    if _staged(x, group):
        send = _to_host(x)
        recv = torch.empty_like(send, pin_memory=True)
        dist.all_to_all_single(recv, send, group=group)
        return _to_device(recv, x.device)
    recv = torch.empty_like(x)
    dist.all_to_all_single(recv, x, group=group)
    return recv


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum over ranks (``jax.lax.psum``), as a new tensor."""
    _count("all_reduce")
    if _staged(x, group):
        host = _to_host(x)
        dist.all_reduce(host, group=group)
        return _to_device(host, x.device)
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over ranks (``jax.lax.pmax``), as a new tensor."""
    _count("all_reduce")
    if _staged(x, group):
        host = _to_host(x)
        dist.all_reduce(host, op=dist.ReduceOp.MAX, group=group)
        return _to_device(host, x.device)
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated in rank order along
    the leading axis."""
    _count("all_gather")
    n = dist.get_world_size(group)
    x = x.contiguous()
    if _staged(x, group):
        send = _to_host(x)
        recv = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                           pin_memory=True)
        dist.all_gather(list(recv.unbind(0)), send, group=group)
        return _to_device(recv, x.device).reshape((-1,) + tuple(x.shape[1:]))
    recv = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather(list(recv.unbind(0)), x, group=group)
    return recv.reshape((-1,) + tuple(x.shape[1:]))
