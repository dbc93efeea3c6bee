"""The collectives of the sharded paths over a ``torch.distributed``
process group: the study's exchange (all-to-all), the sums of counts, stats
and cohort bitsets and the gather of a sharded table where a caller asks
for the whole of it (``ShardedTable.gather``); and, for the sharded models,
collectives that autograd differentiates (``copy_to``, ``reduce_from``,
``gather``, ``ppermute``).

The group's backend decides the transport.  NCCL takes CUDA tensors
directly.  Gloo moves host tensors only for these collectives, and it is
what several ranks sharing one card must use (NCCL refuses two ranks on one
device), so under gloo a CUDA tensor is staged through pinned host memory
around the collective.  That is the collective's transport, not a fallback:
every kernel still runs on the card.  ``stats`` counts the collectives (in
all and by kind; ``objects`` are the small pickled host objects the sharded
query service agrees on), each tensor kind's bytes (``<kind>_bytes``: the
bytes of its results, as the reference's dry run sums an HLO collective's
result shape: a gather's whole output, a ppermute's tensor on every rank,
whether or not one was sent to it) and the staging's bytes and host
seconds (``reset_stats`` sets them to 0).  A collective on meta tensors is
counted like any other (the dry run, ``launch.dryrun``).

The differentiable ones follow Megatron's convention for a tensor that is
whole on every rank of a model group (replicated) and the rank-specific
work done with it: ``copy_to`` (identity forward, sum backward) marks where
a replicated tensor enters rank-specific work, whose gradients are
partial; ``reduce_from`` (sum forward, identity backward) turns partial
results into a replicated one.  ``torch.distributed.nn.functional.
all_reduce`` is not ``reduce_from``: its backward sums gradients that are
already replicated, which multiplies them by the group's size.
"""
from __future__ import annotations

import math
import time
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["world_size", "group_key", "all_to_all", "all_reduce_sum",
           "all_reduce_max",
           "all_gather_cat", "all_gather_object", "broadcast_object",
           "all_gather_dim", "copy_to", "reduce_from", "gather", "exchange",
           "ppermute",
           "stats", "reset_stats"]

KINDS = ("all_to_all", "all_reduce", "all_gather", "ppermute")

stats = {}


def reset_stats() -> None:
    stats.update(collectives=0, **{k: 0 for k in KINDS}, objects=0,
                 staged_bytes=0, staging_s=0.0,
                 **{k + "_bytes": 0 for k in KINDS})


reset_stats()


def _count(kind: str, nbytes: int = 0) -> None:
    stats["collectives"] += 1
    stats[kind] += 1
    if kind in KINDS:
        stats[kind + "_bytes"] += nbytes


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


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
    n = dist.get_world_size(group)
    return _exchange(x, group, [1] * n, [1] * n)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum over ranks (``jax.lax.psum``), as a new tensor."""
    _count("all_reduce", _nbytes(x))
    if _staged(x, group):
        host = _to_host(x)
        dist.all_reduce(host, group=group)
        return _to_device(host, x.device)
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over ranks (``jax.lax.pmax``), as a new tensor."""
    _count("all_reduce", _nbytes(x))
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
    n = dist.get_world_size(group)
    _count("all_gather", n * _nbytes(x))
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


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated in rank order along
    ``dim``."""
    if dist.get_world_size(group) == 1:
        return x
    out = all_gather_cat(x.movedim(dim, 0), group)
    return out.movedim(0, dim).contiguous()


def _own_chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    return x.chunk(n, dim)[dist.get_rank(group)].contiguous()


def _exchange(x: torch.Tensor, group, send: Sequence[int],
              recv: Sequence[int], kind: str = "all_to_all",
              nbytes: int = None) -> torch.Tensor:
    """An all-to-all over the leading axis with uneven splits: rank ``t``
    gets the next ``send[t]`` rows of ``x``; the result holds ``recv[s]``
    rows from each rank ``s``, in rank order.  ``nbytes``: the bytes to
    count for it (default: the result's)."""
    x = x.contiguous()
    shape = (sum(recv),) + tuple(x.shape[1:])
    _count(kind, sum(recv) * math.prod(x.shape[1:]) * x.element_size()
           if nbytes is None else nbytes)
    staged = _staged(x, group)
    src = _to_host(x) if staged else x
    out = torch.empty(shape, dtype=x.dtype, device=src.device,
                      pin_memory=staged)
    dist.all_to_all_single(out, src, list(recv), list(send), group=group)
    return _to_device(out, x.device) if staged else out


def _ppermute(x: torch.Tensor, group, pairs: Sequence[Tuple[int, int]]
              ) -> torch.Tensor:
    """``jax.lax.ppermute``: rank ``dst`` receives rank ``src``'s ``x`` for
    each ``(src, dst)`` of ``pairs`` (group ranks); a rank no pair sends to
    receives zeros."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    dst = [d for s, d in pairs if s == me]
    src = [s for s, d in pairs if d == me]
    flat = x.reshape(1, -1)
    out = _exchange(flat if dst else flat[:0], group,
                    [int(bool(dst) and t == dst[0]) for t in range(n)],
                    [int(bool(src) and t == src[0]) for t in range(n)],
                    kind="ppermute", nbytes=_nbytes(x))
    return out.reshape(x.shape) if src else torch.zeros_like(x)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        if x.dtype in (torch.bfloat16, torch.float16):
            # the partials meet in fp32 and are rounded once, as one
            # product's fp32 accumulation would be
            return all_reduce_sum(x.float(), group).to(x.dtype)
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, partial):
        ctx.group, ctx.dim, ctx.partial = group, dim, partial
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:          # reduce-scatter: sum, then the own block
            g = all_reduce_sum(g.contiguous(), ctx.group)
        return _own_chunk(g, ctx.group, ctx.dim), None, None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.group, ctx.send, ctx.recv = group, send, recv
        return _exchange(x, group, send, recv)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.recv, ctx.send), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pairs):
        ctx.group, ctx.pairs = group, pairs
        return _ppermute(x, group, pairs)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.pairs)
        return _ppermute(g, ctx.group, inverse), None, None


def _trivial(group) -> bool:
    return dist.get_world_size(group) == 1


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, sum over ``group`` backward: a replicated tensor
    entering rank-specific work."""
    return x if _trivial(group) else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward (in fp32 for half types), identity
    backward: partial results made whole (``psum`` of partials whose
    gradient is replicated)."""
    return x if _trivial(group) else _ReduceFrom.apply(x, group)


def gather(x: torch.Tensor, group, dim: int, partial: bool = True
           ) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim``.  Backward: where the
    gathered tensor feeds rank-specific work (``partial``, the default) its
    gradient is partial and is reduce-scattered (summed, then each rank
    keeps its block); where every rank uses it alike (``partial=False``)
    its gradient is replicated and each rank keeps its block of it."""
    return x if _trivial(group) else _Gather.apply(x, group, dim, partial)


def exchange(x: torch.Tensor, group, send: Sequence[int],
             recv: Sequence[int]) -> torch.Tensor:
    """An all-to-all with uneven splits over the leading axis (``send[t]``
    rows to rank ``t``, ``recv[s]`` rows from rank ``s``); its backward
    sends the gradient back the same way."""
    if _trivial(group):
        return x
    return _Exchange.apply(x, group, tuple(send), tuple(recv))


def ppermute(x: torch.Tensor, group, pairs: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """``jax.lax.ppermute`` over ``group`` (``(src, dst)`` pairs of group
    ranks); its backward sends the gradient along the inverse pairs."""
    return _PPermute.apply(x, group, tuple(tuple(p) for p in pairs))
