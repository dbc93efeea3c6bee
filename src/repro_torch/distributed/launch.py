"""Spawn the ranks of one ``torch.distributed`` process group on one host.

``spawn(fn, n, args, device=...)`` starts ``n`` processes with the
``spawn`` start method (never ``fork``: the parent may hold a CUDA
context), joins them through a ``FileStore`` in ``store_dir``, runs
``fn(group, device, *args)`` on every rank and returns the ranks' results
in rank order.  ``device`` defaults to the card, as every entry point of
the port does, and raises without CUDA; pass ``device="cpu"`` to run the
ranks on the CPU.  ``fn`` must be importable from a module (it is pickled by
name); its result must be picklable host data.  Every rank uses the one
given device and one CPU thread: several ranks may share one card, which
NCCL refuses, so the group's backend is gloo.  On a CUDA device a rank
loads the kernel library the parent built (``build.library()`` before
``spawn``) and never builds it itself.

``study_rank``, ``flatten_rank`` and ``exposures_rank`` are the rank
functions of the sharded study path, and ``service_rank`` that of the
sharded query service: they take numpy tables, run one entry point sharded
over the group, gather its table outputs (``ShardedTable.gather``) and
return numpy results; ``tasks_rank`` runs several of them in one job.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.columnar import resolve_device

__all__ = ["spawn", "tasks_rank", "study_rank", "service_rank",
           "flatten_rank", "exposures_rank", "result_to_numpy", "blocks"]


def _rank_main(rank: int, n: int, store_path: str, device: str,
               timeout: float, fn: Callable, args: Tuple, results) -> None:
    try:
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            from repro_torch.kernels import build

            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
            build.load_built()
        store = dist.FileStore(store_path, n)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(dist.group.WORLD, dev, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:      # SystemExit too: the parent reports it
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, n: int, args: Sequence = (), device=None,
          timeout: float = 600.0, store_dir: str = None) -> List[Any]:
    """Run ``fn(group, device, *args)`` on ``n`` spawned ranks; their
    results in rank order.  Raises ``RuntimeError`` with the rank's
    traceback as soon as one rank fails, and ``TimeoutError`` past
    ``timeout`` seconds; either way every rank is stopped."""
    device = resolve_device(device)
    ctx = mp.get_context("spawn")
    own_dir = store_dir is None
    store_dir = tempfile.mkdtemp() if own_dir else store_dir
    store_path = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, store_path, str(device), timeout, fn,
                               tuple(args), results),
                         daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < n:
            try:
                r, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank exited with code {dead[0]} "
                                       f"and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks did not finish within "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} of {n} failed:\n{payload}")
            out[r] = payload
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == n else 1)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
        if own_dir:
            for f in os.listdir(store_dir):
                os.remove(os.path.join(store_dir, f))
            os.rmdir(store_dir)
    return [out[r] for r in range(n)]


def tasks_rank(group, device, tasks: Sequence[Tuple[Callable, Tuple]]
               ) -> List[Any]:
    """``[fn(group, device, *args) for fn, args in tasks]`` on one rank."""
    return [fn(group, device, *args) for fn, args in tasks]


def result_to_numpy(res) -> Dict[str, Any]:
    """A sharded ``StudyResult`` as host data: event tables gathered whole
    (numpy star form), cohort words and descriptions, flow rows, features
    and their checks, FlatteningStats, the OperationLog without ``ts``, and
    the plan that ran.  Every rank of the run's group calls it (the gathers
    are collectives)."""
    from repro_torch.interop import tables_to_numpy

    return {
        "events": tables_to_numpy({k: t.gather()
                                   for k, t in res.events.items()}),
        "cohorts": {name: {"subjects": c.subjects.cpu().numpy(),
                           "description": c.description,
                           "count": c.subject_count()}
                    for name, c in res.cohorts.items()},
        "flow": res.flow.flowchart() if res.flow is not None else None,
        "features": {k: (tuple(x.cpu().numpy() for x in v)
                         if isinstance(v, tuple) else v.cpu().numpy())
                     for k, v in res.features.items()},
        "feature_checks": res.feature_checks,
        "flatten_stats": res.flatten_stats,
        "log": [{k: v for k, v in e.items() if k != "ts"}
                for e in res.log.entries],
        "plan": res.plan,
    }


def blocks(res) -> Dict[str, Dict[str, int]]:
    """What this rank holds of each event table of a sharded result: the
    block's capacity and count, and the elements of the largest tensor
    storage behind it."""
    return {k: {"capacity": t.block.capacity, "count": int(t.block.count),
                "storage": max(x.untyped_storage().nbytes() // x.element_size()
                               for x in (t.block.valid,
                                         *t.block.columns.values()))}
            for k, t in res.events.items()}


def study_rank(group, device, study, star: Mapping[str, Mapping],
               runs: Sequence[Tuple[str, str]], axis_name: str = "data"
               ) -> List[Dict[str, Any]]:
    """``study.run(mesh=group, axis_name=axis_name)`` on the numpy ``star``
    once per ``(engine, predicate_engine)`` in ``runs``; per run
    ``result_to_numpy`` plus the kernel launches and collectives of that
    run (before the gathers), its wall seconds, and what this rank held of
    each event table when ``run`` returned (``blocks``: the block's
    capacity and count, and the elements of the largest tensor storage
    behind it)."""
    from repro_torch.distributed import comm
    from repro_torch.interop import tables_from_numpy
    from repro_torch.kernels import launch_counts, reset_launch_counts

    tables = tables_from_numpy(star, device=device)
    out = []
    for engine, peng in runs:
        reset_launch_counts()
        comm.reset_stats()
        t0 = time.perf_counter()
        res = study.run(dict(tables), engine=engine, predicate_engine=peng,
                        mesh=group, axis_name=axis_name, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        launches, stats = dict(launch_counts), dict(comm.stats)
        held = blocks(res)
        summary = result_to_numpy(res)
        summary.update(launches=launches, comm=stats, seconds=seconds,
                       blocks=held)
        out.append(summary)
    return out


def service_rank(group, device, star: Mapping[str, Mapping],
                 jobs: Sequence[Tuple[str, Any]], config: Mapping[str, Any],
                 axis_name: str = "data",
                 then: Sequence[Tuple[Any, Sequence]] = ()
                 ) -> List[Dict[str, Any]]:
    """The sharded query service on this rank:
    ``CohortQueryService(star, mesh=group, config=ServiceConfig(**config))``
    serves ``jobs`` (``(tenant, study)`` pairs, all submitted, then one
    drain; or a mapping from rank to such pairs, whose tickets fail on
    every rank where the ranks' studies differ); then, for each
    ``(new_star, jobs)`` of ``then``, ``update_tables(new_star)`` where
    ``new_star`` is not None and a drain of those jobs.  Per batch: each
    ticket's status, error, ``cache_hits``, ``cache_misses``, ``compiled``
    and ``hit_ops``, and for a done ticket what this rank held of its
    events when the drain returned (``blocks``) and its
    ``result_to_numpy`` (gathered after the drain, in ticket order); the
    service's stats and cache entries, the batch's kernel launches and
    collectives (before the gathers) and its wall seconds."""
    from repro_torch.distributed import comm
    from repro_torch.interop import tables_from_numpy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.study.service import CohortQueryService, ServiceConfig

    if isinstance(jobs, Mapping):
        jobs = jobs[dist.get_rank(group)]
    svc = CohortQueryService(tables_from_numpy(star, device=device),
                             config=ServiceConfig(**dict(config)),
                             mesh=group, axis_name=axis_name, device=device)
    out = []
    for new_star, batch in ((None, jobs), *then):
        if new_star is not None:
            svc.update_tables(tables_from_numpy(new_star, device=device))
        reset_launch_counts()
        comm.reset_stats()
        t0 = time.perf_counter()
        tickets = [svc.submit(study, tenant=tenant) for tenant, study in batch]
        svc.drain()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        launches, stats = dict(launch_counts), dict(comm.stats)
        rows = []
        for t in tickets:
            row = {"status": t.status,
                   "error": None if t.error is None else repr(t.error),
                   "cache_hits": t.cache_hits,
                   "cache_misses": t.cache_misses,
                   "compiled": t.compiled, "hit_ops": list(t.hit_ops)}
            if t.result is not None:
                row["blocks"] = blocks(t.result)
            rows.append(row)
        for t, row in zip(tickets, rows):
            if t.result is not None:
                row.update(result_to_numpy(t.result))
        out.append({"tickets": rows, "stats": svc.stats.snapshot(),
                    "cache_entries": len(svc._cache), "launches": launches,
                    "comm": stats, "seconds": seconds})
    return out


def flatten_rank(group, device, schema, star: Mapping[str, Mapping],
                 engine: str = "torch") -> Dict[str, Any]:
    """``distributed_flatten`` of the numpy ``star``: the flat table (numpy
    star form) and the summed overflow."""
    from repro_torch.core.flattening import distributed_flatten
    from repro_torch.interop import tables_from_numpy, tables_to_numpy

    flat, overflow = distributed_flatten(
        schema, tables_from_numpy(star, device=device), group, engine=engine)
    return {"flat": tables_to_numpy({"flat": flat.gather()})["flat"],
            "overflow": int(overflow)}


def exposures_rank(group, device, table: Mapping, n_patients: int,
                   kwargs: Mapping) -> Dict[str, Any]:
    """``exposures_sharded`` of one numpy table, gathered (numpy star
    form)."""
    from repro_torch.core.transformers import exposures_sharded
    from repro_torch.interop import tables_from_numpy, tables_to_numpy

    t = tables_from_numpy({"t": table}, device=device)["t"]
    out = exposures_sharded(t, n_patients, group, **dict(kwargs))
    return tables_to_numpy({"t": out.gather()})["t"]
