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

The sharded models' rank functions build a ``launch.mesh.Mesh`` of the
given shape over the group (every rank builds every mesh, in one order),
take their blocks of the reference's numpy parameters, train state or
inputs (``interop``, ``distributed.sharding``), run under ``hints.
use_mesh`` and return the logical results (``gather_tree``) as numpy on
the mesh's first rank (None elsewhere): ``moe_rank`` (the MoE layer),
``loss_grads_rank`` (``train_loss``, its gradients and ``prefill``),
``train_step_rank`` (ZeRO-1 AdamW steps), ``checkpoint_rank`` (an elastic
save and restores onto other meshes), ``gpipe_rank``
(``pipeline_transformer``), ``shard_gather_rank`` and ``decode_rank`` (the
sharded decode: ``make_serve_step`` steps on the rank's blocks of a
cache).  ``dryrun_rank`` runs the calls that the dry run traces
(``launch.dryrun.Call``) on real blocks, to hold the dry run against.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.columnar import resolve_device

__all__ = ["spawn", "tasks_rank", "study_rank", "service_rank",
           "flatten_rank", "exposures_rank", "result_to_numpy", "blocks",
           "make_mesh", "moe_rank", "loss_grads_rank", "train_step_rank",
           "checkpoint_rank", "gpipe_rank", "shard_gather_rank",
           "decode_rank", "dryrun_rank"]


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


# ---------------------------------------------------------------------------
# sharded models
# ---------------------------------------------------------------------------
def make_mesh(group, shape: Sequence[int], names=None):
    """A ``launch.mesh.Mesh`` of ``shape`` over ``names`` and ``group``;
    ``names`` defaults to ("data", "model"), or ("pod", "data", "model")
    for a shape of three."""
    from repro_torch.launch.mesh import Mesh

    if names is None:
        names = ("pod", "data", "model")[-len(shape):]
    return Mesh(shape, names, group)


def _first(mesh) -> bool:
    return dist.get_rank(mesh.group) == 0


def _numpy_tree(tree):
    from repro_torch.interop import tree_map

    def host(t):
        t = t.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()

    return tree_map(host, tree)


def _batch_block(cfg, mesh, batch: Mapping, device) -> Dict[str, Any]:
    from repro_torch.distributed import sharding

    specs = sharding.batch_shardings(cfg, mesh, batch)
    return {k: torch.from_numpy(np.ascontiguousarray(
        sharding.block(np.asarray(v), specs[k], mesh))).to(device)
        for k, v in batch.items()}


def _gather_data(x, mesh):
    """A batch-sharded output whole again (over the data axes)."""
    from repro_torch.distributed import comm, sharding

    dp = sharding.data_axes(mesh)
    n = 1
    for a in dp:
        n *= mesh.shape[a]
    return x if n == 1 else comm.all_gather_dim(x.contiguous(),
                                                mesh.group_of(*dp), 0)


def moe_rank(group, device, cfg, shape, params: Mapping, x) -> Any:
    """``models.layers.moe_ffn`` of one MoE layer's numpy ``params`` on a
    (data, model) mesh of ``shape``, ``x`` (B, S, d) split over "data";
    the whole output on the first rank."""
    from repro_torch.distributed import hints, sharding
    from repro_torch.interop import _leaf_to_tensor, tree_map
    from repro_torch.models import layers as L

    mesh = make_mesh(group, shape)
    specs = sharding.param_shardings(cfg, mesh, params)
    p = tree_map(lambda a: _leaf_to_tensor(a, device),
                 sharding.shard_tree(dict(params), specs, mesh))
    xb = _batch_block(cfg, mesh, {"x": x}, device)["x"]
    with torch.no_grad(), hints.use_mesh(mesh):
        y = _gather_data(L.moe_ffn(p, xb, cfg), mesh)
    return y.cpu().numpy() if _first(mesh) else None


def loss_grads_rank(group, device, cfg, shape, params: Mapping,
                    batch: Mapping, engine: str = "torch") -> Any:
    """``train_step.loss_and_grads`` and ``bundle.prefill`` of the
    reference's numpy ``params`` and ``batch`` on a mesh of ``shape``
    (``make_mesh``);
    on the first rank ``{"loss", "grads" (logical, numpy), "prefill" (the
    whole batch's last-token logits)}``."""
    from repro_torch.distributed import hints, sharding
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.models.registry import ModelBundle
    from repro_torch.train.train_step import loss_and_grads

    mesh = make_mesh(group, shape)
    bundle = ModelBundle(cfg)
    p = lm_params_from_numpy(params, cfg, device, mesh)
    b = _batch_block(cfg, mesh, batch, device)
    with hints.use_mesh(mesh):
        loss, grads = loss_and_grads(bundle, p, b, engine)
        grads = sharding.gather_tree(grads, sharding.param_shardings(
            cfg, mesh, bundle.abstract_params()), mesh)
        with torch.no_grad():
            logits = _gather_data(bundle.prefill(p, b, engine), mesh)
    if not _first(mesh):
        return None
    return {"loss": float(loss), "grads": _numpy_tree(grads),
            "prefill": logits.float().cpu().numpy()}


def train_step_rank(group, device, cfg, shape, state: Mapping,
                    batches: Sequence[Mapping], opt: Mapping,
                    param_dtype: str = "float32", engine: str = "torch",
                    microbatches: int = 1,
                    compress_crosspod: bool = False) -> Any:
    """``make_train_step`` (ZeRO-1) over ``batches`` from the reference's
    numpy train ``state`` on a (data, model) or (pod, data, model) mesh of
    ``shape`` (``compress_crosspod``: the step's over the "pod" axis); on
    the first rank each step's metrics and the logical state after the
    last step (numpy)."""
    from repro_torch.distributed import hints, sharding
    from repro_torch.interop import train_state_from_numpy
    from repro_torch.models.registry import ModelBundle
    from repro_torch.train import AdamWConfig
    from repro_torch.train.train_step import make_train_step, state_shardings

    mesh = make_mesh(group, shape)
    bundle = ModelBundle(cfg)
    st = train_state_from_numpy(state, cfg, device, mesh)
    step = make_train_step(bundle, AdamWConfig(**dict(opt)), microbatches,
                           compress_crosspod=compress_crosspod,
                           pod_axis="pod" if compress_crosspod else None,
                           engine=engine,
                           param_dtype=getattr(torch, param_dtype))
    metrics = []
    with hints.use_mesh(mesh):
        for batch in batches:
            st, m = step(st, _batch_block(cfg, mesh, batch, device))
            metrics.append({k: float(v) for k, v in m.items()})
        whole = sharding.gather_tree(st, state_shardings(bundle, mesh), mesh)
    return {"metrics": metrics, "state": _numpy_tree(whole)} \
        if _first(mesh) else None


def checkpoint_rank(group, device, cfg, save_shape, restore_shapes,
                    seed: int, ckpt_dir: str) -> Any:
    """A train state drawn from ``seed`` on a (data, model) mesh of
    ``save_shape`` (each rank its blocks), saved under ``ckpt_dir`` as step
    1, then restored onto each mesh of ``restore_shapes``; on the first
    rank the logical state saved and each one restored, gathered (numpy,
    bf16 as uint16 bits)."""
    from repro_torch.distributed import hints, sharding
    from repro_torch.interop import tree_map
    from repro_torch.models.registry import ModelBundle
    from repro_torch.train.checkpointing import (_to_numpy,
                                                 restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.train.train_step import (abstract_train_state,
                                              init_train_state,
                                              state_shardings)

    bundle = ModelBundle(cfg)
    mesh = make_mesh(group, save_shape)
    with hints.use_mesh(mesh):
        st = init_train_state(bundle, seed, device, mesh)
        specs = state_shardings(bundle, mesh)
        save_checkpoint(ckpt_dir, 1, st, meta={"arch": cfg.name},
                        shardings=specs)
        saved = sharding.gather_tree(st, specs, mesh)
    out = {"saved": tree_map(_to_numpy, saved), "restored": []}
    for shp in restore_shapes:
        m2 = make_mesh(group, shp)
        with hints.use_mesh(m2):
            specs2 = state_shardings(bundle, m2)
            st2, _ = restore_checkpoint(ckpt_dir, 1,
                                        abstract_train_state(bundle),
                                        device=device, shardings=specs2)
            out["restored"].append(tree_map(
                _to_numpy, sharding.gather_tree(st2, specs2, m2)))
    return out if _first(mesh) else None


def gpipe_rank(group, device, weights, mbs) -> Any:
    """``pipeline_transformer`` of the layer ``tanh(x @ W)`` over a "pipe"
    mesh of the group's ranks: ``weights`` (P, layers a stage, D, D),
    ``mbs`` (M, mb, D); on the first rank the output and the gradient of
    its sum with respect to ``weights`` (numpy)."""
    from repro_torch.distributed import comm, sharding
    from repro_torch.distributed.pipeline import pipeline_transformer

    n = dist.get_world_size(group)
    mesh = make_mesh(group, (n,), ("pipe",))
    W = torch.from_numpy(np.asarray(weights)).to(device)
    w = sharding.block(W, ("pipe", None, None, None), mesh).detach() \
        .clone().requires_grad_(True)
    run = pipeline_transformer(lambda p, x: torch.tanh(x @ p), mesh, n)
    out = run(w, torch.from_numpy(np.asarray(mbs)).to(device))
    g, = torch.autograd.grad(out.sum(), [w])
    g = comm.all_gather_dim(g, mesh.group_of("pipe"), 0)
    return {"out": out.detach().cpu().numpy(),
            "grads": g.cpu().numpy()} if _first(mesh) else None


def shard_gather_rank(group, device, arrays: Mapping, specs: Mapping,
                      shape) -> Any:
    """``gather_tree(shard_tree(arrays))`` on a (data, model) mesh of
    ``shape``: the logical arrays gathered back from the rank's blocks
    (numpy; first rank)."""
    from repro_torch.distributed import sharding

    mesh = make_mesh(group, shape)
    tree = {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in arrays.items()}
    blocks_ = sharding.shard_tree(tree, dict(specs), mesh)
    back = sharding.gather_tree(blocks_, dict(specs), mesh)
    return {k: v.cpu().numpy() for k, v in back.items()} \
        if _first(mesh) else None


def _rows_whole(x, cfg, mesh, batch: int):
    """A batch-sharded output whole again: gathered over the axes that
    ``batch_shardings`` splits a batch of ``batch`` over (none: as it
    is)."""
    from repro_torch.distributed import comm, sharding

    entry = sharding.batch_shardings(cfg, mesh, {"b": (batch,)})["b"][0]
    axes = sharding.axes_of(entry)
    return comm.all_gather_dim(x.contiguous(), mesh.group_of(*axes), 0) \
        if axes else x


def decode_rank(group, device, cfg, shape, params: Mapping, cache: Mapping,
                steps: Sequence[Tuple[Any, int]], engine: str = "torch",
                sample: bool = False) -> Any:
    """``make_serve_step`` of the reference's numpy ``params`` and decode
    ``cache`` (its tree, ``interop.cache_from_numpy``) on a mesh of
    ``shape`` (``make_mesh``), one step for each ``(tokens (B, S), pos)``
    of ``steps``, the tokens cut to the rank's rows.  On the first rank:
    each step's logits (or greedy tokens, ``sample``) of the whole batch,
    the logical cache after the last step (``gather_tree``, in the port's
    layout, numpy), ``block_err``, the largest difference over the ranks
    between a rank's blocks and ``shard_tree`` of that logical cache, and
    the step's collectives (``comm.stats``)."""
    from repro_torch.distributed import comm, hints, sharding
    from repro_torch.interop import cache_from_numpy, lm_params_from_numpy
    from repro_torch.models.registry import ModelBundle
    from repro_torch.serving.serve_step import make_serve_step

    mesh = make_mesh(group, shape)
    p = lm_params_from_numpy(params, cfg, device, mesh)
    blocks_ = cache_from_numpy(cache, cfg, device, mesh)
    specs = sharding.specs_of(blocks_)
    step = make_serve_step(ModelBundle(cfg), sample=sample, engine=engine)
    outs = []
    comm.reset_stats()
    with torch.no_grad(), hints.use_mesh(mesh):
        for tokens, pos in steps:
            batch = _batch_block(cfg, mesh, {"tokens": tokens}, device)
            out, blocks_ = step(p, blocks_, dict(batch, pos=int(pos)))
            outs.append(_rows_whole(out, cfg, mesh, len(tokens)))
        stats = dict(comm.stats)
        whole = sharding.gather_tree(blocks_, specs, mesh)
        again = sharding.shard_tree(whole, specs, mesh)
        err = max([float((a.float() - b.float()).abs().max())
                   for a, b in zip(_tensors(again), _tensors(blocks_))]
                  + [0.0])
        err = float(comm.all_reduce_max(torch.tensor([err]), mesh.group)[0])
    if not _first(mesh):
        return None
    return {"out": [o.float().cpu().numpy() if not sample else
                    o.cpu().numpy() for o in outs],
            "cache": _numpy_tree(whole), "block_err": err, "comm": stats}


def dryrun_rank(group, device, calls: Sequence, seed: int = 0) -> Any:
    """Each of ``calls`` (``launch.dryrun.Call``) on this rank: seeded
    weights or train state, a zeroed cache, seeded batch blocks (tokens in
    ``[3, vocab)``, a loss mask of ones, normal frontend inputs), the step
    once.  On the mesh's first rank each call's collectives
    (``comm.stats`` around exactly that call, as the dry run counts them)
    and the bytes of the inputs the call reads and of all it holds; None
    elsewhere."""
    from repro_torch.distributed import comm, sharding
    from repro_torch.launch import dryrun
    from repro_torch.train.train_step import init_train_state

    out = []
    for call in calls:
        bundle, mesh = call.bundle(), make_mesh(group, call.mesh)
        specs = {k: v for k, v in call.specs(bundle).items() if k != "pos"}
        shard = sharding.batch_shardings(bundle.cfg, mesh, specs)
        gen = torch.Generator().manual_seed(seed + 1)
        batch = {}
        for name, s in specs.items():
            if name == "tokens":
                x = torch.randint(3, bundle.cfg.vocab_size, tuple(s.shape),
                                  generator=gen, dtype=torch.int64)
            elif name == "loss_mask":
                x = torch.ones(tuple(s.shape))
            else:
                x = torch.randn(tuple(s.shape), generator=gen)
            batch[name] = sharding.own_block(x.to(s.dtype), shard[name],
                                             mesh).to(device)
        if call.kind == "train":
            args = (init_train_state(bundle, seed, device, mesh), batch)
        else:
            args = (bundle.init(seed, device, mesh), batch)
        if call.kind == "decode":
            cache = bundle.init_cache(call.batch, call.seq_len, device, mesh)
            batch["pos"] = dryrun.decode_position(call.seq_len, call.pos)
            args = (args[0], cache, batch)
        traced = dryrun.Traced(dryrun.make_step(bundle, call.kind), args,
                               mesh, call.kind == "train")
        comm.reset_stats()
        reads = dryrun.read_bytes(traced)
        out.append({"collectives": dryrun.collective_counts(comm.stats),
                    "argument_bytes": reads,
                    "held_bytes": dryrun.tree_bytes(args)})
    return out if dist.get_rank(group) == 0 else None


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensors(v)]
    return [tree]
