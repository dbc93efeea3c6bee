"""The dry run: every (arch x shape x mesh) cell's step traced once on meta
tensors as rank 0 of a fake 256- or 512-rank ``torch.distributed`` world
(the port of ``repro/launch/dryrun.py``).

The reference forces 512 host devices, lowers and compiles each cell's jit
step on ``ShapeDtypeStruct`` inputs and reads XLA's analyses of the
compiled artifact.  The port does the same the PyTorch way: ``fake_world``
starts the ``fake`` backend (every collective returns at once, nothing is
sent) with rank 0 of the production mesh's ranks, ``launch.mesh.Mesh``
builds that mesh with all its subgroups, meta tensors stand in for the
abstract inputs (nothing is allocated on any device), and the cell's real
step (``make_train_step``, ``make_prefill_step``, ``make_serve_step``)
runs once on rank 0's blocks under ``hints.use_mesh``.  Nothing needs CUDA.

    python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

writes one JSON record a cell under ``--out`` (default ``dryrun_out/``) and
exits 1 when a cell fails.  A record has the reference's keys:
``memory`` — ``argument_bytes`` (rank 0's bytes of the inputs the step
reads: ``jax.jit`` drops an argument the step never reads, ROADMAP C21, so
seamless's decode counts no encoder), ``output_bytes``, ``alias_bytes``
(inputs the step updates in place), ``temp_bytes`` (the peak of
``MemTracker``, which tracks the inputs and every storage the step makes,
less ``argument_bytes``), ``generated_code_bytes`` (0); ``cost`` —
``flops`` (``FlopCounterMode``: matrix products, two a multiply-add),
``transcendentals`` (output elements of the ops that take an exp, log,
tanh, sigmoid, rsqrt or erf an element: softmax, gelu and log-sigmoid
among them), ``bytes_accessed`` (input and output bytes of every aten op that is
not a view); ``collectives`` — the reference's five kinds, each's count and
result bytes from ``distributed.comm.stats`` (``collective-permute`` is
the port's ppermute; the port issues no reduce-scatter: its gather's
backward is an all-reduce); ``ops`` — the 30 most frequent aten ops.
``lower_s`` is the inputs' build, ``compile_s`` the traced run.  A decode
record also has ``pos``, the position it decoded at: ``seq_len - 1``, the
last slot, where every sequence block holds a key the query sees.  The
position is a CPU int32 scalar, not a meta tensor: the decode step reads it
on the host (``models/lm.py``, ``layers.py``, ``encdec.py``).

What reads XLA's text has no counterpart: ``hlo``, ``hlo_lines`` (no
record has them; ``keep_hlo`` is accepted and ignored), ``_shape_bytes``,
``parse_collectives`` and ``op_histogram`` (``comm.stats`` and the aten
op counts take their place).  On meta tensors every kernel wrapper takes
its plain version (the ``auto`` engine resolves to ``torch``), so ``flops``
counts the plain arithmetic, the reference's ``sdpa`` (every score of the
window's blocks, not B6's skipped tiles).  A step that reads a meta
tensor's value fails with its error and the record says so.

``run_cell_with_probes`` adds the reference's two reduced-depth probes.
XLA counts a scan body once, which is why the reference needs them; the
port counts every layer, so a record's own ``flops`` is already the
whole model's and the probes only check the identity ``f(l0) + (n - l0) *
(f(l0 + 1) - f(l0))``.

``Call`` and ``trace_call`` dry-run one call of a given configuration (a
mesh of any size, the batch a caller's own) in a fake world;
``distributed.launch.dryrun_rank`` runs the same call on the ranks of a
real group, which holds the dry run's collectives and argument bytes
against real ones (``make_step``, ``decode_position`` and
``read_bytes`` are shared with it).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

from repro_torch.configs.base import SHAPES, ShapeCell
from repro_torch.distributed import comm, hints, sharding
from repro_torch.launch.mesh import (PRODUCTION_SHAPES, Mesh,
                                     make_production_mesh)
from repro_torch.models.registry import ModelBundle, all_archs, get_bundle
from repro_torch.serving.serve_step import make_prefill_step, make_serve_step
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_step import (abstract_train_state,
                                          make_train_step, state_shardings)

__all__ = ["PERF_OVERRIDES", "COLLECTIVES", "fake_world", "lower_cell",
           "run_cell", "run_cell_with_probes", "Traced", "make_step",
           "decode_position", "measure", "read_bytes", "Call", "trace_call",
           "collective_counts", "tree_bytes", "main"]

# the reference's five kinds, each with the ``comm.stats`` kind it counts
COLLECTIVES = (("all-reduce", "all_reduce"), ("all-gather", "all_gather"),
               ("reduce-scatter", None), ("all-to-all", "all_to_all"),
               ("collective-permute", "ppermute"))

# Per-cell performance knobs promoted from the reference's hillclimb.
PERF_OVERRIDES = {
    ("gemma3-12b", "train_4k"): {"microbatches": 4},
    # RG-LRU's fp32 (B, S, R) gate tensors: half the microbatch halves them
    ("recurrentgemma-2b", "train_4k"): {"microbatches": 2},
}


def production_ranks(multi_pod: bool) -> int:
    """The production mesh's rank count: 256, or 512 with the pod axis."""
    return math.prod(PRODUCTION_SHAPES[bool(multi_pod)][0])


@contextlib.contextmanager
def fake_world(ranks: int):
    """This process as rank 0 of a ``fake`` process group of ``ranks``
    ranks; on exit the group and every subgroup made inside are destroyed.
    Raises if a default group exists already (a real rank never dry-runs
    inside its own group)."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group is already "
                           "initialized")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(ranks))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# a cell's call and its inputs
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Traced:
    """A step and its arguments (rank 0's blocks); calling it runs the step
    once under its mesh (no autograd for serving)."""
    step: Any
    args: Tuple[Any, ...]
    mesh: Any
    train: bool

    def __call__(self):
        grad = contextlib.nullcontext() if self.train else torch.no_grad()
        with hints.use_mesh(self.mesh), grad:
            return self.step(*self.args)


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def make_step(bundle: ModelBundle, kind: str, microbatches: int = 1):
    """The step of a cell's kind: ``make_train_step``, ``make_prefill_step``
    or ``make_serve_step``."""
    if kind == "train":
        return make_train_step(bundle, microbatches=microbatches)
    if kind == "prefill":
        return make_prefill_step(bundle)
    return make_serve_step(bundle)


def decode_position(seq_len: int, pos: Optional[int] = None
                    ) -> torch.Tensor:
    """A decode's position, a CPU int32 scalar (the step reads it on the
    host): ``pos``, by default ``seq_len - 1``."""
    return torch.tensor(seq_len - 1 if pos is None else pos,
                        dtype=torch.int32)


def _inputs(bundle: ModelBundle, kind: str, mesh, specs, seq_len: int,
            pos: Optional[int]) -> Tuple[Any, ...]:
    """The step's arguments as rank 0's meta blocks: ``(state, batch)``,
    ``(params, batch)`` or ``(params, cache, batch)``."""
    specs = {k: v for k, v in specs.items() if k != "pos"}
    batch = sharding.shard_tree(specs, sharding.batch_shardings(
        bundle.cfg, mesh, specs), mesh)
    if kind == "train":
        return sharding.shard_tree(abstract_train_state(bundle),
                                   state_shardings(bundle, mesh),
                                   mesh), batch
    abstract = bundle.abstract_params()
    params = sharding.shard_tree(abstract, sharding.param_shardings(
        bundle.cfg, mesh, abstract), mesh)
    if kind == "prefill":
        return params, batch
    logical = bundle.abstract_cache(specs["tokens"].shape[0], seq_len)
    cspecs = sharding.cache_shardings(bundle.cfg, mesh, logical,
                                      specs["tokens"].shape[0])
    cache = sharding.with_specs(sharding.shard_tree(logical, cspecs, mesh),
                                cspecs)
    batch["pos"] = decode_position(seq_len, pos)
    return params, cache, batch


def _lower(bundle: ModelBundle, kind: str, mesh, specs, seq_len: int,
           microbatches: int = 1, pos: Optional[int] = None) -> Traced:
    return Traced(make_step(bundle, kind, microbatches),
                  _inputs(bundle, kind, mesh, specs, seq_len, pos), mesh,
                  kind == "train")


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               donate: bool = True, bundle: Optional[ModelBundle] = None):
    """The cell's step with rank 0's abstract inputs: ``(traced, meta)``,
    or ``(None, {"skipped": True, "reason": ...})`` for a cell the arch
    does not run.  Runs inside ``fake_world`` of the production mesh's
    size.  ``donate`` is the reference's: the port's train and decode
    steps update their state and cache in place whatever it says."""
    bundle = bundle or get_bundle(arch)
    cell: ShapeCell = SHAPES[shape_name]
    if not bundle.supports(cell):
        return None, {"skipped": True, "reason": "full-attention arch at 500k"}
    mesh = make_production_mesh(multi_pod=multi_pod)
    if not isinstance(mesh, Mesh):
        raise RuntimeError(f"lower_cell needs a world of {mesh.size} ranks "
                           f"(run it inside fake_world)")
    knobs = PERF_OVERRIDES.get((arch, shape_name), {})
    mb = knobs.get("microbatches", 1) if cell.kind == "train" else 1
    traced = _lower(bundle, cell.kind, mesh, bundle.input_specs(cell),
                    cell.seq_len, microbatches=mb)
    meta = {"mesh": dict(mesh.shape), "cell": cell.name, "arch": arch}
    if cell.kind == "train":
        meta["microbatches"] = mb
    if cell.kind == "decode":
        meta["pos"] = int(traced.args[-1]["pos"])
    return traced, meta


# ---------------------------------------------------------------------------
# counting a traced run
# ---------------------------------------------------------------------------
# ops that take one exp, log, tanh, sigmoid, rsqrt or erf an output element
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "erf", "gelu", "silu", "softplus",
                   "_softmax", "_log_softmax", "log_sigmoid_forward"}
# ops that read no tensor argument's values, only its shape or nothing
_NO_READ = {"empty_like", "zeros_like", "ones_like", "full_like",
            "new_empty", "new_empty_strided", "new_zeros", "new_ones",
            "new_full", "detach", "alias", "lift_fresh"}
# in-place ops that overwrite their first argument without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_"}


def _storage(t: torch.Tensor) -> Optional[int]:
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    """The bytes of every tensor of a tree of dicts, lists and tuples."""
    return sum(_nbytes(t) for t in _tensors(tree))


class _Counter(TorchDispatchMode):
    """Per-op counts of a traced run: the storages every op reads and
    writes, bytes accessed, transcendental elements and the aten op
    histogram."""

    def __init__(self):
        super().__init__()
        self.reads, self.writes = set(), set()
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == "aten":
            self.ops[name] += 1
        if name in _TRANSCENDENTAL or name.rstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += sum(
                t.numel() for t in _pytree_leaves(out)
                if isinstance(t, torch.Tensor))
        if func.is_view or name in _NO_READ:
            return out
        written = set()
        for i, a in enumerate(func._schema.arguments):
            v = args[i] if i < len(args) else kwargs.get(a.name)
            if a.alias_info is not None and a.alias_info.is_write:
                written |= {id(t) for t in _pytree_leaves(v)
                            if isinstance(t, torch.Tensor)}
        ins = [t for t in _pytree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        for j, t in enumerate(ins):
            key = _storage(t)
            if id(t) in written:
                self.writes.add(key)
                if name in _WRITE_ONLY and j == 0:
                    continue
            self.reads.add(key)
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes_accessed += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs if id(t) not in written)
        return out


def collective_counts(stats: Dict[str, Any]) -> Dict[str, Dict[str, int]]:
    """The reference's five collective kinds, each's count and bytes, from
    ``comm.stats`` (or a difference of two of its snapshots)."""
    return {name: {"count": stats[k] if k else 0,
                   "bytes": stats[k + "_bytes"] if k else 0}
            for name, k in COLLECTIVES}


def _read(inputs, counter: _Counter) -> int:
    return sum(_nbytes(t) for t in inputs if _storage(t) in counter.reads)


def read_bytes(traced: Traced) -> int:
    """Run ``traced`` once: the bytes of its inputs that it reads."""
    counter = _Counter()
    with counter:
        traced()
    return _read(_tensors(traced.args), counter)


def measure(traced: Traced) -> Dict[str, Any]:
    """Run ``traced`` once and count it: the record's ``memory``, ``cost``,
    ``collectives`` and ``ops`` (see the module's docstring)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    inputs = _tensors(traced.args)
    comm.reset_stats()
    counter = _Counter()
    with FlopCounterMode(display=False) as flops, MemTracker() as mem:
        mem.track_external(*inputs)
        with counter:
            out = traced()
    stats = dict(comm.stats)
    peak = sum(dev.get("Total", 0) for dev in
               mem.get_tracker_snapshot("peak").values())
    args = _read(inputs, counter)
    seen, out_bytes = set(), 0
    for t in _tensors(out):
        if id(t) not in seen:
            seen.add(id(t))
            out_bytes += _nbytes(t)
    return {
        "memory": {
            "argument_bytes": args,
            "output_bytes": out_bytes,
            "temp_bytes": peak - args,
            "alias_bytes": sum(_nbytes(t) for t in inputs
                               if _storage(t) in counter.writes),
            "generated_code_bytes": 0,
        },
        "cost": {"flops": float(flops.get_total_flops()),
                 "transcendentals": float(counter.transcendentals),
                 "bytes_accessed": float(counter.bytes_accessed)},
        "collectives": collective_counts(stats),
        "ops": dict(counter.ops.most_common(30)),
    }


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------
def run_cell(arch: str, shape_name: str, multi_pod: bool,
             keep_hlo: bool = False, ranks: Optional[int] = None
             ) -> Dict[str, Any]:
    """One cell's record (the module's docstring), traced in a fake world
    of ``ranks`` ranks (default: the production mesh's).  ``keep_hlo`` is
    the reference's and has no effect: there is no HLO."""
    t0 = time.time()
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": 512 if multi_pod else 256,
    }
    try:
        with fake_world(ranks or production_ranks(multi_pod)):
            traced, meta = lower_cell(arch, shape_name, multi_pod)
            if traced is None:
                rec.update(meta)
                return rec
            rec["microbatches"] = meta.get("microbatches", 1)
            if "pos" in meta:
                rec["pos"] = meta["pos"]
            rec["lower_s"] = round(time.time() - t0, 1)
            t1 = time.time()
            counts = measure(traced)
            rec["compile_s"] = round(time.time() - t1, 1)
            rec.update(counts)
            rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record and continue the matrix
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def _probe_bundle(arch: str, n_periods: int) -> ModelBundle:
    """The arch cut to its leading dense layers and tail plus
    ``n_periods`` periods (and as many encoder layers): the reference's
    depth probes."""
    cfg = get_bundle(arch).cfg
    base = cfg.first_dense_layers + (
        (cfg.n_layers - cfg.first_dense_layers) % len(cfg.pattern))
    kw = {"n_layers": base + n_periods * len(cfg.pattern)}
    if cfg.is_encdec:
        kw["n_encoder_layers"] = n_periods
    return ModelBundle(dataclasses.replace(cfg, **kw))


def run_cell_with_probes(arch: str, shape_name: str,
                         ranks: Optional[int] = None) -> Dict[str, Any]:
    """The single-pod cell and the two depth probes, levels (0, 1), or
    (1, 2) for an encoder-decoder (it has no 0-layer form), with dense
    attention in the probes as in the reference."""
    from repro_torch.models import layers as Lmod

    rec = run_cell(arch, shape_name, multi_pod=False, ranks=ranks)
    if not rec.get("ok"):
        return rec
    cfg = get_bundle(arch).cfg
    rec["n_periods"] = (cfg.n_layers - cfg.first_dense_layers) \
        // len(cfg.pattern)
    levels = (1, 2) if cfg.is_encdec else (0, 1)
    rec["probe_levels"] = list(levels)
    old = Lmod._CHUNKED_THRESHOLD
    Lmod._CHUNKED_THRESHOLD = 1 << 62
    probes = {}
    try:
        for n in levels:
            t0 = time.time()
            try:
                with fake_world(ranks or production_ranks(False)):
                    traced, _ = lower_cell(arch, shape_name, False,
                                           bundle=_probe_bundle(arch, n))
                    m = measure(traced)
                probes[f"p{n}"] = dict(m["cost"],
                                       collectives=m["collectives"],
                                       compile_s=round(time.time() - t0, 1))
            except Exception as e:  # noqa: BLE001
                probes[f"p{n}"] = {"error": f"{type(e).__name__}: {e}"[:500]}
    finally:
        Lmod._CHUNKED_THRESHOLD = old
    rec["probes"] = probes
    return rec


# ---------------------------------------------------------------------------
# one call of a given configuration, dry and on real ranks
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Call:
    """One step call: the arch (``reduced``: its smoke-test config), the
    kind, the (data, model) or (pod, data, model) mesh shape, the global
    batch and sequence, a decode's position (default ``seq_len - 1``) and
    whether a train batch carries a loss mask (the claims stream's)."""
    arch: str
    kind: str
    mesh: Tuple[int, ...]
    batch: int
    seq_len: int
    reduced: bool = False
    pos: Optional[int] = None
    loss_mask: bool = False

    def bundle(self) -> ModelBundle:
        from repro_torch.models.registry import get_bundle as registry_bundle

        return registry_bundle(self.arch, reduced=self.reduced)

    def specs(self, bundle: ModelBundle) -> Dict[str, torch.Tensor]:
        specs = bundle.input_specs(ShapeCell("call", self.seq_len,
                                             self.batch, self.kind))
        if self.loss_mask:
            specs["loss_mask"] = torch.empty(
                (self.batch, self.seq_len), device="meta")
        return specs


def trace_call(call: Call) -> Dict[str, Any]:
    """``call`` dry-run as rank 0 of a fake world of its mesh's ranks:
    ``measure``'s record, with ``lower_s`` and ``compile_s``."""
    from repro_torch.distributed.launch import make_mesh

    t0 = time.time()
    with fake_world(math.prod(call.mesh)) as group:
        bundle = call.bundle()
        traced = _lower(bundle, call.kind, make_mesh(group, call.mesh),
                        call.specs(bundle), call.seq_len, pos=call.pos)
        t1 = time.time()
        rec = measure(traced)
    rec.update(lower_s=t1 - t0, compile_s=time.time() - t1)
    return rec


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--probes", action="store_true",
                    help="also trace the depth probes (single pod)")
    ap.add_argument("--out", default="dryrun_out")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    archs = all_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                if args.probes and not mp:
                    rec = run_cell_with_probes(arch, shape)
                else:
                    rec = run_cell(arch, shape, mp)
                tag = f"{arch}__{shape}__{rec['mesh']}"
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                status = ("SKIP" if rec.get("skipped")
                          else "OK" if rec.get("ok") else "FAIL")
                if status == "FAIL":
                    n_fail += 1
                    print(f"[{status}] {tag}: {rec.get('error')}", flush=True)
                else:
                    mem = rec.get("memory", {})
                    print(
                        f"[{status}] {tag} lower={rec.get('lower_s')}s "
                        f"compile={rec.get('compile_s')}s "
                        f"args={mem.get('argument_bytes', 0)/2**30:.2f}GiB "
                        f"temp={mem.get('temp_bytes', 0)/2**30:.2f}GiB "
                        f"flops={rec.get('cost', {}).get('flops', 0):.3g}",
                        flush=True,
                    )
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
