"""One run of one cell: set-up, the measured window, the metrics and the
comparison with the plain reference.

Everything a cell is made of is found by name: its file
``workloads/<cell>.json`` names the configuration (``configs/<config>.json``)
and the traffic mix (``traffic/<mix>.json``); a query's shape names the
program-side builder (``shapes/<shape>.py``) and the reference's answer
(``reference/<config>.py``); each metric in ``BENCHMARK.json`` is read by
``metrics/<metric>.py``.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from portbench.lib import compare, data, spans, traffic
from portbench.lib.data import seed64

ROOT = Path(__file__).resolve().parent.parent


def load_json(*parts) -> Dict:
    return json.loads(ROOT.joinpath(*parts).read_text())


def load_cell(name: str, overrides: Optional[Dict] = None) -> Dict:
    cell = load_json("workloads", f"{name}.json")
    cfg = load_json("configs", f"{cell['config']}.json")
    cfg.update((overrides or {}).get("config", {}))
    params = dict(cell.get("params", {}))
    params.update((overrides or {}).get("mix", {}))
    return {"name": name, "cell": cell, "cfg": cfg,
            "mix": traffic.load_mix(cell["traffic"], params)}


def metric_reader(name: str):
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pb_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def shape(name: str):
    return importlib.import_module(f"portbench.shapes.{name}")


def reference(config: str):
    return importlib.import_module(f"portbench.reference.{config}")


def ref_answer(config: str, state, q: Dict):
    """The reference's answer to ``q``: from the configuration's module, or
    for a shape it does not list, from ``reference/<config>__<shape>.py``
    (so that a later change adds a query shape as new files alone)."""
    ref = reference(config)
    if q["shape"] in ref.SHAPES:
        return ref.answer(state, q)
    return importlib.import_module(
        f"portbench.reference.{config}__{q['shape']}").answer(state, q)


class Ctx:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def program_tables(star, device):
    from repro_torch.core.columnar import ColumnarTable

    return {name: ColumnarTable.from_columns(cols, device=device)
            for name, cols in star.items()}


def pmsi_flat_rows(star) -> int:
    """Rows of the flat PMSI-MCO table: a stay's diagnoses times its acts,
    at least one each."""
    n = star["MCO_B"]["stay_id"].shape[0]
    d = torch.bincount(star["MCO_D"]["stay_id"].long(), minlength=n)
    a = torch.bincount(star["MCO_A"]["stay_id"].long(), minlength=n)
    return int((d.clamp(min=1) * a.clamp(min=1)).sum())


def setup_program(run: Dict, seed: int, device) -> Dict:
    """The star from the seed, the program's tables over it, and for a
    configuration that flattens once, the flat tables."""
    from repro_torch.core import DCIR_SCHEMA, PMSI_MCO_SCHEMA, flatten_star

    cfg = run["cfg"]
    star = data.make_star(cfg, seed, device)
    raw = program_tables(star, device)
    out = {"star": star}
    if cfg["star"] == "snds":
        dcir = {k: raw[k] for k in ("ER_PRS", "ER_PHA", "ER_CAM", "IR_BEN")}
        pmsi = {k: raw[k] for k in ("MCO_B", "MCO_D", "MCO_A")}
        flat_d, st_d = flatten_star(DCIR_SCHEMA, dcir)
        flat_p, st_p = flatten_star(PMSI_MCO_SCHEMA, pmsi)
        out["tables"] = {"DCIR": flat_d, "PMSI_MCO": flat_p,
                         "IR_BEN": raw["IR_BEN"]}
        out["setup_flat"] = {"DCIR": flat_d, "PMSI_MCO": flat_p}
        out["setup_stats"] = st_d + st_p
        out["rows"] = (data.rows(star, ("ER_PRS", "IR_BEN"))
                       + pmsi_flat_rows(star))
    else:
        out["tables"] = raw
        out["rows"] = data.rows(star, ("ER_PRS", "ER_PHA", "ER_CAM", "IR_BEN"))
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_study(q: Dict, tables, n_patients: int, device):
    res = shape(q["shape"]).build(q, n_patients).run(
        dict(tables), engine="cuda", predicate_engine="cuda", device=device)
    _sync(device)
    return res


def output_bytes(res) -> int:
    """Bytes of what a study hands back: its tables' valid rows, its
    cohorts' words and its features."""
    n = 0
    for t in res.events.values():
        n += int(t.count) * sum(c.element_size() for c in t.columns.values())
    for c in res.cohorts.values():
        n += c.subjects.numel() * c.subjects.element_size()
    for f in res.features.values():
        for x in (f if isinstance(f, tuple) else (f,)):
            n += x.numel() * x.element_size()
    return n


def read_bytes(q: Dict, mix: Dict, star, tables) -> int:
    """Bytes of the input columns the query's shape reads (``reads`` in the
    mix file), each once."""
    reads = next(s["reads"] for s in mix["shapes"] if s["shape"] == q["shape"])
    n = 0
    for table, cols in reads.items():
        src = tables[table].columns if table in tables else star[table]
        rows = int(tables[table].count) if table in tables else \
            next(iter(star[table].values())).shape[0]
        n += rows * sum(src[c].element_size() for c in cols)
    return n


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------
def _sizes(q: Dict) -> Dict:
    return {k: len(v) if isinstance(v, list) else v
            for k, v in q.items() if k != "shape"}


class _GcClock:
    """Seconds the interpreter's cyclic collector has run, while counted."""

    def __init__(self):
        self.s, self._t = 0.0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.s += time.perf_counter() - self._t


def _reserved(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.memory_reserved())
    return 0


def closed_window(run, prog, stream, sample, seconds, device):
    """Studies back to back for ``seconds``, each ending in a
    synchronize.  The studies whose index is in ``sample`` are kept for the
    comparison as checksums taken when each ends; the time that takes is
    the harness's, and is left out of the window."""
    mix, P = run["mix"], int(run["cfg"]["n_patients"])
    kept, n, failed, rows, errors = [], 0, 0, 0, []
    moved, studies = [], []          # per study: bytes; seconds and sizes
    check_s = 0.0                    # the harness's own time in the window
    gc_clock = _GcClock()
    gc.callbacks.append(gc_clock)
    t0 = time.perf_counter()
    t_end, in_window = t0, 0.0
    while t_end - t0 - check_s < seconds:
        q = next(stream)
        t1 = time.perf_counter()
        try:
            res = run_study(q, prog["tables"], P, device)
        except Exception:  # noqa: BLE001 - a failed study is counted
            failed += 1
            errors.append(traceback.format_exc())
            res = None
        t_end = time.perf_counter()
        in_window = t_end - t0 - check_s
        studies.append({"s": t_end - t1, "sizes": _sizes(q),
                        "gc_s": gc_clock.s, "reserved": _reserved(device)})
        if res is not None:
            rows += prog["rows"]
            moved.append(read_bytes(q, mix, prog["star"], prog["tables"])
                         + output_bytes(res))
            if n in sample:
                kept.append((n, q, compare.digest(res, P)))
        check_s += time.perf_counter() - t_end
        del res
        n += 1
    gc.callbacks.remove(gc_clock)
    return {"attempted": n, "failed": failed, "errors": errors,
            "window_s": in_window, "rows": rows, "kept": kept,
            "moved": moved, "studies": studies}


def warm_up(run, prog, seed, device) -> None:
    """Queries of each shape (literals of their own, every size once)
    through the path the window drives: every shape's first call is paid
    here."""
    mix, P = run["mix"], int(run["cfg"]["n_patients"])
    for q in traffic.warmup_queries(mix, seed):
        run_study(q, prog["tables"], P, device)
    _sync(device)


def grow_pool(gib: float, device) -> None:
    """Grow the allocator's pool to ``gib`` (the mix's ``pool_gib``): the
    warm-up meets each size once, not every combination of sizes and data,
    and a pool that grows inside the window maps fresh memory there, a
    stall of a tenth of a second or more at a study that the seed picks."""
    grow = int(gib * 2 ** 30) - torch.cuda.memory_allocated()
    if grow > 0 and torch.cuda.memory_reserved() < gib * 2 ** 30:
        try:
            torch.empty(grow, dtype=torch.uint8, device=device)
        except torch.cuda.OutOfMemoryError:
            print(f"pool: {gib} GiB do not fit", file=sys.stderr)
    print(f"pool: {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved "
          f"after the warm-up", file=sys.stderr)


def study_summary(studies) -> str:
    """One line on the window's study times: quartiles and the slowest."""
    if not studies:
        return "studies: none"
    s = sorted(x["s"] for x in studies)
    q = np.quantile(s, [0.0, 0.25, 0.5, 0.75, 1.0])
    slow = sorted(range(len(studies)), key=lambda i: -studies[i]["s"])[:3]
    gib = [x["reserved"] / 2 ** 30 for x in (studies[0], studies[-1])]
    return (f"studies: {len(s)}, collector {studies[-1]['gc_s']:.4f} s, "
            f"reserved {gib[0]:.2f} -> {gib[1]:.2f} GiB, "
            "seconds min/q1/median/q3/max "
            + "/".join(f"{v:.4f}" for v in q) + "; slowest: "
            + "; ".join(f"#{i} {studies[i]['s']:.4f} {studies[i]['sizes']}"
                        for i in slow))


# ---------------------------------------------------------------------------
# correctness
# ---------------------------------------------------------------------------
def judge(run, prog, out, control: bool) -> Dict[str, int]:
    """The program's sampled answers (or, with ``control``, the reference
    computed on int16 copies of the int32 columns) against the plain
    reference; counts of what differs, each held to 0."""
    cfg, P = run["cfg"], int(run["cfg"]["n_patients"])
    got = [(q, d) for _, q, d in out.pop("kept")]
    setup_got = None
    if "setup_flat" in prog:
        setup_got = {"flat": {k: compare.table_rows(t)
                              for k, t in prog.pop("setup_flat").items()},
                     "flatten_stats": [
                         {k: int(getattr(s, k)) for k in (
                             "rows_in", "rows_out", "matched", "overflow",
                             "null_keys", "key_sum_in", "key_sum_out")}
                         for s in prog.pop("setup_stats")]}
    prog.pop("tables", None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    ref = reference(run["cell"]["config"])
    state = ref.prepare(prog["star"], cfg)
    cstate = ref.prepare(prog["star"], cfg, control=True) if control else None
    nums: Dict[str, int] = {}

    def add(d):
        for k, v in d.items():
            nums[k] = nums.get(k, 0) + int(v)

    if setup_got is not None:
        want = ref.setup_answer(state)
        if cstate is not None:
            c = ref.setup_answer(cstate)
            setup_got = {"flat": c["flat"], "flatten_stats": c["flatten_stats"]}
        add({"flat": sum(compare.rows_differing(setup_got["flat"][k],
                                                want["flat"][k])
                         for k in want["flat"]),
             "flatten": compare.compare(
                 {"events": {}, "cohorts": {}, "flow": None, "features": {},
                  "feature_checks": {},
                  "flatten_stats": setup_got["flatten_stats"]},
                 {"events": {}, "cohorts": {}, "flow": None, "features": {},
                  "feature_checks": {},
                  "flatten_stats": want["flatten_stats"]}, P)["flatten"]})
    for q, g in got:
        want = compare.answer_digest(ref_answer(run["cell"]["config"], state, q))
        if cstate is not None:
            g = compare.answer_digest(
                ref_answer(run["cell"]["config"], cstate, q))
        add(compare.compare(g, want, P))
        del g, want
    out["compared"] = len(got)
    return nums


# ---------------------------------------------------------------------------
def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             overrides: Optional[Dict] = None, control: bool = False
             ) -> Dict:
    """One run; returns the context the metric readers read and the
    numbers compared.

    The window is the same in every run.  A traced run then runs a second
    window of the same length under ``torch.profiler`` with the spans
    installed; the per-layer metrics that come from the trace read that
    one, the others (such as ``study.mfu_pct``) the untraced first."""
    run = load_cell(name, overrides)
    cfg, mix = run["cfg"], run["mix"]
    build_s = 0.0
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build

        t = time.perf_counter()
        build.library()
        build_s = time.perf_counter() - t
    prog = setup_program(run, seed, device)
    warm_up(run, prog, seed, device)
    if torch.device(device).type == "cuda":
        grow_pool(float(mix.get("pool_gib", 0)), device)
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    setup_s = time.perf_counter() - t_start

    rng = np.random.default_rng([seed64(seed), 3, 3])
    sample = set(int(i) for i in rng.choice(
        int(mix["sample_within"]), size=int(mix["sample"]), replace=False))
    stream = traffic.closed_queries(mix, seed)
    out = closed_window(run, prog, stream, sample, seconds, device)
    ctx = Ctx(run=run, out=out, setup_s=setup_s, build_s=build_s, peak_bytes=0,
              card=card_name(device), nodes=None, trace=None, traced=None)
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        rec = spans.Recorder()
        with profile(activities=acts) as prof, spans.installed(rec), \
                record_function("pb.window"):
            ctx.traced = closed_window(run, prog, stream, set(), seconds,
                                       device)
            _sync(device)
        from portbench.lib.trace import Trace

        ctx.trace = Trace(prof)
        ctx.nodes = rec.node_bytes()
        print(ctx.trace.summary(), file=sys.stderr)
        del prof
    if torch.device(device).type == "cuda":
        ctx.peak_bytes = torch.cuda.max_memory_allocated()
    print(study_summary(out["studies"]), file=sys.stderr)
    for w in (out, ctx.traced or {}):
        for e in w.get("errors", [])[:3]:
            print(e, file=sys.stderr)
    nums = judge(run, prog, out, control)
    if ctx.traced is not None:
        out["attempted"] += ctx.traced["attempted"]
        out["failed"] += ctx.traced["failed"]
    return {"run": run, "ctx": ctx, "nums": nums, "out": out}


def card_name(device) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(0)
    return "cpu"
