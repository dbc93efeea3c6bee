"""Run one cell of the port's benchmark once, on the card(s) of this
machine, and print its result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1] [--log <file>]

From the root of a checkout.  ``--trace 0`` measures the cell's end-to-end
metrics; ``--trace 1`` runs the same window, then a second one under
``torch.profiler`` with the benchmark's spans, and reports its per-layer
metrics.  ``--control 1`` puts the reference computed on int16 copies of
the int32 columns in the program's place for the comparison (it must come
out not correct).  ``--log`` writes each study of the window (seconds,
literal sizes) as a JSON line.  The result line also carries ``build_s``,
the part of ``setup_s`` that built the kernel library (a checkout's first
run).  The run fails, and prints no
result, where CUDA is absent or has fewer cards than the cell asks for, and
where ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once the
window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def result_line(bench, name, res, trace, device_info) -> dict:
    from portbench.lib.cell import metric_reader

    ctx, out, nums = res["ctx"], res["out"], res["nums"]
    metrics = {}
    for m in metrics_of(bench, name, trace):
        if m["source"] == "device_trace" and device_info["platform"] != "gpu":
            continue          # no device metric from a run without the card
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = {k: {"value": v, "limit": 0} for k, v in sorted(nums.items())}
    correct = (out["failed"] == 0 and out["compared"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_info}
    line["build_s"] = ctx.build_s
    if trace and ctx.trace is not None:
        line["device"] = dict(device_info, busy_s=ctx.trace.busy_s(),
                              window_s=ctx.trace.window_s())
        line["breakdown"] = ctx.trace.breakdown()
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--log", default=None)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("USE_FLAX", "0")
    # a study's 17 GiB design matrix, made and freed every study, would
    # otherwise strand tens of GiB in the allocator's fixed segments
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = cell_entry(bench, args.workload)

    import torch

    if not torch.cuda.is_available():
        print("run.py: CUDA is not available; this benchmark runs only on "
              "the card", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(entry["chips"]):
        print(f"run.py: the cell asks for {entry['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3

    from portbench.lib.cell import run_cell

    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   T_START, device="cuda", control=bool(args.control))
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": int(entry["chips"]),
                   "memory_peak_bytes": int(res["ctx"].peak_bytes)}
    line = result_line(bench, args.workload, res, bool(args.trace),
                       device_info)
    if args.log:
        with open(args.log, "w") as f:
            for st in res["out"]["studies"]:
                f.write(json.dumps(st) + "\n")
    bad = forbidden_modules()
    if bad:
        print(f"run.py: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    print(f"compared: {res['out']['compared']} answers (at least 1)",
          file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
