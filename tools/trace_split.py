#!/usr/bin/env python3
"""Split the device time of a Chrome trace written by ``chip_smoke.py``
(``torch.profiler``) by kind of kernel, inside and outside its device
ranges.

    python3 tools/trace_split.py chiprun_out/train_step_trace.json [--prefix train_step.]

For each device range whose name starts with ``--prefix`` (the forward and
the optimizer of a traced train step), and for the device time outside
every such range (the backward, whose kernels autograd launches from its
own thread), prints the milliseconds and the launch counts of: the hand
kernels of B6 (``flash_wgmma``, ``bwd_*``), cuBLAS's matmuls (``nvjet``,
``gemm``), PyTorch's elementwise and reduction kernels, and the rest by
name.  Reads the trace only; needs no card.
"""
from __future__ import annotations

import argparse
import collections
import json


def kind(name: str) -> str:
    if "bwd_" in name:
        return "B6 backward"
    if "flash_wgmma" in name or "flash_f32" in name:
        return "B6 forward"
    if "nvjet" in name or "gemm" in name.lower():
        return "matmul"
    if "elementwise" in name or "reduce" in name.lower():
        return "elementwise/reduce"
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace")
    ap.add_argument("--prefix", default="train_step.")
    args = ap.parse_args()
    with open(args.trace) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "gpu_user_annotation"
              and e["name"].startswith(args.prefix)}
    ms = collections.defaultdict(collections.Counter)
    n = collections.defaultdict(collections.Counter)
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        part = next((k for k, (lo, hi) in ranges.items()
                     if lo <= e["ts"] <= hi), "outside the ranges")
        ms[part][kind(e["name"])] += e["dur"] / 1e3
        n[part][kind(e["name"])] += 1
    for part in sorted(ms):
        print(f"{part}: {sum(ms[part].values()):.1f} ms")
        for k, v in ms[part].most_common(8):
            print(f"  {v:10.1f} ms {n[part][k]:6d} launches  {k}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
