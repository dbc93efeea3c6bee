#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s training phase (phase 16) alone on the card.

    python3 tools/train_probe.py

Builds the port's kernels, then runs B6's backward battery, h2o-danube-1.8b
at full width through ``launch.train.train`` from the claims stream (4
steps of 2 x 8,192 tokens: launches, every gradient, the warm step's wall,
tokens/s, peak memory, a trace in ``chiprun_out/train_step_trace.json``),
the engines at 2 layers, card against CPU, the restart, and B6's backward
timed at danube's training shape.  Exits nonzero when a check fails.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    cs.LOG["file"] = open(ROOT / "chiprun_out" / "train_probe.log", "w")
    name = torch.cuda.get_device_name(0)
    cs.log(cs.nvidia_smi_line())
    build.library()
    t0 = time.perf_counter()
    launches, timing, summary = cs.training_phase(cs.REPS, cs.mem_rate(name))
    cs.log(f"train_probe: phase 16 in {time.perf_counter() - t0:.3f} s; "
           f"launches {json.dumps(launches)}")
    cs.log(f"train_probe: B6 backward {json.dumps(timing)}")
    cs.log(f"train_probe: {json.dumps(summary)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
