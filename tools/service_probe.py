#!/usr/bin/env python3
"""The cohort-query service's two stages on one NVIDIA GPU.

    python3 tools/service_probe.py [--patients 2000000] [--rounds 2]

Builds the kernels and generates the quickstart's synthetic DCIR star at
``--patients`` on the card (seed 0, as ``chip_smoke.py``).  Then:

  * **where the stages wait for the card**: a synchronous service under the
    cuda engines (``chip_smoke.new_service``), warmed with one query of
    each shape, serves three queries under
    ``torch.cuda.set_sync_debug_mode(1)``; every synchronizing call is
    counted by its three innermost frames in ``repro_torch``;
  * **sync against pipelined walls**, in turns within the call: the
    32-query mix of ``chip_smoke.py``'s service phase on fresh warmed
    services, synchronous and pipelined, each also under a 0.1 ms
    interpreter switch interval (``sys.setswitchinterval``; the
    interpreter lock's hand-offs between the two stages), ``--rounds``
    times: serve wall, submit_s, realize_s, overlap_s, latency p50.

The log is also written to ``chiprun_out/service_probe.log``.
"""
from __future__ import annotations

import argparse
import collections
import sys
import traceback
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--patients", type=int, default=2_000_000)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("service_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir
    from repro_torch.kernels import build

    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    cs.LOG["file"] = open(out / "service_probe.log", "w")
    cs.log(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"card {torch.cuda.get_device_name(0)}, {cs.nvidia_smi_line()}")
    build.library()
    n = args.patients
    dcir = generate_dcir(SyntheticConfig(n_patients=n, seed=0),
                         device="cuda")
    torch.cuda.synchronize()

    svc = cs.new_service(dcir, pipeline=False)
    cs.warm_up(svc, n, cs.take)
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()
                  if "repro_torch" in f.filename]
        sites[" <- ".join(f"{Path(f.filename).name}:{f.lineno}:{f.name}"
                          for f in frames[-3:][::-1]) or "(outside)"] += 1

    shown = warnings.showwarning
    warnings.showwarning = record
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(1)
            for q in range(3):
                svc.submit(cs.service_study(100 + q, n), tenant="probe")
            svc.drain(on_done=cs.take)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        warnings.showwarning = shown
    for site, k in sites.most_common():
        cs.log(f"sync: {k:4d} calls  {site}")
    del svc

    default = sys.getswitchinterval()
    for rnd in range(args.rounds):
        for mode, pipeline, interval in (
                ("sync", False, default), ("pipelined", True, default),
                ("pipelined, 0.1 ms switch", True, 1e-4),
                ("sync, 0.1 ms switch", False, 1e-4)):
            svc = cs.new_service(dcir, pipeline)
            cs.warm_up(svc, n, cs.take)
            sys.setswitchinterval(interval)
            try:
                tickets, wall, (sub, rea) = cs.serve(svc, n, cs.take)
            finally:
                sys.setswitchinterval(default)
            lat = np.percentile([t.latency_s for t in tickets], 50)
            cs.log(f"walls: round {rnd}, {mode}: serve {wall:.6f} s, "
                   f"submit_s {sub:.6f}, realize_s {rea:.6f}, overlap_s "
                   f"{max(0.0, sub + rea - wall):.6f}, latency p50 "
                   f"{lat:.6f} s")
            del svc, tickets
            torch.cuda.empty_cache()
    cs.log(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
