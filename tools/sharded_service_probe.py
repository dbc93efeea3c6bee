#!/usr/bin/env python3
"""The sharded cohort-query service alone, on one NVIDIA GPU.

    python3 tools/sharded_service_probe.py [--patients 2000000]

Builds the kernels, spawns ``chip_smoke.SHARDS`` gloo ranks on the one card
(``distributed.launch.spawn``), and on every rank generates the synthetic
DCIR star at ``--patients`` (seed 0, as ``chip_smoke.py``) and runs
``chip_smoke.py``'s sharded-service part (``sharded_service``): the naive
path of solo ``Study.run(mesh=group)`` runs, timed synchronous and
pipelined serves of the mix's first 12 queries with their launches held
against the hits' prediction, and both modes again with every ticket held
against its solo run.  Prints each rank's lines, also written to
``chiprun_out/sharded_service_probe.log``.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def probe_rank(group, device, n_patients: int) -> dict:
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir

    t0 = time.perf_counter()
    dcir = generate_dcir(SyntheticConfig(n_patients=n_patients, seed=0),
                         device=device)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    out = cs.sharded_service(group, device, dcir, n_patients)
    out["lines"].insert(0, f"rank {dist.get_rank(group)}: star generated "
                           f"in {gen_s:.3f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--patients", type=int, default=2_000_000)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("sharded_service_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.distributed import launch
    from repro_torch.kernels import build

    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    cs.LOG["file"] = open(out / "sharded_service_probe.log", "w")
    cs.log(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"card {torch.cuda.get_device_name(0)}, {cs.nvidia_smi_line()}")
    build.library()
    t0 = time.perf_counter()
    ranks = launch.spawn(probe_rank, cs.SHARDS, (args.patients,),
                         device="cuda", timeout=cs.SHARDED_TIMEOUT)
    for r in ranks:
        for line in r["lines"]:
            cs.log("sharded service: " + line)
    cs.log(f"sharded_service_probe: {cs.SHARDS} ranks, {args.patients} "
           f"patients, all checks passed in {time.perf_counter() - t0:.3f} s "
           f"with the ranks' start; the part "
           f"{[round(r['seconds'], 3) for r in ranks]} s a rank")
    cs.log(cs.nvidia_smi_line())
    cs.LOG["file"].close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
