#!/usr/bin/env python3
"""The quickstart out of core at a chosen scale, on one NVIDIA GPU.

    python3 tools/chunked_probe.py [--patients 14500000]

Builds the kernels, generates the synthetic DCIR star at ``--patients`` on
the card (seed 0, as ``chip_smoke.py``), runs the quickstart resident under
the cuda engines (its wall and peak device memory), partitions ER_PRS into
chunks of ``chip_smoke.CHUNK_CAPACITY`` rows under ``.chunk_store/``, frees
the card, and runs ``chip_smoke.py``'s chunked phase over the store: with
and without prefetch (each bit for bit the resident run, B1-B3 launched on
every chunk), a kill-and-resume at 200,000 patients and a traced run
(``chiprun_out/chunked_trace.json``).  The normalized-plan check is left to
``chip_smoke.py`` (it runs the plan twice more, resident).  The store is
removed at the end.  The log is also written to
``chiprun_out/chunked_probe.log``.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--patients", type=int, default=14_500_000)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chunked_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build

    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    cs.LOG["file"] = open(out / "chunked_probe.log", "w")
    cs.log(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"card {torch.cuda.get_device_name(0)}, {cs.nvidia_smi_line()}")
    build.library()
    store_dir = REPO / ".chunk_store"
    t_all = time.perf_counter()
    try:
        study, dcir, res, launches, peak = cs.resident_run(args.patients)
        prep = cs.chunked_prepare(study, dcir, res, store_dir, peak,
                                  normalized=False)
        del study, dcir, res
        torch.cuda.empty_cache()
        cs.chunked_phase(prep, launches, store_dir)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    cs.log(f"chunked_probe: {args.patients} patients, all checks passed in "
           f"{time.perf_counter() - t_all:.3f} s")
    cs.log(cs.nvidia_smi_line())
    cs.LOG["file"].close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
