#!/usr/bin/env python3
"""Probe kernels B1 (fused predicate) and B4 (segmented scan) of the PyTorch
port on the card: a quick check and timing while they are being changed.

    python3 tools/b1_b4_probe.py [--variant FILE ...] [--skip-battery]
                                 [--sass DIR]

1. Builds the port's kernels and prints ptxas's stack-frame, spill and
   register lines (and any warning) for B1's and B4's kernels.
2. Runs ``chip_smoke.py``'s kernel batteries: B1's expressions at its edge,
   tile and persistent-wave sizes (with B2 at the edge sizes and B3's
   program battery), and B4's flag patterns up to a thousand look-back
   tiles, bit for bit against the plain versions.
3. Times, as ``chip_smoke.py`` does (the middle of 3 medians of 20 CUDA-event
   reps, each behind a ~1 ms spin), B1 at the quickstart's scale (48M rows)
   on the shapes of the programs the studies launch (``a IS NOT NULL``; that
   and ``a IN range(65)``; ``a IN range(65)`` and two compares of a second
   column) and B4 at the cohort study's (9.6M rows, block 512, exact fill, a
   flag every ~20 rows), each beside its byte bound.
4. ``--variant FILE`` (repeatable): FILE is an edited copy of
   ``csrc/predicate.cu`` or ``csrc/segment_scan.cu`` with the same C
   interface; it is built standalone with ``nvcc -shared``, its output is
   held against the package's build, and the two are timed in turns
   (package, variant, variant, package) through the package's wrapper; a
   variant's tile constants (``kThreads`` with B1's ``kWideRows``/
   ``kNarrowRows`` or B4's ``kItems``) replace the wrappers' planning
   constants while it runs.
5. ``--sass DIR``: writes the SASS of B1's and B4's kernels (``cuobjdump``)
   to DIR, with a count of instructions by opcode.

Exits nonzero when a check fails.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

B1_ROWS = 48_000_000       # the quickstart's ER_PRS rows at 2,000,000 patients
B4_ROWS = 9_600_000        # the cohort study's exposures rows at 400,000


def b1_cases(device):
    """(label, expr_param, columns, valid, n) at the quickstart's scale."""
    import numpy as np
    import torch

    from repro_torch.core import bitset as bs
    from repro_torch.core.columnar import NULL_INT
    from repro_torch.study import col

    rng = np.random.default_rng(0)
    a = rng.integers(0, 100, B1_ROWS).astype(np.int32)
    a[rng.random(B1_ROWS) < 0.1] = NULL_INT
    b = rng.integers(14_000, 16_000, B1_ROWS).astype(np.int32)
    cols = {"a": torch.from_numpy(a).to(device),
            "b": torch.from_numpy(b).to(device)}
    valid = bs.pack(torch.from_numpy(rng.random(B1_ROWS) < 0.9).to(device))
    codes = list(range(65))
    quick = col("a").not_null() & col("a").isin(codes)
    cohort = (col("a").isin(codes) & (col("b") >= 14_600)
              & (col("b") < 15_700))
    return [("a IS NOT NULL", col("a").not_null().to_param(), cols, valid),
            ("a IS NOT NULL & a IN range(65)", quick.to_param(), cols, valid),
            ("a IN range(65) & 2 compares of b", cohort.to_param(), cols,
             valid)]


def b4_case(device):
    import numpy as np
    import torch

    from repro_torch.core import bitset as bs

    rng = np.random.default_rng(1)
    flags = bs.pack(torch.from_numpy(rng.random(B4_ROWS) < 0.05).to(device))
    vals = torch.from_numpy(rng.integers(14_000, 16_000, B4_ROWS)
                            .astype(np.int32)).to(device)
    return flags, vals


def timers(device):
    """(label, kernel fn, plain fn, bound ms) of each timed case."""
    import chip_smoke as cs
    from repro_torch.kernels import predicate as pk
    from repro_torch.kernels import segment_scan as ss

    rate = cs.mem_rate(__import__("torch").cuda.get_device_name(0))
    out = []
    for label, param, cols, valid in b1_cases(device):
        prog = pk.compile_program(param, *pk._kinds(cols, param, None))

        def kern(param=param, cols=cols, valid=valid):
            return pk.predicate_bitset(cols, valid, expr_param=param,
                                       capacity=B1_ROWS)

        def plain(prog=prog, cols=cols, valid=valid):
            return pk.predicate_bitset_plain(prog, cols, valid, B1_ROWS)

        plan = pk.device_plan(prog, B1_ROWS, device)
        bound = (4 * len(prog.columns) + 0.25) * B1_ROWS / rate * 1e3
        out.append((f"B1 {label} ({len(prog.instrs)} instructions, "
                    f"{len(plan.instrs)} scheduled, {plan.n_slots} slots, "
                    f"grid {plan.grid}, {plan.smem_bytes} B)", kern, plain,
                    bound))
    flags, vals = b4_case(device)
    out.append(("B4 9.6M rows block 512",
                lambda: ss.segmented_scan_kernel(flags, vals, 512,
                                                 ss.EXACT_FILL),
                lambda: ss.segmented_scan_plain(flags, vals, 512,
                                                ss.EXACT_FILL),
                (4 * flags.shape[0] + 16 * B4_ROWS) / rate * 1e3))
    return out


def same(a, b) -> bool:
    import chip_smoke as cs

    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return all(cs._same(x.reshape(-1), y.reshape(-1)) for x, y in zip(a, b))


def variant_lib(path: str, nvcc: str, package):
    """FILE built standalone; its entry points declared as the package's."""
    import ctypes

    from repro_torch.kernels import build

    out = Path(tempfile.mkdtemp(dir=build.BUILD_DIR)) / "variant.so"
    r = subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(out),
                        path], capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"variant {path} does not build:\n{r.stdout}"
                         f"{r.stderr}")
    for line in (r.stdout + r.stderr).splitlines():
        if any(k in line for k in ("registers", "spill", "warning")):
            print(f"variant ptxas: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    for name in ("repro_predicate_bitset", "repro_predicate_occupancy",
                 "repro_segmented_scan"):
        if hasattr(lib, name):
            fn, ref = getattr(lib, name), getattr(package, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return lib


def tiles_of(source: str) -> dict:
    """The tile constants a B1 or B4 source fixes, as the module
    attributes of the wrappers that plan with them."""
    threads = re.search(r"constexpr int kThreads = (\d+);", source)
    rows = re.search(r"constexpr int kWideRows = (\d+), kNarrowRows = (\d+);",
                     source)
    items = re.search(r"constexpr int kItems = (\d+);", source)
    if rows:
        t, wide = int(threads.group(1)), int(rows.group(1))
        return {"PRED_THREADS": t, "PRED_ROWS": (wide, int(rows.group(2))),
                "PRED_TILE": t * wide}
    if items:
        return {"SCAN_TILE": int(threads.group(1)) * int(items.group(1))}
    return {}


def use_lib(lib, tiles: dict) -> None:
    """Route the package's wrappers to ``lib`` (the occupancy cache
    cleared), planning with ``tiles``."""
    from repro_torch.kernels import build
    from repro_torch.kernels import predicate as pk
    from repro_torch.kernels import segment_scan as ss

    build._STATE["lib"] = lib
    pk._OCCUPANCY.clear()
    for name, value in tiles.items():
        setattr(pk if name.startswith("PRED") else ss, name, value)


def dump_sass(so: str, out_dir: Path) -> None:
    """SASS of the B1 and B4 kernels in ``so``, one file each, with a count
    of instructions by opcode."""
    import collections

    from repro_torch.kernels import build

    tool = Path(build._nvcc()).with_name("cuobjdump")
    r = subprocess.run([str(tool), "-sass", so], capture_output=True,
                       text=True)
    if r.returncode != 0:
        print(f"cuobjdump failed: {r.stderr.strip()}")
        return
    out_dir.mkdir(parents=True, exist_ok=True)
    for chunk in r.stdout.split("Function : ")[1:]:
        name = chunk.splitlines()[0].strip()
        tag = next((t for t in ("predicate_kernel", "seg_scan_kernel")
                    if t in name), None)
        if tag is None:
            continue
        ops = collections.Counter()
        for line in chunk.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                         line)
            if m:
                ops[m.group(2).split(".")[0]] += 1
        (out_dir / f"{tag}.sass").write_text(chunk)
        print(f"sass {tag}: {sum(ops.values())} instructions; "
              f"{dict(ops.most_common(25))}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--skip-battery", action="store_true")
    ap.add_argument("--sass", type=Path, default=None)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("b1_b4_probe: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"card: {cs.nvidia_smi_line()}")
    lib = build.library()
    info = build.build_info()
    print(f"build: {info['seconds']:.3f} s")
    for tag in ("predicate_kernelILi16E", "predicate_kernelILi8E",
                "seg_scan_kernel"):
        print(f"ptxas {tag}: {cs.ptxas_report(info['log'], tag)}")
    for section in info["log"].split("== ")[1:]:
        if section.startswith(("predicate.cu", "segment_scan.cu")):
            for line in section.splitlines():
                if "warning" in line or "error" in line:
                    print(f"nvcc: {line.strip()}")
    if args.sass is not None:
        dump_sass(info["path"], args.sass)
    if not args.skip_battery:
        cs.kernel_battery(dev)
        cs.segment_scan_battery(dev)
    package_tile = {**tiles_of((build.CSRC_DIR / "predicate.cu").read_text()),
                    **tiles_of((build.CSRC_DIR / "segment_scan.cu")
                               .read_text())}
    cases = timers(dev)
    for label, kern, plain, bound in cases:
        if not same(kern(), plain()):
            raise SystemExit(f"{label}: kernel != plain")
        mid, lo, hi = cs.spread_ms(kern, cs.REPS)
        print(f"time {label}: kernel {mid:.4f} ms [{lo:.4f}-{hi:.4f}], "
              f"bound {bound:.4f} ms ({100 * bound / mid:.1f} %)")
    for path in args.variant:
        var = variant_lib(path, build._nvcc(), lib)
        tile = tiles_of(Path(path).read_text())
        if args.sass is not None:
            dump_sass(str(Path(var._name)), args.sass / Path(path).stem)
        target = "repro_predicate_bitset" if "repro_predicate_bitset" in \
            Path(path).read_text() else "repro_segmented_scan"
        picked = [c for c in cases if c[0].startswith(
            "B1" if target == "repro_predicate_bitset" else "B4")]
        for label, kern, plain, bound in picked:
            want = kern()
            use_lib(var, tile)
            got = kern()
            torch.cuda.synchronize()
            use_lib(lib, package_tile)
            if not same(got, want):
                raise SystemExit(f"variant {path} != package at {label}")
            times = []
            for which, t in ((lib, package_tile), (var, tile), (var, tile),
                             (lib, package_tile)):
                use_lib(which, t)
                times.append(cs.spread_ms(kern, cs.REPS)[0])
            use_lib(lib, package_tile)
            print(f"variant {Path(path).name} {label}: package "
                  f"{times[0]:.4f} / {times[3]:.4f} ms, variant "
                  f"{times[1]:.4f} / {times[2]:.4f} ms, bound {bound:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
