#!/usr/bin/env python3
"""Probe kernel B3 (the cohort-expression program kernel) of the PyTorch port
on the card: a quick check and timing while it is being changed.

    python3 tools/b3_probe.py [--parent FILE] [--variant FILE ...]

1. Builds the port's kernels and prints ptxas's stack-frame, spill and
   register lines for B3's kernels (one a program length, 1-8 ops).
2. Holds the package's kernel against ``bitset_expr_plain`` on the
   quickstart's expression (``drugged & base - acts``: 2 ops over 3
   leaves) at 62,500 words (2,000,000 patients) and 2,062,500 (the SNDS
   universe), then times it as ``chip_smoke.py`` does (the middle of 3
   medians of 20 CUDA-event reps, each behind a ~1 ms spin; L2 cleared
   before each rep at 2,062,500) beside an empty kernel's launch and the
   byte bound, ``4 B x (leaves + ops)`` a word.
3. ``--parent FILE``: FILE is an older ``csrc/bitset_ops.cu`` with the one-op
   entry ``repro_bitset_op(a, b, out, n, op, count, stream)``; the same
   expression is timed the way the executor ran it with that kernel: per
   op a ``torch.zeros`` count, the kernel, and a recount of the words
   (``core.bitset.count``).
4. ``--variant FILE`` (repeatable): an edited copy of ``csrc/bitset_ops.cu``
   with the same C interface, built standalone with ``nvcc -shared``, held
   against the package's build and timed in turns with it (package,
   variant, variant, package) through the package's wrapper.

Exits nonzero when a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PROGRAM = (("and", 0, 1), ("andnot", 3, 2))
SIZES = (62_500, 2_062_500)


def standalone(src: Path, out_dir: Path) -> ctypes.CDLL:
    """``src`` built alone into a shared library (its ptxas lines printed)."""
    from repro_torch.kernels import build

    so = out_dir / (src.stem + ".so")
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                        str(so), str(src)], capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"b3_probe: nvcc failed on {src}:\n{r.stdout}"
                         f"{r.stderr}")
    print(f"built {src}:\n{ptxas_lines(r.stdout + r.stderr)}")
    return ctypes.CDLL(str(so))


def ptxas_lines(log: str) -> str:
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Function properties" in line and "bitset" in line:
            name = line.split("for ")[-1].strip()
            out.append(f"  {name}: " + " | ".join(x.strip() for x in
                                                 lines[i + 1:i + 3]))
    return "\n".join(out)


def use(lib: ctypes.CDLL) -> None:
    """Route the package's wrapper to ``lib`` (its occupancy re-read)."""
    from repro_torch.kernels import bitset_ops, build

    _P, _I32 = ctypes.c_void_p, ctypes.c_int
    lib.repro_bitset_expr.argtypes = [_P, _I32, _P]
    lib.repro_bitset_expr.restype = _I32
    lib.repro_bitset_expr_limits.argtypes = [_I32, _P, _P]
    lib.repro_bitset_expr_limits.restype = _I32
    build._STATE["lib"] = lib
    bitset_ops._LIMITS.clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--variant", type=Path, action="append", default=[])
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.core import bitset as bs
    from repro_torch.kernels import bitset_ops, build

    if not torch.cuda.is_available():
        print("b3_probe: CUDA is not available", file=sys.stderr)
        return 2
    print(cs.nvidia_smi_line())
    package = build.library()
    print("package build:\n" + ptxas_lines(build.build_info()["log"]))
    rate = cs.mem_rate(torch.cuda.get_device_name(0))
    leaves = {n: [torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                                device="cuda") for _ in range(3)]
              for n in SIZES}
    want = {n: bitset_ops.bitset_expr_plain(ls, PROGRAM)
            for n, ls in leaves.items()}

    def run(label: str) -> None:
        for n, ls in leaves.items():
            got = bitset_ops.bitset_expr_kernel(ls, PROGRAM)
            if not (torch.equal(got[0], want[n][0])
                    and torch.equal(got[1], want[n][1])):
                raise SystemExit(f"b3_probe: {label} != plain at n={n}")
            t, lo, hi = cs.spread_ms(
                lambda: bitset_ops.bitset_expr_kernel(ls, PROGRAM), cs.REPS,
                cold=n > SIZES[0])
            bound = 4 * (3 + len(PROGRAM)) * n / rate * 1e3
            print(f"{label}: n={n} {t:.4f} ms [{lo:.4f}-{hi:.4f}], bound "
                  f"{bound:.4f} ms ({100 * bound / t:.1f} %)")

    floor, lo, hi = cs.empty_launch_ms(cs.REPS)
    print(f"empty launch: {floor:.4f} ms [{lo:.4f}-{hi:.4f}]")
    with tempfile.TemporaryDirectory() as tmp:
        if args.parent is not None:
            old = standalone(args.parent, Path(tmp))
            old.repro_bitset_op.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p]
            old.repro_bitset_op.restype = ctypes.c_int

            def parent(ls):
                vals = list(ls)
                for op, a, b in PROGRAM:
                    x, y = vals[a], vals[b]
                    out = torch.empty_like(x)
                    cnt = torch.zeros((1,), dtype=torch.int32, device="cuda")
                    build.check(old.repro_bitset_op(
                        x.data_ptr(), y.data_ptr(), out.data_ptr(),
                        x.shape[0], bitset_ops.OPS[op], cnt.data_ptr(),
                        torch.cuda.current_stream().cuda_stream), "parent")
                    bs.count(out)            # the executor's recount
                    vals.append(out)
                return vals[len(ls):]

            for n, ls in leaves.items():
                if not all(torch.equal(g, w)
                           for g, w in zip(parent(ls), want[n][0])):
                    raise SystemExit(f"b3_probe: parent != plain at n={n}")
                t, lo, hi = cs.spread_ms(lambda: parent(ls), cs.REPS,
                                         cold=n > SIZES[0])
                print(f"parent (2 x (zeros + kernel + recount)): n={n} "
                      f"{t:.4f} ms [{lo:.4f}-{hi:.4f}]")
        variants = [(v, standalone(v, Path(tmp))) for v in args.variant]
        run("package")
        for path, lib in variants:
            for label, chosen in (("variant", lib), ("variant", lib),
                                  ("package", package)):
                use(chosen)
                run(f"{label} {path.name}" if chosen is lib else label)
        use(package)
    return 0


if __name__ == "__main__":
    sys.exit(main())
