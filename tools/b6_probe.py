#!/usr/bin/env python3
"""Probe kernel B6 of the PyTorch port on the card: a quick check and timing
of its bf16 prefill kernel while it is being changed.

    python3 tools/b6_probe.py [--variant FILE:DIMS ...]

1. Builds the port's kernels and prints ptxas's register, spill and
   serialization lines for B6.
2. Holds ``flash_swa_attention`` against its plain version on the card at
   every head dim, in bf16 and fp32, on both routes (prefill: Sq not a
   multiple of 128, kv_len not a multiple of the key tile, a window edge
   inside a tile, causal=False, rows before the first key, GQA groups 1-4,
   transposed (B, S, H, D) views; decode: a 3-query ring and a windowed
   full cache), with ``chip_smoke.py``'s gates (2e-2 / 2e-5 absolute, 1e-2
   / 1e-4 per row).
3. Times the bf16 prefill at h2o-danube-1.8b's shape (2 x 32 x 8,192 x 80,
   GQA 4, window 4,096) and gemma3-12b's global and local ones (1 x 16 x
   4,096 x 240, GQA 2, causal, window 0 / 1,024).
4. ``--variant FILE:DIMS`` (repeatable): builds FILE, an edited copy of
   ``csrc/swa_prefill.cu``, standalone with ``nvcc -shared`` and times its
   ``repro_flash_prefill_bf16`` against the package's build, in turns (two
   rounds), at the shapes whose head dim is in DIMS (comma separated),
   after comparing its output with the package's.

Times are the mean of 20 launches after one warm-up (CUDA events around the
loop), a quick probe; ``chip_smoke.py`` takes the reported device times.
Exits nonzero when a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

SHAPES = {   # name: (B, Hq, Hkv, S, D, window, causal), the model's layout
    "danube": (2, 32, 8, 8192, 80, 4096, True),
    "d128": (2, 32, 8, 8192, 128, 4096, True),
    "d64": (2, 32, 8, 8192, 64, 4096, True),
    "gemma_global": (1, 16, 8, 4096, 240, 0, True),
    "gemma_local": (1, 16, 8, 4096, 240, 1024, True),
    "d256_global": (1, 16, 8, 4096, 256, 0, True),
}
# B, Hq, Hkv, Sq, Skv, causal, window, q_offset, kv_len, transposed
PREFILL_CASES = [
    (1, 4, 1, 200, 200, True, 0, None, None, False),
    (2, 4, 2, 128, 128, True, 0, None, None, True),
    (1, 2, 2, 300, 333, True, 50, None, 317, True),
    (1, 6, 2, 257, 257, False, 0, None, 200, False),
    (1, 3, 1, 130, 400, True, 0, 270, 400, True),
    (1, 2, 1, 64, 64, True, 0, -8, 64, False),
    (2, 8, 8, 96, 500, False, 0, 1000, 77, True),
]
DECODE_KWARGS = [dict(causal=False, window=0, q_offset=500, kv_len=700),
                 dict(causal=True, window=256, q_offset=900, kv_len=1024)]


def timeit(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def errors(got, want):
    """(max abs error, worst row error over the row's largest |output|,
    nonzero outputs in rows that see no key)."""
    import torch

    err = (got.float() - want.float()).abs()
    top = want.float().abs().amax(-1)
    empty = (want == 0).all(-1)
    row = torch.where(empty, err.amax(-1), err.amax(-1) / top.clamp_min(1e-30))
    return float(err.max()), float(row.max()), int(torch.count_nonzero(got[empty]))


def check_all(swa, dev) -> int:
    import torch

    fails = 0
    gates = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (2e-5, 1e-4)}
    for D in swa.HEAD_DIMS:
        for dt, (tol, rtol) in gates.items():
            for B, Hq, Hkv, Sq, Skv, causal, window, qo, kvl, tr in PREFILL_CASES:
                g = torch.Generator(device=dev).manual_seed(Sq + Skv + D)
                q, k, v = (torch.randn(s, generator=g, device=dev).to(dt) for s in (
                    (B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
                if tr:
                    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                               for x in (q, k, v))
                kw = dict(causal=causal, window=window, q_offset=qo, kv_len=kvl)
                err, row, nz = errors(swa.flash_swa_attention(q, k, v, **kw),
                                      swa.flash_swa_attention_plain(q, k, v, **kw))
                ok = err <= tol and row <= rtol and nz == 0
                fails += not ok
                print(f"D={D} {dt} B{B} H{Hq}/{Hkv} Sq{Sq} Skv{Skv} causal {causal} "
                      f"window {window} q_offset {qo} kv_len {kvl} transposed {tr}: "
                      f"max {err:.3g} row {row:.3g} {'ok' if ok else 'FAIL'}", flush=True)
            g = torch.Generator(device=dev).manual_seed(D)
            q = torch.randn((2, 16, 3, D), generator=g, device=dev).to(dt)
            k, v = (torch.randn((2, 8, 1024, D), generator=g, device=dev).to(dt)
                    for _ in range(2))
            for kw in DECODE_KWARGS:
                err, row, nz = errors(swa.flash_swa_attention(q, k, v, **kw),
                                      swa.flash_swa_attention_plain(q, k, v, **kw))
                ok = err <= tol and row <= rtol and nz == 0
                fails += not ok
                print(f"decode D={D} {dt} {kw}: max {err:.3g} row {row:.3g} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
    return fails


def model_layout(shape, dev):
    import torch

    B, Hq, Hkv, S, D, window, causal = shape
    g = torch.Generator(device=dev).manual_seed(0)
    return [torch.randn((B, S, h, D), generator=g, device=dev)
            .to(torch.bfloat16).transpose(1, 2) for h in (Hq, Hkv, Hkv)]


def variant_lib(path: str, nvcc: str):
    """Build one edited copy of csrc/swa_prefill.cu into a shared library."""
    so = path[:-3] + ".so"
    r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                        "-Xptxas", "-v", "-o", so, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"variant {path} does not build:\n{r.stdout}{r.stderr}")
    for line in (r.stdout + r.stderr).splitlines():
        if "serialized" in line or "spill" in line:
            print(f"ptxas {os.path.basename(path)}: {line.strip()[:160]}")
    lib = ctypes.CDLL(so)
    P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.repro_flash_prefill_bf16.argtypes = [P] * 4 + [I64] * 12 + [I32] * 7 + [I64, I32, P]
    lib.repro_flash_prefill_bf16.restype = I32
    return lib


def variant_call(lib, q, k, v, causal: bool, window: int):
    import torch

    out = torch.empty_like(q)
    B, Hq, Sq, D = q.shape
    st = [ctypes.c_longlong(s) for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = lib.repro_flash_prefill_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *st, B, Hq,
        k.shape[1], Sq, D, int(causal), window, ctypes.c_longlong(k.shape[2] - Sq),
        k.shape[2], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"variant launch failed with CUDA error {rc}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="FILE:DIMS")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("b6_probe: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import swa_attention as swa

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {smi.stdout.strip()}")
    build.library()
    info = build.build_info()
    print(f"build {info['seconds']:.3f} s")
    for line in info["log"].splitlines():
        m = re.search(r"flash_wgmmaILi(\d+)", line)
        if "serialized" in line:
            print(f"ptxas: serialized wgmma at D = {m.group(1) if m else '?'}")
    fails = check_all(swa, dev)
    print(f"checks failed: {fails}")
    for name in ("danube", "gemma_global", "gemma_local"):
        q, k, v = model_layout(SHAPES[name], dev)
        window, causal = SHAPES[name][5:]
        ms = timeit(lambda: swa.flash_swa_attention(q, k, v, causal=causal,
                                                    window=window))
        print(f"time {name}: {ms:.4f} ms", flush=True)
    for spec in args.variant:
        path, dims = spec.rsplit(":", 1)
        lib = variant_lib(path, build._nvcc())
        tag = os.path.basename(path)[:-3]
        for name, shape in SHAPES.items():
            if shape[4] not in {int(d) for d in dims.split(",")}:
                continue
            q, k, v = model_layout(shape, dev)
            window, causal = shape[5:]
            main_fn = lambda: swa.flash_swa_attention(q, k, v, causal=causal,  # noqa: E731
                                                      window=window)
            var_fn = lambda: variant_call(lib, q, k, v, causal, window)  # noqa: E731
            err = float((var_fn().float() - main_fn().float()).abs().max())
            rounds = [(t, timeit(f)) for _ in range(2)
                      for t, f in (("package", main_fn), (tag, var_fn))]
            print(f"variant {name}: max |{tag} - package| {err:.3g}; "
                  + " ".join(f"{t} {ms:.4f}" for t, ms in rounds), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
