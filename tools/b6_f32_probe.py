#!/usr/bin/env python3
"""Probe B6's fp32 kernels on the card (the forward ``flash_f32`` of
``csrc/swa_attention.cu``, the backward ``bwd_dq``/``bwd_dkdv`` of
``csrc/swa_backward.cu``): a quick check and timing while they change.

    python3 tools/b6_f32_probe.py [--no-battery] [--no-timing] [--compare DIR ...]
                                  [--sass] [--nvcc-times]

1. Builds the port's kernels, prints ptxas's lines (registers, stack,
   spills) for the three fp32 kernels at every head dim, and holds the tile
   plans' Python twins (``f32_forward_tiles``, ``f32_backward_tiles``) to
   the library's (``f32_kernel_tiles``).
2. Battery: the fp32 forward, asked for the log-sum-exp, against its plain
   version on every ``chip_smoke.ATTN_CASES`` and ``BWD_CASES`` case that
   takes the prefill route (odd cases through transposed views), with
   ``chip_smoke``'s gates; the fp32 backward against the plain backward on
   ``BWD_CASES`` (rows that are 0 in the plain backward within
   ``BWD_ZERO_ROW_TOL``), and twice bit for bit;
   each call one ``flash_attention_f32`` / ``flash_attention_bwd_f32``
   launch.
3. Timing at h2o-danube-1.8b's training shape in fp32
   (``chip_smoke.BWD_DANUBE``): the forward writing the LSE
   (``chip_smoke.time_attention``: kernel, plain version, SDPA with the
   boolean mask, the bound) and the backward
   (``chip_smoke.time_attention_backward``), the backward's device time
   split between its two launches (``torch.profiler``), and the forward at
   the fp32 cuts' other head dims.
4. ``--compare DIR`` (repeatable): another tree (an earlier commit, or a
   copy with other tile plans); its ``csrc/swa_attention.cu``,
   ``swa_prefill.cu``, ``swa_backward.cu`` (and ``swa_backward_wide.cu``
   where it has one) are built standalone and its
   fp32 forward and backward are timed beside the package's on the same
   inputs, in turns (other, package, package, other), after a comparison
   of their outputs; the backward's split between its launches too.

5. ``--sass``: the three kernels' machine code at D = 80 (``cuobjdump
   -sass`` of the built library) into ``chiprun_out/b6_f32_sass/``, with
   each kernel's count of instructions by opcode printed.

6. ``--nvcc-times``: each source of ``csrc/`` compiled alone, one at a
   time, with the build's flags; the wall of each (the parallel build waits
   for the slowest).

Exits nonzero when a check fails.  Writes ``chiprun_out/b6_f32_probe.log``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

KERNELS = ("flash_f32", "bwd_dq", "bwd_dkdv")
# the fp32 cuts' other attention shapes (phase 15's families at 1 x 4,096):
# phi-3-vision 32 heads of 96, deepseek-moe 16 of 128, recurrentgemma MQA
# 10/1 of 256 with window 2,048
OTHER_SHAPES = {
    "phi-3-vision": (1, 32, 32, 4096, 4096, 96, True, 0, None, None),
    "deepseek-moe": (1, 16, 16, 4096, 4096, 128, True, 0, None, None),
    "recurrentgemma": (1, 10, 1, 4096, 4096, 256, True, 2048, None, None),
}


def build_other(tree: Path):
    """Another tree's fp32 entry points (``repro_flash_attention``,
    ``repro_flash_attention_bwd``), built standalone from its sources."""
    import chip_smoke as cs
    from repro_torch.kernels import build

    csrc = tree / "src" / "repro_torch" / "csrc"
    out = ROOT / "_proof" / f"{tree.name}_f32.so"
    out.parent.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        names = ("swa_attention.cu", "swa_prefill.cu", "swa_backward.cu",
                 "swa_backward_wide.cu")
        for name in (n for n in names if (csrc / n).exists()):
            obj = Path(tmp) / (name + ".o")
            procs.append((obj, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-c",
                 str(csrc / name), "-o", str(obj)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        for obj, p in procs:
            log, _ = p.communicate()
            if p.returncode:
                raise SystemExit(f"{tree.name}: {obj.name} does not build:\n"
                                 f"{log}")
            lines = log.splitlines()
            for i, line in enumerate(lines):
                if "Function properties" in line and "ILi80E" in line and (
                        "flash_f32" in line or "bwd_d" in line):
                    cs.log(f"{tree.name} ptxas: {line.strip()} "
                           + " | ".join(x.strip() for x in lines[i + 1:i + 3]))
        r = subprocess.run([build._nvcc(), "-gencode",
                            "arch=compute_90a,code=sm_90a", "-shared", "-o",
                            str(out), *[str(o) for o, _ in procs]],
                           capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"{tree.name}: link failed:\n{r.stdout}"
                             f"{r.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.repro_flash_attention.argtypes = ([P] * 4 + [I64] * 12 + [I32] * 8
                                          + [I64, I32, I32, P, P])
    lib.repro_flash_attention_bwd.argtypes = ([P] * 10 + [I64] * 24
                                              + [I32] * 8 + [I64, I32, P])
    lib.repro_flash_attention.restype = I32
    lib.repro_flash_attention_bwd.restype = I32
    return lib


def _masks(q, k, kw):
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kv_len = Skv if kw["kv_len"] is None else kw["kv_len"]
    q_off = kv_len - Sq if kw["q_offset"] is None else kw["q_offset"]
    return B, Hq, Hkv, Sq, Skv, D, q_off, kv_len


def lib_forward(lib, q, k, v, lse, kw):
    """The fp32 forward through ``lib``'s entry point (the wrapper's call)."""
    import torch

    B, Hq, Hkv, Sq, Skv, D, q_off, kv_len = _masks(q, k, kw)
    out = torch.empty_like(q)
    st = [ctypes.c_longlong(s) for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *st, B, Hq,
        Hkv, Sq, Skv, D, int(kw["causal"]), int(kw["window"]),
        ctypes.c_longlong(q_off), kv_len, 0, lse.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"other forward failed with CUDA error {rc}")
    return out


def lib_backward(lib, q, k, v, o, do, lse, kw):
    """The fp32 backward through ``lib``'s entry point."""
    import torch

    B, Hq, Hkv, Sq, Skv, D, q_off, kv_len = _masks(q, k, kw)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty(B * Hq * Sq, dtype=torch.float32, device=q.device)
    st = [ctypes.c_longlong(s) for t in (q, k, v, o, do, dq, dk, dv)
          for s in t.stride()[:3]]
    rc = lib.repro_flash_attention_bwd(
        *[t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv, lse, delta)],
        *st, B, Hq, Hkv, Sq, Skv, D, int(kw["causal"]), int(kw["window"]),
        ctypes.c_longlong(q_off), kv_len,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"other backward failed with CUDA error {rc}")
    return dq, dk, dv


def battery(device) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import swa_attention as swa

    fwd = dict(err=0.0, row=0.0, lse=0.0, n=0, dims=set())
    for i, case in enumerate(cs.ATTN_CASES + list(cs.BWD_CASES)):
        B, Hq, Hkv, Sq, Skv, D = case[:6]
        if Hq // Hkv * Sq <= swa.DECODE_ROWS:
            continue
        g = torch.Generator(device=device).manual_seed(i)
        q, k, v = (torch.randn(sh, generator=g, device=device)
                   for sh in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                              (B, Hkv, Skv, D)))
        if i % 2:
            q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                       for x in (q, k, v))
        kw = cs._attn_kwargs(case)
        lse = torch.full(q.shape[:3], float("nan"), device=device)
        before = launch_counts["flash_attention_f32"]
        got = swa.flash_swa_attention(q, k, v, lse=lse, **kw)
        if launch_counts["flash_attention_f32"] != before + 1:
            cs.fail(f"fp32 forward {case}: no flash_attention_f32 launch")
        want, plse = swa.flash_swa_attention_plain(q, k, v, return_lse=True,
                                                   **kw)
        err, row = cs.check_attention(got, want, f"fp32 {case}")
        lerr = cs.check_lse(lse, plse, f"fp32 {case}")
        fwd["err"], fwd["row"] = max(fwd["err"], err), max(fwd["row"], row)
        fwd["lse"] = max(fwd["lse"], lerr)
        fwd["n"] += 1
        fwd["dims"].add(D)
        del q, k, v, got, want, lse, plse
    if fwd["dims"] != set(swa.HEAD_DIMS):
        cs.fail(f"fp32 forward checked at {sorted(fwd['dims'])} only")
    fwd["dims"] = sorted(fwd["dims"])
    cs.log(f"battery: fp32 forward {json.dumps(fwd)}")

    bwd = dict(err=0.0, row=0.0, zero=0.0, n=0)
    for i, case in enumerate(cs.BWD_CASES):
        q, k, v, do = cs._bwd_inputs(case, torch.float32, device, 1000 + i,
                                     i % 2 == 1)
        kw = cs._attn_kwargs(case)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=device)
        o = swa.flash_swa_attention(q, k, v, lse=lse, **kw)
        before = launch_counts["flash_attention_bwd_f32"]
        got = swa.flash_swa_attention_backward(q, k, v, o, do, lse=lse, **kw)
        if launch_counts["flash_attention_bwd_f32"] != before + 1:
            cs.fail(f"fp32 backward {case}: no flash_attention_bwd_f32 "
                    f"launch")
        want = swa.flash_swa_attention_backward_plain(q, k, v, o, do, **kw)
        err, row = cs.check_grads(got, want, f"fp32 {case}")
        bwd["zero"] = max(bwd["zero"], cs.zero_rows(got, want, str(case)))
        bwd["err"], bwd["row"] = max(bwd["err"], err), max(bwd["row"], row)
        again = swa.flash_swa_attention_backward(q, k, v, o, do, lse=lse,
                                                 **kw)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            cs.fail(f"fp32 backward {case}: two calls differ")
        bwd["n"] += 1
        del q, k, v, do, o, got, want, again, lse
    cs.log(f"battery: fp32 backward (each twice, bit for bit) "
           f"{json.dumps(bwd)}")
    return dict(forward=fwd, backward=bwd)


def sass(lib_path: str) -> None:
    """Each fp32 kernel's SASS at D = 80 into chiprun_out/b6_f32_sass/, its
    instructions counted by opcode, and each loop of more than 40
    instructions (a branch back to a lower address) with its opcodes."""
    import collections
    import shutil

    import chip_smoke as cs
    from repro_torch.kernels import build

    tool = shutil.which("cuobjdump") or str(
        Path(build._nvcc()).parent / "cuobjdump")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True)
    if out.returncode:
        raise SystemExit(f"cuobjdump failed: {out.stderr}")
    folder = ROOT / "chiprun_out" / "b6_f32_sass"
    folder.mkdir(parents=True, exist_ok=True)
    blocks = out.stdout.split("Function : ")
    line = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9._]*)([^;]*);")
    for kern in KERNELS:
        body = next((b for b in blocks if b.startswith("_Z")
                     and f"{kern}ILi80E" in b.split("\n")[0]), None)
        if body is None:
            cs.fail(f"no SASS for {kern}<80>")
        (folder / f"{kern}_80.sass").write_text(body)
        code = [(int(m.group(1), 16), m.group(2), m.group(3))
                for m in line.finditer(body)]
        ops = collections.Counter(op for _, op, _ in code)
        cs.log(f"sass: {kern}<80>: {len(code)} instructions, "
               f"{json.dumps(dict(ops.most_common(14)))}")
        at = {a: i for i, (a, _, _) in enumerate(code)}
        for i, (a, op, rest) in enumerate(code):
            back = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if back and int(back.group(1), 16) in at and \
                    int(back.group(1), 16) < a:
                loop = code[at[int(back.group(1), 16)]:i + 1]
                if len(loop) > 40:
                    cs.log(f"sass: {kern}<80> loop {back.group(0)}-{a:#x}: "
                           f"{len(loop)} instructions, " + json.dumps(dict(
                               collections.Counter(o for _, o, _ in loop)
                               .most_common(6))))


def nvcc_times() -> None:
    """Each ``build.SOURCES`` file compiled alone with the build's flags,
    one at a time: its wall in seconds."""
    import time

    import chip_smoke as cs
    from repro_torch.kernels import build

    with tempfile.TemporaryDirectory() as tmp:
        for name in build.SOURCES:
            t0 = time.perf_counter()
            r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-c",
                                str(build.CSRC_DIR / name), "-o",
                                str(Path(tmp) / "x.o")], capture_output=True)
            if r.returncode:
                cs.fail(f"nvcc failed on {name}")
            cs.log(f"nvcc: {name} {time.perf_counter() - t0:.1f} s")


def launch_split(fn, reps: int = 5) -> dict:
    """Device ms a call of ``fn`` (a backward) spends in each launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        name = re.search(r"bwd_dkdv|bwd_dq", e.key)
        if name and e.device_time_total > 0:
            n = name.group(0)
            split[n] = split.get(n, 0.0) + e.device_time_total / 1e3 / reps
    return split


def compare(lib, q, k, v, kw, reps: int) -> dict:
    """Another tree's fp32 forward and backward beside the package's: the
    largest output gap, then each timed in turns."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import swa_attention as swa

    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    plse = torch.empty_like(lse)
    o = swa.flash_swa_attention(q, k, v, lse=lse, **kw)
    po = lib_forward(lib, q, k, v, plse, kw)
    do = torch.randn_like(o)
    fwd_gap = float((o - po).abs().max())
    lse_gap = float((lse - plse).abs().max())
    got = swa.flash_swa_attention_backward(q, k, v, o, do, lse=lse, **kw)
    want = lib_backward(lib, q, k, v, o, do, lse, kw)
    bwd_gap = max(float((a - b).abs().max()) for a, b in zip(got, want))
    out = dict(forward_gap=fwd_gap, lse_gap=lse_gap, backward_gap=bwd_gap)
    calls = {
        "forward": (lambda: lib_forward(lib, q, k, v, plse, kw),
                    lambda: swa.flash_swa_attention(q, k, v, lse=lse, **kw)),
        "backward": (lambda: lib_backward(lib, q, k, v, o, do, lse, kw),
                     lambda: swa.flash_swa_attention_backward(
                         q, k, v, o, do, lse=lse, **kw)),
    }
    for name, (other, package) in calls.items():
        order = (("other", other), ("package", package),
                 ("package", package), ("other", other))
        out[name] = [(tag, cs.cuda_ms(fn, reps)) for tag, fn in order]
    out["backward_split"] = launch_split(calls["backward"][0])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-battery", action="store_true")
    ap.add_argument("--no-timing", action="store_true")
    ap.add_argument("--compare", action="append", default=[],
                    help="another tree to time beside this one")
    ap.add_argument("--sass", action="store_true",
                    help="dump and count the kernels' SASS at D = 80")
    ap.add_argument("--nvcc-times", action="store_true",
                    help="compile each source alone and time it")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("b6_f32_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import swa_attention as swa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    cs.LOG["file"] = open(ROOT / "chiprun_out" / "b6_f32_probe.log", "w")
    cs.log(cs.nvidia_smi_line())
    if args.nvcc_times:
        nvcc_times()
    build.library()
    info = build.build_info()
    cs.log(f"build: {info['seconds']:.1f} s")
    for D in swa.HEAD_DIMS:
        for kern in KERNELS:
            cs.log(f"ptxas: {kern}<{D}>: "
                   + cs.kernel_registers(info["log"], kern, D))
        twin = swa.f32_backward_tiles(D) + swa.f32_forward_tiles(D)
        if swa.f32_kernel_tiles(D) != twin:
            cs.fail(f"fp32 tiles at D={D}: kernel {swa.f32_kernel_tiles(D)}"
                    f", twins {twin}")
    cs.log("tiles: the fp32 kernels' plans equal their Python twins")
    if args.sass:
        sass(info["path"])
    device = torch.device("cuda")
    if not args.no_battery:
        battery(device)
    if not args.no_timing:
        rate = cs.mem_rate(torch.cuda.get_device_name(0))
        q, k, v, _ = cs._bwd_inputs(cs.BWD_DANUBE, torch.float32, device, 3,
                                    True)
        kw = cs._attn_kwargs(cs.BWD_DANUBE)
        fwd = cs.time_attention("danube training, fp32", q, k, v, kw,
                                cs.BWD_LIBRARY_REPS, rate, lse=True)
        cs.log(f"b6_f32_probe: forward {json.dumps(fwd)}")
        bwd = cs.time_attention_backward("danube training, fp32", q, k, v,
                                         kw, cs.BWD_LIBRARY_REPS, rate)
        cs.log(f"b6_f32_probe: backward {json.dumps(bwd)}")
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=device)
        o = swa.flash_swa_attention(q, k, v, lse=lse, **kw)
        do = torch.randn_like(o)
        split = launch_split(lambda: swa.flash_swa_attention_backward(
            q, k, v, o, do, lse=lse, **kw))
        cs.log(f"b6_f32_probe: backward device ms a call by launch "
               f"{json.dumps(split)}")
        del lse, o, do
        for tree in args.compare:
            lib = build_other(Path(tree))
            cmp = compare(lib, q, k, v, kw, cs.BWD_LIBRARY_REPS)
            cs.log(f"b6_f32_probe: {Path(tree).name} vs package at danube's "
                   f"shape {json.dumps(cmp)}")
        del q, k, v
        torch.cuda.empty_cache()
        for label, case in OTHER_SHAPES.items():
            q, k, v, _ = cs._bwd_inputs(case, torch.float32, device, 5, True)
            kw = cs._attn_kwargs(case)
            lse = torch.empty(q.shape[:3], dtype=torch.float32, device=device)
            ms = cs.cuda_ms(lambda: swa.flash_swa_attention(q, k, v, lse=lse,
                                                            **kw), cs.REPS)
            bound = cs.attention_bound(q, k, kw, rate)
            cs.log(f"b6_f32_probe: forward at {label} {case}: {ms:.4f} ms, "
                   f"bound {bound[0]:.4f} ms ({bound[1]}, "
                   f"{100 * bound[0] / ms:.1f} %)")
            del q, k, v, lse
    cs.log(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
