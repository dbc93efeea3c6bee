#!/usr/bin/env python3
"""Probe B6's backward on the card: a quick check and timing while it is
being changed.

    python3 tools/b6_bwd_probe.py [--no-battery] [--no-timing] [--variant FILE ...]

1. Builds the port's kernels and prints ptxas's lines for the bf16 backward
   (``bwd_dq_wgmma``/``bwd_dkdv_wgmma`` at every head dim), the
   bf16 prefill kernel ``flash_wgmma<80>`` (which writes the log-sum-exp),
   and any "serialized" or "ignored" warning of the backward's source.
2. Runs ``chip_smoke.py``'s backward battery (every ``BWD_CASES`` entry in
   fp32 and bf16, the forward's log-sum-exp against the plain one, the bf16
   backward twice bit for bit, autograd through ``FlashAttention``).
3. Times the backward at h2o-danube-1.8b's training shape and at
   recurrentgemma's head dim 256 (``chip_smoke.time_attention_backward``:
   kernel, plain backward, SDPA's backward, the bound, the forward that
   writes the log-sum-exp), and splits a call's device time between its
   dq and dkdv launches (``torch.profiler``).

4. ``--variant FILE`` (repeatable): builds FILE, an edited or earlier copy
   of ``csrc/swa_backward_bf16.cu``, standalone (``nvcc -shared``, its
   ptxas lines logged) and, at both timed shapes, compares its gradients
   with the package's and times both in turns.

Exits nonzero when a check fails.  ``tools/b6_probe.py --variant`` does the
same for ``swa_prefill.cu``.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def variant_fn(path: str):
    """``repro_flash_attention_bwd_bf16`` of ``path`` (an edited copy of
    ``csrc/swa_backward_bf16.cu``), built standalone with ``nvcc -shared``
    beside ``csrc/``'s headers; ptxas's lines are logged."""
    import ctypes
    import subprocess

    import chip_smoke as cs
    from repro_torch.kernels import build

    out = ROOT / "_proof" / (Path(path).stem + ".so")
    out.parent.mkdir(exist_ok=True)
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                        "-I", str(build.CSRC_DIR), "-o", str(out), path],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"variant {path} does not build:\n{r.stdout}"
                         f"{r.stderr}")
    for line in (r.stdout + r.stderr).splitlines():
        if "Used" in line or "spill" in line or "serialized" in line:
            cs.log(f"variant ptxas: {line.strip()}")
    fn = ctypes.CDLL(str(out)).repro_flash_attention_bwd_bf16
    P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [P] * 10 + [I64] * 24 + [I32] * 8 + [I64, I32, P]
    fn.restype = I32
    return fn


def variant_call(fn, q, k, v, o, do, lse, kw):
    """The wrapper's launch of the bf16 backward, through ``fn``."""
    import ctypes

    import torch

    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kv_len = Skv if kw["kv_len"] is None else kw["kv_len"]
    q_off = kv_len - Sq if kw["q_offset"] is None else kw["q_offset"]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty(B * Hq * Sq, dtype=torch.float32, device=q.device)
    st = [ctypes.c_longlong(x) for t in (q, k, v, o, do, dq, dk, dv)
          for x in t.stride()[:3]]
    rc = fn(*[t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv, lse,
                                     delta)], *st, B, Hq, Hkv, Sq, Skv, D,
            int(kw["causal"]), int(kw["window"]), ctypes.c_longlong(q_off),
            kv_len, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"variant launch failed with CUDA error {rc}")
    return dq, dk, dv


def compare_variant(fn, name, label, q, k, v, kw):
    """The variant's gradients against the package's (bit for bit or the
    gap), then both timed in turns (package, variant, variant, package)."""
    import chip_smoke as cs
    import torch

    from repro_torch.kernels import swa_attention as swa

    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    o = swa.flash_swa_attention(q, k, v, lse=lse, **kw)
    do = torch.randn_like(o)
    pkg = lambda: swa.flash_swa_attention_backward(  # noqa: E731
        q, k, v, o, do, lse=lse, **kw)
    var = lambda: variant_call(fn, q, k, v, o, do, lse, kw)  # noqa: E731
    gap = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(pkg(), var()))
    times = [(tag, cs.cuda_ms(f, cs.REPS)) for tag, f in
             (("package", pkg), (name, var), (name, var), ("package", pkg))]
    cs.log(f"variant {name} at {label}: max |variant - package| {gap}; "
           + ", ".join(f"{tag} {ms:.4f} ms" for tag, ms in times))


def launch_split(q, k, v, kw, reps: int = 10) -> dict:
    """Device ms a backward call spends in each of its kernels (the dq and
    the dkdv launch), from ``torch.profiler`` over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import swa_attention as swa

    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    o = swa.flash_swa_attention(q, k, v, lse=lse, **kw)
    do = torch.randn_like(o)
    swa.flash_swa_attention_backward(q, k, v, o, do, lse=lse, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            swa.flash_swa_attention_backward(q, k, v, o, do, lse=lse, **kw)
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        name = re.search(r"bwd_\w+", e.key)
        if name:
            split[name.group(0)] = e.device_time_total / 1e3 / reps
    return split


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-battery", action="store_true")
    ap.add_argument("--no-timing", action="store_true")
    ap.add_argument("--variant", action="append", default=[],
                    help="an edited copy of csrc/swa_backward_bf16.cu, timed "
                         "against the package's build")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("b6_bwd_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.swa_attention import HEAD_DIMS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    cs.LOG["file"] = open(ROOT / "chiprun_out" / "b6_bwd_probe.log", "w")
    cs.log(cs.nvidia_smi_line())
    build.library()
    info = build.build_info()
    cs.log(f"build: {info['seconds']:.1f} s")
    text = info["log"]
    section = text.split("== swa_backward_bf16.cu")[1].split("\n== ")[0]
    for line in section.splitlines():
        if "serialized" in line or "ignored" in line or "warning" in line:
            cs.log("ptxas warning: " + line.strip())
    cs.log("ptxas: flash_wgmma<80>: "
           + cs.kernel_registers(text, "flash_wgmma", 80))
    for D in HEAD_DIMS:
        for kern in ("bwd_dq_wgmma", "bwd_dkdv_wgmma"):
            cs.log(f"ptxas: {kern}<{D}>: "
                   + cs.kernel_registers(text, kern, D))
    variants = {path: variant_fn(path) for path in args.variant}
    if not args.no_battery:
        cs.backward_battery(torch.device("cuda"))
    if not args.no_timing:
        rate = cs.mem_rate(torch.cuda.get_device_name(0))
        for label, case, seed in (("danube training", cs.BWD_DANUBE, 3),
                                  ("recurrentgemma, head dim 256",
                                   cs.BWD_WIDE, 4)):
            q, k, v, _ = cs._bwd_inputs(case, torch.bfloat16,
                                        torch.device("cuda"), seed, True)
            t = cs.time_attention_backward(label, q, k, v,
                                           cs._attn_kwargs(case), cs.REPS,
                                           rate)
            cs.log(f"b6_bwd_probe: {label} {json.dumps(t)}")
            cs.log(f"b6_bwd_probe: {label}, device ms a call by kernel "
                   f"{json.dumps(launch_split(q, k, v, cs._attn_kwargs(case)))}")
            for path in args.variant:
                compare_variant(variants[path], Path(path).stem, label, q, k,
                                v, cs._attn_kwargs(case))
            del q, k, v
            torch.cuda.empty_cache()
    cs.log(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
