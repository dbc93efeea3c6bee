#!/usr/bin/env python3
"""The bf16 serving gate of ``chip_smoke.py`` (``bf16_gate``) on one NVIDIA
GPU: its margin over the sound cuda engine and over deliberately wrong ones.

    python3 tools/bf16_gate_probe.py [--arch ARCH ...]

For each model (default: phase 15's families at their depth there, with
deepseek-moe-16b at the 4 layers of its bf16 gate, and gemma3-12b whole;
xlstm-125m has no attention and is left out) at full width, bf16, seeded
weights drawn on the card as ``chip_smoke.py`` draws them: the last-token
logits of a 1 x 4,096 prefill (``chip_smoke.family_batch``) under the torch
engine, the cuda engine, and the cuda engine with its B6 calls made wrong
in one of three ways:

  * ``scale``: queries times 1.02 (a softmax temperature 2 % off);
  * ``late``: causal calls at ``q_offset + 1`` (each query also sees the
    key after it);
  * ``short``: ``kv_len - 1`` (the newest key is never attended);

then the same weights in fp32 under the same five engines.  Prints each
bf16 engine's max |logit difference| from the fp32 torch engine, its ratio
to the bf16 torch engine's and whether ``chip_smoke.bf16_gate`` passes it,
and each fp32 cuda engine's difference from the fp32 torch engine against
``chip_smoke.SERVE_GATE`` (1e-3); writes ``chiprun_out/bf16_gate_probe.json``.
Exits nonzero when either gate fails the sound cuda engine or the fp32 gate
passes a wrong one (the bf16 gate passes some wrong ones: their error
hides under bf16's own rounding).

``--sound ARCH`` (repeatable; any family, xlstm-125m too) reads instead how
far sound bf16 computations of one model spread: the cuda engine as
phase 15 runs it, with cuBLAS's reduced-precision bf16 reductions off,
and on a batch of the sequence twice (other GEMM shapes, row 0 read); each
one's distance from the fp32 model and from the first.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WRONG = ("scale", "late", "short")


def wrong_flash(fn, kind: str):
    """B6 on the model's tensors (``layers._flash``) made wrong by ``kind``."""
    def call(q, k, v, *, causal, window, q_offset, kv_len):
        if kind == "scale":
            q = q * 1.02
        elif kind == "late" and causal:
            q_offset = q_offset + 1
        elif kind == "short":
            kv_len = kv_len - 1
        return fn(q, k, v, causal=causal, window=window, q_offset=q_offset,
                  kv_len=kv_len)
    return call


def readings(cs, arch: str, layers) -> dict:
    import numpy as np
    import torch

    from repro_torch.models import get_bundle
    from repro_torch.models import layers as L
    from repro_torch.models.registry import ModelBundle

    cfg = get_bundle(arch).cfg
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    bundle = ModelBundle(cfg)
    params = bundle.init(0, device="cuda")
    batch = cs.family_batch(cfg, 1, cs.FAMILY_PREFILL,
                            np.random.default_rng(11), "cuda")

    def engines(bundle, batch):
        out = {e: bundle.prefill(params, batch, engine=e).float()
               for e in ("torch", "cuda")}
        flash = L._flash
        for kind in WRONG:
            L._flash = wrong_flash(flash, kind)
            try:
                out[kind] = bundle.prefill(params, batch,
                                           engine="cuda").float()
            finally:
                L._flash = flash
        return out

    b16 = engines(bundle, batch)
    gc.collect()
    torch.cuda.empty_cache()
    cs.to_fp32_in_place(params)
    l32 = engines(ModelBundle(dataclasses.replace(cfg, dtype="float32")),
                  {k: v if k == "tokens" else v.float()
                   for k, v in batch.items()})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ref = l32["torch"]
    out = {"bf16": {e: float((x - ref).abs().max()) for e, x in b16.items()},
           "fp32": {e: float((x - ref).abs().max()) for e, x in l32.items()
                    if e != "torch"},
           "max_logit32": float(ref.abs().max()), "layers": cfg.n_layers}
    out["bound"] = cs.bf16_gate(out["bf16"]["torch"], out["max_logit32"])
    return out


def sound_readings(cs, arch: str) -> dict:
    """Sound bf16 computations of ``arch`` at phase 15's depth and prefill
    length: their distances from the fp32 model and from phase 15's."""
    import numpy as np
    import torch

    from repro_torch.models import get_bundle
    from repro_torch.models.registry import ModelBundle

    _, layers, twin, seq, _ = next(f for f in cs.FAMILIES if f[0] == arch)
    cfg = get_bundle(arch).cfg
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    bundle = ModelBundle(cfg)
    params = bundle.init(0, device="cuda")
    batch = cs.family_batch(cfg, 1, seq, np.random.default_rng(11), "cuda")
    twice = {k: torch.cat([v, v]) for k, v in batch.items()}
    mm = torch.backends.cuda.matmul
    with torch.no_grad():
        got = {"phase 15": bundle.prefill(params, batch, engine="cuda")}
        mm.allow_bf16_reduced_precision_reduction = False
        try:
            got["no reduced-precision reductions"] = bundle.prefill(
                params, batch, engine="cuda")
        finally:
            mm.allow_bf16_reduced_precision_reduction = True
        got["batch of two, row 0"] = bundle.prefill(params, twice,
                                                    engine="cuda")[:1]
        cs.to_fp32_in_place(params)
        b32 = ModelBundle(dataclasses.replace(cfg, dtype="float32"))
        ref = b32.prefill(params, {k: v if k == "tokens" else v.float()
                                   for k, v in batch.items()},
                          engine="torch").float()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    first = got["phase 15"].float()
    return {"seq": seq, "layers": cfg.n_layers,
            "max_logit32": float(ref.abs().max()),
            "from_fp32": {k: float((v.float() - ref).abs().max())
                          for k, v in got.items()},
            "from_phase_15": {k: float((v.float() - first).abs().max())
                              for k, v in got.items()}}


def main() -> int:
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    default = [(a, twin if twin is not None else layers)
               for a, layers, twin, _, _ in cs.FAMILIES if a != "xlstm-125m"]
    default.append((cs.GEMMA, None))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append",
                    help="a model of the default list (repeatable)")
    ap.add_argument("--sound", action="append",
                    help="read the spread of sound bf16 computations of "
                         "this family instead (repeatable)")
    args = ap.parse_args()
    runs = [r for r in default if not args.arch or r[0] in args.arch]
    import torch

    if not torch.cuda.is_available():
        print("bf16_gate_probe: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    cs.LOG["file"] = open(out / "bf16_gate_probe.log", "w")
    cs.log(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"card {torch.cuda.get_device_name(0)}, {cs.nvidia_smi_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    if args.sound:
        res = {arch: sound_readings(cs, arch) for arch in args.sound}
        for arch, r in res.items():
            cs.log(f"sound bf16: {arch} ({r['layers']} layers, 1 x "
                   f"{r['seq']}): {json.dumps(r)}")
        (out / "bf16_sound_probe.json").write_text(json.dumps(res, indent=1))
        return 0
    res, bad = {}, []
    gate32 = cs.SERVE_GATE["float32"]
    for arch, layers in runs:
        r = readings(cs, arch, layers)
        res[arch] = r
        b16, f32 = r["bf16"], r["fp32"]
        cs.log(f"bf16 gate: {arch} ({r['layers']} layers): from the fp32 "
               f"model, torch {b16['torch']}, max |logit| "
               f"{r['max_logit32']}, gate {r['bound']}; " + "; ".join(
                   f"{e} {b16[e]} (ratio {b16[e] / b16['torch']:.4f}, "
                   f"{'passes' if b16[e] <= r['bound'] else 'fails'})"
                   for e in ("cuda",) + WRONG))
        cs.log(f"fp32 gate: {arch}: from the fp32 torch engine (gate "
               f"{gate32}): " + "; ".join(
                   f"{e} {f32[e]} "
                   f"({'passes' if f32[e] <= gate32 else 'fails'})"
                   for e in ("cuda",) + WRONG))
        if b16["cuda"] > r["bound"] or f32["cuda"] > gate32:
            bad.append(f"{arch} cuda")
        bad += [f"{arch} {e} (fp32)" for e in WRONG if f32[e] <= gate32]
    (out / "bf16_gate_probe.json").write_text(json.dumps(res, indent=1))
    if bad:
        cs.log(f"gates: wrong verdicts: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
