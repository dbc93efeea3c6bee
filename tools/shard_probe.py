#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s sharded-models phase (phase 17) alone on the card.

    python3 tools/shard_probe.py [--no-fp32-backward] [--parts a,b,...]

Builds the port's kernels; runs phase 15's record of each family phase 17
holds a sharded prefill against (deepseek-moe-16b for part (a), the four
families of part (d): full-depth and twin logits, the fp32 model's, the
bf16 gate) and danube's step-1 loss on the claims stream's first batch
(the forward of phase 16's first step, for part (b)); times B6's fp32
backward at danube's training shape (phase 16's call); with part (g),
runs phase 9's battery and timings of B6's decode route with the LSE; then
phase 17's parts on 4 gloo ranks of the card: all of them, or those of
``--parts`` (letters a-g); with ``h``, part (h) (the dry run of the calls
of parts (a), (b) and (g3), and danube's production cells, started before
the build and held against the calls that ran).  Exits nonzero when a
check fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-fp32-backward", action="store_true")
    ap.add_argument("--parts", default="abcdefgh")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("shard_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.launch.train import claims_token_stream
    from repro_torch.models import get_bundle

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    cs.LOG["file"] = open(ROOT / "chiprun_out" / "shard_probe.log", "w")
    name = torch.cuda.get_device_name(0)
    rate = cs.mem_rate(name)
    cs.log(cs.nvidia_smi_line())
    parts = tuple(cs.PARTS[ord(c) - ord("a")] for c in args.parts
                  if c not in ",h")
    started = cs.dryrun_start() if "h" in args.parts else None
    build.library()
    archs = ([cs.SHARD_MOE] if "prefill" in parts else []) + (
        list(cs.SHARD_FAMILIES) if "families" in parts else [])
    for arch, layers, twin, seq, batcher in cs.FAMILIES:
        if arch in archs:
            t0 = time.perf_counter()
            cs.family_run(arch, layers, twin, seq, batcher, cs.REPS, rate)
            cs.log(f"shard_probe: phase 15's {arch} record in "
                   f"{time.perf_counter() - t0:.3f} s")
    step1 = None
    if "train" in parts:
        bundle = get_bundle(cs.DANUBE)
        batch = next(claims_token_stream(cs.TRAIN_SEQ, cs.TRAIN_BATCH,
                                         bundle.cfg.vocab_size, 0,
                                         device="cuda"))
        with torch.no_grad():
            step1 = float(bundle.train_loss(bundle.init(0, device="cuda"),
                                            batch))
        del batch
        torch.cuda.empty_cache()
    if not args.no_fp32_backward:
        q, k, v, _ = cs._bwd_inputs(cs.BWD_DANUBE, torch.float32,
                                    torch.device("cuda"), 3, True)
        rec = cs.time_attention_backward(
            "danube training, fp32", q, k, v, cs._attn_kwargs(cs.BWD_DANUBE),
            cs.BWD_LIBRARY_REPS, rate)
        cs.log(f"shard_probe: B6 fp32 backward {json.dumps(rec)}")
        del q, k, v
        torch.cuda.empty_cache()
    if "decode" in parts:
        t0 = time.perf_counter()
        rec = cs.decode_lse_battery(torch.device("cuda"), cs.REPS, rate)
        cs.log(f"shard_probe: B6's decode route with the LSE in "
               f"{time.perf_counter() - t0:.3f} s: {json.dumps(rec)}")
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, summary = cs.sharded_models_phase(step1, parts)
    cs.log(f"shard_probe: phase 17 in {time.perf_counter() - t0:.3f} s; "
           f"launches {json.dumps(launches)}")
    calls = summary.pop("dryrun_calls")
    if started:
        t0 = time.perf_counter()
        rec = cs.dryrun_phase(started, calls)
        cs.log(f"shard_probe: part (h) in {time.perf_counter() - t0:.3f} "
               f"s: {json.dumps(rec)}")
    cs.log(f"shard_probe: {json.dumps(summary)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
