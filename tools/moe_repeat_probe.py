#!/usr/bin/env python3
"""Run one deepseek-moe-16b MoE layer many times in one process and report
every run whose output is not bit-equal to the first (ROADMAP C19).

    python3 tools/moe_repeat_probe.py [--repeats N] [--profiled N]

On the card.  The layer is the one ``chip_smoke.py``'s phase 15 splits by
stage: the first MoE layer (layer 1) of deepseek-moe-16b at full width,
phase 15's seeded weights (``bundle.init(0)``; drawing the first two
layers alone gives the same values), and its input on phase 15's 1 x
4,096 prefill tokens (the ``cuda`` engine, as phase 15 runs it).  Settings,
each against the first plain ``moe_ffn`` output:

* ``plain``: ``moe_ffn`` called ``--repeats`` times;
* ``staged``: the same, with each stage function wrapped in a profiler
  range that ends in a synchronization, as phase 15's ``moe_split`` runs
  it;
* ``profiled``: staged and plain calls alternating under
  ``torch.profiler`` (``--profiled`` of each);
* ``deterministic``: one call under ``torch.use_deterministic_algorithms(
  True, warn_only=True)``, naming every op on the path that has no
  deterministic CUDA implementation;
* ``workspace``: a child process under ``CUBLAS_WORKSPACE_CONFIG=:4096:8``
  repeats ``plain`` and ``staged``; its outputs' digests are compared
  with this process's.

It also counts ties in the router's top-k (equal logits at the k-th and
(k+1)-th choice of a token).  The whole log goes to
``chiprun_out/moe_repeat_probe.log``; the last line is a JSON summary.
Exits nonzero if any run differs.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

ARCH = "deepseek-moe-16b"
WORKSPACE = ":4096:8"


def capture():
    """(params, x, cfg) of phase 15's first MoE layer call."""
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.models import get_bundle
    from repro_torch.models import layers as L
    from repro_torch.models.registry import ModelBundle

    full = get_bundle(ARCH).cfg
    bundle = ModelBundle(dataclasses.replace(full, n_layers=2))
    params = bundle.init(0, device="cuda")
    batch = cs.family_batch(full, 1, cs.FAMILY_PREFILL,
                            np.random.default_rng(11), "cuda")
    rec = cs.Recorder(L, "moe_ffn", lambda p, x, c: x.numel())
    with rec, torch.no_grad():
        bundle.prefill(params, batch, engine="cuda")
    _, (p, x, cfg), _ = rec.best
    return p, x, cfg


def staged_ffn(p, x, cfg):
    """``moe_ffn`` with each stage function in a range that ends in a
    synchronization (phase 15's ``moe_split``)."""
    import torch
    from torch.profiler import record_function

    from chip_smoke import MOE_STAGES
    from repro_torch.models import layers as L

    def wrap(stage, fn):
        def staged(*a, **kw):
            with record_function("moe." + stage):
                res = fn(*a, **kw)
                torch.cuda.synchronize()
            return res
        return staged

    saved = {name: getattr(L, name) for _, name in MOE_STAGES}
    try:
        for stage, name in MOE_STAGES:
            setattr(L, name, wrap(stage, saved[name]))
        return L.moe_ffn(p, x, cfg)
    finally:
        for name, fn in saved.items():
            setattr(L, name, fn)


def digest(y) -> str:
    """The sha256 of a tensor's bytes."""
    import torch

    return hashlib.sha256(y.contiguous().view(-1).view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()


def repeat(fn, y0, n: int) -> dict:
    """``fn()`` ``n`` times: the runs that differ from ``y0``, the largest
    difference and the digests of the differing outputs."""
    import torch

    differ, worst, digests = 0, 0.0, set()
    for _ in range(n):
        y = fn()
        if not torch.equal(y, y0):
            differ += 1
            worst = max(worst, float((y.float() - y0.float()).abs().max()))
            digests.add(digest(y))
    torch.cuda.synchronize()
    return dict(runs=n, differ=differ, max_abs_diff=worst,
                digests=sorted(digests))


def router_ties(p, x, cfg) -> dict:
    """Tokens whose k-th and (k+1)-th router logits are equal (a tie at the
    top-k boundary), and whose chosen logits hold a tie."""
    import torch

    from repro_torch.models import layers as L

    xt = x.reshape(-1, x.shape[-1])
    logits = L.mm(xt.float(), p["router"])
    top = torch.sort(logits, dim=-1, descending=True).values
    k = cfg.top_k
    edge = int((top[:, k - 1] == top[:, k]).sum())
    inner = int((top[:, :k - 1] == top[:, 1:k]).any(dim=-1).sum())
    gap = float((top[:, k - 1] - top[:, k]).min())
    return dict(tokens=xt.shape[0], k=k, boundary_ties=edge,
                tokens_with_inner_ties=inner, smallest_boundary_gap=gap)


def child(repeats: int) -> dict:
    import torch

    from repro_torch.kernels import build
    from repro_torch.models import layers as L

    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    p, x, cfg = capture()
    with torch.no_grad():
        y0 = L.moe_ffn(p, x, cfg)
        return {"workspace": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
                "first": digest(y0),
                "plain": repeat(lambda: L.moe_ffn(p, x, cfg), y0, repeats),
                "staged": repeat(lambda: staged_ffn(p, x, cfg), y0,
                                 repeats)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=300)
    ap.add_argument("--profiled", type=int, default=50)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("moe_repeat_probe: CUDA is not available", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(child(args.repeats)))
        return 0
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.models import layers as L

    torch.backends.cuda.matmul.allow_tf32 = False
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    cs.LOG["file"] = open(ROOT / "chiprun_out" / "moe_repeat_probe.log", "w")
    cs.log(cs.nvidia_smi_line())
    cs.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"CUBLAS_WORKSPACE_CONFIG "
           f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}")
    build.library()
    t0 = time.perf_counter()
    p, x, cfg = capture()
    cs.log(f"captured {ARCH} layer 1's MoE input {tuple(x.shape)} "
           f"{x.dtype} in {time.perf_counter() - t0:.3f} s")
    out = {}
    with torch.no_grad():
        y0 = L.moe_ffn(p, x, cfg)
        out["first"] = digest(y0)
        out["ties"] = router_ties(p, x, cfg)
        cs.log(f"router: {json.dumps(out['ties'])}")
        for name, fn in (("plain", lambda: L.moe_ffn(p, x, cfg)),
                         ("staged", lambda: staged_ffn(p, x, cfg))):
            t0 = time.perf_counter()
            out[name] = repeat(fn, y0, args.repeats)
            cs.log(f"{name}: {json.dumps(out[name])} in "
                   f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        with cs.profiled():
            pro = [repeat(lambda: staged_ffn(p, x, cfg), y0, 1)
                   for _ in range(args.profiled)]
            pro += [repeat(lambda: L.moe_ffn(p, x, cfg), y0, 1)
                    for _ in range(args.profiled)]
        out["profiled"] = dict(
            runs=len(pro), differ=sum(r["differ"] for r in pro),
            max_abs_diff=max(r["max_abs_diff"] for r in pro),
            digests=sorted({d for r in pro for d in r["digests"]}))
        cs.log(f"profiled: {json.dumps(out['profiled'])} in "
               f"{time.perf_counter() - t0:.3f} s")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                y = L.moe_ffn(p, x, cfg)
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        ops = sorted({str(w.message).split(" does not have")[0]
                      for w in caught})
        out["deterministic"] = dict(equal=bool(torch.equal(y, y0)),
                                    nondeterministic_ops=ops)
        cs.log(f"deterministic: {json.dumps(out['deterministic'])}")
    del p, x, y0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=WORKSPACE)
    res = subprocess.run(
        [sys.executable, __file__, "--child", "--repeats",
         str(args.repeats)], env=env, capture_output=True, text=True,
        timeout=1200)
    if res.returncode != 0:
        cs.log(f"workspace child failed: {res.stderr[-3000:]}")
        return 1
    kid = json.loads(res.stdout.strip().splitlines()[-1])
    kid["same_as_parent"] = kid["first"] == out["first"]
    out["workspace"] = kid
    cs.log(f"workspace {WORKSPACE}: {json.dumps(kid)} in "
           f"{time.perf_counter() - t0:.3f} s")
    digests = {out["first"]} | set(out["plain"]["digests"]) | set(
        out["staged"]["digests"]) | set(out["profiled"]["digests"])
    runs = sum(out[k]["runs"] for k in ("plain", "staged", "profiled")) \
        + 1 + kid["plain"]["runs"] + kid["staged"]["runs"]
    differ = sum(out[k]["differ"] for k in ("plain", "staged", "profiled")) \
        + int(not out["deterministic"]["equal"]) + kid["plain"]["differ"] \
        + kid["staged"]["differ"] + int(not kid["same_as_parent"])
    summary = dict(runs=runs, differ=differ, digests=len(digests),
                   ties=out["ties"],
                   nondeterministic_ops=out["deterministic"][
                       "nondeterministic_ops"])
    cs.log(json.dumps(summary))
    return 0 if differ == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
