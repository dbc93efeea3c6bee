"""Serving launcher: continuous-batching engine over a reduced model (the
port of ``repro/launch/serve.py``).

``python -m repro_torch.launch.serve --arch qwen2-1.5b --requests 8`` boots
the slot-based engine (``serving/batching.py``) on the card with random
weights from a seed, submits synthetic event-token prompts drawn from the
SCALPEL3 tokenizer space, and decodes until done.  ``--device cpu`` runs it
on the CPU, where attention takes B6's plain version.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.models.registry import get_bundle
from repro_torch.serving.batching import ContinuousBatcher, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--kv-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    bundle = get_bundle(args.arch, reduced=True)
    params = bundle.init(0, device=args.device)
    engine = ContinuousBatcher(bundle, params, n_slots=args.slots,
                               kv_len=args.kv_len)

    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(args.requests):
        prompt = [1] + rng.integers(8, bundle.cfg.vocab_size,
                                    size=rng.integers(4, 12)).tolist()
        req = Request(rid=rid, prompt=prompt, max_new=args.max_new)
        reqs.append(req)
        engine.submit(req)

    t0 = time.time()
    steps = 0
    while any(not r.done for r in reqs) and steps < 10_000:
        engine.step()
        steps += 1
    dt = time.time() - t0
    n_tok = sum(len(r.out) for r in reqs)
    print(f"{len(reqs)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok/max(dt,1e-9):.1f} tok/s, {steps} engine steps)")
    for r in reqs[:4]:
        print(f"  req {r.rid}: prompt={len(r.prompt)} out={r.out[:8]}...")
    return reqs


if __name__ == "__main__":
    main()
