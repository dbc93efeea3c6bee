"""Training launcher: SCALPEL3 claims -> tokens -> LM train loop with
checkpoint and restart (the port of ``repro/launch/train.py``).

Pipeline: synthetic SNDS (DCIR star) -> flatten -> extract (drug
dispenses, medical acts) -> cohort -> ``FeatureDriver.token_sequences`` ->
fixed-shape batches -> ``train.make_train_step``.  Batch ``t`` is a pure
function of ``(seed, t)`` (one numpy permutation of the patients, as the
reference's), so a restart replays the data cursor exactly; the latest
checkpoint under ``ckpt_dir`` is restored on start; steps that take more
than 3x the median of the last 50 are logged as stragglers.

    python -m repro_torch.launch.train --arch xlstm-125m --device cpu

runs a reduced model on the CPU (attention through B6's plain forward and
backward); without ``--device`` it runs on the card.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.columnar import resolve_device
from repro_torch.models.registry import get_bundle
from repro_torch.train.checkpointing import (AsyncCheckpointer, latest_step,
                                             restore_checkpoint)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step

__all__ = ["claims_token_stream", "train", "main"]


def claims_token_stream(seq_len: int, batch: int, vocab: int, seed: int,
                        n_patients: int = 512, device=None
                        ) -> Iterator[Dict[str, torch.Tensor]]:
    """Deterministic batches from the SCALPEL3 pipeline, built once on
    ``device`` (None = CUDA) at the default engines: ``{"tokens" (batch,
    seq_len) int32 clipped to [0, vocab), "loss_mask" (batch, seq_len)
    fp32}``; batch ``t`` takes patients ``order[(t * batch + i) %
    n_patients]`` of ``np.random.default_rng(seed).permutation``."""
    from repro_torch.core import (Cohort, DCIR_SCHEMA, FeatureDriver,
                                  TokenizerSpec, drug_dispenses,
                                  flatten_star, medical_acts_dcir,
                                  sort_events)
    from repro_torch.core.columnar import ColumnarTable
    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir

    dev = resolve_device(device)
    cfg = SyntheticConfig(n_patients=n_patients, seed=seed)
    dcir = generate_dcir(cfg, device=dev)
    flat, _ = flatten_star(DCIR_SCHEMA, dcir)
    events = sort_events(ColumnarTable.concat(
        [drug_dispenses()(flat), medical_acts_dcir()(flat)]))
    cohort = Cohort.from_events("all", events, cfg.n_patients)
    toks, mask = FeatureDriver(cohort).token_sequences(
        seq_len, TokenizerSpec.default())
    toks = torch.clamp(toks, 0, vocab - 1)
    mask = mask.to(torch.float32)

    step = 0
    order = np.random.default_rng(seed).permutation(n_patients)
    while True:
        idx = order[(step * batch + np.arange(batch)) % n_patients]
        ix = torch.from_numpy(idx).to(dev)
        yield {"tokens": toks[ix], "loss_mask": mask[ix]}
        step += 1


def train(arch: str, steps: int = 100, batch: int = 8, seq_len: int = 128,
          reduced: bool = True, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, log_every: int = 10, microbatches: int = 1,
          seed: int = 0, device=None, engine: str = "auto",
          n_patients: int = 512) -> Dict[str, Any]:
    """Train ``arch`` on the claims stream for ``steps`` steps (from the
    latest checkpoint under ``ckpt_dir``, if any) on ``device`` (None =
    CUDA).  Returns ``{"losses", "final_loss", "step_times", "state"}``
    (losses and step times of the steps this call ran)."""
    dev = resolve_device(device)
    bundle = get_bundle(arch, reduced=reduced)
    cfg = bundle.cfg
    if cfg.is_encdec:
        raise ValueError(f"{arch}: the claims stream has tokens only; an "
                         f"encoder-decoder also needs frames")
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=20, total_steps=steps)
    step_fn = make_train_step(bundle, opt_cfg, microbatches=microbatches,
                              engine=engine)
    state = init_train_state(bundle, seed, dev)
    start_step = 0
    ckpt = None
    if ckpt_dir:
        ckpt = AsyncCheckpointer(ckpt_dir)
        last = latest_step(ckpt_dir)
        if last is not None:
            state, manifest = restore_checkpoint(ckpt_dir, last, state,
                                                 device=dev)
            start_step = manifest["step"]
            print(f"[restore] resumed from step {start_step}")

    stream = claims_token_stream(seq_len, batch, cfg.vocab_size, seed,
                                 n_patients=n_patients, device=dev)
    for _ in range(start_step):  # replay the cursor deterministically
        next(stream)

    losses, step_times = [], []
    for t in range(start_step, steps):
        batch_t = next(stream)
        t0 = time.time()
        state, metrics = step_fn(state, batch_t)
        loss = float(metrics["loss"])         # waits for the step
        dt = time.time() - t0
        losses.append(loss)
        step_times.append(dt)
        if len(step_times) > 10:
            med = float(np.median(step_times[-50:]))
            if dt > 3.0 * med:
                print(f"[straggler] step {t} took {dt:.2f}s "
                      f"(median {med:.2f}s)")
        if t % log_every == 0:
            print(f"step {t:5d} loss {loss:8.4f} ({dt * 1e3:6.1f} ms)",
                  flush=True)
        if ckpt and (t + 1) % ckpt_every == 0:
            ckpt.save(t + 1, state, meta={"arch": arch, "seed": seed})
    if ckpt:
        ckpt.wait()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "step_times": step_times, "state": state}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full (non-reduced) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = train(args.arch, steps=args.steps, batch=args.batch,
                seq_len=args.seq_len, reduced=not args.full_size,
                ckpt_dir=args.ckpt_dir, microbatches=args.microbatches,
                device=args.device)
    print(f"final loss: {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
