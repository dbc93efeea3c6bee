#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--n-patients N] [--cohort-patients N]
                          [--sharded-patients N] [--chunked-patients N]

Phases (any failure exits nonzero; no phase catches its own failure, and
nothing falls back to the CPU):

  1. environment: torch/CUDA versions, the card's name and power limit, and
     the build of the CUDA kernels from ``src/repro_torch/csrc`` (ptxas must
     report no stack frame and no spill for both of B1's kernels, and no
     spill for B6's bf16 prefill kernel at head dim 96);
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, bit for bit, at edge sizes with NULLs, NaNs, an Expr battery,
     hoisted literals and ragged whitelists (up to eight of 1,024 values,
     bitmaps, shared- and global-memory searches, 15 register-file slots);
     the battery again over float32 denormals of both signs in columns,
     literals and whitelists (flushed as XLA flushes them, ROADMAP C4);
     B1's whole battery again at its tile edges (tile ± 1 row), one wave of
     its persistent grid ± 33 rows and three waves; the segmented scan (B4)
     over flag patterns, runs spanning many blocks and up to a thousand of
     its look-back tiles (with no flag at all), block sizes on and off its
     tiles, and values beyond its ±2e9 fills; B3's program kernel over
     programs of 1-8 ops on 1-8 leaves (every op), aligned and misaligned
     views, sizes at its block and grid edges up to 2,062,500 words (the
     SNDS universe), with its count buffers' pool blocks poisoned first;
  3. quickstart: the quickstart study (synthetic DCIR star, flatten, two
     extractors, patients, cohort algebra, flow) at ``--n-patients`` on the
     card with the ``cuda`` engines; every kernel of the path must have
     launched (B3 once for each cohort expression), the no-loss audit must
     pass, and the ``torch`` engines must give the same answer; each kernel
     is timed at the shapes that run gave it (B1 also at the longest
     program with a whitelist that the run launched; B3 also over 2,062,500
     words with L2 cleared, beside an empty kernel's launch; B1, B3 and B4
     as the middle of 3 medians of 20 with their min-max), and one warm run
     is traced with torch.profiler: device time by
     kernel, the device's busy and idle share of the run's wall time, and a
     Chrome trace in ``chiprun_out/quickstart_trace.json``;
  4. chunked: the quickstart's star (at ``--chunked-patients``, default
     the quickstart's 2,000,000: the same star and resident cuda result)
     partitioned into chunks of 8,388,608 ER_PRS rows under
     ``.chunk_store/`` (removed after); ``Study.check`` must equal
     ``tests/goldens/quickstart_diag.json`` (code, severity, node); the
     normalized plan (``normalize``, ``device_params``) must equal the
     plan's own run on the card, B1 launching as often with hoisted
     operands and nothing demoted; ``run_chunked`` under the cuda engines
     with and without prefetch must equal the resident run bit for bit
     (valid rows in order, cohort words and counts, flow, FlatteningStats,
     the OperationLog's plan entries), build one runner, and launch B1 and
     B2 as the resident run does on every chunk and B3 once per cohort
     expression per chunk plus the replay; a kill-and-resume (``crash_after
     =2``) at 200,000 patients must equal its resident run with 2 chunks
     resumed; the chunk count, each run's ``load_s``/``exec_s``/
     ``wall_s``/``overlap_saved_s`` and peak device memory beside the
     resident run's are printed, and one warm chunked run is traced
     (``chiprun_out/chunked_trace.json``);
  5. spec: ``spec_from_study`` of the quickstart and cohort-study plans
     must equal ``tests/goldens/*_spec.json``, and ``compile_spec`` of each
     golden, run on the card under the cuda engines, must equal the
     builder-made study bit for bit (every slot, words, stats, cohorts,
     flow, features, the plan's log entries); then the fuzzer's corpus
     (``study.fuzz.run_corpus``, 48 specs from seed 0 over a 200,000-patient
     star, executor engine ``cuda``): 24 valid specs each run under the
     torch and cuda predicate engines (raw columns and words equal) and
     chunked over a store under ``.chunk_store/spec`` (valid rows equal;
     SP003 plans refused by its preflight), 24 mutations each rejected with
     their ``SPEC-nnn`` code; B1-B3 must have launched;
  6. service: the cohort-query service on the quickstart's resident star
     (``--n-patients``) under the cuda engines, 8 slots, a 16 GiB cache:
     ``benchmarks/serving_bench.py``'s mix re-expressed with the port (32
     queries of 4 tenants over its three shapes, literals of their own,
     after one warm-up query a shape), each result taken and let go as the
     drain resolves it; the naive path (one solo run a query), the service
     synchronous and pipelined (walls, submit_s, realize_s, overlap_s,
     latency p50/p95, hits, misses, evictions, bytes cached, peak memory):
     3 runners built, 0 demotions, and B1/B2/B3 launches equal to what the
     solo runs and the hit counts predict; both modes again on fresh
     services with every ticket checked against its solo run (every slot,
     words, counts, FlatteningStats, cohorts, flow, plan log), hits and
     misses equal to the timed serves'; a served log is the solo run's
     without its plan entries, as the reference's local service logs
     (ROADMAP C12); a wire spec of shape full equal to
     its Study twin and a malformed spec ``invalid`` with SPEC-012; one
     warm pipelined serve traced (``chiprun_out/service_trace.json``);
  7. cohort study: ``examples/cohort_study.py``'s plan (DCIR and PMSI,
     exposures, fractures, follow-up, cohort algebra, flow, the dense and
     token featurizes) at ``--cohort-patients``, checked, timed and traced
     the same way (``chiprun_out/cohort_study_trace.json``), with B4 timed at
     the shapes ``exposures`` gave it;
  8. card against CPU: both studies at 20,000 patients on the card and on
     the CPU (the plain versions) must agree bit for bit;
  9. attention: B6 (flash attention) against its plain version on the card
     over the reference's test sweep, phase 15's shapes (head dim 96 on
     every route; non-causal calls with more or fewer queries than keys at
     q_offset 0), h2o-danube-1.8b's shapes (prefill
     to 8,192 tokens with window 4,096, full-cache decode offsets, the
     ring-buffer mode, ragged shapes) and gemma3-12b's (16/8 heads of 240:
     local and global prefill to 8,192, decode offsets, the ring with 1 and
     3 queries), head dim 256, and every head dim on the bf16 prefill kernel
     with ragged Sq and kv_len and a window edge inside a tile, fp32 within
     2e-5 and bf16 within 2e-2; every call of at most 16 rows per KV head
     (group x Sq) must take the decode route (split-KV flash-decoding,
     ``csrc/swa_decode.cu``), every other call the prefill kernel (bf16:
     ``csrc/swa_prefill.cu``, TMA and wgmma; fp32:
     ``csrc/swa_attention.cu``), which must have run at every head dim;
  10. serving: h2o-danube-1.8b at full width (24 layers, bf16, random weights
     from a seeded generator on the card): a 2 x 8,192-token prefill under
     the cuda and torch attention engines (B6 launched once per layer, the
     last-token logits within 0.1; the decode route never taken), the
     continuous batcher (4 slots, every cache a 4,096-slot ring, 8 requests
     of 16-256 prompt tokens, 32 new each: all finish; every attention call
     takes the decode route), a teacher-forced decode past position 4,096
     (the ring wraps; its wall before and after the wrap) under both
     engines in fp32 (within 1e-3) and bf16 (within 0.1), cut to 2 layers
     at full width, and the reduced config on the card against the CPU
     (within 1e-5); B6 is timed at the prefill's shape and its decode route
     at the batcher's shape over a full ring (the L2 cache cleared before
     every rep: one layer's 42 MB of K/V would fit in it), beside its plain
     version, torch's scaled_dot_product_attention with a boolean mask (a
     yardstick the port never calls) and its bound, each time the middle
     of 3 separate medians of 20 reps with their min-max, and one prefill,
     one warm batcher step and one decode pass over full rings are traced
     (``chiprun_out/serving_*_trace.json``).
  11. gemma3: one gemma3-12b local layer at full width over its 1,024-slot
     ring with 3 queries a call, before and after the wrap, cuda engine
     against torch engine (fp32 within 1e-3, bf16 within 0.1); then the
     whole model at full width (48 layers, bf16, seeded random weights on
     the card, after the danube model is freed): a 1 x 4,096-token prefill
     under both engines (B6's prefill kernel once per layer at head dim
     240, its decode route never), then the same weights in fp32 under
     both (last-token logits within 1e-3; in bf16 the cuda engine within
     ``bf16_gate`` of the fp32 model, as in phase 15), and B6
     timed at the model's global (causal) and local (window 1,024) prefill
     shapes as in phase 10.
  12. partition: B5 (the shuffle's plan) against its plain version, bit for
     bit, over 1-64 destinations, blocks 256/512/1024, ragged lengths,
     invalid rows, NULL and negative keys; B2b (compaction by a bool mask,
     a single pass with decoupled look-back) through ``ops.filter_compact``
     against its plain version at the edges of its 4,096-row tiles and up to
     48M rows, once with 7 columns, and timed there;
  13. sharded: the quickstart through ``Study.run(mesh=group)`` on 4 gloo
     ranks of one process group, all on the one card, at
     ``--sharded-patients`` (2,000,000 by default): every rank launches B5
     once per exchange (5) and B3 once, no exchange overflows, no rank
     holds more of a table output than its own block (the blocks' counts
     add up to the global count), the cuda engines equal the torch engines
     (each rank's block words, the valid rows of every block, gathered),
     the sharded result equals the single-card run of the same seed (event
     rows as multisets, cohort words, flow, join stats), each rank's output
     capacities, peak memory, staged bytes and collectives are printed,
     and at 20,000 patients
     the quickstart, ``distributed_flatten`` and ``exposures_sharded`` on
     the card equal the same 4 ranks on the CPU (through the package's
     rank functions in ``distributed.launch``); B5 is timed at rank 0's
     largest exchange beside its plain version, its bound and the torch
     engine's ``hash_partition`` (the argsort route, a yardstick).
  14. sharded service: on the same 4 ranks, after the sharded quickstart
     and over the same star (each rank's 2,000,000 patients, generated
     once), ``CohortQueryService(star, mesh=group)`` under the cuda
     engines, 8 slots, a 16 GiB global budget: the naive path (the mix's
     first 12 queries, every tenant x every shape, each a solo
     ``Study.run(mesh=group)``, timed; their launches and digests kept),
     then on fresh services, synchronous and pipelined, a warm-up query a
     shape and the 12 queries timed (3 runners built, 0 demotions, B1-B3
     and B5 launches equal to what the solo runs and the hits predict),
     then both modes again with every ticket held against its solo run
     (this rank's block words and valid rows, so the gathered rows, global
     counts, FlatteningStats with the exchanges', cohort words, flow, the
     log) and no block past its capacity; hits, misses, evictions and
     bytes cached equal on every rank and in both modes.  Per rank: the
     walls, latency p50/p95, ``submit_s``/``realize_s``, hits, misses,
     evictions, bytes cached, peak memory, staged bytes and collectives by
     kind (``tools/sharded_service_probe.py`` runs this phase alone).
  15. families: each other model family at full width, bf16, seeded random
     weights drawn on the card, freed before the next: deepseek-moe-16b
     (28 layers: a dense one, 27 of 64 routed experts top-6 and 2 shared),
     qwen2-moe-a2.7b (60 experts padded to 64, QKV bias; depth cut to 4),
     recurrentgemma-2b (26 layers: RG-LRU and local attention, MQA 10/1 of
     256, window 2,048), xlstm-125m (12 mLSTM/sLSTM layers, no attention),
     seamless-m4t-medium (12 encoder and 12 decoder layers over 1,024
     frames) and phi-3-vision-4.2b (32 layers, heads of 96, 576 image
     embeddings): a 1 x 4,096 prefill under the cuda and torch engines (B6
     once per attention call, the encoder's and cross-attention's
     non-causal ones included, its decode route never; last-token logits
     finite; their bf16 difference between engines is printed, not gated:
     bf16 alone moves these logits 0.07-0.24 from the fp32 model's), the
     batcher (4 slots of
     4,096, 8 requests, all finish, every attention call on the decode
     route; one warm step traced, ``chiprun_out/<arch>_decode_trace.json``),
     then the same weights in fp32, the whole model (converted in place,
     a layer at a time: deepseek's 61 GiB fit once its bf16 weights are
     gone), under both engines (within 1e-3), and the bf16 gate against
     that fp32 model as gemma3-12b's: the bf16 cuda engine no further from
     it than 1.15 times the bf16 torch engine plus a quarter bf16 ulp of
     the largest logit (``bf16_gate``; deepseek: its first 4 layers beside
     their own fp32 twin, as routing flips spread through the whole
     model); every B6 call of these runs must have the shapes and mask
     kind of a battery case of phase 9 (``b6_key``); the reduced config in
     fp32 on the card against the CPU (within 1e-5);
     each MoE model's layer split by stage from one trace
     (``chiprun_out/<arch>_moe_layer_trace.json``), xlstm's recurrent layers timed
     at 4,096 tokens (its prefills run 1,024: the sLSTM is a loop of
     launches), and B6 timed at phi-3-vision's prefill shape and at
     seamless's cross-attention (4,096 queries over 1,024 frames) as in
     phase 10.
  16. training: B6's backward (``csrc/swa_backward_bf16.cu`` in bf16,
     ``csrc/swa_backward.cu`` in fp32) against its plain backward over the
     forward's sweep, every head dim with ragged Sq,
     Skv and kv_len and a window edge inside a tile, GQA 1-10, non-causal
     and cross calls, rows that see no key, fp32 and bf16 (within
     ATTN_TOL of each gradient's largest |value| and ATTN_ROW_TOL a row),
     and autograd through ``FlashAttention`` against autograd through the
     plain forward; both backwards twice on the same inputs, bit for bit;
     the fp32 kernels' tile plans against their Python twins;
     h2o-danube-1.8b at full width (bf16, remat, seeded
     random weights) trained by ``launch.train.train`` from the claims
     stream, 4 AdamW steps of 2 x 8,192 tokens: finite losses, B6's
     forward 48 and backward 24 launches a step (the decode route never),
     every parameter's gradient finite and nonzero on the next batch, the
     warm step's wall, tokens/s and peak memory, one step traced
     (``chiprun_out/train_step_trace.json``: device time of the forward,
     backward and optimizer ranges, top kernels, idle share); at full
     width cut to 2 layers, the cuda engine against the torch engine in
     fp32 (loss within 1e-5 relative, every gradient leaf within 1e-3 of
     its largest |value|) and in bf16 against the fp32 loss
     (``bf16_gate``); reduced danube, deepseek-moe-16b and
     seamless-m4t-medium in fp32 end to end, 3 steps on the card against
     the CPU (losses and master within 1e-5); the reference's restart
     test on the card (reduced xlstm-125m: 6 steps against 3 + save +
     restore + 3, bit for bit); and B6's backward timed at danube's
     training shape beside its plain version, the backward of SDPA with a
     boolean mask and its bound (10 D flops a visible pair and head), in
     bf16 and in fp32 (``csrc/swa_backward.cu``, the CUDA cores, 5 reps a
     median), with the fp32 forward (``csrc/swa_attention.cu``'s
     ``flash_f32`` writing the LSE) beside its plain version and SDPA with
     the boolean mask, 5 reps a median.
  17. sharded models: one ``spawn`` of 4 gloo ranks on the card, the
     parts in turn (no fallback: a failing rank fails the run).
     (a) deepseek-moe-16b at full width and depth (28 layers, 64 routed
     experts top-6 + 2 shared), bf16, on a (1, 4) mesh: each rank's blocks
     (16 experts, 4 of 16 heads, a quarter of the vocab) drawn leaf by leaf
     from phase 15's seed, never the whole model on a rank; a 1 x 4,096
     prefill of phase 15's tokens: B6's prefill kernel 28 times on every
     rank, logits finite; at phase 15's 4-layer twin the last-token logits
     within phase 15's bf16 gate for deepseek of both its one-rank cuda
     engine and its fp32 model (at 28 layers the one-rank distance is
     printed, not gated: routing flips); the model cut to 2 layers in fp32
     against one rank within 1e-3.  (b) h2o-danube-1.8b at full width and
     depth (16/4 heads of 80 a rank), bf16, remat, on a (2, 2) mesh with
     ZeRO-1, phase 16's seed and claims stream, 3 steps of 2 x 8,192
     tokens (a sequence a data rank): finite losses, B6's forward 48 and
     bf16 backward 24 times a step on every rank, step 1's loss within a
     bf16 gate of phase 16's (``bf16_gate`` of the fp32 model's loss and
     the bf16 torch engine's, built on the card before the ranks start);
     cut to 2 layers in fp32, the loss within 1e-5 and every gathered
     gradient within 1e-3 of its leaf's largest against one rank.  (c)
     ``pipeline_transformer`` over a 4-rank "pipe" mesh, one danube layer
     (fp32, B6) a stage, 4 microbatches of 1 x 2,048: output and gradients
     against the sequential run within 1e-4.  (d) recurrentgemma-2b,
     xlstm-125m, seamless-m4t-medium and phi-3-vision-4.2b at full width
     and depth, bf16, on a (1, 4) mesh (recurrentgemma also on (2, 2),
     where its 10 heads split 5 a rank; at (1, 4) its attention runs whole
     on every rank), each rank's blocks drawn leaf by leaf from phase 15's
     seed: the prefill of phase 15's tokens, frames and images (1 x 4,096,
     xlstm 1 x 1,024), B6 once an attention call on every rank, logits
     finite and within phase 15's bf16 gate for the family of both its
     one-rank cuda engine and its fp32 model (xlstm has no attention, so
     its torch engine is its cuda engine bit for bit: its bound takes the
     larger distance from the fp32 model of that and of the cuda engine on
     a batch of the sequence twice), and cut to a period of its layer
     kinds in fp32 against one rank within 1e-3, the check that decides
     where bf16's own spread hides an error.  (e) recurrentgemma-2b at
     full width cut to 8 of 26 layers (two periods and the tail), as (b):
     3 steps of 2 x 4,096 claims tokens, B6 4 + 2 a step, step 1's loss
     within the bf16 gate of the fp32 model's; its fp32 cut is one period
     (3 layers, B6 at head dim 256 with MQA) on 2 x 1,024 tokens.  (f)
     A9-pod: danube cut to 2 layers in fp32 on a (pod, data, model) = (2,
     1, 2) mesh, one step with ``compress_crosspod=True`` against the
     one-rank compressed step, read from what each step produced (from
     zero moments, a first step's m is a fixed multiple of its compressed
     gradient): loss within 1e-5; every logical tensor's m on the int8
     grid of one scale within 1e-3 of a bin; the compressed gradients
     where the bins agree and each leaf's scale within 1e-3 of their
     largest, at most one bin apart in at most 1e-2 of the elements; the
     master within 1e-5 where the bins agree and lr + 1e-5 where they do
     not.  (g) A9-sp, the sharded decode (``make_serve_step`` on the
     rank's blocks of a cache under ``cache_shardings``, a token a step):
     (g1) gemma3-12b's long_500k cell, batch 1, kv_len 524,288, the
     sequence over every axis of (2, 2), full width cut to 12 layers (10
     rings of 1,024 slots, 2 global caches of 4.03 GB, 1.01 GB a rank), at
     positions 1,000, 131,071 and 131,072 (ranks past the first blocks see
     no key of a global cache) and 524,280-524,287; (g2) recurrentgemma-2b
     at decode_32k's batch 128, (1, 4), full depth, its 2,048-slot MQA ring
     512 slots a rank, 8 tokens past the wrap; (g3) deepseek-moe-16b on (1,
     4), part (a)'s rank weights, batch 4, kv_len 4,096, KV heads a rank,
     EP MoE.  Caches drawn in fixed chunks of 4,096 slots, each from its
     own seed, a rank only its blocks' chunks, the one-rank twin the same.
     Gates: every rank's B6 decode launches a step as its blocks predict
     (the route with the LSE where the sequence is split, none where the
     rank holds no key the query sees) and its blocks outside the written
     slots equal to their draw; the bf16 run (g3: at phase 15's twin
     depth; its full depth printed) within ``bf16_gate`` of one rank's
     cuda engine and of the fp32 model (logits, the written cache slots,
     the recurrent states); a full-width fp32 cut (one period of g1 and
     g2, part (a)'s 2 layers for g3) within 1e-3 of one rank, greedy
     tokens equal.  Phase 9 also holds B6's decode route with the LSE
     against its plain version at those blocks' shapes, an empty block
     included, and times it (``flash_decode_lse``).
     Per part and rank: the wall, peak memory, staged bytes, the staging's
     share of the wall and the collectives by kind; the warm step's
     tokens/s for (b) and (e), the wall a token for (g) beside one rank's
     (``tools/shard_probe.py`` runs this phase alone).  (h) A9-dryrun:
     the dry run (``repro_torch.launch.dryrun``: meta tensors, rank 0 of a
     fake world of the part's mesh, no kernel) of (a)'s prefill, (b)'s
     first step and (g3)'s first token at their own meshes, shapes and
     depths, each in a subprocess that sees no card, beside the command
     line on danube's ``train_4k``, ``prefill_32k`` and ``decode_32k``
     cells on 16 x 16 (``chiprun_out/dryrun/``); all six start together
     before the kernel build (niced, a thread each: they read nothing of
     the run) and are read once the ranks end: each call's collectives by
     kind (count and bytes) and argument bytes equal to what rank 0
     measured around exactly that call, each cell ``ok``; the predicted
     peak printed beside the call's ``max_memory_allocated`` (no gate).

Each kernel's launches are counted over the two studies' first runs, the
first chunked run (with prefetch), the spec corpus, the timed pipelined
service serve, the serving path (prefill and batcher), gemma3-12b's
prefill, the sharded run's first cuda run, the sharded service's timed
pipelined serve (both summed over ranks) and each family's prefill and
batcher (phase 15), the full-width training run (phase 16) and phase 17's
prefills, training steps, pipeline, pod step and the main bf16 run of
each sharded decode (summed over ranks), with the counts set to 0 just
before each.  B6's ``flash_attention`` count takes one per call on either
route; its record's launches are those calls less the decode route's
(``flash_decode``), which has a record of its own; ``flash_decode_lse``
counts the decode-route launches that also write the LSE (phase 17's (g),
in ``flash_decode`` too); its backward (``flash_attention_bwd``) launches
only in training.  B6's fp32 kernels count under ``flash_attention_f32``
and ``flash_attention_bwd_f32`` too (their main path: phase 17's fp32 pod
step), and their launches over the whole run, the fp32 gates and phase
17's ranks included, are printed beside.  B2b runs on none of these paths
(no caller compacts by a bool mask): its count is 0.  The last lines of
standard output are the card's name and power limit, one JSON line with the kernel records,
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# memory rate of each card, bytes/s (NVIDIA data sheets); the bound of a
# kernel is the bytes it must move over this rate
_MEM_RATE = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12))


LOG = {"file": None}       # main() also writes every line to a log file


def log(*a) -> None:
    print(*a, flush=True)
    if LOG["file"] is not None:
        print(*a, file=LOG["file"], flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def mem_rate(name: str) -> float:
    for key, rate in _MEM_RATE:
        if key in name:
            return rate
    fail(f"no memory rate known for card {name!r}")


L2_FLUSH = {"buf": None}    # 256 MiB read before a cold rep: 5x the L2
SPIN_CYCLES = 2_000_000     # ~1 ms of device spin ahead of every timed rep


def cuda_ms(fn, reps: int, cold: bool = False) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after one warm-up).
    Each rep starts behind a spin kernel of ~1 ms, so that the host has
    queued all of ``fn``'s launches before the card reaches the first
    event: the time is the card's, not the host's.  ``cold``: the L2 cache
    is cleared before each rep, outside the timed window, by reading a
    256 MiB buffer (a read leaves no dirty lines to write back)."""
    import torch

    if cold and L2_FLUSH["buf"] is None:
        L2_FLUSH["buf"] = torch.zeros(32 << 20, dtype=torch.int64,
                                      device="cuda")
    fn()
    times = []
    for _ in range(reps):
        if cold:
            L2_FLUSH["buf"].sum()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
EDGE_SIZES = (0, 1, 31, 32, 33, 1025)
REPS = 20                 # CUDA-event timings per kernel (median reported)
SNDS_WORDS = 2_062_500    # B3 at the SNDS universe, 66M patients
CPU_PATIENTS = 20_000     # scale of the card-vs-CPU comparison


def _same(a, b) -> bool:
    """Bit-identical (NaNs included), compared on ``a``'s device."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b.to(a.device)))


def expr_battery():
    from repro_torch.study import col
    from repro_torch.study.expr import HoistedIsIn, HoistedLit

    return [
        col("a") >= 3,
        (col("a") >= 3) & (col("b") < 10),
        col("a").isin([1, 2, 9]),                  # padded 3 -> 8
        col("a").isin([]),
        col("x").isin([0, 1]),
        col("x").isin([0.5, -1.25, 2.0]),
        col("a").not_null() & col("x").not_null(),
        col("a").is_null() | col("x").is_null(),
        (col("a") + 2) % 3 == 1,
        col("b") * 2 >= col("a"),
        col("x") > 0.25,
        ~(col("x") <= 0.75),
        (col("a").is_null() | (col("a") > 4)) & (col("b") != 7),
        col("b").between(-1, 9),
        ~((col("a") < 0) | col("x").is_null())
        & (col("a").isin([3, 4, 5]) | (col("b") % 2 == 0)),
        col("a") // 0 == -2,                       # jnp: x // 0 == -2
        col("b") // col("z") <= 1,                 # mixed zero divisors
        col("b") % col("z") == 0,
        col("x") // 0.0 != col("x") // 0.0,        # NaN
        col("x") % 0.0 != col("x") % 0.0,
        col("x") // col("y") >= 1.0,
        col("x") % col("y") < 0.5,
        col("a") - col("b") * 3 < col("x"),        # int32 -> float32
        col("b") == 2.5,
        HoistedLit(0) < col("b"),
        col("x") >= HoistedLit(1),
        HoistedIsIn(col("b"), 0, 5, False),
        HoistedIsIn(col("x"), 1, 3, True) | (col("a") == HoistedLit(0)),
        # whitelists of the full MAX_ISIN_VALUES (staged in shared memory,
        # the int ones as bitmaps), one past it (searched in global memory),
        # eight at once (every table slot), and a hoisted one of 1,024
        # values
        col("a").isin(list(range(-509, 515))),
        col("x").isin([float(v) / 8 for v in range(-512, 512)]),
        col("b").isin(list(range(-3, 1098))),
        # int whitelists too wide for a bitmap (searched in shared memory),
        # one holding the NULL sentinel
        col("a").isin([-10 ** 6, 3, 4, 10 ** 6]),
        col("a").isin([-2 ** 31 + 1, 4]) | col("b").isin([2 ** 31 - 1, -2]),
        _any_isin([col(c) for c in "abzabzab"], 1024),
        HoistedIsIn(col("a") + col("b"), 2, 1024, False),
        # 16 live registers: 15 register-file slots, the 8-row kernel
        _nested_sum("abzab" * 3 + "z") > 0,
        # a balanced tree: many live registers (register-file slots)
        (((col("a") < 3) | (col("b") > 2)) & ((col("x") < 0.5)
                                              | (col("y") > -0.5)))
        & (((col("z") != 0) | (col("a") + col("b") < col("z") * 4))
           & ((col("x") * col("y") < 0.25) | col("a").is_null())),
    ]


def _nested_sum(names: str):
    """``c0 + (c1 + (... + c_last))`` over the columns ``names``: each
    left operand stays live until the innermost sum is done."""
    from repro_torch.study import col

    e = col(names[-1])
    for c in reversed(names[:-1]):
        e = col(c) + e
    return e


def _any_isin(operands, size: int):
    """``operand_k in W_k`` OR'd over k: one whitelist of ``size`` values
    (shifted by 3 k) for each operand."""
    e = None
    for k, x in enumerate(operands):
        term = x.isin(list(range(3 * k - size // 2, 3 * k + size - size // 2)))
        e = term if e is None else e | term
    return e


def battery_params():
    """The bound (literals, whitelists) behind the battery's hoisted slots."""
    import numpy as np

    return ((np.int32(4), np.float32(-0.5)),
            (np.array([7, -3, 2, 2, 11], np.int32),
             np.array([0.25, np.nan, -1.0], np.float32),
             np.arange(-700, 2 * 1024 - 700, 2, dtype=np.int32)))


def denormal_battery():
    """C4: float32 denormals of both signs in columns, literals and
    whitelists, under arithmetic and compares (the battery's ``x`` and
    ``y`` columns draw from ``DENORMALS``); with ``denormal_params``."""
    from repro_torch.study import col
    from repro_torch.study.expr import HoistedIsIn, HoistedLit

    return [col("x") > 0, col("x") == 0, col("x") * 1e30 > 0,
            col("x") < 0.0, col("y") >= 1e-40, col("x") - col("y") == 0,
            col("x") * col("y") != 0, col("x") // -1.0 < col("y"),
            col("x") % col("y") >= 0, col("b") * 1e-44 == col("x"),
            col("x").isin([1e-40, -2.5]), col("y").isin([0.0, 1e30]),
            col("x") > HoistedLit(1), col("y") == HoistedLit(1),
            HoistedIsIn(col("x"), 1, 3, True)]


# denormals of both signs, signed zeros, the least normals, NaN and others
DENORMALS = (1e-45, -1e-45, 1e-39, -1e-40, 3e-39, 0.0, -0.0, 1.1754944e-38,
             -1.1754942e-38, float("nan"), 1.0, -2.5, 1e30)


def denormal_params():
    import numpy as np

    lits, vecs = battery_params()
    return ((lits[0], np.float32(-1e-40)),
            (vecs[0], np.array([1e-41, 2.0, -1e-45], np.float32), vecs[2]))


def battery_columns(n: int, device, denormal: bool = False):
    """The battery's columns and validity words over ``n`` rows: NULLs,
    NaNs and zero divisors, from a seed of ``n``; with ``denormal``, the
    float columns drawn from ``DENORMALS``."""
    import numpy as np
    import torch

    from repro_torch.core import bitset as bs
    from repro_torch.core.columnar import NULL_INT

    rng = np.random.default_rng(n)
    a = rng.integers(-5, 15, n).astype(np.int32)
    a[rng.random(n) < 0.25] = NULL_INT
    x = rng.normal(size=n).astype(np.float32)
    x[rng.random(n) < 0.2] = np.nan
    y = rng.normal(size=n).astype(np.float32)
    y[rng.random(n) < 0.2] = 0.0
    if denormal:
        pool = np.array(DENORMALS, np.float32)
        x, y = rng.choice(pool, n), rng.choice(pool, n)
    cols = {"a": a, "b": rng.integers(-5, 15, n).astype(np.int32),
            "x": x, "y": y,
            "z": rng.integers(-2, 3, n).astype(np.int32)}
    cols = {k: torch.from_numpy(v).to(device) for k, v in cols.items()}
    valid = bs.pack(torch.from_numpy(rng.random(n) < 0.85).to(device))
    return cols, valid, rng


def check_predicates(exprs, cols, valid, n: int, params) -> int:
    """Each expression through the kernel against its plain version, bit
    for bit; returns the number checked."""
    import torch

    from repro_torch.kernels import predicate as pk

    for e in exprs:
        param = e.to_param()
        prog = pk.compile_program(param, *pk._kinds(cols, param, params))
        got = pk.predicate_bitset(cols, valid, expr_param=param, capacity=n,
                                  params=params)
        want = pk.predicate_bitset_plain(prog, cols, valid, n, params) \
            if n else got
        torch.cuda.synchronize()
        if not (_same(got[0], want[0]) and int(got[1]) == int(want[1])):
            fail(f"predicate kernel != plain at n={n} for {e!r}")
    return len(exprs)


def kernel_battery(device) -> None:
    import torch

    from repro_torch.kernels import filter_compact as fc

    exprs = expr_battery()
    params = battery_params()
    checked = 0
    for n in EDGE_SIZES:
        cols, valid, _ = battery_columns(n, device)
        checked += check_predicates(exprs, cols, valid, n, params)
        # B2: int32 + float32 columns (NaNs), and > 32 columns (two launches)
        many = [cols[k] for k in ("a", "b", "x", "y", "z")] * 7
        for cs in (many[:5], many):
            got, gc = fc.filter_compact_bits(cs, valid)
            want, wc = fc.filter_compact_plain(cs, valid)
            torch.cuda.synchronize()
            if int(gc) != int(wc) or not all(_same(g, w)
                                             for g, w in zip(got, want)):
                fail(f"filter_compact kernel != plain at n={n}")
            checked += 1
    # C4: denormals in columns, literals and whitelists (flushed as XLA does)
    for n in (1025, 100_003):
        cols, valid, _ = battery_columns(n, device, denormal=True)
        checked += check_predicates(exprs + denormal_battery(), cols, valid,
                                    n, denormal_params())
    log(f"kernels: {checked} kernel-vs-plain checks bit-identical "
        f"at n in {EDGE_SIZES}, and with float32 denormals at 1025 and "
        f"100003 rows")
    predicate_edges(device, exprs, params)
    bitset_battery(device)


def random_program(rng, n_leaves: int, n_ops: int, first_op: int = 0):
    """A seeded B3 program: op ``j`` is ``OPS[(first_op + j) % 4]``, each
    operand a leaf or, half the time where there is one, an earlier op."""
    from repro_torch.kernels import bitset_ops as bo

    ops = list(bo.OPS)
    return tuple(
        (ops[(first_op + j) % 4],
         *[int(rng.integers(n_leaves, n_leaves + j)) if j
           and rng.random() < 0.5 else int(rng.integers(0, n_leaves))
           for _ in range(2)])
        for j in range(n_ops))


def bitset_battery(device) -> None:
    """B3's program kernel against its plain version, bit for bit: programs
    of 1-8 ops over 1-8 leaves covering every op, aligned and misaligned
    (scalar path) views, sizes at its block and grid edges up to 2,062,500
    words, with the pool's blocks of its count buffers poisoned (-1) and
    freed before every launch."""
    import numpy as np
    import torch

    from repro_torch.kernels import bitset_ops as bo

    t = bo.THREADS
    sms, per_sm = bo._limits(device, 1)
    wave = sms * per_sm * t * 4     # the widest grid's
    sizes = sorted({0, 1, 3, 4, 5, t - 1, t + 1, 4 * t - 1, 4 * t,
                    4 * t + 1, 62_500, wave - 1, wave + 5, SNDS_WORDS})
    rng = np.random.default_rng(17)
    checked = 0
    for n in sizes:
        base = torch.randint(-2**31, 2**31 - 1, (8, n + 1),
                             dtype=torch.int32, device=device)
        for k, (n_leaves, n_ops) in enumerate(
                [(i + 1, 8 - i) for i in range(8)]):
            prog = random_program(rng, n_leaves, n_ops, first_op=k)
            for off in (0, 1):
                leaves = [base[i, off:n + off] for i in range(n_leaves)]
                grid = bo.expr_grid(n if off else n // 4 + n % 4,
                                    *bo._limits(device, n_ops))
                junk = [torch.full((n_ops * (1 + grid),), -1,
                                   dtype=torch.int32, device=device)
                        for _ in range(8)]
                del junk
                got, gc = bo.bitset_expr_kernel(leaves, prog)
                want, wc = bo.bitset_expr_plain(leaves, prog)
                torch.cuda.synchronize()
                if not (_same(got, want) and _same(gc, wc)):
                    fail(f"bitset_expr kernel != plain at n={n} "
                         f"offset={off} program={prog}")
                checked += 1
    log(f"kernels: {checked} bitset_expr (B3) kernel-vs-plain checks "
        f"bit-identical (1-8 ops over 1-8 leaves, every op, offsets 0/1, "
        f"poisoned counts) at n in {sizes}; its grid: {sms} SMs x "
        f"{[bo._limits(device, k)[1] for k in range(1, 9)]} blocks of "
        f"{bo.THREADS} for 1-8 ops")


def predicate_sizes(exprs, params, device):
    """B1's sizes at the edges of its design: one tile (± 1 row), one full
    wave of the persistent grid (grid x tile ± 33, for each grid and tile
    the battery's programs get) and one where every block walks at least 3
    tiles; and those (grid, tile) pairs."""
    from repro_torch.kernels import predicate as pk

    cols, _, _ = battery_columns(1, device)
    sizes, waves = set(), set()
    for e in exprs:
        param = e.to_param()
        prog = pk.compile_program(param, *pk._kinds(cols, param, params))
        plan = pk.device_plan(prog, 1 << 40, device, params)
        sizes |= {plan.tile - 1, plan.tile, plan.tile + 1}
        waves.add((plan.grid, plan.tile))
    for g, tile in waves:
        sizes |= {g * tile - 33, g * tile + 33}
    sizes.add(3 * max(g * tile for g, tile in waves) + 17)
    return sorted(sizes), sorted(waves)


def predicate_edges(device, exprs, params) -> None:
    """The whole expression battery at B1's tile and wave edges."""
    import torch

    sizes, waves = predicate_sizes(exprs, params, device)
    checked = 0
    for n in sizes:
        cols, valid, _ = battery_columns(n, device)
        checked += check_predicates(exprs, cols, valid, n, params)
        del cols, valid
    torch.cuda.empty_cache()
    log(f"kernels: {checked} predicate kernel-vs-plain checks bit-identical "
        f"at B1's tile and wave edges, n in {sizes} (persistent grids, "
        f"tiles: {waves})")


# to 4,103 rows: the 512-row blocks' edges; then hundreds of the kernel's
# 4,096-row look-back tiles
SCAN_SIZES = (1, 31, 511, 512, 513, 4096 + 7, 300 * 4096 + 5,
              1000 * 4096 - 1)
SCAN_BLOCKS = (32, 512, 4099)   # 4,099: block edges off the tile grid
# values beyond the reference kernel's ±2e9 fills, where its clamp shows
EXTREMES = (2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1, 2_000_000_000,
            -2_000_000_000, 2_100_000_000, -2_100_000_000, 0, 7)


def segment_scan_battery(device) -> None:
    """B4 against its plain version, bit for bit: random, all and only-first
    flags, runs spanning many blocks (and, with no flag, every look-back
    tile), extreme values, both fills."""
    import numpy as np
    import torch

    from repro_torch.core import bitset as bs
    from repro_torch.kernels import segment_scan as ss

    checked = 0
    for n in SCAN_SIZES:
        rng = np.random.default_rng(n)
        flag_sets = {"random": rng.random(n) < 0.05,
                     "all": np.ones(n, bool),
                     "first": np.arange(n) == 0,
                     "none": np.zeros(n, bool),
                     "sparse": rng.random(n) < 2e-3}
        val_sets = {"dates": rng.integers(14_000, 16_000, n),
                    "extreme": rng.choice(np.array(EXTREMES, np.int64), n)}
        for fname, f in flag_sets.items():
            words = bs.pack(torch.from_numpy(f).to(device))
            for vname, v in val_sets.items():
                vals = torch.from_numpy(v.astype(np.int32)).to(device)
                for block in SCAN_BLOCKS:
                    for fill in (ss.DEFAULT_FILL, ss.EXACT_FILL):
                        got = ss.segmented_scan_kernel(words, vals, block, fill)
                        want = ss.segmented_scan_plain(words, vals, block, fill)
                        torch.cuda.synchronize()
                        if not all(_same(g, w) for g, w in zip(got, want)):
                            fail(f"segmented_scan kernel != plain at n={n} "
                                 f"flags={fname} values={vname} "
                                 f"block={block} fill={fill}")
                        checked += 1
    log(f"kernels: {checked} segmented_scan kernel-vs-plain checks "
        f"bit-identical at n in {SCAN_SIZES}, blocks {SCAN_BLOCKS}")


# ---------------------------------------------------------------------------
# phases 3, 7 and 8: the quickstart, the cohort study, card against CPU
# ---------------------------------------------------------------------------
STUDY_END = 14_600 + 3 * 365


def build_study(n_patients: int):
    from repro_torch.core import DCIR_SCHEMA, drug_dispenses, medical_acts_dcir
    from repro_torch.study import Study

    return (Study(n_patients=n_patients)
            .flatten(DCIR_SCHEMA)
            .extract(drug_dispenses(), name="drug_purchases")
            .extract(medical_acts_dcir(codes=list(range(30))), name="acts")
            .patients("IR_BEN")
            .cohort("base", "extract_patients")
            .cohort("drugged", "drug_purchases")
            .cohort("final", "drugged & base - acts")
            .flow("base", "drugged", "final"))


def build_cohort_study(n_patients: int):
    """``examples/cohort_study.py``'s plan, tasks (a)-(g), over the port."""
    from repro_torch.core import (diagnoses, drug_dispenses, hospital_stays,
                                  medical_acts_dcir, medical_acts_pmsi)
    from repro_torch.study import Study, col

    end = STUDY_END
    return (Study(n_patients=n_patients, window=(14_600, end))
            .patients("IR_BEN")
            .extract(drug_dispenses(), name="drug_purchases")
            .extract(drug_dispenses()
                     .filtered(col("cip13").isin(range(65))
                               & col("execution_date").between(14_600, end)),
                     name="prevalent_drugs")
            .extract(medical_acts_dcir(), name="acts")
            .extract(medical_acts_pmsi(), name="hospital_acts")
            .extract(diagnoses(), name="diagnoses")
            .extract(hospital_stays(), name="stays")
            .transform("exposures", "drug_purchases", name="exposures",
                       purview_days=60)
            .concat("all_acts", "acts", "hospital_acts")
            .transform("fractures", "all_acts", "diagnoses", name="fractures",
                       fracture_act_codes=list(range(30)),
                       fracture_diag_codes=list(range(40)))
            .transform("follow_up", "extract_patients", "drug_purchases",
                       name="follow_up", study_end=end)
            .cohort("base", "extract_patients")
            .cohort("exposed", "exposures")
            .cohort("fractured", "fractures")
            .cohort("final", "(exposed & base) - fractured")
            .flow("base", "exposed", "final")
            .featurize("X", cohort="final", kind="dense",
                       n_buckets=36, bucket_days=31, n_features=128)
            .featurize("tokens", cohort="final", kind="tokens", seq_len=256))


def snds_tables(n_patients: int, device):
    """The flat DCIR and PMSI tables plus IR_BEN, as the example feeds them."""
    from repro_torch.core import DCIR_SCHEMA, PMSI_MCO_SCHEMA, flatten_star
    from repro_torch.data.synthetic import SyntheticConfig, generate_snds

    dcir, pmsi = generate_snds(SyntheticConfig(n_patients=n_patients,
                                               seed=42), device=device)
    return {"DCIR": flatten_star(DCIR_SCHEMA, dcir)[0],
            "PMSI_MCO": flatten_star(PMSI_MCO_SCHEMA, pmsi)[0],
            "IR_BEN": dcir["IR_BEN"]}


def compare_results(a, b, what: str, full_columns: bool) -> None:
    """Events (valid rows in order; every slot when ``full_columns``),
    validity words, counts, FlatteningStats, cohort words, flow and
    features (bit for bit; feature checks equal)."""
    if sorted(a.events) != sorted(b.events):
        fail(f"{what}: different outputs")
    for name in a.events:
        ta, tb = a.events[name], b.events[name]
        na, nb = int(ta.count), int(tb.count)
        if na != nb or not _same(ta.valid, tb.valid):
            fail(f"{what}: {name} count/validity differ ({na} vs {nb})")
        for c in ta.columns:
            ca, cb = ta.columns[c], tb.columns[c]
            if not full_columns:
                ca, cb = ca[:na], cb[:nb]
            if not _same(ca, cb):
                fail(f"{what}: {name}.{c} differs")
    if a.flatten_stats != b.flatten_stats:
        fail(f"{what}: FlatteningStats differ")
    for name in a.cohorts:
        if not _same(a.cohorts[name].subjects, b.cohorts[name].subjects):
            fail(f"{what}: cohort {name} differs")
    if (a.flow is None) != (b.flow is None) or (
            a.flow is not None and a.flow.flowchart() != b.flow.flowchart()):
        fail(f"{what}: flow differs")
    if sorted(a.features) != sorted(b.features) \
            or a.feature_checks != b.feature_checks:
        fail(f"{what}: features or feature checks differ")
    for name, fa in a.features.items():
        fb = b.features[name]
        pairs = zip(fa, fb) if isinstance(fa, tuple) else [(fa, fb)]
        if not all(_same(x, y) for x, y in pairs):
            fail(f"{what}: feature {name} differs")


PEAKS = {}        # label -> (peak, held) device bytes of drive()'s first run


class Recorder:
    """Keeps the largest call of a kernel wrapper on the main path, so that
    the kernel can be timed at the shapes the path gave it; with ``second``,
    also the call that ranks highest by that key."""

    def __init__(self, module, name, size, second=None):
        self.module, self.name, self.size = module, name, size
        self.second = second
        self.fn = getattr(module, name)
        self.best = None
        self.other = None

    def __call__(self, *args, **kwargs):
        s = self.size(*args, **kwargs)
        if self.best is None or s > self.best[0]:
            self.best = (s, args, kwargs)
        if self.second is not None:
            k = self.second(*args, **kwargs)
            if self.other is None or k > self.other[0]:
                self.other = (k, args, kwargs)
        return self.fn(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def recorders():
    from repro_torch.kernels import (bitset_ops, filter_compact, predicate,
                                     segment_scan)

    return {"predicate_bitset": Recorder(
                predicate, "_launch", lambda prog, cols, valid, cap, p: cap,
                second=longest_program),
            "filter_compact": Recorder(
                filter_compact, "filter_compact_bits",
                lambda cols, words: cols[0].shape[0] * len(cols)),
            "bitset_op": Recorder(bitset_ops, "bitset_expr_kernel",
                                  lambda leaves, prog: leaves[0].shape[0]),
            "segmented_scan": Recorder(
                segment_scan, "segmented_scan_kernel",
                lambda words, vals, block, fill: vals.shape[0])}


def longest_program(prog, cols, valid, cap, params):
    """B1's second timed program: the one with a whitelist, then the most
    instructions, then the most rows."""
    isin = any(i[0].startswith("ISIN") for i in prog.instrs)
    return (isin, len(prog.instrs), cap)


def drive(label: str, study, tables, kernels, reps: int, rate: float):
    """The main path of one study: its first run on the card with the cuda
    engines (launch counts set to 0 just before and read just after; every
    kernel in ``kernels`` must launch), a warm rerun, the torch engines, and
    the timing of each kernel at the largest shape the first run gave it."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    recs = recorders()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for r in recs.values():
        r.__enter__()
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        res = study.run(dict(tables), engine="cuda", predicate_engine="cuda",
                        device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(launch_counts)
    finally:
        for r in recs.values():
            r.__exit__()
    peak = torch.cuda.max_memory_allocated()
    PEAKS[label] = (peak, held)
    res.assert_no_loss()
    log(f"{label}: cuda engines wall {wall:.3f} s (first run), peak device "
        f"memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB of it held "
        f"before the run), launches {launches}")
    for k in kernels:
        if launches[k] <= 0:
            fail(f"{label}: kernel {k} was never launched on the main path")
    from repro_torch.study.executor import cohort_groups

    if launches["bitset_op"] != len(cohort_groups(res.plan)):
        fail(f"{label}: {launches['bitset_op']} B3 launches for "
             f"{len(cohort_groups(res.plan))} cohort expressions")
    log(f"{label}: final cohort {res.cohorts['final'].subject_count()} "
        f"subjects\n" + res.flow.render())
    # time the kernels on the recorded inputs, then let those inputs go
    timing = time_kernels({k: recs[k] for k in kernels}, reps, rate)
    del recs

    t0 = time.perf_counter()
    res2 = study.run(dict(tables), engine="cuda", predicate_engine="cuda",
                     device="cuda")
    torch.cuda.synchronize()
    log(f"{label}: cuda engines wall {time.perf_counter() - t0:.3f} s (warm)")
    compare_results(res, res2, "cuda run vs cuda rerun", full_columns=True)
    del res2
    t0 = time.perf_counter()
    ref = study.run(dict(tables), engine="torch", predicate_engine="torch",
                    device="cuda")
    torch.cuda.synchronize()
    log(f"{label}: torch engines wall {time.perf_counter() - t0:.3f} s")
    compare_results(res, ref, "cuda vs torch engines on the card",
                    full_columns=False)
    log(f"{label}: cuda engines == torch engines (valid rows, words, counts, "
        f"FlatteningStats, cohorts, flow, features)")
    return launches, timing, res


def study_phase(n_patients: int, reps: int, rate: float):
    import torch

    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir

    t0 = time.perf_counter()
    dcir = generate_dcir(SyntheticConfig(n_patients=n_patients, seed=0),
                         device="cuda")
    torch.cuda.synchronize()
    log(f"quickstart: generated DCIR for {n_patients} patients "
        f"({int(dcir['ER_PRS'].count)} ER_PRS rows) in "
        f"{time.perf_counter() - t0:.3f} s")
    study = build_study(n_patients)
    launches, timing, res = drive(
        "quickstart", study, dcir,
        ("predicate_bitset", "filter_compact", "bitset_op"), reps, rate)
    return launches, timing, study, dcir, res


def cohort_phase(n_patients: int, reps: int, rate: float):
    import torch

    t0 = time.perf_counter()
    tables = snds_tables(n_patients, "cuda")
    torch.cuda.synchronize()
    rows = {k: int(t.count) for k, t in tables.items()}
    log(f"cohort: generated and flattened the SNDS star for {n_patients} "
        f"patients ({rows} rows) in {time.perf_counter() - t0:.3f} s")
    study = build_cohort_study(n_patients)
    # the design matrix alone: patients x 36 x 128 float32, once per engine
    x_bytes = n_patients * 36 * 128 * 4
    log(f"cohort: design matrix {x_bytes / 2**30:.3f} GiB per copy; the "
        f"phase holds two (cuda and torch engines)")
    launches, timing, res = drive(
        "cohort", study, tables, ("predicate_bitset", "filter_compact",
                                  "bitset_op", "segmented_scan"), reps, rate)
    X = res.features["X"]
    toks, mask = res.features["tokens"]
    if tuple(X.shape) != (n_patients, 36, 128) or not bool(
            torch.isfinite(X).all()) or float(X.sum()) <= 0:
        fail(f"cohort: design matrix {tuple(X.shape)} is not finite and "
             f"non-empty")
    if tuple(toks.shape) != (n_patients, 256) or \
            int(res.events["exposures"].count) <= 0 or \
            int(res.events["fractures"].count) <= 0:
        fail("cohort: empty exposures/fractures or a bad token shape")
    log(f"cohort: exposures {int(res.events['exposures'].count)}, fractures "
        f"{int(res.events['fractures'].count)}, design matrix "
        f"{tuple(X.shape)} sum {float(X.sum())}, tokens {tuple(toks.shape)} "
        f"(mask {int(mask.sum())} true), checks {res.feature_checks}")
    del res, X, toks, mask
    return launches, timing, study, tables


def profile_phase(label: str, run_once) -> None:
    """torch.profiler over one warm run: device time by kernel, idle share,
    and a Chrome trace in ``chiprun_out/{label}_trace.json``."""
    import torch

    def run():
        run_once()
        torch.cuda.synchronize()

    run()
    with profiled() as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    for line in trace_report(label, prof, wall_us):
        log(line)


def profiled():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def trace_report(label: str, prof, wall_us: float) -> list:
    """The trace as ``{label}_trace.json`` beside the log, and lines with the
    device's busy time and idle share of ``wall_us`` and the device time of
    the 25 largest kernels, copies and fills."""
    import collections

    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    trace = out / f"{label}_trace.json"
    prof.export_chrome_trace(str(trace))
    # device time = kernels, copies and fills on the device timeline
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name, calls = collections.Counter(), collections.Counter()
    for e in events:
        by_name[e["name"][:90]] += e["dur"]
        calls[e["name"][:90]] += 1
    busy_us = sum(by_name.values())
    lines = [f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
             f"{busy_us / 1e3:.3f} ms ({len(events)} device events), idle "
             f"share {1 - busy_us / wall_us:.4f}"]
    for name, us in by_name.most_common(25):
        lines.append(f"profile {label}: {us / 1e3:9.3f} ms device "
                     f"{calls[name]:6d} calls  {name}")
    return lines


def time_kernels(recs, reps: int, rate: float):
    """Each recorded kernel against its plain version at the recorded shape
    (bit for bit), then timed: kernel, plain version, library call."""
    from repro_torch.core import bitset as bs
    from repro_torch.kernels import filter_compact, segment_scan

    out = {}
    if "predicate_bitset" in recs:
        rec = recs["predicate_bitset"]
        out["predicate_bitset"] = time_predicate(rec.fn, rec.best[1], reps,
                                                 rate)
        other = time_predicate(rec.fn, rec.other[1], reps, rate)
        out["predicate_bitset"]["longest"] = other
    if "segmented_scan" in recs:
        rec = recs["segmented_scan"]
        words, vals, block, fill = rec.best[1]
        n = vals.shape[0]
        kern = lambda: rec.fn(words, vals, block, fill)  # noqa: E731
        plain = lambda: segment_scan.segmented_scan_plain(  # noqa: E731
            words, vals, block, fill)
        if not all(_same(x, y) for x, y in zip(kern(), plain())):
            fail("segmented_scan kernel != plain at the main path's shape")
        # packed flags 1/8 B, values 4 B in; min, max, count 12 B out
        nbytes = 4 * words.shape[0] + 16 * n
        t = dict(n=n, columns=None, library_ms=None,
                 bound_ms=nbytes / rate * 1e3, max_abs_err=0.0)
        for key, fn in (("ms", kern), ("plain_ms", plain)):
            t[key], lo, hi = spread_ms(fn, reps)
            t[key + "_range"] = (lo, hi)
        out["segmented_scan"] = t
    if "filter_compact" in recs:
        rec = recs["filter_compact"]
        cs, words = rec.best[1]
        n = cs[0].shape[0]
        kern = lambda: rec.fn(cs, words)  # noqa: E731
        plain = lambda: filter_compact.filter_compact_plain(cs, words)  # noqa: E731
        mask = bs.unpack(words, n)
        library = lambda: [c[mask] for c in cs]  # noqa: E731
        (g, gc), (w, wc) = kern(), plain()
        if int(gc) != int(wc) or not all(_same(x, y) for x, y in zip(g, w)):
            fail("filter_compact kernel != plain at the main path's shape")
        nbytes = (8 * len(cs) + 0.125) * n
        out["filter_compact"] = dict(
            n=n, columns=len(cs), ms=cuda_ms(kern, reps),
            plain_ms=cuda_ms(plain, reps), library_ms=cuda_ms(library, reps),
            bound_ms=nbytes / rate * 1e3, max_abs_err=0.0)
    if "bitset_op" in recs:
        out["bitset_op"] = time_bitset(recs["bitset_op"], reps, rate)
    for k, v in out.items():
        for label, t in [(k, v)] + [(f"{k} ({sub})", v[sub])
                                    for sub in ("longest", "snds")
                                    if sub in v]:
            spread = "" if "ms_range" not in t else (
                f" [{t['ms_range'][0]:.4f}-{t['ms_range'][1]:.4f}], middle "
                f"of {TIMING_CALLS} medians of {reps}")
            log(f"timing: {label} n={t['n']} columns={t['columns']} "
                f"{t.get('program', '')}kernel {t['ms']:.4f} ms{spread}, "
                f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']}, "
                f"bound {t['bound_ms']:.4f} ms "
                f"({100 * t['bound_ms'] / t['ms']:.1f} % reached)")
    return out


EMPTY_KERNEL = r"""
__global__ void empty_kernel() {}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def empty_launch_ms(reps: int):
    """The card's floor for one launch: an empty kernel, built alone (it
    is no kernel of the port), timed as the kernels are (middle, min, max
    of ``TIMING_CALLS`` medians)."""
    import ctypes
    import tempfile

    import torch

    from repro_torch.kernels import build

    with tempfile.TemporaryDirectory() as tmp:
        src, so = Path(tmp) / "empty.cu", Path(tmp) / "empty.so"
        src.write_text(EMPTY_KERNEL)
        r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                            "-o", str(so), str(src)], capture_output=True,
                           text=True)
        if r.returncode != 0:
            fail(f"nvcc failed on the empty kernel:\n{r.stdout}{r.stderr}")
        lib = ctypes.CDLL(str(so))
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    launch = lambda: build.check(lib.empty_launch(  # noqa: E731
        torch.cuda.current_stream().cuda_stream), "empty launch")
    return spread_ms(launch, reps)


def time_bitset(rec, reps: int, rate: float) -> dict:
    """B3 on the recorded call (the study's cohort expression: one launch)
    and on the same program over the SNDS universe (``SNDS_WORDS``, seeded
    leaves, L2 cleared before each rep: its 41 MB would fit in L2), each
    against its plain version bit for bit, then kernel and plain version as
    the middle of ``TIMING_CALLS`` medians with their min-max, beside the
    empty-launch floor.  Bound: ``4 B x (leaves + ops)`` a word."""
    import torch

    from repro_torch.kernels import bitset_ops

    leaves, prog = rec.best[1]
    n = leaves[0].shape[0]
    big = [torch.randint(-2**31, 2**31 - 1, (SNDS_WORDS,), dtype=torch.int32,
                         device=leaves[0].device) for _ in leaves]
    out = {}
    for label, ls, cold in (("study", leaves, False),
                            ("snds", big, True)):
        kern = lambda ls=ls: rec.fn(ls, prog)  # noqa: E731
        plain = lambda ls=ls: bitset_ops.bitset_expr_plain(  # noqa: E731
            ls, prog)
        (g, gc), (w, wc) = kern(), plain()
        if not (_same(g, w) and _same(gc, wc)):
            fail(f"bitset_expr kernel != plain at the {label} shape")
        m = ls[0].shape[0]
        t = dict(n=m, columns=None, library_ms=None, max_abs_err=0.0,
                 bound_ms=4 * (len(ls) + len(prog)) * m / rate * 1e3,
                 program=f"({len(prog)} ops over {len(ls)} leaves "
                         f"{list(prog)}{', L2 cleared' if cold else ''}) ")
        for key, fn in (("ms", kern), ("plain_ms", plain)):
            t[key], lo, hi = spread_ms(fn, reps, cold)
            t[key + "_range"] = (lo, hi)
        out[label] = t
    floor, lo, hi = empty_launch_ms(reps)
    res = dict(out["study"], snds=out["snds"], floor_ms=floor,
               floor_range=(lo, hi))
    log(f"timing: empty launch (the card's floor for one launch) "
        f"{floor:.4f} ms [{lo:.4f}-{hi:.4f}]; B3 over {n} words "
        f"{res['ms']:.4f} ms and {out['snds']['ms']:.4f} ms over "
        f"{SNDS_WORDS} (bounds {res['bound_ms']:.4f} and "
        f"{out['snds']['bound_ms']:.4f} ms)")
    return res


def time_predicate(fn, args, reps: int, rate: float) -> dict:
    """B1 on one recorded call: against its plain version bit for bit, then
    kernel and plain version as the middle of ``TIMING_CALLS`` medians."""
    from repro_torch.kernels import predicate

    prog, cols, valid, cap, params = args
    kern = lambda: fn(prog, cols, valid, cap, params)  # noqa: E731
    plain = lambda: predicate.predicate_bitset_plain(  # noqa: E731
        prog, cols, valid, cap, params)
    got, want = kern(), plain()
    if not (_same(got[0], want[0]) and int(got[1]) == int(want[1])):
        fail("predicate kernel != plain at the main path's shape")
    plan = predicate.device_plan(prog, cap, valid.device, params)
    nbytes = (4 * len(prog.columns) + 0.25) * cap
    out = dict(n=cap, columns=len(prog.columns), library_ms=None,
               bound_ms=nbytes / rate * 1e3, max_abs_err=0.0,
               program=f"({len(prog.instrs)} instructions "
                       f"{[i[0] for i in prog.instrs]}, {plan.n_slots} "
                       f"register-file slots, grid {plan.grid}, "
                       f"{plan.smem_bytes} B shared memory) ")
    for key, f in (("ms", kern), ("plain_ms", plain)):
        out[key], lo, hi = spread_ms(f, reps)
        out[key + "_range"] = (lo, hi)
    return out


def cpu_phase(n_patients: int) -> None:
    """Both studies on the card and on the CPU, bit for bit."""
    import torch

    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir

    cfg = SyntheticConfig(n_patients=n_patients, seed=0)
    study = build_study(n_patients)
    card = study.run(generate_dcir(cfg, device="cuda"), engine="cuda",
                     predicate_engine="cuda", device="cuda")
    torch.cuda.synchronize()
    cpu = study.run(generate_dcir(cfg, device="cpu"), engine="cuda",
                    predicate_engine="cuda", device="cpu")
    compare_results(card, cpu, "quickstart card vs CPU", full_columns=True)
    log(f"cpu: quickstart at {n_patients} patients, card == CPU bit for bit "
        f"(final cohort {card.cohorts['final'].subject_count()} subjects)")
    study = build_cohort_study(n_patients)
    card = study.run(snds_tables(n_patients, "cuda"), engine="cuda",
                     predicate_engine="cuda", device="cuda")
    torch.cuda.synchronize()
    cpu = study.run(snds_tables(n_patients, "cpu"), engine="cuda",
                    predicate_engine="cuda", device="cpu")
    compare_results(card, cpu, "cohort study card vs CPU", full_columns=True)
    compare_stats(card, cpu)
    log(f"cpu: cohort study at {n_patients} patients, card == CPU bit for "
        f"bit (final cohort {card.cohorts['final'].subject_count()} "
        f"subjects, {int(card.events['exposures'].count)} exposures)")


# statistics that sum float32 values, whose order differs between devices
FLOAT_SUM_STATS = ("age_mean", "age_at_first_event", "weight_total")


def compare_stats(card, cpu) -> None:
    """The stats battery and the Supplementary-A distribution of the cohort
    study's cohorts, card against CPU: exact, except the float32 sums to a
    relative 1e-5."""
    from repro_torch.core import stats

    pc, pp = card.events["extract_patients"], cpu.events["extract_patients"]
    for name in ("exposed", "fractured", "final"):
        a = stats.compute(card.cohorts[name], pc)
        b = stats.compute(cpu.cohorts[name], pp)
        if a.keys() != b.keys():
            fail(f"stats of {name}: different statistics")
        for k in a:
            close = all(abs(a[k][f] - b[k][f]) <= 1e-5 * abs(b[k][f])
                        for f in a[k]) if k in FLOAT_SUM_STATS else False
            if a[k] != b[k] and not close:
                fail(f"stats of {name}.{k}: card {a[k]} vs CPU {b[k]}")
    for sa, sb in zip(card.flow.steps, cpu.flow.steps):
        if stats.distribution_by_gender_age_bucket(sa, pc) != \
                stats.distribution_by_gender_age_bucket(sb, pp):
            fail(f"gender x age distribution of {sa.name} differs")
    log(f"cpu: stats of exposed/fractured/final and the flow's gender x age "
        f"distributions, card == CPU ({len(stats.STATISTICS)} statistics)")


# ---------------------------------------------------------------------------
# phase 4: the quickstart out of core (chunked), checked and normalized
# ---------------------------------------------------------------------------
CHUNK_CAPACITY = 1 << 23     # ER_PRS rows a chunk: 6 chunks at 2,000,000
RESUME_PATIENTS = 200_000    # the kill-and-resume store (5 chunks)
RESUME_CAPACITY = 1 << 20


def plan_entries(log_) -> list:
    """The ``record_plan`` entries of an OperationLog, without ``ts``."""
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in log_.entries if e["op"].startswith("plan:")]


def chunk_digest(res) -> dict:
    """What the chunked phase compares of a result, on the host: each event
    table's count and valid rows in order (a chunked table is its chunks'
    tables concatenated, so its capacity and padding differ), cohort words
    and counts, flow, FlatteningStats (uint32 checksums included) and the
    plan entries of the OperationLog."""
    events = {}
    for name, t in res.events.items():
        keep = t.valid_bool()
        events[name] = (int(t.count),
                        {c: v[keep].cpu() for c, v in t.columns.items()})
    return dict(events=events, stats=res.flatten_stats,
                cohorts={k: (c.subjects.cpu(), c.subject_count())
                         for k, c in res.cohorts.items()},
                flow=res.flow.flowchart(), log=plan_entries(res.log))


def compare_chunked(a: dict, b: dict, what: str) -> None:
    if sorted(a["events"]) != sorted(b["events"]):
        fail(f"{what}: different outputs")
    for name, (na, ca) in a["events"].items():
        nb, cb = b["events"][name]
        if na != nb or sorted(ca) != sorted(cb) or not all(
                _same(ca[c], cb[c]) for c in ca):
            fail(f"{what}: {name} valid rows differ ({na} vs {nb} rows)")
    if sorted(a["cohorts"]) != sorted(b["cohorts"]) or not all(
            _same(w, b["cohorts"][k][0]) and n == b["cohorts"][k][1]
            for k, (w, n) in a["cohorts"].items()):
        fail(f"{what}: cohort words or counts differ")
    if a["stats"] != b["stats"]:
        fail(f"{what}: FlatteningStats differ")
    if a["flow"] != b["flow"]:
        fail(f"{what}: flow differs")
    if a["log"] != b["log"]:
        fail(f"{what}: the OperationLog's plan entries differ")


def chunked_prepare(study, dcir, res, store_dir, peak,
                    normalized: bool = True) -> dict:
    """With the quickstart's star and its resident cuda result still on the
    card: the store, the resident result's digest, ``Study.check`` against
    the diag golden, and (``normalized``) the normalized plan on the card.
    ``peak`` is the resident run's ``(peak, held)`` device bytes."""
    import torch

    from repro_torch.data import partition_star

    t0 = time.perf_counter()
    store = partition_star(dcir, str(store_dir), source="ER_PRS",
                           chunk_capacity=CHUNK_CAPACITY)
    size = sum(p.stat().st_size for p in Path(store_dir).rglob("*.npz"))
    log(f"chunked: partitioned ER_PRS ({store.manifest.total_rows} rows) "
        f"into {store.n_chunks} chunks of {CHUNK_CAPACITY} rows, "
        f"{size / 2**30:.3f} GiB on disk, in "
        f"{time.perf_counter() - t0:.3f} s")
    if store.n_chunks < 3:
        fail(f"chunked: only {store.n_chunks} chunks")

    diags = study.check(predicate_engine="cuda", engine="cuda", device="cuda")
    want = json.loads((REPO / "tests" / "goldens" / "quickstart_diag.json")
                      .read_text())
    got = [(d.code, d.severity, d.node) for d in diags]
    if got != [(d["code"], d["severity"], d["node"]) for d in want]:
        fail(f"chunked: Study.check gave {got}, not the diag golden's")
    log(f"chunked: Study.check == tests/goldens/quickstart_diag.json {got}")

    if normalized:
        normalized_check(study, dcir, res)
    torch.cuda.synchronize()
    return dict(store=store, want=chunk_digest(res), peak=peak,
                n_patients=study.n_patients)


def resident_run(n_patients: int):
    """A star at ``n_patients`` on the card and the quickstart's resident
    run under the cuda engines: ``(study, star, result, launches, (peak,
    held))``, the counts at 0 just before the run."""
    import torch

    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir
    from repro_torch.kernels import launch_counts, reset_launch_counts

    dcir = generate_dcir(SyntheticConfig(n_patients=n_patients, seed=0),
                         device="cuda")
    study = build_study(n_patients)
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = study.run(dict(dcir), engine="cuda", predicate_engine="cuda",
                    device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"chunked: resident quickstart at {n_patients} patients "
        f"({int(dcir['ER_PRS'].count)} ER_PRS rows): wall {wall:.3f} s, "
        f"peak device memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} "
        f"GiB of it the star)")
    return study, dcir, res, dict(launch_counts), (peak, held)


def normalized_check(study, dcir, res) -> None:
    """normalize -> execute(expr_params=device_params(...)) on the card
    equals the plan's own run, node for node; B1 launches as often, with
    hoisted operands, and nothing is demoted."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import predicate as pk
    from repro_torch.study import device_params, normalize
    from repro_torch.study.executor import execute

    plan = res.plan
    nplan = normalize(plan)
    if nplan.demoted:
        fail(f"normalize demoted nodes {nplan.demoted}")
    hoisted = []
    launch = pk._launch

    def spy(prog, *a):
        hoisted.append(len(prog.lits)
                       + sum(t[0] == "vec" for t in prog.tables))
        return launch(prog, *a)

    kw = dict(n_patients=study.n_patients, engine="cuda",
              predicate_engine="cuda")
    reset_launch_counts()
    want = execute(plan, dict(dcir), **kw)
    b1 = launch_counts["predicate_bitset"]
    pk._launch = spy
    try:
        reset_launch_counts()
        got = execute(nplan.plan, dict(dcir),
                      expr_params=device_params(nplan, device="cuda"), **kw)
    finally:
        pk._launch = launch
    if launch_counts["predicate_bitset"] != b1 or not max(hoisted, default=0):
        fail(f"normalized plan: {launch_counts['predicate_bitset']} B1 "
             f"launches (plan: {b1}), hoisted operands {hoisted}")
    outs, ids = dict(nplan.out_map), dict(nplan.plan.outputs)
    for name, i in plan.outputs:
        if i not in want:
            continue
        a, b = want[i], got[ids[outs[name]]]
        if hasattr(a, "columns"):
            same = (int(a.count) == int(b.count) and _same(a.valid, b.valid)
                    and all(_same(a.columns[c], b.columns[c])
                            for c in a.columns))
        else:
            same = _same(a, b)
        if not same:
            fail(f"normalized plan: output {name} differs")
    log(f"chunked: normalized quickstart on the card == its plan "
        f"({len(nplan.lits)} literals, {len(nplan.vecs)} whitelists "
        f"hoisted; B1 {b1} launches with {max(hoisted)} hoisted operands, "
        f"none demoted)")


def chunked_run(study, store, what: str, **kw):
    """One chunked run under the cuda engines with the counts at 0 just
    before and the runner cache cleared; returns the result, the report,
    the launches and the peak device memory above what was held before."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.study import clear_jit_cache

    clear_jit_cache()
    gc.collect()                 # a dropped result lives in cycles until now
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    rep = {}
    t0 = time.perf_counter()
    res = study.run_chunked(store, engine="cuda", predicate_engine="cuda",
                            device="cuda", report_sink=rep, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated() - held
    log(f"chunked: {what}: {rep['n_chunks']} chunks, wall {wall:.3f} s "
        f"(the call), load_s {rep['load_s']:.6f}, exec_s "
        f"{rep['exec_s']:.6f}, wall_s {rep['wall_s']:.6f}, serial_s "
        f"{rep['serial_s']:.6f}, overlap_saved_s "
        f"{rep['overlap_saved_s']:.6f}, compiles {rep['compiles']}, peak "
        f"device memory {peak / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held before, launches {launches}")
    if rep["compiles"] != 1:
        fail(f"chunked: {what}: {rep['compiles']} runners built, not 1")
    return res, rep, launches, peak


def check_chunk_launches(launches, resident, n_chunks: int, groups: int,
                         what: str) -> None:
    """B1 and B2 launch once per node per chunk (the resident run's count
    on every chunk); B3 once per cohort expression per chunk, plus the
    replay over the merged words."""
    for k in ("predicate_bitset", "filter_compact"):
        if launches[k] != resident[k] * n_chunks:
            fail(f"chunked: {what}: {launches[k]} {k} launches, not "
                 f"{resident[k]} x {n_chunks} chunks")
    if launches["bitset_op"] != groups * (n_chunks + 1):
        fail(f"chunked: {what}: {launches['bitset_op']} B3 launches, not "
             f"{groups} expressions x ({n_chunks} chunks + the replay)")


def chunked_phase(prep: dict, resident_launches: dict, store_dir) -> dict:
    """The quickstart over the store with and without prefetch, bit for bit
    the resident run; a kill-and-resume; a traced run.  Returns the
    prefetching run's launches (the main path's)."""
    import shutil

    import torch

    from repro_torch.data import partition_star
    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir
    from repro_torch.study import ChunkedExecutor
    from repro_torch.study.chunked import _InjectedCrash
    from repro_torch.study.executor import cohort_groups

    store, want, n = prep["store"], prep["want"], prep["n_patients"]
    study = build_study(n)
    peak_res, held_res = prep["peak"]
    main = None
    for prefetch in (True, False):
        what = f"prefetch={prefetch}"
        res, rep, launches, peak = chunked_run(study, store, what,
                                               prefetch=prefetch)
        check_chunk_launches(launches, resident_launches, store.n_chunks,
                             len(cohort_groups(res.plan)), what)
        compare_chunked(chunk_digest(res), want,
                        f"chunked ({what}) vs resident")
        del res
        log(f"chunked: {what} == resident cuda run (valid rows in order, "
            f"cohort words and counts, flow, FlatteningStats, plan log); "
            f"peak {peak / 2**30:.3f} GiB vs the resident run's "
            f"{(peak_res - held_res) / 2**30:.3f} GiB above its star "
            f"({peak_res / 2**30:.3f} GiB with it)")
        if main is None:
            main = launches
    torch.cuda.empty_cache()

    small = generate_dcir(SyntheticConfig(n_patients=RESUME_PATIENTS,
                                          seed=1), device="cuda")
    sstudy = build_study(RESUME_PATIENTS)
    swant = chunk_digest(sstudy.run(dict(small), engine="cuda",
                                    predicate_engine="cuda", device="cuda"))
    sstore = partition_star(small, str(store_dir / "resume"),
                            source="ER_PRS", chunk_capacity=RESUME_CAPACITY)
    del small
    kw = dict(engine="cuda", predicate_engine="cuda", device="cuda",
              checkpoint_dir=str(store_dir / "ckpt"))
    ex = ChunkedExecutor(sstore, crash_after=2, **kw)
    try:
        ex.run(build_study(RESUME_PATIENTS))
        fail("chunked: crash_after=2 did not stop the run")
    except _InjectedCrash:
        pass
    ex = ChunkedExecutor(sstore, **kw)
    got = ex.run(build_study(RESUME_PATIENTS))
    if ex.report.resumed != 2 or ex.report.executed != sstore.n_chunks - 2:
        fail(f"chunked: resume restored {ex.report.resumed} and ran "
             f"{ex.report.executed} of {sstore.n_chunks} chunks")
    compare_chunked(chunk_digest(got), swant, "resumed vs resident")
    del got
    log(f"chunked: killed after 2 of {sstore.n_chunks} chunks at "
        f"{RESUME_PATIENTS} patients, resumed 2 and ran "
        f"{ex.report.executed}: == resident cuda run")
    shutil.rmtree(store_dir / "resume")
    shutil.rmtree(store_dir / "ckpt")

    profile_phase("chunked", lambda: study.run_chunked(
        store, engine="cuda", predicate_engine="cuda", device="cuda"))
    return main


# ---------------------------------------------------------------------------
# phase 5: the declarative front end (spec) and the differential fuzzer
# ---------------------------------------------------------------------------
FUZZ_N = 48                  # 24 valid specs, 24 mutations
FUZZ_PATIENTS = 200_000      # the star the fuzzed specs run over
KERNELS_B1_B3 = ("predicate_bitset", "filter_compact", "bitset_op")


def spec_phase(store_dir) -> dict:
    """The golden studies as wire specs, compiled specs on the card against
    their builder-made twins, and the fuzzer's corpus under the torch, cuda
    and chunked arms; returns the corpus run's launches."""
    import torch

    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.study import compile_spec, spec_from_study
    from repro_torch.study.defects import golden_studies
    from repro_torch.study.fuzz import run_corpus

    goldens = golden_studies()
    for name, study in goldens.items():
        want = json.loads((REPO / "tests" / "goldens" / f"{name}_spec.json")
                          .read_text())
        if json.loads(json.dumps(spec_from_study(study))) != want:
            fail(f"spec: spec_from_study({name}) != tests/goldens/"
                 f"{name}_spec.json")
        n = study.n_patients
        tables = (generate_dcir(SyntheticConfig(n_patients=n, seed=0),
                                device="cuda") if name == "quickstart"
                  else snds_tables(n, "cuda"))
        kw = dict(engine="cuda", predicate_engine="cuda", device="cuda")
        a = study.run(dict(tables), **kw)
        b = compile_spec(want).run(dict(tables), **kw)
        compare_results(a, b, f"spec: compiled {name} vs its builder",
                        full_columns=True)
        if plan_entries(a.log) != plan_entries(b.log):
            fail(f"spec: compiled {name}: the plan's log entries differ")
        log(f"spec: spec_from_study({name}) == tests/goldens/{name}_spec"
            f".json; compile_spec of it on the card == the builder's study "
            f"({n} patients, every slot, words, stats, cohorts, flow, "
            f"features, plan log)")
        del a, b, tables
    torch.cuda.empty_cache()

    gc.collect()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    report = run_corpus(n=FUZZ_N, seed=0, n_patients=FUZZ_PATIENTS,
                        store_dir=str(store_dir), engine="cuda",
                        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    for line in report.summary().splitlines():
        log(f"spec: {line}")
    log(f"spec: corpus of {FUZZ_N} at {FUZZ_PATIENTS} patients in "
        f"{wall:.3f} s, launches {launches}")
    if not report.ok:
        fail(f"spec: the fuzz corpus failed: {report.failures[:3]}")
    if report.arms != ("torch", "cuda", "chunked") \
            or report.n_valid != FUZZ_N - FUZZ_N // 2 \
            or report.n_mutated != FUZZ_N // 2:
        fail(f"spec: arms {report.arms}, {report.n_valid} valid and "
             f"{report.n_mutated} mutated specs checked")
    for k in KERNELS_B1_B3:
        if launches[k] <= 0:
            fail(f"spec: kernel {k} was never launched by the corpus")
    return launches


# ---------------------------------------------------------------------------
# phase 6: the cohort-query service over the quickstart's resident star
# ---------------------------------------------------------------------------
SERVICE_QUERIES = 32         # benchmarks/serving_bench.py's mix
SERVICE_TENANTS = 4
SERVICE_SLOTS = 8
SERVICE_CACHE = 16 << 30     # holds the shared flatten prefix at 2,000,000


def service_study(q: int, n_patients: int):
    """Query ``q`` of ``benchmarks/serving_bench.py``'s mix, re-expressed
    with the port: its three plan shapes in turn (``_shape_full``,
    ``_shape_drugs``, ``_shape_acts``), threshold ``40 + q`` and codes
    ``60 + q .. 119 + q``, so no two queries share their literals."""
    from repro_torch.core import (DCIR_SCHEMA, drug_dispenses,
                                  medical_acts_dcir)
    from repro_torch.study import Study, col

    threshold, codes = 40 + q, list(range(60 + q, 120 + q))
    s = Study(n_patients=n_patients).flatten(DCIR_SCHEMA)
    shape = q % 3
    if shape == 0:
        s.extract(drug_dispenses(codes=codes), name="drugs")
        s.extract(medical_acts_dcir(), name="acts")
        s.filter("acts", col("value") >= threshold, name="acts_hi")
        s.cohort("base", "drugs")
        s.cohort("final", "base & acts_hi")
    elif shape == 1:
        s.extract(drug_dispenses(codes=codes), name="drugs")
        s.cohort("exposed", "drugs")
    else:
        s.extract(medical_acts_dcir(codes=codes), name="acts")
        s.filter("acts", (col("value") >= threshold)
                 & (col("value") < threshold + 400), name="band")
        s.cohort("banded", "band")
    return s


def check_served(solo, got, what: str) -> None:
    """A served result against its solo run, bit for bit; the served log is
    the solo run's without its plan entries, as the reference's local
    service logs (ROADMAP C12)."""
    compare_results(solo, got, what, full_columns=True)
    if [e for e in log_entries(solo.log) if not e["op"].startswith("plan:")] \
            != log_entries(got.log):
        fail(f"{what}: the OperationLog differs from the solo run's without "
             f"its plan entries")


def log_entries(log_) -> list:
    return [{k: v for k, v in e.items() if k != "ts"} for e in log_.entries]


def new_service(dcir, pipeline: bool, mesh=None, device="cuda"):
    from repro_torch.study import CohortQueryService, ServiceConfig

    return CohortQueryService(dict(dcir), mesh=mesh, device=device,
                              config=ServiceConfig(
                                  n_slots=SERVICE_SLOTS, engine="cuda",
                                  predicate_engine="cuda",
                                  cache_budget_bytes=SERVICE_CACHE,
                                  pipeline=pipeline))


def serve(svc, n_patients: int, on_done, queries: int = SERVICE_QUERIES
          ) -> tuple:
    """The mix's first ``queries`` queries (4 tenants) through ``svc``, each
    ticket handed to ``on_done`` as the drain resolves it; returns the
    tickets, the wall (to a synchronization) and the submit/realize stage
    times."""
    import torch

    sub0, rea0 = svc.stats.submit_s, svc.stats.realize_s
    t0 = time.perf_counter()
    tickets = [svc.submit(service_study(q, n_patients),
                          tenant=f"tenant{q % SERVICE_TENANTS}")
               for q in range(queries)]
    svc.drain(on_done=on_done)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return tickets, wall, (svc.stats.submit_s - sub0,
                           svc.stats.realize_s - rea0)


def warm_up(svc, n_patients: int, on_done, first: int = SERVICE_QUERIES
            ) -> None:
    """One query of each shape, with literals of its own (queries
    ``first`` to ``first + 2`` of the mix), pays the service's three
    runner builds."""
    for i in range(3):
        svc.submit(service_study(first + i, n_patients), tenant="warmup")
    svc.drain(on_done=on_done)


def require_done(ticket) -> None:
    if ticket.status != "done":
        fail(f"service: ticket {ticket.seq} of {ticket.tenant} is "
             f"{ticket.status}: {ticket.error!r}")


def take(ticket) -> None:
    """A tenant that takes its answer and lets the result go."""
    require_done(ticket)
    ticket.result = None


def predicted_launches(tickets, solo: dict, kernels=KERNELS_B1_B3) -> dict:
    """What the hit and miss counts predict for the tickets of queries 0,
    1, ...: each query launches what its solo run launches, less one B1
    launch for every predicate cut served from the cache (a hit node does
    not run; B2, B3 and B5 never sit on a cut, and a hit node's inputs
    still run)."""
    from repro_torch.study.plan import PREDICATE_OPS

    out = {k: sum(solo[q][k] for q in range(len(tickets))) for k in kernels}
    out["predicate_bitset"] -= sum(op in PREDICATE_OPS
                                   for t in tickets for op in t.hit_ops)
    return out


def service_phase(dcir, n_patients: int) -> dict:
    """The naive path (one solo run per query), the service synchronous and
    pipelined (timed), both again with every ticket checked against its
    solo run, the wire path, and a traced warm serve.  Returns the timed
    pipelined serve's launches."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.study import clear_jit_cache, jit_cache_info

    # the naive path: every query a solo run, literals in the plan
    clear_jit_cache()
    gc.collect()
    solo, naive_lat = {}, []
    t_all = time.perf_counter()
    for q in range(SERVICE_QUERIES):
        reset_launch_counts()
        t0 = time.perf_counter()
        res = service_study(q, n_patients).run(
            dict(dcir), engine="cuda", predicate_engine="cuda",
            device="cuda")
        torch.cuda.synchronize()
        naive_lat.append(time.perf_counter() - t0)
        solo[q] = dict(launch_counts)
        del res
    naive_wall = time.perf_counter() - t_all
    naive_compiles = jit_cache_info()["compiles"]
    if naive_compiles != SERVICE_QUERIES:
        fail(f"service: the naive path built {naive_compiles} runners for "
             f"{SERVICE_QUERIES} distinct queries")
    log(f"service: naive path, {SERVICE_QUERIES} solo runs: wall "
        f"{naive_wall:.6f} s, {naive_compiles} runners built, latency p50 "
        f"{np.percentile(naive_lat, 50):.6f} s p95 "
        f"{np.percentile(naive_lat, 95):.6f} s")

    timed = {}
    for pipeline in (False, True):
        mode = "pipelined" if pipeline else "sync"
        svc = new_service(dcir, pipeline)
        warm_up(svc, n_patients, take)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        tickets, wall, (sub, rea) = serve(svc, n_patients, take)
        launches = dict(launch_counts)
        peak = torch.cuda.max_memory_allocated()
        st = svc.stats
        lat = [t.latency_s for t in tickets]
        flat_hits = [t.latency_s for t in tickets
                     if "lookup_join" in t.hit_ops]
        want = predicted_launches(tickets, solo)
        log(f"service: {mode}: serve wall {wall:.6f} s for "
            f"{SERVICE_QUERIES} queries (after {st.compile_count} warm-up "
            f"runner builds), submit_s {sub:.6f}, realize_s {rea:.6f}, "
            f"overlap_s {max(0.0, sub + rea - wall):.6f}; latency p50 "
            f"{np.percentile(lat, 50):.6f} s p95 "
            f"{np.percentile(lat, 95):.6f} s; flatten-cut hits "
            f"{len(flat_hits)}, their latency p50 "
            f"{np.percentile(flat_hits, 50) if flat_hits else 0:.6f} s")
        log(f"service: {mode}: compiles {st.compile_count}, hits "
            f"{st.cache_hits}, misses {st.cache_misses}, evictions "
            f"{st.cache_evictions}, entries {st.cache_entries}, bytes "
            f"cached {st.cache_bytes} ({st.cache_bytes / 2**30:.3f} GiB "
            f"accounted), demotions {st.demotions}, peak device memory "
            f"{peak / 2**30:.3f} GiB; launches "
            f"{ {k: launches[k] for k in KERNELS_B1_B3} } against "
            f"{want} predicted from the hits")
        if st.compile_count != 3 or st.demotions:
            fail(f"service: {mode}: {st.compile_count} runners built "
                 f"(3 shapes), {st.demotions} demotions")
        if any(launches[k] != want[k] for k in KERNELS_B1_B3):
            fail(f"service: {mode}: launches differ from the prediction")
        timed[mode] = dict(svc=svc if pipeline else None, wall=wall,
                           launches=launches,
                           counts=[(t.cache_hits, t.cache_misses,
                                    t.compiled) for t in tickets])
        del svc, tickets
    if timed["sync"]["counts"] != timed["pipelined"]["counts"]:
        fail("service: per-ticket hits and misses differ between modes")
    log(f"service: walls: naive {naive_wall:.6f} s, sync serve "
        f"{timed['sync']['wall']:.6f} s, pipelined serve "
        f"{timed['pipelined']['wall']:.6f} s")

    # every ticket against its solo run, in both modes, on fresh services
    # (the checks' solo runs would disturb the timed walls)
    for pipeline in (False, True):
        mode = "pipelined" if pipeline else "sync"
        svc = new_service(dcir, pipeline)
        checked = []

        def check(t, mode=mode, checked=checked):
            require_done(t)
            s = solo_run(t.study, dcir)
            check_served(s, t.result, f"service ({mode}): ticket {t.seq}")
            checked.append(t.seq)
            t.result = None

        warm_up(svc, n_patients, check)
        tickets, _, _ = serve(svc, n_patients, check)
        counts = [(t.cache_hits, t.cache_misses, t.compiled)
                  for t in tickets]
        if counts != timed[mode]["counts"] or len(checked) != \
                SERVICE_QUERIES + 3:
            fail(f"service: {mode}: the checked serve's hits and misses "
                 f"differ from the timed serve's")
        if pipeline:
            wire_checks(svc, dcir, n_patients)
        log(f"service: {mode}: all {len(checked)} tickets (3 warm-up) == "
            f"their solo runs (every slot, words, counts, FlatteningStats, "
            f"cohorts, flow, plan log), hits and misses == the timed "
            f"serve's")
        del svc, tickets
    torch.cuda.empty_cache()

    svc = timed["pipelined"]["svc"]
    profile_phase("service", lambda: serve(svc, n_patients, take))
    return timed["pipelined"]["launches"]


def solo_run(study, dcir):
    import torch

    res = study.run(dict(dcir), engine="cuda", predicate_engine="cuda",
                    device="cuda")
    torch.cuda.synchronize()
    return res


def wire_checks(svc, dcir, n_patients: int) -> None:
    """A wire spec of shape full equals its Study twin; a malformed spec
    comes back ``invalid`` with its code."""
    import copy

    from repro_torch.study import spec_from_study

    twin = service_study(0, n_patients)
    spec = json.loads(json.dumps(spec_from_study(twin)))
    got = []
    t = svc.submit_spec(spec, tenant="wire")
    svc.drain(on_done=got.append)
    if t.status != "done" or got != [t]:
        fail(f"service: the wire spec is {t.status}: {t.error!r}")
    check_served(solo_run(twin, dcir), t.result, "service: wire spec")
    payload = t.wire_payload()
    t.result = None
    bad = copy.deepcopy(spec)
    bad["cohorts"]["broken"] = "base & ("
    b = svc.submit_spec(bad, tenant="wire")
    codes = {e["code"] for e in b.wire_payload()["errors"]}
    if b.status != "invalid" or "SPEC-012" not in codes:
        fail(f"service: the malformed spec came back {b.status} {codes}")
    log(f"service: wire spec of shape full == its Study twin (payload "
        f"{json.dumps(payload)}); malformed spec -> {b.status} {sorted(codes)}")


# ---------------------------------------------------------------------------
# phases 9-10: attention (B6) and the serving path
# ---------------------------------------------------------------------------
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the reference's own bounds
# and each row's max abs error over that row's largest |output|: with randn
# inputs a row that sees 4,096 keys has outputs of ~0.03, where 2e-2 of
# absolute error would pass a kernel off by tens of percent.  In bf16 the
# output's rounding flips at most one ulp, under 2**-7 of the row's largest;
# B6's bf16 rounding of the probabilities for P V moves the fp32 result far
# less than an ulp.
ATTN_ROW_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# peak rates of the H100 SXM (data sheet): bf16 on the tensor cores, fp32 on
# the CUDA cores (B6's fp32 path uses no TF32)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
DANUBE = "h2o-danube-1.8b"
SERVE_GATE = {"float32": 1e-3, "bfloat16": 0.1}  # cuda vs torch engines
# bf16 models whose bf16 rounding alone moves their logits past 0.1 (gemma3
# and phase 15's families) are held against the fp32 model of the same
# weights: the cuda engine may sit at most BF16_RATIO times as far from it
# as the torch engine does, plus a quarter bf16 ulp of the largest logit.
# The sound engines' ratios are 0.57-1.07, deliberately wrong ones' 0.71-18
# (``tools/bf16_gate_probe.py``, PERF.md)
BF16_RATIO = 1.15


def bf16_gate(torch_vs_fp32: float, max_logit: float) -> float:
    """The bound on the cuda engine's bf16 distance from the fp32 model."""
    import math

    ulp = 2.0 ** (math.floor(math.log2(max_logit)) - 7)
    return BF16_RATIO * torch_vs_fp32 + ulp / 4


# teacher-forced decode depth, at full width: 2 layers since the families
# phase joined the run (4 before; its 8,320 host-bound steps per dtype pair
# took 143 s of a 770 s run on the slower of two hosts)
TF_LAYERS = 2
TF_STEPS = 4096 + 64       # past the 4,096-slot ring, so that it wraps
CPU_GATE = 1e-5            # reduced config, card against CPU, fp32

# (B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len)
ATTN_SWEEP = [             # tests/test_kernels.py's sweep
    (2, 4, 2, 128, 128, 64, True, 0, None, None),
    (1, 8, 2, 256, 256, 64, True, 64, None, None),
    (2, 4, 4, 1, 384, 64, True, 0, None, None),
    (1, 4, 1, 1, 512, 128, True, 128, None, None),
    (2, 2, 2, 96, 96, 32, False, 0, None, None),
    (1, 2, 1, 80, 160, 32, True, 0, None, None),
    # the decode route at every head dim: many splits, 16 rows (Sq 4 x
    # group 4), kv_len 0, a window crossing splits
    (2, 16, 4, 4, 4096, 128, True, 1000, 3000, None),
    (3, 8, 8, 1, 2049, 16, True, 0, 2048, None),
    (2, 8, 1, 2, 1500, 32, True, 300, 1400, 1450),
    (2, 8, 2, 1, 640, 64, False, 0, 9000, 0),
]
ATTN_DANUBE = (            # h2o-danube-1.8b: Hq 32, Hkv 8, D 80, window 4096
    [(1, 32, 8, s, s, 80, True, 4096, None, None)             # prefill
     for s in (1, 63, 4097, 8192)]
    + [(1, 32, 8, 1, 8192, 80, True, 4096, off, 8192)          # full cache
       for off in (0, 4095, 4096, 8191)]
    + [(4, 32, 8, 1, 4096, 80, False, 0, 9000, kv)             # ring
       for kv in (0, 1, 17, 4001, 4096)]
    + [(4, 32, 8, 1, 4097, 80, False, 0, 9000, 4097),          # ragged ring
       (1, 32, 8, 1, 8192, 80, True, 4096, 5000, 8192)]        # window edge
    + [(2, 32, 8, 100, 300, 80, True, 50, 200, None),          # ragged
       (1, 32, 8, 77, 4099, 80, True, 4096, 4022, None),
       (3, 32, 8, 5, 33, 80, True, 0, -2, None)])


# gemma3-12b: Hq 16, Hkv 8, D 240, window 1,024 (five local layers to one
# global), and head dim 256: local and global prefill to 8,192 tokens, decode
# offsets into a full cache, the ring with S = 1 and S = 3 (and a ring call of
# 130 queries, which takes the prefill kernel with causal=False); then every
# head dim on the bf16 prefill kernel with Sq not a multiple of its 128 rows,
# kv_len not a multiple of its key tile and a window edge inside a tile
ATTN_WIDE = (
    [(1, 16, 8, s, s, 240, True, w, None, None)
     for s in (300, 8192) for w in (1024, 0)]
    + [(1, 16, 8, 1, 8192, 240, True, w, off, 8192)
       for w, off in ((1024, 5000), (0, 8191), (0, 77))]
    + [(2, 16, 8, S, 1024, 240, False, 0, 9000, kv)
       for S in (1, 3) for kv in (1, 700, 1024)]
    + [(1, 16, 8, 130, 1024, 240, False, 0, 9000, 1000),
       (2, 8, 4, 200, 500, 256, True, 0, 300, None),
       (1, 8, 8, 3, 2048, 256, False, 0, 5000, 2000)]
    + [(1, 4, 2, 300, 333, D, True, 50, None, 317)
       for D in (16, 32, 64, 80, 96, 128, 240, 256)])
# the families of phase 15, every B6 call they make (phase 15 fails on a
# call whose ``b6_key`` no case here has): phi-3-vision (32 heads of 96: its
# prefill, decode steps into a full cache at the batcher's positions and
# late ones); seamless (16 heads of 64: its encoder and cross-attention,
# non-causal at q_offset 0, with more queries than keys, fewer, and a decode
# step's; its decoder's causal prefill and decode steps); recurrentgemma
# (MQA 10/1 of 256, window 2,048: prefill, and decode steps over the ring
# full and as the batcher fills it); deepseek and qwen2-moe (16 heads of
# 128, causal: prefill and decode steps)
ATTN_FAMILIES = [
    (1, 32, 32, 4096, 4096, 96, True, 0, None, None),
    (1, 32, 32, 1, 4096, 96, True, 0, 4095, 4096),
    (4, 32, 32, 1, 4096, 96, True, 0, 3000, 4096),
    (4, 32, 32, 1, 4096, 96, True, 0, 40, 4096),
    (2, 32, 32, 9, 700, 96, False, 0, 0, 650),
    (1, 16, 16, 1024, 1024, 64, False, 0, 0, None),
    (1, 16, 16, 4096, 1024, 64, False, 0, 0, None),
    (1, 16, 16, 300, 1024, 64, False, 0, 0, None),
    (4, 16, 16, 1, 1024, 64, False, 0, 0, None),
    (1, 16, 16, 4096, 4096, 64, True, 0, 0, 4096),
    (4, 16, 16, 1, 4096, 64, True, 0, 3000, 4096),
    (4, 16, 16, 1, 4096, 64, True, 0, 40, 4096),
    (1, 10, 1, 4096, 4096, 256, True, 2048, None, None),
    (4, 10, 1, 1, 2048, 256, False, 0, 9000, 2048),
    (4, 10, 1, 1, 2048, 256, False, 0, 40, 41),
    (4, 10, 1, 1, 2048, 256, False, 0, 700, 701),
    (1, 16, 16, 4096, 4096, 128, True, 0, None, None),
    (4, 16, 16, 1, 4096, 128, True, 0, 3000, 4096),
    (4, 16, 16, 1, 4096, 128, True, 0, 40, 4096),
]
ATTN_CASES = ATTN_SWEEP + ATTN_DANUBE + ATTN_WIDE + ATTN_FAMILIES


def b6_key(case):
    """What a battery case must share with a call for the call to count as
    checked: the shapes, the mask's kind, and whether the last query sees
    fewer keys than the cache holds (a decode step's partly filled cache)."""
    B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len = case
    kv = Skv if kv_len is None else kv_len
    off = kv - Sq if q_offset is None else q_offset
    seen = min(kv, off + Sq) if causal else kv
    return (B, Hq, Hkv, Sq, Skv, D, causal, window, seen < Skv)


class B6Calls:
    """Records the ``b6_key`` of every call of B6's wrapper while entered."""

    def __init__(self):
        from repro_torch.kernels import swa_attention as swa

        self.swa, self.fn, self.keys = swa, swa.flash_swa_attention, set()

    def __call__(self, q, k, v, *, causal=True, window=0, q_offset=None,
                 kv_len=None, lse=None):
        B, Hq, Sq, D = q.shape
        self.keys.add(b6_key((B, Hq, k.shape[1], Sq, k.shape[2], D, causal,
                              window, q_offset, kv_len)))
        return self.fn(q, k, v, causal=causal, window=window,
                       q_offset=q_offset, kv_len=kv_len, lse=lse)

    def __enter__(self):
        self.swa.flash_swa_attention = self
        return self

    def __exit__(self, *exc):
        self.swa.flash_swa_attention = self.fn


def _attn_kwargs(case):
    causal, window, q_offset, kv_len = case[6:]
    return dict(causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len)


def check_attention(got, want, what: str):
    """(max abs error, worst row error): fails past ATTN_TOL or
    ATTN_ROW_TOL.  A row with no visible key must come out exactly 0."""
    import torch

    d = (got.float() - want.float()).abs().amax(dim=-1)
    s = want.float().abs().amax(dim=-1)
    row = torch.where(s > 0, d / s.clamp_min(1e-30),
                      torch.where(d > 0, float("inf"), 0.0))
    err, row = float(d.max()), float(row.max())
    dname = str(want.dtype).replace("torch.", "")
    if not (err <= ATTN_TOL[dname] and row <= ATTN_ROW_TOL[dname]):
        fail(f"flash_attention kernel != plain ({dname}, {what}): max abs "
             f"error {err} (gate {ATTN_TOL[dname]}), worst row error {row} "
             f"(gate {ATTN_ROW_TOL[dname]})")
    return err, row


def attention_battery(device) -> None:
    """B6 against its plain version on the card (allow_tf32 is off, so the
    plain version's products are full fp32), in fp32 and bf16; also through
    transposed (B, S, H, D) views, as the model passes them."""
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import swa_attention as swa

    worst = {}
    n_decode = 0
    prefill_dims = set()       # head dims that reached the bf16 prefill kernel
    f32_dims = set()           # and the fp32 one
    cases = ATTN_CASES
    for i, case in enumerate(cases):
        errs = []
        for dname in ATTN_TOL:
            dt = getattr(torch, dname)
            B, Hq, Hkv, Sq, Skv, D = case[:6]
            g = torch.Generator(device=device).manual_seed(i)
            q, k, v = (torch.randn(sh, generator=g, device=device).to(dt)
                       for sh in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                                  (B, Hkv, Skv, D)))
            if i % 2:
                q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                           for x in (q, k, v))
            kw = _attn_kwargs(case)
            before = launch_counts["flash_decode"]
            f32 = launch_counts["flash_attention_f32"]
            got = swa.flash_swa_attention(q, k, v, **kw)
            decode = (Hq // Hkv) * Sq <= swa.DECODE_ROWS
            moved = launch_counts["flash_attention_f32"] - f32
            if moved != int(dt == torch.float32 and not decode):
                fail(f"flash_attention {case} {dname}: the fp32 kernel's "
                     f"count moved by {moved}")
            if dt == torch.float32 and not decode:
                f32_dims.add(D)
            if launch_counts["flash_decode"] != before + int(decode):
                fail(f"flash_attention {case}: the decode route was "
                     f"{'not ' if decode else ''}taken")
            n_decode += int(decode)
            if dt == torch.bfloat16 and not decode:
                prefill_dims.add(D)
            want = swa.flash_swa_attention_plain(q, k, v, **kw)
            err = check_attention(got, want, str(case))
            w = worst.get(dname, (0.0, 0.0))
            worst[dname] = (max(w[0], err[0]), max(w[1], err[1]))
            errs.append(f"{dname} {err[0]:.3g} / {err[1]:.3g}")
            del q, k, v, got, want
        log(f"attention: {case}: max abs / worst row error {', '.join(errs)}")
    for what, dims in (("bf16 prefill", prefill_dims), ("fp32", f32_dims)):
        if dims != set(swa.HEAD_DIMS):
            fail(f"attention: the {what} kernel ran at head dims "
                 f"{sorted(dims)}, not at every one of {swa.HEAD_DIMS}")
    n = len(cases)
    log(f"attention: {2 * n} flash_attention kernel-vs-plain checks "
        f"({n_decode} on the decode route), max abs "
        f"/ worst row error fp32 {worst['float32'][0]} / "
        f"{worst['float32'][1]} (gates {ATTN_TOL['float32']} / "
        f"{ATTN_ROW_TOL['float32']}), bf16 {worst['bfloat16'][0]} / "
        f"{worst['bfloat16'][1]} (gates {ATTN_TOL['bfloat16']} / "
        f"{ATTN_ROW_TOL['bfloat16']})")


def attention_bound(q, k, kw, rate, flops_per_pair: int = 4,
                    q_tensors: int = 2, kv_tensors: int = 2):
    """(bound ms, 'bytes' or 'operations', visible pairs): the larger of the
    bytes B6 must move (q and o once, the K/V rows some query can see once;
    the backward's ``q_tensors`` = 4, q, o, dout and dq, and ``kv_tensors``
    = 4, k, v, dk and dv) over the memory rate, and ``flops_per_pair`` D
    flops (4 forward, 10 backward) per visible (query, key) pair and query
    head over the peak rate of the type."""
    import numpy as np

    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kv_len = Skv if kw["kv_len"] is None else kw["kv_len"]
    q_off = kv_len - Sq if kw["q_offset"] is None else kw["q_offset"]
    qpos = q_off + np.arange(Sq, dtype=np.int64)
    lo = np.maximum(0, qpos - kw["window"] + 1) if kw["window"] > 0 \
        else np.zeros(Sq, np.int64)
    hi = np.minimum(kv_len - 1, qpos) if kw["causal"] \
        else np.full(Sq, kv_len - 1)
    n = np.maximum(0, hi - lo + 1)
    pairs = int(n.sum())
    keys = int(hi.max() - lo.min() + 1) if pairs else 0
    esize = q.element_size()
    nbytes = esize * (q_tensors * B * Hq * Sq * D
                      + kv_tensors * B * Hkv * keys * D)
    flops = flops_per_pair * D * pairs * B * Hq
    dname = str(q.dtype).replace("torch.", "")
    t_bytes, t_ops = nbytes / rate, flops / PEAK_FLOPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", pairs * B * Hq)


TIMING_CALLS = 3            # separate cuda_ms calls behind each B6 time


def spread_ms(fn, reps: int, cold: bool = False):
    """(middle, min, max) of the medians of ``TIMING_CALLS`` separate
    ``cuda_ms`` calls."""
    m = sorted(cuda_ms(fn, reps, cold) for _ in range(TIMING_CALLS))
    return m[len(m) // 2], m[0], m[-1]


def time_attention(label, q, k, v, kw, reps, rate, cold=False,
                   lse: bool = False) -> dict:
    """B6 at one shape: kernel, plain version, and torch's
    scaled_dot_product_attention with an explicit boolean mask (on
    contiguous copies, K/V repeated over the group; a yardstick only), each
    the middle of ``TIMING_CALLS`` medians of ``reps`` reps, with their
    min-max; ``cold``: the L2 cache is cleared before every rep of all
    three.  ``lse``: the kernel writes each row's log-sum-exp too (the
    plain version returns it; SDPA has none), and its 4 bytes a row join
    the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import swa_attention as swa

    buf = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) \
        if lse else None
    kern = lambda: swa.flash_swa_attention(q, k, v, lse=buf,  # noqa: E731
                                           **kw)
    plain = lambda: swa.flash_swa_attention_plain(  # noqa: E731
        q, k, v, return_lse=lse, **kw)
    got, want = kern(), plain()
    if lse:
        want, want_lse = want
        lse_err = check_lse(buf, want_lse, label)
    err, row = check_attention(got, want, label)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kv_len = Skv if kw["kv_len"] is None else kw["kv_len"]
    q_off = kv_len - Sq if kw["q_offset"] is None else kw["q_offset"]
    qpos = q_off + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = (kpos < kv_len).expand(Sq, Skv)
    if kw["causal"]:
        mask = mask & (kpos <= qpos)
    if kw["window"] > 0:
        mask = mask & (kpos > qpos - kw["window"])
    qc = q.contiguous()
    kr = k.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    vr = v.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qc, kr, vr, attn_mask=mask, scale=D ** -0.5)
    lib_err = float((lib().float() - want.float()).abs().max())
    bound_ms, bound_by, pairs = attention_bound(q, k, kw, rate)
    if lse and bound_by == "bytes":
        bound_ms += 4 * B * Hq * Sq / rate * 1e3
    out = dict(shape=(B, Hq, Hkv, Sq, Skv, D), kv_len=kv_len, pairs=pairs,
               bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
               row_err=row, l2_cleared=cold)
    if lse:
        out["lse_err"] = lse_err
    for key, fn in (("ms", kern), ("plain_ms", plain), ("library_ms", lib)):
        out[key], lo, hi = spread_ms(fn, reps, cold)
        out[key + "_range"] = (lo, hi)
    log(f"timing: flash_attention {label} {out['shape']} kv_len {kv_len} "
        f"{q.dtype} causal {kw['causal']} window {kw['window']} "
        f"({'L2 cleared before each rep' if cold else 'warm L2'}) "
        f"({pairs} visible pairs x heads); middle of {TIMING_CALLS} medians "
        f"of {reps} reps [min-max of the medians]: kernel {out['ms']:.4f} ms "
        f"[{out['ms_range'][0]:.4f}-{out['ms_range'][1]:.4f}], plain "
        f"{out['plain_ms']:.4f} ms [{out['plain_ms_range'][0]:.4f}-"
        f"{out['plain_ms_range'][1]:.4f}], sdpa+mask "
        f"{out['library_ms']:.4f} ms [{out['library_ms_range'][0]:.4f}-"
        f"{out['library_ms_range'][1]:.4f}] (its max abs error {lib_err}), "
        f"bound {bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / out['ms']:.1f}"
        f" % reached), kernel-vs-plain max abs error {err}, worst row error "
        f"{row}" + (f", LSE relative error {lse_err} (its rows' 4 bytes in "
                    f"the bound)" if lse else ""))
    return out


# B6's decode route with the log-sum-exp (a sequence-sharded decode's
# blocks, phase 17's part (g)) against its plain version in fp32 and bf16:
# gemma3's 131,072-key block (D 240, group 2, every key of the block
# visible), recurrentgemma's 512-slot ring block (D 256, group 10,
# decode_32k's 128 sequences), an empty block (kv_len 0, a negative
# q_offset: output and LSE exactly 0) and danube's D 80 over 4,096 keys
LSE_DECODE_CASES = {
    "gemma3 block": (1, 16, 8, 1, 131_072, 240, True, 0, 131_071, 131_072),
    "recurrentgemma block": (128, 10, 1, 1, 512, 256, False, 0, 5_000, 512),
    "empty block": (1, 16, 8, 1, 131_072, 240, True, 0, -7, 0),
    "danube": (4, 32, 8, 1, 4_096, 80, True, 4_096, 4_095, 4_096),
}
# and timed in bf16 with the LSE, L2 cleared: those blocks, and gemma3's
# whole 524,288-key global cache on one rank
LSE_TIMED = ("gemma3 block", "gemma3 whole cache", "recurrentgemma block")
GEMMA3_WHOLE = (1, 16, 8, 1, 524_288, 240, True, 0, 524_287, 524_288)


def decode_lse_battery(device, reps: int, rate: float) -> dict:
    """``LSE_DECODE_CASES`` on the card: the decode route taken (one
    ``flash_decode`` and one ``flash_decode_lse`` launch, never the
    prefill kernels), the output within the attention battery's gates and
    the LSE within ``LSE_TOL`` of the plain version's, the empty block
    exactly 0; then ``LSE_TIMED`` timed.  Returns the timings by label."""
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import swa_attention as swa

    def inputs(case, dt, seed):
        B, Hq, Hkv, Sq, Skv, D = case[:6]
        g = torch.Generator(device=device).manual_seed(seed)
        return [torch.randn(sh, generator=g, device=device).to(dt)
                for sh in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                           (B, Hkv, Skv, D))]

    worst = {}
    for i, (label, case) in enumerate(LSE_DECODE_CASES.items()):
        for dname in ATTN_TOL:
            q, k, v = inputs(case, getattr(torch, dname), 700 + i)
            kw = _attn_kwargs(case)
            lse = torch.full(q.shape[:3], float("nan"), device=device)
            before = dict(launch_counts)
            got = swa.flash_swa_attention(q, k, v, lse=lse, **kw)
            moved = {n: launch_counts[n] - before[n] for n in DECODE_KINDS}
            if moved != {n: 1 for n in DECODE_KINDS}:
                fail(f"flash_attention with the lse, {label} {case}: "
                     f"launches {moved}, not one decode-route launch")
            want, want_lse = swa.flash_swa_attention_plain(
                q, k, v, return_lse=True, **kw)
            err = check_attention(got, want, f"{label} with the lse")
            lerr = check_lse(lse, want_lse, f"{dname} {label}")
            if case[9] == 0 and (torch.count_nonzero(got)
                                 or torch.count_nonzero(lse)):
                fail(f"flash_attention with the lse, {label}: an empty "
                     f"block's output or LSE is not 0")
            w = worst.get(dname, (0.0, 0.0, 0.0))
            worst[dname] = (max(w[0], err[0]), max(w[1], err[1]),
                            max(w[2], lerr))
            del q, k, v, got, want, want_lse, lse
    log(f"attention (decode route with the LSE): {2 * len(LSE_DECODE_CASES)}"
        f" kernel-vs-plain checks ({', '.join(LSE_DECODE_CASES)}), each one "
        f"decode-route launch; max abs / worst row / LSE relative error "
        f"{json.dumps(worst)} (gates {ATTN_TOL} / {ATTN_ROW_TOL} / "
        f"{LSE_TOL}); the empty block 0")
    out = {}
    for label in LSE_TIMED:
        case = GEMMA3_WHOLE if label == "gemma3 whole cache" \
            else LSE_DECODE_CASES[label]
        q, k, v = inputs(case, torch.bfloat16, 800)
        kw = _attn_kwargs(case)
        out[label] = rec = time_attention(
            f"decode route with the LSE, {label}", q, k, v, kw, reps, rate,
            cold=True, lse=True)
        # what writing the LSE costs: the same call without it
        rec["ms_without_lse"] = spread_ms(
            lambda: swa.flash_swa_attention(q, k, v, **kw), reps, True)[0]
        log(f"timing: {label} without the LSE {rec['ms_without_lse']:.4f} "
            f"ms, with it {rec['ms']:.4f} ms")
        del q, k, v
        torch.cuda.empty_cache()
    return out


def teacher_forced(cfg, toks) -> float:
    """Decode ``toks`` one by one from position 0 under the cuda and the
    torch engines (a ring cache: kv_len 8,192 > window); the max abs logit
    difference over every step."""
    import torch

    from repro_torch.models.registry import ModelBundle

    b = ModelBundle(cfg)
    params = b.init(1, device="cuda")
    caches = {e: b.init_cache(1, 8192, device="cuda")
              for e in ("cuda", "torch")}
    if caches["cuda"][0][0].shape[1] != cfg.window:
        fail("teacher-forced decode: the cache is not a ring")
    worst = torch.zeros((), device="cuda")
    walls = []                 # before and after the ring's wrap
    t0 = time.perf_counter()
    for t in range(toks.shape[1]):
        if t == cfg.window:
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
        batch = {"tokens": toks[:, t:t + 1], "pos": t}
        lc, _ = b.decode(params, caches["cuda"], batch, engine="cuda")
        lt, _ = b.decode(params, caches["torch"], batch, engine="torch")
        worst = torch.maximum(worst, (lc.float() - lt.float()).abs().max())
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    err = float(worst)
    if err != err:
        fail(f"teacher-forced decode ({cfg.dtype}): NaN logits")
    n = toks.shape[1]
    log(f"serving: teacher-forced decode, {cfg.n_layers} layers at full "
        f"width, {cfg.dtype}, {n} steps per engine: {walls[0]:.3f} s for "
        f"the {cfg.window} steps before the ring wraps "
        f"({1e3 * walls[0] / cfg.window:.3f} ms a step, both engines), "
        f"{walls[1]:.3f} s for the {n - cfg.window} after "
        f"({1e3 * walls[1] / (n - cfg.window):.3f} ms a step); max abs logit "
        f"difference cuda vs torch engines {err} (gate "
        f"{SERVE_GATE[cfg.dtype]})")
    return err


def serving_phase(reps: int, rate: float):
    """h2o-danube-1.8b at full width: prefill, the batcher, the
    teacher-forced decode, card against CPU, B6's timings and two traces.
    Returns B6's launches on the main path (prefill + batcher) and its
    timing at the prefill's shape."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.interop import tree_map
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import swa_attention as swa
    from repro_torch.models import get_bundle
    from repro_torch.models.registry import ModelBundle
    from repro_torch.serving import ContinuousBatcher, Request

    bundle = get_bundle(DANUBE)
    cfg = bundle.cfg
    t0 = time.perf_counter()
    params = bundle.init(0, device="cuda")
    torch.cuda.synchronize()
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    log(f"serving: {cfg.name} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
        f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, window "
        f"{cfg.window}), {sum(sizes)} {cfg.dtype} parameters drawn on "
        f"the card in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(0)
    V = cfg.vocab_size

    # prefill, B = 2, S = 8,192: the main path's first part
    toks = torch.from_numpy(rng.integers(3, V, (2, 8192)).astype(np.int32)
                            ).cuda()
    rec = Recorder(swa, "flash_swa_attention",
                   lambda q, k, v, **kw: q.numel())
    with rec:
        reset_launch_counts()
        t0 = time.perf_counter()
        got = bundle.prefill(params, {"tokens": toks}, engine="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(launch_counts)
    if launches["flash_attention"] != cfg.n_layers or launches["flash_decode"]:
        fail(f"prefill called B6 {launches['flash_attention']} times, not "
             f"once per layer ({cfg.n_layers}), or took the decode route "
             f"({launches['flash_decode']})")
    t0 = time.perf_counter()
    want = bundle.prefill(params, {"tokens": toks}, engine="torch")
    torch.cuda.synchronize()
    twall = time.perf_counter() - t0
    err = float((got.float() - want.float()).abs().max())
    if not bool(torch.isfinite(got).all()) or got.shape != (2, 1,
                                                            cfg.padded_vocab):
        fail(f"prefill logits {tuple(got.shape)} not finite")
    # how far bf16 itself moves these logits: the same weights in fp32
    b32 = ModelBundle(dataclasses.replace(cfg, dtype="float32"))
    p32 = tree_map(lambda t: t.float(), params)
    l32 = b32.prefill(p32, {"tokens": toks}, engine="cuda")
    spread = float((want.float() - l32).abs().max())
    del p32, l32
    torch.cuda.empty_cache()
    log(f"serving: prefill 2 x 8192 wall {wall:.3f} s (cuda engine, first "
        f"call), {twall:.3f} s (torch engine); B6 launches {launches['flash_attention']}"
        f"; last-token logits max |cuda - torch| {err} (gate "
        f"{SERVE_GATE['bfloat16']}), max |logit| {float(want.abs().max())}, "
        f"bf16 torch engine vs the fp32 model {spread}")
    if not err <= SERVE_GATE["bfloat16"]:
        fail(f"prefill: cuda vs torch engines differ by {err}")

    # the continuous batcher: 4 slots, every cache a 4,096-slot ring
    engine = ContinuousBatcher(bundle, params, n_slots=4, kv_len=8192)
    if engine.cache[0][0].shape[1] != cfg.window:
        fail("batcher: the caches are not rings")
    reqs = [Request(rid=i, prompt=[1] + rng.integers(
        8, V, size=rng.integers(16, 256)).tolist(), max_new=32)
        for i in range(8)]
    for r in reqs:
        engine.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    steps = 0
    while any(not r.done for r in reqs) and steps < 10_000:
        engine.step()
        steps += 1
    torch.cuda.synchronize()
    bwall = time.perf_counter() - t0
    blaunch = dict(launch_counts)
    n_tok = sum(len(r.out) for r in reqs)
    if not all(r.done and 1 <= len(r.out) <= 32 for r in reqs):
        fail("batcher: not every request finished")
    if blaunch["flash_attention"] <= 0:
        fail("batcher: B6 was never launched")
    if blaunch["flash_decode"] != blaunch["flash_attention"]:
        fail(f"batcher: {blaunch['flash_attention']} decode attention calls "
             f"but {blaunch['flash_decode']} launches of the decode route")
    for k in launches:
        launches[k] += blaunch[k]
    passes = blaunch["flash_attention"] // cfg.n_layers
    log(f"serving: batcher {len(reqs)} requests "
        f"({sum(len(r.prompt) for r in reqs)} prompt tokens), {n_tok} tokens "
        f"in {bwall:.3f} s ({n_tok / bwall:.1f} tok/s, {steps} engine steps, "
        f"{passes} forward passes of 4 slots, {1e3 * bwall / passes:.3f} ms "
        f"each), B6 calls {blaunch['flash_attention']}, decode-route "
        f"launches {blaunch['flash_decode']}")

    # teacher-forced decode past the ring's wrap, both engines
    tf_toks = torch.from_numpy(rng.integers(3, V, (1, TF_STEPS)).astype(
        np.int32)).cuda()
    tf = {}
    for dname in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dname, n_layers=TF_LAYERS)
        tf[dname] = teacher_forced(c, tf_toks)
        if not tf[dname] <= SERVE_GATE[dname]:
            fail(f"teacher-forced decode ({dname}): cuda vs torch engines "
                 f"differ by {tf[dname]}")

    # card against CPU: the reduced config in fp32 (the CPU runs B6's plain
    # version through the same cuda engine)
    rb = ModelBundle(dataclasses.replace(get_bundle(DANUBE, reduced=True).cfg,
                                         dtype="float32"))
    pc = rb.init(0, device="cpu")
    pg = tree_map(lambda t: t.cuda(), pc)
    ct = torch.from_numpy(rng.integers(3, rb.cfg.vocab_size, (2, 40)).astype(
        np.int32))
    gt = ct.cuda()
    cerr = float((rb.prefill(pg, {"tokens": gt}, engine="cuda").cpu()
                  - rb.prefill(pc, {"tokens": ct}, engine="cuda")).abs().max())
    caches = (rb.init_cache(2, 32, device="cuda"),
              rb.init_cache(2, 32, device="cpu"))
    for t in range(24):
        lg, _ = rb.decode(pg, caches[0], {"tokens": gt[:, t:t + 1], "pos": t},
                          engine="cuda")
        lc, _ = rb.decode(pc, caches[1], {"tokens": ct[:, t:t + 1], "pos": t},
                          engine="cuda")
        cerr = max(cerr, float((lg.cpu() - lc).abs().max()))
    log(f"cpu: reduced {DANUBE} fp32, prefill + 24 decode steps (ring of "
        f"{rb.cfg.window} wraps): max abs logit difference card vs CPU {cerr}"
        f" (gate {CPU_GATE})")
    if not cerr <= CPU_GATE:
        fail(f"serving card vs CPU: logits differ by {cerr}")

    # B6 at the prefill's shape (the recorded call) and at the batcher's
    # decode shape over a full ring (its layer-0 cache, 4 slots)
    (q, k, v), kw = rec.best[1], rec.best[2]
    timing = time_attention("prefill", q, k, v, kw, reps, rate)
    del rec, q, k, v
    kc, vc = engine.cache[0]
    g = torch.Generator(device="cuda").manual_seed(5)
    dq = torch.randn((4, 1, cfg.n_heads, cfg.head_dim_), generator=g,
                     device="cuda").to(kc.dtype).transpose(1, 2)
    # one layer's K/V (42 MB) fits in the 50 MB L2, while a pass streams
    # 24 layers' caches from device memory: time it with L2 cleared
    decode = time_attention(
        "decode (batcher, full ring)", dq, kc.transpose(1, 2),
        vc.transpose(1, 2), dict(causal=False, window=0, q_offset=8191,
                                 kv_len=cfg.window), reps, rate, cold=True)
    # a yardstick: one torch pass reading the same 42 MB once (a sum over a
    # copy of both caches), L2 cleared alike
    both = torch.cat([kc.reshape(-1), vc.reshape(-1)]).view(torch.int64)
    decode["read_floor_ms"] = cuda_ms(lambda: both.sum(), reps, cold=True)
    log(f"timing: reading the decode shape's {both.numel() * 8} bytes of K/V "
        f"once (one torch sum, L2 cleared) {decode['read_floor_ms']:.4f} ms")
    del both

    # traces: one prefill, one warm batcher step (4 live slots)
    profile_phase("serving_prefill",
                  lambda: bundle.prefill(params, {"tokens": toks},
                                         engine="cuda"))
    for i in range(4):
        engine.submit(Request(rid=100 + i, prompt=[1] + rng.integers(
            8, V, size=16).tolist(), max_new=32))
    engine.step()
    profile_phase("serving_decode", engine.step)
    # one decode pass of the 4 slots over full rings (position 8,191): the
    # device time of every layer's attention reading all 4,096 slots
    tok = torch.from_numpy(rng.integers(3, V, (4, 1)).astype(np.int32)).cuda()
    profile_phase("serving_decode_full_ring", lambda: bundle.decode(
        params, engine.cache, {"tokens": tok, "pos": 8191}, engine="cuda"))
    return launches, timing, decode, tf, err, cerr


# ---------------------------------------------------------------------------
# phase 11: gemma3-12b at full width (head dim 240)
# ---------------------------------------------------------------------------
GEMMA = "gemma3-12b"
GEMMA_PREFILL = 4096       # one 1 x 4,096-token prefill
RING_POS = (500, 1021, 1500, 4097)   # before the wrap, a clamped write, after


def ring_decode_check() -> dict:
    """ROADMAP C11(b) on the card: one gemma3-12b local layer at full width
    over its 1,024-slot ring, three queries a call at positions before and
    after the wrap, the cuda engine (B6's decode route: group 2 x 3 rows)
    against the torch engine (the reference's ``_ring_sdpa``)."""
    import dataclasses

    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.models import get_bundle
    from repro_torch.models import layers as L

    base = get_bundle(GEMMA).cfg
    worst = {}
    for dname in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dname)
        dt = getattr(torch, dname)
        g = torch.Generator(device="cuda").manual_seed(3)
        p = L.attn_params(g, cfg, dt)
        shape = (1, cfg.window, cfg.n_kv_heads, cfg.head_dim_)
        worst[dname] = 0.0
        for pos in RING_POS:
            x = torch.randn((1, 3, cfg.d_model), generator=g,
                            device="cuda").to(dt)
            kc, vc = (torch.randn(shape, generator=g, device="cuda").to(dt)
                      for _ in range(2))
            positions = (pos + torch.arange(3, dtype=torch.int32,
                                            device="cuda"))[None]
            outs = {}
            for engine in ("cuda", "torch"):
                before = launch_counts["flash_decode"]
                outs[engine], _ = L.attention(
                    p, x, cfg, kind="swa", positions=positions,
                    cache=(kc.clone(), vc.clone()), cache_pos=pos,
                    engine=engine)
                if (launch_counts["flash_decode"] - before) != int(
                        engine == "cuda"):
                    fail(f"ring decode S = 3 at pos {pos}: the cuda engine "
                         f"did not take B6's decode route")
            err = float((outs["cuda"].float() - outs["torch"].float())
                        .abs().max())
            if not err <= SERVE_GATE[dname]:
                fail(f"ring decode S = 3 at pos {pos} ({dname}): cuda vs "
                     f"torch engines differ by {err}")
            worst[dname] = max(worst[dname], err)
    log(f"gemma3: ring decode, one local layer at full width (1,024-slot "
        f"ring, S = 3, pos {RING_POS}): max |cuda - torch| engines fp32 "
        f"{worst['float32']} (gate {SERVE_GATE['float32']}), bf16 "
        f"{worst['bfloat16']} (gate {SERVE_GATE['bfloat16']})")
    return worst


def ptxas_report(log_text: str, tag: str) -> str:
    """The ptxas lines (stack frame and spills, registers) of the kernel
    whose mangled name holds ``tag``."""
    lines = log_text.splitlines()
    for i, line in enumerate(lines):
        if "Function properties" in line and tag in line:
            return " | ".join(x.strip() for x in lines[i + 1:i + 3])
    fail(f"no ptxas report for {tag}")


def kernel_registers(log_text: str, kernel: str, D: int) -> str:
    """The ptxas lines (registers at launch, spills) of ``kernel<D>``."""
    return ptxas_report(log_text, f"{kernel}ILi{D}E")


def gemma3_phase(reps: int, rate: float):
    """gemma3-12b at full width, bf16, seeded random weights on the card:
    the C11(b) ring check, one 1 x 4,096 prefill under both engines (B6's
    prefill kernel once per layer at D = 240, its decode route never) and
    B6 timed at the model's global and local prefill shapes.  Returns the
    prefill's launches, the two timings, the logit gate and the ring's."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.interop import tree_map
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import get_bundle
    from repro_torch.models.registry import ModelBundle

    ring = ring_decode_check()
    bundle = get_bundle(GEMMA)
    cfg = bundle.cfg
    t0 = time.perf_counter()
    params = bundle.init(0, device="cuda")
    torch.cuda.synchronize()
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    log(f"gemma3: {cfg.name} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
        f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, window "
        f"{cfg.window}, pattern {cfg.pattern}), {sum(sizes)} {cfg.dtype} "
        f"parameters drawn on the card in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (
        1, GEMMA_PREFILL)).astype(np.int32)).cuda()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = bundle.prefill(params, {"tokens": toks}, engine="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    if launches["flash_attention"] != cfg.n_layers or launches["flash_decode"]:
        fail(f"gemma3 prefill called B6 {launches['flash_attention']} times, "
             f"not once per layer ({cfg.n_layers}), or took the decode route "
             f"({launches['flash_decode']})")
    t0 = time.perf_counter()
    bundle.prefill(params, {"tokens": toks}, engine="cuda")
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = bundle.prefill(params, {"tokens": toks}, engine="torch")
    torch.cuda.synchronize()
    twall = time.perf_counter() - t0
    if not bool(torch.isfinite(got).all()) or got.shape != (
            1, 1, cfg.padded_vocab):
        fail(f"gemma3 prefill logits {tuple(got.shape)} not finite")
    err = float((got.float() - want.float()).abs().max())
    # The same bf16 weights in fp32, under both engines.  Over 48 layers and
    # 262,144 logits bf16 alone moves the largest logit past 0.1 under
    # either engine (each 0.1255 from the fp32 model, while the fp32 engines
    # agree to 2.4e-5: PERF.md), so the bf16 gate holds each engine
    # against the fp32 model (``bf16_gate``).
    p32 = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    b32 = ModelBundle(dataclasses.replace(cfg, dtype="float32"))
    l32 = {e: b32.prefill(p32, {"tokens": toks}, engine=e).float()
           for e in ("cuda", "torch")}
    del p32
    torch.cuda.empty_cache()
    err32 = float((l32["cuda"] - l32["torch"]).abs().max())
    spread = {e: float((x.float() - l32["torch"]).abs().max())
              for e, x in (("cuda", got), ("torch", want))}
    bound = bf16_gate(spread["torch"], float(l32["torch"].abs().max()))
    log(f"gemma3: prefill 1 x {GEMMA_PREFILL} wall {wall:.3f} s (cuda "
        f"engine, first call), {warm:.3f} s (cuda, warm), {twall:.3f} s "
        f"(torch engine); B6 prefill-kernel launches "
        f"{launches['flash_attention']}, decode-route launches "
        f"{launches['flash_decode']}; last-token logits: bf16 max |cuda - "
        f"torch| {err}, max |logit| {float(want.abs().max())}; the same "
        f"weights in fp32: max |cuda - torch| {err32} (gate "
        f"{SERVE_GATE['float32']}); bf16 against the fp32 model (torch "
        f"engine): cuda {spread['cuda']}, torch {spread['torch']} (gate: "
        f"cuda <= {bound})")
    if not err32 <= SERVE_GATE["float32"]:
        fail(f"gemma3 prefill (fp32): cuda vs torch engines differ by "
             f"{err32}")
    if not spread["cuda"] <= bound:
        fail(f"gemma3 prefill (bf16): the cuda engine is {spread['cuda']} "
             f"from the fp32 model, the torch engine {spread['torch']}")
    del got, want, l32
    torch.cuda.empty_cache()

    # B6 at the model's prefill shapes, in its (B, S, H, D) layout
    timings = {}
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn((1, GEMMA_PREFILL, h, cfg.head_dim_), generator=g,
                           device="cuda").to(torch.bfloat16).transpose(1, 2)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    for label, window in (("gemma3 global", 0), ("gemma3 local", cfg.window)):
        timings[label] = time_attention(
            label, q, k, v, dict(causal=True, window=window, q_offset=None,
                                 kv_len=None), reps, rate)
    return launches, timings, dict(bf16=err, fp32=err32, **{
        f"bf16_{e}_vs_fp32": v for e, v in spread.items()}), ring


# ---------------------------------------------------------------------------
# phase 15: the other six model families at full width
# ---------------------------------------------------------------------------
FAMILY_PREFILL = 4096      # one 1 x 4,096-token prefill a family
# deepseek-moe-16b's bf16 gate runs its first 4 layers (the dense one and 3
# MoE layers) beside their fp32 twin: over the whole model a rounding that
# flips one token's expert choice in an early layer spreads through the
# later ones, and the two engines' bf16 logits part by up to the logits'
# own size (PERF.md)
TWIN_LAYERS = 4
QWEN_MOE_LAYERS = 4        # qwen2-moe-a2.7b at full width, depth cut to 4
# (arch, layers or None for full depth, bf16 gate's layers or None for the
# whole model, prefill tokens, batcher (prompt lengths [lo, hi), new
# tokens)).  xlstm-125m's sLSTM is a loop of ~30 launches a token (1.7 s a
# layer at 4,096 tokens: it is timed there): its prefills run 1,024 tokens
FAMILIES = (
    ("deepseek-moe-16b", None, TWIN_LAYERS, FAMILY_PREFILL, (16, 48, 16)),
    ("qwen2-moe-a2.7b", QWEN_MOE_LAYERS, None, FAMILY_PREFILL, (8, 24, 8)),
    ("recurrentgemma-2b", None, None, FAMILY_PREFILL, (8, 24, 8)),
    ("xlstm-125m", None, None, 1024, (8, 24, 8)),
    ("seamless-m4t-medium", None, None, FAMILY_PREFILL, (8, 24, 8)),
    ("phi-3-vision-4.2b", None, None, FAMILY_PREFILL, (8, 24, 8)),
)
FAMILY_KV_LEN = 4096       # the batcher's cache slots (4 slots)
# B6 timed in phase 15: (label, keys, call) by family
ATTN_TIMED = {
    "phi-3-vision-4.2b": ("phi-3-vision prefill", FAMILY_PREFILL, dict(
        causal=True, window=0, q_offset=None, kv_len=None)),
    "seamless-m4t-medium": ("seamless cross", FAMILY_PREFILL // 4, dict(
        causal=False, window=0, q_offset=0, kv_len=None)),
}


def attention_calls(cfg, decode: bool) -> int:
    """B6 calls of one forward: an LM's attention layers; an
    encoder-decoder's encoder layers and decoder self- and cross-attention
    (a decode step runs no encoder)."""
    from repro_torch.models import lm as LM

    if cfg.is_encdec:
        return 2 * cfg.n_layers + (0 if decode else cfg.n_encoder_layers)
    return sum(k in LM.ATTENTION_KINDS for k, _ in LM.layer_kinds(cfg))


def family_batch(cfg, B: int, S: int, rng, device):
    """Tokens and the frontend's inputs (the reference's input specs:
    ``src_len(S)`` encoder frames; one embedding a vision token), drawn
    from ``rng``."""
    import numpy as np
    import torch

    from repro_torch.models.registry import src_len

    batch = {"tokens": torch.from_numpy(rng.integers(
        3, cfg.vocab_size, (B, S)).astype(np.int32)).to(device)}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, src_len(S), cfg.frontend_dim), np.float32)).to(device)
    if cfg.frontend == "vision_patches":
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.frontend_dim), np.float32)).to(
                device)
    return {k: v if k == "tokens" else v.to(torch.bfloat16)
            for k, v in batch.items()}


# the stage functions moe_ffn calls, by the stage each one times
MOE_STAGES = (("router", "moe_route"), ("dispatch", "moe_dispatch"),
              ("experts", "moe_experts"), ("combine", "moe_combine"),
              ("shared", "ffn"))


def moe_split(p, x, cfg) -> dict:
    """One MoE layer's device time by stage (router, dispatch, expert
    products, combine, shared experts) from one trace of ``moe_ffn``
    itself: while it runs, each stage function it calls is wrapped in a
    range of its own that ends in a synchronization, and a device event
    belongs to the stage whose range on the device's timeline (the trace's
    ``gpu_user_annotation``) holds it; the host-side ranges are on another
    clock.  The trace opens with a ~50 ms spin and ``moe_ffn`` runs twice in
    it, the second run read: late in a long process the tracer has dropped
    a first run's early events.  Fails unless that run called each stage
    once.  ``repeat_diff`` is the largest difference between that run's
    output and a later plain ``moe_ffn`` call's (a reading, no gate)."""
    import torch
    from torch.profiler import record_function

    from repro_torch.models import layers as L

    calls, keeps = {}, []

    def wrap(tag: str, stage: str, fn):
        def staged(*a, **kw):
            with record_function(tag + stage):
                res = fn(*a, **kw)
                torch.cuda.synchronize()
            calls[tag + stage] = calls.get(tag + stage, 0) + 1
            if stage == "dispatch":
                keeps.append(res[2])
            return res
        return staged

    def run(tag: str):
        saved = {name: getattr(L, name) for _, name in MOE_STAGES}
        try:
            for stage, name in MOE_STAGES:
                setattr(L, name, wrap(tag, stage, saved[name]))
            return L.moe_ffn(p, x, cfg)
        finally:
            for name, fn in saved.items():
                setattr(L, name, fn)

    run("warm.")
    with profiled() as prof:
        torch.cuda._sleep(50 * SPIN_CYCLES)      # ~50 ms for the tracer
        torch.cuda.synchronize()
        run("warm.")
        y = run("moe.")
    want = {f"moe.{stage}": 1 for stage, _ in MOE_STAGES
            if stage != "shared" or "shared_i" in p}
    got = {k: n for k, n in calls.items() if k.startswith("moe.")}
    if got != want:
        fail(f"moe_split: moe_ffn called its stages {got}, not {want}")
    trace = REPO / "chiprun_out" / f"{cfg.name}_moe_layer_trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "gpu_user_annotation"
              and e["name"].startswith("moe.")}
    if set(ranges) != set(want):
        fail(f"moe_split: the trace has device ranges for {sorted(ranges)}, "
             f"not for the stages {sorted(want)}")
    split = {k: 0.0 for k in ranges}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            for k, (lo, hi) in ranges.items():
                if lo <= e["ts"] <= hi:
                    split[k] += e["dur"] / 1e3
    repeat = float((y.float() - L.moe_ffn(p, x, cfg).float()).abs().max())
    tokens = x.shape[0] * x.shape[1]
    return dict(ms=split, capacity=L.moe_capacity(cfg, tokens),
                dropped=int((~keeps[-1]).sum()), tokens=tokens,
                repeat_diff=repeat)


def recurrent_times(params, cfg, S: int) -> dict:
    """Wall time (host clock to a synchronization) of one layer of each
    recurrent kind over S tokens of random input, its second call."""
    import torch

    from repro_torch.models import lm as LM
    from repro_torch.models import recurrent as R

    out = {}
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((1, S, cfg.d_model), generator=g, device="cuda").to(
        torch.bfloat16)
    for i, (kind, _) in enumerate(LM.layer_kinds(cfg)):
        if kind in out or kind in LM.ATTENTION_KINDS:
            continue
        fn = getattr(R, kind)
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(params["layers"][i]["mixer"], x, cfg)
            torch.cuda.synchronize()
            out[kind] = time.perf_counter() - t0
    return out


def family_cpu_check(arch: str) -> float:
    """The reduced config in fp32 on the card against the CPU (B6's plain
    version there), both under the cuda engine: a 40-token prefill, then 8
    decode steps; the max abs logit difference."""
    import dataclasses

    import numpy as np

    from repro_torch.interop import tree_map
    from repro_torch.models import get_bundle
    from repro_torch.models.registry import ModelBundle

    rb = ModelBundle(dataclasses.replace(get_bundle(arch, reduced=True).cfg,
                                         dtype="float32"))
    pc = rb.init(0, device="cpu")
    pg = tree_map(lambda t: t.cuda(), pc)
    batch = family_batch(rb.cfg, 2, 40, np.random.default_rng(4), "cpu")
    batch = {k: v if k == "tokens" else v.float() for k, v in batch.items()}
    gbatch = {k: v.cuda() for k, v in batch.items()}
    err = float((rb.prefill(pg, gbatch, engine="cuda").cpu()
                 - rb.prefill(pc, batch, engine="cuda")).abs().max())
    caches = [rb.init_cache(2, 32, device="cuda"),
              rb.init_cache(2, 32, device="cpu")]
    for t in range(8):
        tok = batch["tokens"][:, t:t + 1]
        lg, caches[0] = rb.decode(pg, caches[0], {"tokens": tok.cuda(),
                                                  "pos": t}, engine="cuda")
        lc, caches[1] = rb.decode(pc, caches[1], {"tokens": tok, "pos": t},
                                  engine="cuda")
        err = max(err, float((lg.cpu() - lc).abs().max()))
    return err


def family_batcher(bundle, params, n_attn: int, prompts, max_new: int,
                   rng) -> dict:
    """The continuous batcher (4 slots of FAMILY_KV_LEN) over 8 requests:
    all must finish, and every attention call of its decode passes take
    B6's decode route.  Returns its wall, tokens, passes and launches."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ContinuousBatcher, Request

    V = bundle.cfg.vocab_size
    engine = ContinuousBatcher(bundle, params, n_slots=4,
                               kv_len=FAMILY_KV_LEN, engine="cuda")
    passes = [0]
    step_fn = engine.step_fn

    def counted(*a):
        passes[0] += 1
        return step_fn(*a)

    engine.step_fn = counted
    reqs = [Request(rid=i, prompt=[1] + rng.integers(
        8, V, size=rng.integers(*prompts)).tolist(), max_new=max_new)
        for i in range(8)]
    for r in reqs:
        engine.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    steps = 0
    while any(not r.done for r in reqs) and steps < 10_000:
        engine.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    if not all(r.done and 1 <= len(r.out) <= max_new for r in reqs):
        fail(f"{bundle.cfg.name} batcher: not every request finished")
    if launches["flash_attention"] != passes[0] * n_attn \
            or launches["flash_decode"] != launches["flash_attention"]:
        fail(f"{bundle.cfg.name} batcher: {launches} over {passes[0]} "
             f"passes of {n_attn} attention calls, not all on the decode "
             f"route")
    n_tok = sum(len(r.out) for r in reqs)
    # one warm step of 4 live slots, traced
    for i in range(4):
        engine.submit(Request(rid=100 + i, prompt=[1, 9, 10, 11],
                              max_new=max_new))
    engine.step()
    profile_phase(f"{bundle.cfg.name}_decode", engine.step)
    return dict(wall=wall, tokens=n_tok, passes=passes[0], launches=launches,
                prompt_tokens=sum(len(r.prompt) for r in reqs))


def to_fp32_in_place(params) -> None:
    """Every tensor of a model's parameters to fp32, one layer at a time,
    handing each layer's bf16 memory back before the next: the fp32 copy of
    deepseek-moe-16b (61 GiB) fits on the card only once its bf16 weights
    (30.5 GiB) are gone."""
    import torch

    from repro_torch.interop import tree_map

    for k, v in params.items():
        if isinstance(v, list):
            for i in range(len(v)):
                v[i] = tree_map(lambda t: t.float(), v[i])
                torch.cuda.empty_cache()
        else:
            params[k] = v.float()


def family_run(arch: str, layers, twin_layers, seq: int, batcher,
               reps: int, rate: float) -> dict:
    """One family at full width, bf16, seeded random weights drawn on the
    card: a 1 x ``seq`` prefill under both engines (B6 once per
    attention call, never its decode route; logits finite), the batcher,
    then the same weights in fp32 under both engines (within 1e-3) and the
    bf16 gate against that fp32 model (``bf16_gate``; ``twin_layers`` deep
    where given: deepseek's routing makes its whole bf16 model's logits a
    matter of which expert a rounding picks, so its bf16 gate runs its
    first layers)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.interop import tree_map
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import get_bundle
    from repro_torch.models import layers as L
    from repro_torch.models.registry import ModelBundle

    cfg = get_bundle(arch).cfg
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    bundle = ModelBundle(cfg)
    t0 = time.perf_counter()
    params = bundle.init(0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    rng = np.random.default_rng(11)
    batch = family_batch(cfg, 1, seq, rng, "cuda")
    n_attn = attention_calls(cfg, decode=False)
    rec = Recorder(L, "moe_ffn", lambda p, x, c: x.numel())
    with rec:
        reset_launch_counts()
        t0 = time.perf_counter()
        got = bundle.prefill(params, batch, engine="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(launch_counts)
    if launches["flash_attention"] != n_attn or launches["flash_decode"]:
        fail(f"{arch} prefill: B6 called {launches['flash_attention']} "
             f"times, not once per attention call ({n_attn}), or took the "
             f"decode route ({launches['flash_decode']})")
    t0 = time.perf_counter()
    bundle.prefill(params, batch, engine="cuda")
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = bundle.prefill(params, batch, engine="torch")
    torch.cuda.synchronize()
    twall = time.perf_counter() - t0
    if not bool(torch.isfinite(got).all()) or got.shape != (
            1, 1, cfg.padded_vocab):
        fail(f"{arch} prefill logits {tuple(got.shape)} not finite")
    b16 = {"cuda": got.float(), "torch": want.float()}
    if arch in SHARD_FAMILIES and not n_attn:
        # without attention the torch engine is the cuda engine bit for bit:
        # phase 17's bound takes a second sound computation, the cuda engine
        # on a batch of the sequence twice (other GEMM shapes), row 0
        twice = {k: torch.cat([v, v]) for k, v in batch.items()}
        b16["batch2"] = bundle.prefill(params, twice,
                                       engine="cuda")[:1].float()
        del twice
    out = dict(params=sum(sizes), seq=seq, init_s=init_s, prefill_s=wall,
               prefill_warm_s=warm, prefill_torch_s=twall,
               bf16=float((b16["cuda"] - b16["torch"]).abs().max()),
               max_logit=float(want.abs().max()))
    if rec.best is not None:
        _, (p, x, c), _ = rec.best
        out["moe_split"] = moe_split(p, x, c)
    del rec, got, want
    if cfg.family == "ssm":
        out["recurrent_s"] = recurrent_times(params, cfg, FAMILY_PREFILL)

    b32in = {k: v if k == "tokens" else v.float() for k, v in batch.items()}
    if twin_layers is not None:
        # the bf16 gate at the cut depth, beside its own fp32 twin
        tb = ModelBundle(dataclasses.replace(cfg, n_layers=twin_layers))
        tparams = dict(params, layers=params["layers"][:twin_layers])
        cut = {e: tb.prefill(tparams, batch, engine=e).float()
               for e in ("cuda", "torch")}
        t32 = ModelBundle(dataclasses.replace(tb.cfg, dtype="float32"))
        p32 = tree_map(lambda t: t.float(), tparams)
        c32 = {e: t32.prefill(p32, b32in, engine=e).float()
               for e in ("cuda", "torch")}
        del tparams, p32
        torch.cuda.empty_cache()
        out["cut"] = dict(layers=twin_layers, fp32=float(
            (c32["cuda"] - c32["torch"]).abs().max()),
            max_logit32=float(c32["torch"].abs().max()), **{
            f"bf16_{e}_vs_fp32": float((x - c32["torch"]).abs().max())
            for e, x in cut.items()})

    lo, hi, new = batcher
    bat = family_batcher(bundle, params, attention_calls(cfg, decode=True),
                         (lo, hi), new, rng)
    out["batcher"] = {k: v for k, v in bat.items() if k != "launches"}
    for k in launches:
        launches[k] += bat["launches"][k]
    out["launches"] = launches

    timing = {}
    if arch in ATTN_TIMED:
        # B6 at the model's prefill shape (phi-3-vision: 32 heads of 96,
        # causal) or its cross-attention's (seamless: 4,096 queries over
        # 1,024 frames, non-causal, q_offset 0)
        label, Skv, kw = ATTN_TIMED[arch]
        g = torch.Generator(device="cuda").manual_seed(9)
        q, k, v = (torch.randn((1, S, cfg.n_heads, cfg.head_dim_),
                               generator=g, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2)
                   for S in (seq, Skv, Skv))
        timing[label] = time_attention(label, q, k, v, kw, reps, rate)
        del q, k, v

    # the same weights in fp32, the whole model
    gc.collect()
    torch.cuda.empty_cache()
    to_fp32_in_place(params)
    b32 = ModelBundle(dataclasses.replace(cfg, dtype="float32"))
    l32 = {e: b32.prefill(params, b32in, engine=e).float()
           for e in ("cuda", "torch")}
    out["fp32"] = float((l32["cuda"] - l32["torch"]).abs().max())
    out["max_logit32"] = float(l32["torch"].abs().max())
    for e, x in b16.items():
        out[f"bf16_{e}_vs_fp32"] = float((x - l32["torch"]).abs().max())
    ref32 = l32["torch"].cpu().numpy()
    del params, l32
    gc.collect()
    torch.cuda.empty_cache()
    gate = out.get("cut", out)
    bound = bf16_gate(gate["bf16_torch_vs_fp32"], gate["max_logit32"])
    # phase 17 holds the sharded prefill of the same weights and tokens
    # against these
    if arch == SHARD_MOE:
        FAMILY_REF[arch] = dict(full_cuda=b16["cuda"].cpu().numpy(),
                                cut_cuda=cut["cuda"].cpu().numpy(),
                                cut_fp32=c32["torch"].cpu().numpy(),
                                bound=bound, twin=twin_layers)
    elif arch in SHARD_FAMILIES:
        # phase 15's bf16_gate; without attention (xlstm), bf16_gate of the
        # larger distance from the fp32 model of its engine and of the batch
        # of two
        FAMILY_REF[arch] = dict(
            full_cuda=b16["cuda"].cpu().numpy(), fp32=ref32,
            bound=bf16_gate(max(out["bf16_torch_vs_fp32"],
                                out.get("bf16_batch2_vs_fp32", 0.0)),
                            out["max_logit32"]))
    log(f"families: {arch} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
        f"{cfg.head_dim_}, pattern {cfg.pattern}), {out['params']} bf16 "
        f"parameters drawn on the card in {init_s:.3f} s; prefill 1 x "
        f"{seq} {wall:.3f} s (cuda, first), {warm:.3f} s (cuda, "
        f"warm), {twall:.3f} s (torch); B6 launches {n_attn}; last-token "
        f"logits: bf16 max |cuda - torch| {out['bf16']}, max |logit| "
        f"{out['max_logit']}; the same weights in fp32 max |cuda - torch| "
        f"{out['fp32']} (gate {SERVE_GATE['float32']}), bf16 against them: "
        f"cuda {out['bf16_cuda_vs_fp32']}, torch {out['bf16_torch_vs_fp32']}"
        f"{'' if 'bf16_batch2_vs_fp32' not in out else ', cuda on a batch of two ' + str(out['bf16_batch2_vs_fp32']) + ' (phase 17 bound ' + str(FAMILY_REF[arch]['bound']) + ')'}"
        f"{'' if 'cut' not in out else '; cut to its first ' + str(twin_layers) + ' layers: ' + json.dumps(out['cut'])}"
        f" (gate: cuda <= {bound}); batcher "
        f"{bat['tokens']} tokens in {bat['wall']:.3f} s "
        f"({bat['tokens'] / bat['wall']:.1f} tok/s, {bat['passes']} passes "
        f"of 4 slots, {1e3 * bat['wall'] / bat['passes']:.3f} ms each, "
        f"{bat['prompt_tokens']} prompt tokens), B6 calls "
        f"{bat['launches']['flash_attention']} all on the decode route")
    if "moe_split" in out:
        ms = out["moe_split"]
        log(f"families: {arch} one MoE layer at the prefill's {ms['tokens']} "
            f"tokens (capacity {ms['capacity']}, {ms['dropped']} choices "
            f"dropped), device ms by stage {json.dumps(ms['ms'])}; a second "
            f"moe_ffn call differs from the traced one by "
            f"{ms['repeat_diff']}")
    if "recurrent_s" in out:
        log(f"families: {arch} one layer of each recurrent kind over "
            f"{FAMILY_PREFILL} tokens (wall, second call) "
            f"{json.dumps(out['recurrent_s'])}")
    for what in ([out] + ([out["cut"]] if "cut" in out else [])):
        if not what["fp32"] <= SERVE_GATE["float32"]:
            fail(f"{arch} prefill (fp32): cuda vs torch engines differ by "
                 f"{what['fp32']}")
    if not gate["bf16_cuda_vs_fp32"] <= bound:
        fail(f"{arch} prefill (bf16): the cuda engine is "
             f"{gate['bf16_cuda_vs_fp32']} from the fp32 model, the torch "
             f"engine {gate['bf16_torch_vs_fp32']} (gate {bound})")
    return out, timing


def families_phase(reps: int, rate: float):
    """Phase 15: every family of FAMILIES in turn, each followed by its
    reduced config on the card against the CPU (within CPU_GATE).  Fails on
    a B6 call of a family's run that no case of the B6 battery checked
    (``b6_key``).  Returns the launches summed over their prefills and
    batchers, B6's timings at the shapes of ATTN_TIMED, and each family's
    record."""
    checked = {b6_key(c) for c in ATTN_CASES}
    records, total, timing = {}, None, {}
    for arch, layers, twin, seq, batcher in FAMILIES:
        with B6Calls() as calls:
            rec, t = family_run(arch, layers, twin, seq, batcher, reps, rate)
        if calls.keys - checked:
            fail(f"{arch}: B6 calls no battery case checked: "
                 f"{sorted(calls.keys - checked)}")
        rec["cpu"] = family_cpu_check(arch)
        log(f"families: {arch}: {len(calls.keys)} B6 call shapes, each "
            f"checked by the battery; reduced fp32 card vs CPU {rec['cpu']} "
            f"(gate {CPU_GATE})")
        if not rec["cpu"] <= CPU_GATE:
            fail(f"{arch}: reduced config card vs CPU differ by {rec['cpu']}")
        records[arch] = rec
        timing.update(t)
        total = dict(rec["launches"]) if total is None else {
            k: total[k] + rec["launches"][k] for k in total}
    return total, timing, records


# ---------------------------------------------------------------------------
# phases 12-13: B5 and B2b, and the sharded quickstart
# ---------------------------------------------------------------------------
HP_DESTS = (1, 2, 4, 8, 15, 64)
HP_BLOCKS = (256, 512, 1024)
# B2b: ragged sizes, the edges of its 4,096-row tiles, many tiles
MASK_SIZES = (0, 1, 31, 33, 1025, 4095, 4096, 4097, 100_003,
              300 * 4096 + 5, 48_000_000)
SHARDS = 4                 # ranks of the sharded phase, all on the one card
SHARDED_TIMEOUT = 600.0    # seconds for the sharded phase's ranks
EXPOSURE_KW = {"purview_days": 60}   # exposures_sharded in the small runs


def partition_battery(device, reps: int, rate: float) -> dict:
    """B5 against its plain version, bit for bit: every destination count
    of HP_DESTS at blocks 256/512/1024, ragged lengths, invalid rows, NULL
    and negative keys.  B2b against its plain version through
    ``ops.filter_compact`` with bool masks (all-false, all-true, ragged, and
    long all-false runs with a few kept rows, so that the look-back crosses
    many tiles that publish an aggregate of 0) up to 48M rows, and once
    with 7 columns; B2b timed at 48M rows with a ragged mask."""
    import numpy as np
    import torch

    from repro_torch.core import bitset as bs
    from repro_torch.core.columnar import NULL_INT
    from repro_torch.kernels import filter_compact as fc
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import ops

    checked = 0
    for n_dest in HP_DESTS:
        for block in HP_BLOCKS:
            for n in (1, 31, block - 1, block + 1, 5 * block + 77, 1_000_003):
                rng = np.random.default_rng(n * 131 + n_dest)
                keys = rng.integers(-2 ** 31, 2 ** 31, n,
                                    dtype=np.int64).astype(np.int32)
                keys[rng.random(n) < 0.05] = NULL_INT
                k = torch.from_numpy(keys).to(device)
                w = bs.pack(torch.from_numpy(rng.random(n) < 0.8).to(device))
                got = hp.hash_partition_plan_kernel(k, w, n_dest, block)
                want = hp.hash_partition_plan_plain(k, w, n_dest, block)
                torch.cuda.synchronize()
                if not all(_same(g, x) for g, x in zip(got, want)):
                    fail(f"hash_partition kernel != plain at n={n} "
                         f"n_dest={n_dest} block={block}")
                checked += 1
    log(f"kernels: {checked} hash_partition_plan kernel-vs-plain checks "
        f"bit-identical (n_dest in {HP_DESTS}, blocks {HP_BLOCKS})")
    checked = 0
    g = torch.Generator(device=device).manual_seed(3)
    for n in MASK_SIZES:
        for kind in ("none", "all", "ragged", "runs"):
            for dtype in (torch.int32, torch.float32):
                if dtype == torch.int32:
                    vals = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,),
                                         generator=g, device=device,
                                         dtype=torch.int32)
                else:
                    vals = torch.randn((n,), generator=g, device=device)
                    vals[torch.rand((n,), generator=g, device=device)
                         < 0.1] = float("nan")
                mask = {"none": torch.zeros(n, dtype=torch.bool,
                                            device=device),
                        "all": torch.ones(n, dtype=torch.bool, device=device),
                        "ragged": torch.rand((n,), generator=g, device=device)
                        < 0.5,
                        "runs": torch.rand((n,), generator=g, device=device)
                        < 1e-5}[kind]
                got, gc = ops.filter_compact(vals, mask)
                want, wc = fc.filter_compact_mask_plain([vals], mask)
                torch.cuda.synchronize()
                if int(gc) != int(wc) or not _same(got, want[0]):
                    fail(f"filter_compact (bool mask) kernel != plain at "
                         f"n={n} mask={kind} {dtype}")
                checked += 1
    n = MASK_SIZES[-1]
    cols = [torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g,
                          device=device, dtype=torch.int32) if j % 2 else
            torch.randn((n,), generator=g, device=device) for j in range(7)]
    for c in cols[::2]:
        c[torch.rand((n,), generator=g, device=device) < 0.1] = float("nan")
    mask = torch.rand((n,), generator=g, device=device) < 0.5
    (got, gc), (want, wc) = (fc.filter_compact_mask(cols, mask),
                             fc.filter_compact_mask_plain(cols, mask))
    if int(gc) != int(wc) or not all(_same(a, b) for a, b in zip(got, want)):
        fail(f"filter_compact_mask kernel != plain at n={n}, 7 columns")
    checked += 1
    del cols, got, want
    log(f"kernels: {checked} bool-mask filter_compact kernel-vs-plain "
        f"checks bit-identical at n in {MASK_SIZES} (one with 7 columns)")
    vals = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g,
                         device=device, dtype=torch.int32)
    mask = torch.rand((n,), generator=g, device=device) < 0.5
    kern = lambda: fc.filter_compact_mask([vals], mask)  # noqa: E731
    plain = lambda: fc.filter_compact_mask_plain([vals], mask)  # noqa: E731
    library = lambda: vals[mask]  # noqa: E731
    # the byte mask once, the column read once and written once
    nbytes = 9 * n
    out = dict(n=n, columns=1, ms=cuda_ms(kern, reps),
               plain_ms=cuda_ms(plain, reps), library_ms=cuda_ms(library, reps),
               bound_ms=nbytes / rate * 1e3, max_abs_err=0.0)
    log(f"timing: filter_compact_mask n={n} columns=1 kernel "
        f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, library "
        f"(vals[mask]) {out['library_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms")
    return out


def gathered_rows(t) -> dict:
    """The valid rows of a ``ShardedTable``, every rank's in rank order (the
    whole table's valid rows in order), on every rank: each rank compacts
    its block and the blocks' valid rows are gathered (one explicit gather
    a column, of the largest block's valid rows, not of its capacity)."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import comm

    b, group = t.block, t.group
    counts = comm.all_gather_cat(b.count.reshape(1).to(torch.int64),
                                 group).tolist()
    width = max(counts)
    keep = b.valid_bool()
    out = {}
    for c, v in b.columns.items():
        local = torch.zeros((width,), dtype=v.dtype, device=v.device)
        local[:counts[dist.get_rank(group)]] = v[keep]
        rows = comm.all_gather_cat(local, group).view(len(counts), width)
        out[c] = torch.cat([rows[r, :k] for r, k in enumerate(counts)])
    return out


def digest(res) -> dict:
    """What the sharded phase compares of one result, small enough to keep
    while the next run holds the card: per event table its validity words
    and count and its valid rows in order, the cohort words, the flow and
    the stats.  Of a sharded result (``ShardedTable`` events), the words
    are the rank's block's, the count the global one and the valid rows
    every rank's (``gathered_rows``)."""
    from repro_torch.distributed import ShardedTable

    events = {}
    for name, t in res.events.items():
        if isinstance(t, ShardedTable):
            events[name] = (t.block.valid, t.count, gathered_rows(t))
        else:
            keep = t.valid_bool()
            events[name] = (t.valid, int(t.count),
                            {c: v[keep] for c, v in t.columns.items()})
    return dict(events=events, stats=res.flatten_stats,
                cohorts={k: c.subjects for k, c in res.cohorts.items()},
                flow=res.flow.flowchart())


def compare_digests(a: dict, b: dict, what: str) -> None:
    """Valid rows in order, validity words, counts, FlatteningStats, cohort
    words and flow, bit for bit."""
    if sorted(a["events"]) != sorted(b["events"]):
        fail(f"{what}: different outputs")
    for name, (wa, na, ca) in a["events"].items():
        wb, nb, cb = b["events"][name]
        if na != nb or not _same(wa, wb) or not all(
                _same(ca[c], cb[c]) for c in ca):
            fail(f"{what}: {name} differs")
    if a["stats"] != b["stats"] or a["flow"] != b["flow"] or not all(
            _same(w, b["cohorts"][k]) for k, w in a["cohorts"].items()):
        fail(f"{what}: FlatteningStats, cohorts or flow differ")


def compare_multisets(sharded: dict, single: dict, what: str) -> None:
    """Digests of the sharded and the single-card result of one study:
    event rows as multisets, cohort words, flow, and the joins'
    FlatteningStats (the sharded plan adds its exchanges)."""
    import torch

    for name, (_, n, cols) in single["events"].items():
        rows = []
        for cs in (cols, sharded["events"][name][2]):
            cs = [cs[c].view(torch.int32) for c in sorted(cs)]
            idx = torch.arange(cs[0].shape[0], device=cs[0].device)
            for c in reversed(cs):                   # lexicographic sort
                idx = idx[torch.argsort(c[idx], stable=True)]
            rows.append(torch.stack([c[idx] for c in cs]))
        if rows[0].shape != rows[1].shape or not torch.equal(*rows):
            fail(f"{what}: {name} rows differ as multisets")
    if sharded["flow"] != single["flow"] or not all(
            _same(sharded["cohorts"][k], w)
            for k, w in single["cohorts"].items()):
        fail(f"{what}: cohorts or flow differ")
    joins = [d for _, d in sorted(sharded["stats"].items())
             if not d["stage"].startswith("exchange")]
    if joins != [d for _, d in sorted(single["stats"].items())]:
        fail(f"{what}: join FlatteningStats differ")


def time_partition(rec, reps: int, rate: float) -> dict:
    """B5 at the largest exchange the recorded rank ran, beside its plain
    version and its bound; and the whole ``hash_partition`` at that shape
    under the torch engine (the reference's argsort route, a yardstick) and
    the cuda engine (B5, the offsets and the scatter)."""
    import torch

    from repro_torch.kernels import hash_partition as hp

    (table, key, n_dest, per), _ = rec.best[1], rec.best[2]
    keys, words = table.columns[key], table.valid
    kern = lambda: hp.hash_partition_plan_kernel(  # noqa: E731
        keys, words, n_dest, hp.DEFAULT_BLOCK)
    plain = lambda: hp.hash_partition_plan_plain(  # noqa: E731
        keys, words, n_dest, hp.DEFAULT_BLOCK)
    if not all(_same(g, w) for g, w in zip(kern(), plain())):
        fail("hash_partition kernel != plain at the sharded path's shape")
    route = {e: (lambda e=e: rec.fn(table, key, n_dest, per, engine=e))
             for e in ("torch", "cuda")}
    (ct, vt, ot), (cc, vc, oc) = route["torch"](), route["cuda"]()
    if int(ot) != int(oc) or not torch.equal(vt, vc) or not all(
            _same(ct[k], cc[k]) for k in ct):
        fail("hash_partition torch and cuda routes differ")
    cap = table.capacity
    n_blocks = -(-cap // hp.DEFAULT_BLOCK)
    # keys 4 B + validity 1/8 B in, dest and rank 8 B out per row; one
    # histogram row of n_dest ints per block
    nbytes = (12 + 1 / 8) * cap + 4 * n_dest * n_blocks
    return dict(n=cap, n_dest=n_dest, per_dest=per,
                ms=cuda_ms(kern, reps), plain_ms=cuda_ms(plain, reps),
                torch_route_ms=cuda_ms(route["torch"], reps),
                cuda_route_ms=cuda_ms(route["cuda"], reps), library_ms=None,
                bound_ms=nbytes / rate * 1e3, max_abs_err=0.0)


def small_sharded(group, device, star: dict, n_patients: int,
                  drugs=None) -> list:
    """The sharded entry points on a small numpy ``star`` through the
    package's rank functions (``distributed.launch``), all under the cuda
    engines: the quickstart, ``distributed_flatten``, and
    ``exposures_sharded`` of ``drugs`` (by default the quickstart's drug
    events, which its exchanges left patient-partitioned)."""
    from repro_torch.core import DCIR_SCHEMA
    from repro_torch.distributed import launch

    out = launch.tasks_rank(group, device, [
        (launch.study_rank, (build_study(n_patients), star,
                             [("cuda", "cuda")])),
        (launch.flatten_rank, (DCIR_SCHEMA, star, "cuda"))])
    if drugs is None:
        drugs = out[0][0]["events"]["drug_purchases"]
    out.append(launch.exposures_rank(group, device, drugs, n_patients,
                                     dict(EXPOSURE_KW, engine="cuda")))
    return out


def same_host(a, b) -> bool:
    """Host data (dicts, sequences, numpy arrays, scalars) equal bit for
    bit."""
    import numpy as np

    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_host(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            map(same_host, a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    return a == b


def comparable(small: list) -> list:
    """``small_sharded``'s results without what differs between devices by
    design (launch counts, collectives, seconds); the plan as its nodes."""
    study = [{k: v for k, v in r.items()
              if k not in ("launches", "comm", "seconds", "plan")}
             | {"plan": [(n.op, n.inputs, n.params) for n in r["plan"].nodes]}
             for r in small[0]]
    return [study] + small[1:]


SHARDED_QUERIES = 12        # the mix's first 12: every tenant x every shape
KERNELS_SHARDED_SERVICE = KERNELS_B1_B3 + ("hash_partition_plan",)


def local_digest(res) -> dict:
    """What the sharded service phase compares of one sharded result, on
    the host and with no collective (a drain's ``on_done`` may issue none):
    per event table this rank's block words and count, the global count and
    the block's valid rows in order; FlatteningStats, cohort words, flow and
    the log without ``ts``."""
    events = {}
    for name, t in res.events.items():
        b = t.block
        keep = b.valid_bool()
        events[name] = (b.valid.cpu().numpy(), int(b.count), t.count,
                        {c: v[keep].cpu().numpy()
                         for c, v in b.columns.items()})
    return dict(events=events, stats=res.flatten_stats,
                cohorts={k: c.subjects.cpu().numpy()
                         for k, c in res.cohorts.items()},
                flow=None if res.flow is None else res.flow.flowchart(),
                log=log_entries(res.log))


def sharded_service(group, device, dcir, n_patients: int) -> dict:
    """The sharded query service on this rank (phase 14): the naive path
    (each of the mix's first 12 queries a solo ``Study.run(mesh=group)``,
    timed, its launches and digest kept; and the 3 warm-up queries'), then
    on fresh services, synchronous and pipelined, a warm-up query a shape
    and the 12 queries timed (launch counts set to 0 just before, read just
    after: they must equal what the solo runs and the hits predict), then
    both modes again with every ticket's digest held against its solo
    run's and its blocks against their capacity.  Returns host data and its
    log lines."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import comm
    from repro_torch.distributed.launch import blocks
    from repro_torch.kernels import launch_counts, reset_launch_counts

    me = dist.get_rank(group)
    t_phase = time.perf_counter()
    lines = []
    solo, digests, naive_lat = {}, {}, []
    for q in range(SHARDED_QUERIES + 3):
        reset_launch_counts()
        t0 = time.perf_counter()
        res = service_study(q, n_patients).run(
            dict(dcir), engine="cuda", predicate_engine="cuda", mesh=group,
            device=device)
        torch.cuda.synchronize()
        if q < SHARDED_QUERIES:
            naive_lat.append(time.perf_counter() - t0)
        solo[q] = dict(launch_counts)
        n_ex = sum(n.op == "exchange" for n in res.plan.nodes)
        if solo[q]["hash_partition_plan"] != n_ex:
            fail(f"rank {me}: solo query {q} launched B5 "
                 f"{solo[q]['hash_partition_plan']} times for {n_ex} "
                 f"exchanges")
        digests[q] = local_digest(res)
        del res
    torch.cuda.empty_cache()
    naive_wall = sum(naive_lat)
    lines.append(
        f"rank {me}: service naive path, {SHARDED_QUERIES} solo sharded "
        f"runs: wall {naive_wall:.6f} s, latency p50 "
        f"{np.percentile(naive_lat, 50):.6f} s p95 "
        f"{np.percentile(naive_lat, 95):.6f} s")

    def q_of(t) -> int:
        # warm-up tickets come first (queries 12-14), then queries 0-11
        return SHARDED_QUERIES + t.seq if t.seq < 3 else t.seq - 3

    timed = {}
    for pipeline in (False, True):
        mode = "pipelined" if pipeline else "sync"
        svc = new_service(dcir, pipeline, mesh=group, device=device)
        warm_up(svc, n_patients, take, first=SHARDED_QUERIES)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        comm.reset_stats()
        dist.barrier(group)
        tickets, wall, (sub, rea) = serve(svc, n_patients, take,
                                          queries=SHARDED_QUERIES)
        launches = dict(launch_counts)
        staging = dict(comm.stats)
        peak = torch.cuda.max_memory_allocated()
        st = svc.stats
        lat = [t.latency_s for t in tickets]
        want = predicted_launches(tickets, solo, KERNELS_SHARDED_SERVICE)
        got = {k: launches[k] for k in KERNELS_SHARDED_SERVICE}
        lines.append(
            f"rank {me}: service {mode}: serve wall {wall:.6f} s for "
            f"{SHARDED_QUERIES} queries (after {st.compile_count} warm-up "
            f"runner builds), submit_s {sub:.6f}, realize_s {rea:.6f}; "
            f"latency p50 {np.percentile(lat, 50):.6f} s p95 "
            f"{np.percentile(lat, 95):.6f} s; hits {st.cache_hits}, misses "
            f"{st.cache_misses}, evictions {st.cache_evictions}, entries "
            f"{st.cache_entries}, bytes cached {st.cache_bytes} "
            f"({st.cache_bytes / 2**30:.3f} GiB accounted, the global "
            f"tables'), demotions {st.demotions}; peak device memory "
            f"{peak / 2**30:.3f} GiB; host staging "
            f"{staging['staged_bytes'] / 2**30:.3f} GiB in "
            f"{staging['staging_s']:.3f} s; collectives "
            f"{staging['collectives']} ({staging['all_to_all']} all-to-all, "
            f"{staging['all_reduce']} sums, {staging['all_gather']} gathers, "
            f"{staging['objects']} agreements); launches {got} against "
            f"{want} predicted from the solo runs and the hits")
        if st.compile_count != 3 or st.demotions:
            fail(f"rank {me}: service {mode}: {st.compile_count} runners "
                 f"built (3 shapes), {st.demotions} demotions")
        if got != want:
            fail(f"rank {me}: service {mode}: launches differ from the "
                 f"prediction")
        timed[mode] = dict(wall=wall, launches=launches, peak=peak,
                           staging=staging, lat=lat, sub=sub, rea=rea,
                           counts=[(t.cache_hits, t.cache_misses, t.compiled)
                                   for t in tickets],
                           cache=(st.cache_hits, st.cache_misses,
                                  st.cache_evictions, st.cache_bytes))
        del svc, tickets
        gc.collect()
        torch.cuda.empty_cache()
    if timed["sync"]["counts"] != timed["pipelined"]["counts"]:
        fail(f"rank {me}: service: per-ticket hits and misses differ between "
             f"modes")

    for pipeline in (False, True):
        mode = "pipelined" if pipeline else "sync"
        svc = new_service(dcir, pipeline, mesh=group, device=device)
        checked = []

        def check(t, mode=mode, checked=checked):
            require_done(t)
            q = q_of(t)
            for name, b in blocks(t.result).items():
                if b["storage"] > b["capacity"]:
                    fail(f"rank {me}: service {mode}: query {q}'s {name} "
                         f"holds {b['storage']} slots behind a block of "
                         f"{b['capacity']}")
            got = local_digest(t.result)
            if not same_host(got, digests[q]):
                bad = [k for k in got if not same_host(got[k], digests[q][k])]
                fail(f"rank {me}: service {mode}: query {q} differs from its "
                     f"solo sharded run in {bad}")
            checked.append(t.seq)
            t.result = None

        warm_up(svc, n_patients, check, first=SHARDED_QUERIES)
        tickets, _, _ = serve(svc, n_patients, check, queries=SHARDED_QUERIES)
        counts = [(t.cache_hits, t.cache_misses, t.compiled) for t in tickets]
        if counts != timed[mode]["counts"] or \
                len(checked) != SHARDED_QUERIES + 3:
            fail(f"rank {me}: service {mode}: the checked serve's hits and "
                 f"misses differ from the timed serve's")
        lines.append(
            f"rank {me}: service {mode}: all {len(checked)} tickets (3 "
            f"warm-up) == their solo sharded runs (this rank's block words "
            f"and valid rows, global counts, FlatteningStats with the "
            f"exchanges', cohort words, flow, log), no block past its "
            f"capacity, hits and misses == the timed serve's")
        del svc, tickets
        gc.collect()
        torch.cuda.empty_cache()
    return dict(lines=lines, naive_wall=naive_wall, naive_lat=naive_lat,
                timed=timed, launches=timed["pipelined"]["launches"],
                seconds=time.perf_counter() - t_phase)


def sharded_rank(group, device, n_patients: int, star: dict,
                 cpu_patients: int, reps: int, rate: float) -> dict:
    """One rank of the sharded phase (run by ``distributed.launch.spawn``):
    the quickstart through ``Study.run(mesh=group)`` at ``n_patients``
    under the cuda engines (launch counts set to 0 just before, read just
    after: B5 once per exchange), a warm rerun, the torch engines (equal
    bit for bit), on rank 0 the single-card run of the same seed (equal as
    multisets) and B5's timing, then ``small_sharded`` of the
    ``cpu_patients`` star on the card (the parent holds it against the
    same ranks on the CPU).  Returns host data and its log lines."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import flattening as pfl
    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir
    from repro_torch.distributed import comm
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.study.executor import cohort_groups

    me = dist.get_rank(group)
    lines = []
    t0 = time.perf_counter()
    dcir = generate_dcir(SyntheticConfig(n_patients=n_patients, seed=0),
                         device=device)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    study = build_study(n_patients)
    rec = Recorder(pfl, "hash_partition",
                   lambda table, key, n, per, engine="torch": table.capacity)

    def run(study, tables, engine):
        comm.reset_stats()
        dist.barrier(group)
        t = time.perf_counter()
        res = study.run(dict(tables), engine=engine, predicate_engine=engine,
                        mesh=group, device=device)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t, dict(comm.stats)

    torch.cuda.reset_peak_memory_stats()
    if me == 0:
        rec.__enter__()
    try:
        reset_launch_counts()
        res, wall, staging = run(study, dcir, "cuda")
        launches = dict(launch_counts)
    finally:
        if me == 0:
            rec.__exit__()
    peak = torch.cuda.max_memory_allocated()
    res.assert_no_loss()
    # each rank holds its own block of every table output and nothing more
    caps, held = {}, {}
    for k, t in res.events.items():
        caps[k] = t.block.capacity
        held[k] = max(x.untyped_storage().nbytes() // x.element_size()
                      for x in (t.block.valid, *t.block.columns.values()))
        if held[k] > caps[k]:
            fail(f"rank {me}: {k} holds {held[k]} slots behind a block of "
                 f"{caps[k]}")
    block_counts = {k: int(t.block.count) for k, t in res.events.items()}
    global_counts = {k: t.count for k, t in res.events.items()}
    n_ex = sum(n.op == "exchange" for n in res.plan.nodes)
    ex_stats = [d for d in res.flatten_stats.values()
                if d["stage"].startswith("exchange")]
    if n_ex != 5 or launches["hash_partition_plan"] != n_ex:
        fail(f"rank {me}: {n_ex} exchanges, B5 launched "
             f"{launches['hash_partition_plan']} times")
    if any(d["overflow"] for d in ex_stats):
        fail(f"rank {me}: an exchange overflowed")
    for k in ("predicate_bitset", "filter_compact", "bitset_op"):
        if launches[k] <= 0:
            fail(f"rank {me}: kernel {k} was never launched")
    if launches["bitset_op"] != len(cohort_groups(res.plan)):
        fail(f"rank {me}: {launches['bitset_op']} B3 launches for "
             f"{len(cohort_groups(res.plan))} cohort expressions")
    final = res.cohorts["final"].subject_count()
    flow = res.flow.render()
    first = digest(res)
    del res                          # the next run needs the card's memory
    torch.cuda.empty_cache()
    rows = int(dcir["ER_PRS"].count)
    lines.append(
        f"rank {me}: generated DCIR ({rows} ER_PRS rows, {rows // SHARDS} "
        f"a shard) in {gen_s:.3f} s; cuda engines wall {wall:.3f} s (first "
        f"run), peak device memory {peak / 2**30:.3f} GiB (PR 14: 8.253 at "
        f"1,000,000 patients, every output gathered), {n_ex} exchanges, "
        f"output capacities a rank {caps} (the largest storage behind each "
        f"{held}), block counts {block_counts} of {global_counts}, launches "
        f"{launches}, collectives {staging['collectives']} "
        f"({staging['all_to_all']} all-to-all, {staging['all_reduce']} "
        f"sums, {staging['all_gather']} gathers; PR 14: 41), host staging "
        f"{staging['staged_bytes'] / 2**30:.3f} GiB (PR 14: 7.701) in "
        f"{staging['staging_s']:.3f} s")
    res, warm, staging2 = run(study, dcir, "cuda")
    compare_digests(first, digest(res), f"rank {me}: sharded cuda run vs "
                    f"rerun")
    del res
    torch.cuda.empty_cache()
    res, twall, _ = run(study, dcir, "torch")
    compare_digests(first, digest(res), f"rank {me}: sharded cuda vs torch "
                    f"engines")
    del res
    torch.cuda.empty_cache()
    # one more warm cuda run, traced on rank 0
    if me == 0:
        with profiled() as prof:
            res, pwall, _ = run(study, dcir, "cuda")
        lines += trace_report("sharded_rank0", prof, pwall * 1e6)
    else:
        res, _, _ = run(study, dcir, "cuda")
    del res
    torch.cuda.empty_cache()
    lines.append(
        f"rank {me}: cuda engines wall {warm:.3f} s (warm; host staging "
        f"{staging2['staging_s']:.3f} s), torch engines wall {twall:.3f} s; "
        f"cuda == torch engines (valid rows, words, counts, FlatteningStats, "
        f"cohorts, flow)")
    timing = None
    if me == 0:
        t = time.perf_counter()
        single = study.run(dict(dcir), engine="cuda", predicate_engine="cuda",
                           device=device)
        torch.cuda.synchronize()
        swall = time.perf_counter() - t
        single = digest(single)
        compare_multisets(first, single, "sharded vs single card")
        lines.append(
            f"rank {me}: single-card run {swall:.3f} s; sharded == single "
            f"card (event rows as multisets, cohort words, flow, join "
            f"FlatteningStats); final cohort {final} subjects\n" + flow)
        del single
        timing = time_partition(rec, reps, rate)
    del rec, first
    torch.cuda.empty_cache()
    dist.barrier(group)
    service = sharded_service(group, device, dcir, n_patients)
    lines += service.pop("lines")
    del dcir
    torch.cuda.empty_cache()
    dist.barrier(group)
    small = small_sharded(group, device, star, cpu_patients)
    return dict(lines=lines, launches=launches, wall=wall, warm=warm,
                staging=staging, staging_warm=staging2, timing=timing,
                small=small, peak=peak, caps=caps, service=service,
                block_counts=block_counts, global_counts=global_counts)


def sharded_phase(n_patients: int, cpu_patients: int, reps: int,
                  rate: float):
    """The quickstart sharded over SHARDS ranks of one gloo process group,
    all on the one card (``sharded_rank``); the ranks load the kernel
    library this process built.  Then ``small_sharded`` on the same number
    of CPU ranks, held against the card's.  Returns the launches summed
    over ranks and B5's timing on rank 0."""
    import torch

    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir
    from repro_torch.distributed import launch
    from repro_torch.interop import tables_to_numpy

    torch.cuda.empty_cache()
    star = tables_to_numpy(generate_dcir(
        SyntheticConfig(n_patients=cpu_patients, seed=0), device="cpu"))
    t0 = time.perf_counter()
    ranks = launch.spawn(sharded_rank, SHARDS,
                         (n_patients, star, cpu_patients, reps, rate),
                         device="cuda", timeout=SHARDED_TIMEOUT)
    log(f"sharded: {SHARDS} ranks on one card, quickstart at {n_patients} "
        f"patients, {time.perf_counter() - t0:.3f} s with the ranks' start")
    for r in ranks:
        for line in r["lines"]:
            log("sharded: " + line)
    # card against CPU: the same small runs on the same ranks on the CPU
    t0 = time.perf_counter()
    drugs = ranks[0]["small"][0][0]["events"]["drug_purchases"]
    cpu = launch.spawn(small_sharded, SHARDS, (star, cpu_patients, drugs),
                       device="cpu", timeout=SHARDED_TIMEOUT)
    for me, (r, c) in enumerate(zip(ranks, cpu)):
        card_b5 = r["small"][0][0]["launches"]["hash_partition_plan"]
        if card_b5 != 5 or c[0][0]["launches"]["hash_partition_plan"]:
            fail(f"rank {me}: B5 launched {card_b5} times in the small "
                 f"sharded run on the card (5 expected, none on the CPU)")
        if not same_host(comparable(r["small"]), comparable(c)):
            fail(f"rank {me}: sharded quickstart, distributed_flatten or "
                 f"exposures_sharded at {cpu_patients} patients differ "
                 f"between the card and the CPU")
    small = ranks[0]["small"]
    log(f"sharded: at {cpu_patients} patients the card equals the same "
        f"{SHARDS} ranks on the CPU bit for bit (quickstart: events, "
        f"cohorts, flow, FlatteningStats, log, plan; distributed_flatten "
        f"{small[1]['flat']['count']} rows; exposures_sharded "
        f"{small[2]['count']} rows; final cohort "
        f"{small[0][0]['cohorts']['final']['count']} subjects), "
        f"{time.perf_counter() - t0:.3f} s for the CPU ranks")
    for k, n in ranks[0]["global_counts"].items():
        if sum(r["block_counts"][k] for r in ranks) != n:
            fail(f"sharded: the blocks of {k} do not add up to its count")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    timing = ranks[0]["timing"]
    log(f"sharded: at {n_patients} patients per rank: output capacities "
        f"{[r['caps'] for r in ranks]}, peak device memory "
        f"{[round(r['peak'] / 2**30, 3) for r in ranks]} GiB, host staging "
        f"{[round(r['staging']['staged_bytes'] / 2**30, 3) for r in ranks]}"
        f" GiB (first), "
        f"{[round(r['staging_warm']['staged_bytes'] / 2**30, 3) for r in ranks]}"
        f" GiB (warm), collectives "
        f"{[r['staging']['collectives'] for r in ranks]}, warm wall "
        f"{[round(r['warm'], 3) for r in ranks]} s; PR 14 at 1,000,000: "
        f"96,000,000 slots, 8.253 GiB, 7.701 GiB, 41, 7.002 s")
    log(f"sharded: launches summed over ranks {launches}; wall per rank "
        f"{[round(r['wall'], 3) for r in ranks]} s (first), "
        f"{[round(r['warm'], 3) for r in ranks]} s (warm), host staging per "
        f"rank {[round(r['staging']['staging_s'], 3) for r in ranks]} s "
        f"(first), {[round(r['staging_warm']['staging_s'], 3) for r in ranks]}"
        f" s (warm)")
    log(f"timing: hash_partition_plan n={timing['n']} n_dest="
        f"{timing['n_dest']} kernel {timing['ms']:.4f} ms, plain "
        f"{timing['plain_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms; "
        f"hash_partition per_dest={timing['per_dest']}: torch route "
        f"(argsort) {timing['torch_route_ms']:.4f} ms, cuda route (B5) "
        f"{timing['cuda_route_ms']:.4f} ms")
    # phase 14: the sharded service, every rank the same decisions
    svc = [r["service"] for r in ranks]
    for me, v in enumerate(svc):
        if any(v["timed"][m][k] != svc[0]["timed"][m][k]
                for m in ("sync", "pipelined") for k in ("counts", "cache")):
            fail(f"sharded service: rank {me}'s hits, misses, evictions or "
                 f"bytes cached differ from rank 0's")
    sv_launches = {k: sum(v["launches"][k] for v in svc)
                   for k in svc[0]["launches"]}
    walls = {m: [round(v["timed"][m]["wall"], 6) for v in svc]
             for m in ("sync", "pipelined")}
    log(f"sharded service: {SHARDS} ranks, {SHARDED_QUERIES} queries at "
        f"{n_patients} patients: naive walls "
        f"{[round(v['naive_wall'], 6) for v in svc]} s, sync "
        f"{walls['sync']} s, pipelined {walls['pipelined']} s; hits, misses "
        f"and evictions equal on every rank and in both modes "
        f"({svc[0]['timed']['sync']['cache'][:3]}); peak device memory "
        f"sync {[round(v['timed']['sync']['peak'] / 2**30, 3) for v in svc]}"
        f" GiB, pipelined "
        f"{[round(v['timed']['pipelined']['peak'] / 2**30, 3) for v in svc]}"
        f" GiB; the phase {[round(v['seconds'], 3) for v in svc]} s a rank; "
        f"launches of the timed pipelined serve summed over ranks "
        f"{sv_launches}")
    return launches, timing, sv_launches


# ---------------------------------------------------------------------------
# phase 16: training (A9-train) and B6's backward
# ---------------------------------------------------------------------------
# B6's backward against its plain backward (dq, dk, dv): an absolute gate
# over the tensor's largest |value| (the forward's ATTN_TOL, read relative:
# dk and dv sum over up to thousands of rows and reach magnitudes of 10-100
# where the forward's outputs stay under 1), and the forward's per-row gate
# over max(the row's largest |value|, 1e-2 of the tensor's): a row whose
# terms cancel (dq of a row that sees one key is sum_j dS_ij k_j with dS ~ 0)
# holds only rounding noise, which the floor keeps from reading as 100 %.
BWD_ROW_FLOOR = 1e-2
# (B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len): the forward's
# sweep; every head dim with ragged Sq, Skv and kv_len and a window edge
# inside a tile; GQA 1, 2, 4 and 10; non-causal and cross-attention with
# Sq != Skv at q_offset 0; rows that see no key (kv_len 0, a negative
# offset); a key tile past kv_len; danube's shape at 1,100 tokens and MQA
# with window 2,048 at head dim 256 (recurrentgemma's)
BWD_CASES = (
    ATTN_SWEEP
    + [(1, 4, 2, 300, 333, D, True, 50, None, 317) for D in
       (16, 32, 64, 80, 96, 128, 240, 256)]
    + [(2, 4, 4, 130, 130, 64, True, 0, None, None),
       (1, 20, 2, 77, 77, 32, True, 30, None, None),
       (1, 10, 1, 200, 200, 256, True, 2048, None, None),
       (2, 16, 16, 300, 100, 64, False, 0, 0, None),
       (2, 16, 16, 70, 260, 64, False, 0, 0, 250),
       (2, 8, 2, 40, 64, 80, True, 0, -20, None),
       (1, 8, 4, 65, 65, 96, False, 16, 0, None),
       (3, 32, 8, 5, 33, 80, True, 0, -2, None),
       (1, 32, 8, 1100, 1100, 80, True, 300, None, None)])
BWD_LIBRARY_REPS = 5        # reps of the plain and SDPA backward (~0.25 s)
# h2o-danube-1.8b's training shape: 2 x 8,192 tokens, 32/8 heads of 80
BWD_DANUBE = (2, 32, 8, 8192, 8192, 80, True, 4096, None, None)
# recurrentgemma's attention at 1 x 4,096 tokens: MQA 10/1 of 256, window
# 2,048 (the backward's split-d path)
BWD_WIDE = (1, 10, 1, 4096, 4096, 256, True, 2048, None, None)
# each row's log-sum-exp from the forward kernels against the plain
# version's, over max(|plain|, 1): fp32 sums in another order, ex2.approx
LSE_TOL = 1e-5
# a row of dq, dk or dv that is exactly 0 in the plain backward (masked out,
# or every term cancels: dq of a row that sees one key has dS = dP - Delta
# = 0), over the tensor's largest |value|: both kernels sum dP and Delta in
# other orders than the plain backward and keep their rounding noise there
# (at most 3.5e-7 in fp32 and 2.7e-7 in bf16 over BWD_CASES on an H100)
BWD_ZERO_ROW_TOL = 1e-5


def check_grads(got, want, what: str):
    """(max abs error over the largest |value|, worst row error) of each of
    dq, dk, dv, the worst of the three; fails past ATTN_TOL or ATTN_ROW_TOL
    (per row over max(row's largest |value|, BWD_ROW_FLOOR of the
    tensor's))."""
    import torch

    err = row = 0.0
    dname = str(want[0].dtype).replace("torch.", "")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"flash_attention backward ({what}): {name} is "
                 f"{tuple(g.shape)} {g.dtype}, want {tuple(w.shape)} "
                 f"{w.dtype}")
        if not bool(torch.isfinite(g).all()):
            fail(f"flash_attention backward ({what}): {name} not finite")
        d = (g.float() - w.float()).abs().amax(dim=-1)
        s = w.float().abs().amax(dim=-1)
        top = float(s.max()) if s.numel() else 0.0
        if top == 0.0:
            if float(d.max() if d.numel() else 0.0) != 0.0:
                fail(f"flash_attention backward ({what}): {name} should be 0")
            continue
        err = max(err, float(d.max()) / top)
        row = max(row, float((d / s.clamp_min(BWD_ROW_FLOOR * top)).max()))
    if not (err <= ATTN_TOL[dname] and row <= ATTN_ROW_TOL[dname]):
        fail(f"flash_attention backward kernel != plain ({dname}, {what}): "
             f"max abs error over the largest |value| {err} (gate "
             f"{ATTN_TOL[dname]}), worst row error {row} (gate "
             f"{ATTN_ROW_TOL[dname]})")
    return err, row


def zero_rows(got, want, what: str) -> float:
    """The largest |value| of dq, dk, dv on the rows that are exactly 0 in
    the plain backward, over each tensor's largest |plain value|; fails past
    BWD_ZERO_ROW_TOL."""
    worst = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        zero = (w == 0).all(dim=-1)
        top = float(w.float().abs().max()) if w.numel() else 0.0
        if not bool(zero.any()) or top == 0.0:
            continue
        worst = max(worst, float(g[zero].float().abs().max()) / top)
    if worst > BWD_ZERO_ROW_TOL:
        fail(f"flash_attention backward ({want[0].dtype}, {what}): rows that "
             f"are 0 in the plain backward reach {worst} of the largest "
             f"|value| (gate {BWD_ZERO_ROW_TOL})")
    return worst


def check_bwd_tiles() -> None:
    """The Python twins of the bf16 backward's tile plan and of the fp32
    kernels' (the walks that the CPU tests hold against the mask) against
    the kernels' own, at every head dim."""
    from repro_torch.kernels import swa_attention as swa

    for D in swa.HEAD_DIMS:
        twin = swa.f32_backward_tiles(D) + swa.f32_forward_tiles(D)
        if swa.f32_kernel_tiles(D) != twin:
            fail(f"flash_attention fp32 D={D}: the kernels' tiles "
                 f"{swa.f32_kernel_tiles(D)}, the Python twins' {twin}")
        twin = (swa.BWD_DQ_ROWS, swa.backward_dq_keys(D),
                swa.backward_dkdv_keys(D), swa.backward_dkdv_rows(D))
        if swa.backward_kernel_tiles(D) != twin:
            fail(f"flash_attention backward D={D}: the kernel's tiles "
                 f"{swa.backward_kernel_tiles(D)}, the Python twins' {twin}")


def _bwd_inputs(case, dt, device, seed: int, transposed: bool):
    import torch

    B, Hq, Hkv, Sq, Skv, D = case[:6]
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(sh, generator=g, device=device).to(dt)
                   for sh in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                              (B, Hkv, Skv, D), (B, Hq, Sq, D)))
    if transposed:                     # the model's (B, S, H, D) views
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in (q, k, v))
    return q, k, v, do


def check_lse(got, want, what: str) -> float:
    """Worst |kernel - plain| log-sum-exp over max(|plain|, 1); fails past
    ``LSE_TOL`` (a row with no visible key is 0 in the plain LSE, so the
    kernel's must be within the gate of 0) or on a value that is not
    finite."""
    import torch

    d = (got - want).abs() / want.abs().clamp_min(1.0)
    err = float(d.max()) if d.numel() else 0.0
    if not err <= LSE_TOL or not bool(torch.isfinite(got).all()):
        fail(f"flash_attention forward's lse != plain ({what}): relative "
             f"error {err} (gate {LSE_TOL})")
    return err


def backward_battery(device) -> dict:
    """B6's backward kernel against its plain backward on the card over
    ``BWD_CASES`` in fp32 and bf16 (odd cases through transposed views, as
    the model passes them), each fed the forward kernel's output and
    log-sum-exp (the forward is asked for one: a call of at most
    ``DECODE_ROWS`` rows a KV head takes the decode route, whose combine
    kernel writes the LSE, every other the prefill kernels; its output is
    checked against the plain forward's with the forward's gates, and its
    LSE against the plain LSE); the bf16 backward twice at one shape, bit
    for bit; then ``torch.autograd.grad`` through ``FlashAttention`` against autograd
    through the plain forward (fp32, the cases where every row sees a key:
    there autograd's 0/0 gives NaN)."""
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import swa_attention as swa

    check_bwd_tiles()
    worst = {}
    dims = set()
    lse_worst = {}
    zero_worst = {}
    decode_sized = 0             # cases the decode route takes, with the LSE
    for i, case in enumerate(BWD_CASES):
        errs = []
        decode = case[1] // case[2] * case[3] <= swa.DECODE_ROWS
        decode_sized += int(decode)
        for dname in ATTN_TOL:
            dt = getattr(torch, dname)
            q, k, v, do = _bwd_inputs(case, dt, device, 1000 + i, i % 2 == 1)
            kw = _attn_kwargs(case)
            lse = torch.empty(q.shape[:3], dtype=torch.float32, device=device)
            before = dict(launch_counts)
            o = swa.flash_swa_attention(q, k, v, lse=lse, **kw)
            if launch_counts["flash_decode"] != before["flash_decode"] \
                    + int(decode):
                fail(f"flash_attention {case}: asked for an lse, it took "
                     f"the {'prefill kernels' if decode else 'decode route'}")
            po, plse = swa.flash_swa_attention_plain(q, k, v, return_lse=True,
                                                     **kw)
            check_attention(o, po, f"{case} with lse")
            lse_worst[dname] = max(lse_worst.get(dname, 0.0),
                                   check_lse(lse, plse, f"{dname} {case}"))
            got = swa.flash_swa_attention_backward(q, k, v, o, do, lse=lse,
                                                   **kw)
            if launch_counts["flash_attention_bwd"] \
                    != before["flash_attention_bwd"] + 1:
                fail(f"flash_attention backward {case}: no launch counted")
            want = swa.flash_swa_attention_backward_plain(q, k, v, o, do,
                                                          **kw)
            err = check_grads(got, want, str(case))
            zero_worst[dname] = max(zero_worst.get(dname, 0.0),
                                    zero_rows(got, want, str(case)))
            w = worst.get(dname, (0.0, 0.0))
            worst[dname] = (max(w[0], err[0]), max(w[1], err[1]))
            errs.append(f"{dname} {err[0]:.3g} / {err[1]:.3g}")
            dims.add(case[5])
            del q, k, v, do, o, got, want, po, plse, lse
        log(f"attention backward: {case}: max abs / worst row error "
            f"{', '.join(errs)}")
    if dims != set(swa.HEAD_DIMS):
        fail(f"attention backward: head dims {sorted(dims)} checked, not "
             f"every one")
    if not decode_sized:
        fail("attention backward: no case took the decode route with the "
             "LSE")
    # no atomics: a rerun gives the same bits, in both types
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = _bwd_inputs(BWD_CASES[-1], dt, device, 5, True)
        kw = _attn_kwargs(BWD_CASES[-1])
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=device)
        o = swa.flash_swa_attention(q, k, v, lse=lse, **kw)
        runs = [swa.flash_swa_attention_backward(q, k, v, o, do, lse=lse,
                                                 **kw) for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            fail(f"flash_attention backward ({dt}, {BWD_CASES[-1]}): two "
                 f"runs differ")
        del q, k, v, do, o, runs, lse
    auto = 0.0
    for i, case in enumerate(BWD_CASES):
        B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len = case
        kv = Skv if kv_len is None else kv_len
        off = kv - Sq if q_offset is None else q_offset
        # every row must see a key (a window only hides keys behind one
        # that the causal mask keeps: the row's own position)
        if kv == 0 or (causal and (off < 0 or off >= kv)):
            continue
        q, k, v, do = _bwd_inputs(case, torch.float32, device, 2000 + i,
                                  i % 2 == 1)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        kw = _attn_kwargs(case)
        out = swa.FlashAttention.apply(*leaves, causal, window, q_offset,
                                       kv_len)
        got = torch.autograd.grad(out, leaves, do)
        plain = swa.flash_swa_attention_plain(*leaves, **kw)
        want = torch.autograd.grad(plain, leaves, do)
        auto = max(auto, check_grads(got, want, f"autograd {case}")[0])
        del q, k, v, do, leaves, out, got, plain, want
    log(f"attention backward: {2 * len(BWD_CASES)} kernel-vs-plain checks, "
        f"each on the forward kernel's output and log-sum-exp, max abs (over "
        f"the largest |value|) / worst row error fp32 "
        f"{worst['float32'][0]} / {worst['float32'][1]} (gates "
        f"{ATTN_TOL['float32']} / {ATTN_ROW_TOL['float32']}), bf16 "
        f"{worst['bfloat16'][0]} / {worst['bfloat16'][1]} (gates "
        f"{ATTN_TOL['bfloat16']} / {ATTN_ROW_TOL['bfloat16']}); the "
        f"forward's lse against the plain lse, worst relative error "
        f"{json.dumps(lse_worst)} (gate {LSE_TOL}; {decode_sized} of "
        f"{len(BWD_CASES)} cases on the decode route); rows 0 in the "
        f"plain backward, largest |value| over the tensor's "
        f"{json.dumps(zero_worst)} (gate {BWD_ZERO_ROW_TOL}); "
        f"the bf16 and fp32 tile plans' Python twins equal the kernels'; the "
        f"bf16 and fp32 backward twice, bit for bit; autograd through "
        f"FlashAttention vs "
        f"through the plain forward (fp32): max {auto}")
    worst["lse"] = lse_worst
    worst["zero_rows"] = zero_worst
    return worst


def time_attention_backward(label, q, k, v, kw, reps, rate) -> dict:
    """B6's backward at one shape: the kernel (checked against the plain
    backward first), the plain backward, and the backward of torch's
    scaled_dot_product_attention with an explicit boolean mask (K/V repeated
    over the group, contiguous copies; its forward runs once, outside the
    timed window; a yardstick only), each the middle of ``TIMING_CALLS``
    medians (the plain backward and the yardstick: of ``BWD_LIBRARY_REPS``
    reps), with their min-max;
    the forward kernel's time at the same shape (writing the log-sum-exp,
    as the training forward does) beside them."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import swa_attention as swa

    g = torch.Generator(device=q.device).manual_seed(7)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    o = swa.flash_swa_attention(q, k, v, lse=lse, **kw)
    do = torch.randn(o.shape, generator=g, device=q.device).to(q.dtype)
    kern = lambda: swa.flash_swa_attention_backward(  # noqa: E731
        q, k, v, o, do, lse=lse, **kw)
    plain = lambda: swa.flash_swa_attention_backward_plain(  # noqa: E731
        q, k, v, o, do, **kw)
    err, row = check_grads(kern(), plain(), label)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kv_len = Skv if kw["kv_len"] is None else kw["kv_len"]
    q_off = kv_len - Sq if kw["q_offset"] is None else kw["q_offset"]
    qpos = q_off + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = (kpos < kv_len).expand(Sq, Skv)
    if kw["causal"]:
        mask = mask & (kpos <= qpos)
    if kw["window"] > 0:
        mask = mask & (kpos > qpos - kw["window"])
    leaves = [q.detach().contiguous().requires_grad_(True)] + [
        x.detach().repeat_interleave(Hq // Hkv, dim=1).contiguous()
        .requires_grad_(True) for x in (k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                             scale=D ** -0.5)
    lib = lambda: torch.autograd.grad(  # noqa: E731
        lib_out, leaves, do, retain_graph=True)
    bound_ms, bound_by, pairs = attention_bound(q, k, kw, rate, 10, 4, 4)
    out = dict(shape=(B, Hq, Hkv, Sq, Skv, D), kv_len=kv_len, pairs=pairs,
               bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
               row_err=row)
    fwd = lambda: swa.flash_swa_attention(q, k, v, lse=lse, **kw)  # noqa: E731
    for key, fn, n in (("ms", kern, reps),
                       ("plain_ms", plain, BWD_LIBRARY_REPS),
                       ("library_ms", lib, BWD_LIBRARY_REPS),
                       ("forward_ms", fwd, reps)):
        out[key], lo, hi = spread_ms(fn, n)
        out[key + "_range"] = (lo, hi)
    log(f"timing: flash_attention backward {label} {out['shape']} kv_len "
        f"{kv_len} {q.dtype} causal {kw['causal']} window {kw['window']} "
        f"({pairs} visible pairs x heads); middle of {TIMING_CALLS} medians "
        f"[min-max of the medians]: kernel {out['ms']:.4f} ms "
        f"[{out['ms_range'][0]:.4f}-{out['ms_range'][1]:.4f}] ({reps} reps),"
        f" plain {out['plain_ms']:.4f} ms [{out['plain_ms_range'][0]:.4f}-"
        f"{out['plain_ms_range'][1]:.4f}] ({BWD_LIBRARY_REPS} reps), "
        f"sdpa+mask backward "
        f"{out['library_ms']:.4f} ms [{out['library_ms_range'][0]:.4f}-"
        f"{out['library_ms_range'][1]:.4f}] ({BWD_LIBRARY_REPS} reps), "
        f"bound {bound_ms:.4f} ms ({bound_by}, 10 D flops a pair; "
        f"{100 * bound_ms / out['ms']:.1f} % reached); the forward kernel "
        f"(writing the lse) "
        f"{out['forward_ms']:.4f} ms [{out['forward_ms_range'][0]:.4f}-"
        f"{out['forward_ms_range'][1]:.4f}]; kernel-vs-plain max abs error "
        f"over the largest |value| {err}, worst row error {row}")
    return out


TRAIN_STEPS = 4            # full-width danube, 2 x 8,192 tokens a step
TRAIN_BATCH, TRAIN_SEQ = 2, 8192
ENGINE_LAYERS = 2          # the engines' comparison depth at full width
TRAIN_ENGINE_GATE = {"loss": 1e-5, "grad": 1e-3}   # fp32, cuda vs torch
TRAIN_CPU_ARCHS = ("h2o-danube-1.8b", "deepseek-moe-16b",
                   "seamless-m4t-medium")
TRAIN_CPU_STEPS = 3
TRAIN_CPU_GATE = 1e-5      # losses, gradients (relative), master, fp32
ADAM_FLOOR = 1e-4          # gradients under this of their leaf's largest
TRAIN_OPT = dict(lr_peak=1e-3, warmup_steps=20)    # the launcher's
RESTART_ARCH = "xlstm-125m"   # the reference's restart test's model


def _finite_nonzero(grads, what: str) -> int:
    """Fails unless every gradient leaf is finite and nonzero somewhere (a
    cut graph leaves a parameter with no gradient: zeros); the count."""
    import torch

    from repro_torch.train.optimizer import tree_leaves

    leaves = tree_leaves(grads)
    for i, g in enumerate(leaves):
        if not bool(torch.isfinite(g).all()):
            fail(f"{what}: gradient leaf {i} {tuple(g.shape)} not finite")
        if not bool(g.any()):
            fail(f"{what}: gradient leaf {i} {tuple(g.shape)} is all zero")
    return len(leaves)


def _device_split(trace_path, prefix: str) -> dict:
    """Device time (ms) of the kernels, copies and fills inside each device
    range (``gpu_user_annotation``) whose name starts with ``prefix``, and
    of all of them (``device_busy``)."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "gpu_user_annotation"
              and e["name"].startswith(prefix)}
    split = {k: 0.0 for k in ranges}
    split["device_busy"] = 0.0
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            split["device_busy"] += e["dur"] / 1e3
            for k, (lo, hi) in ranges.items():
                if lo <= e["ts"] <= hi:
                    split[k] += e["dur"] / 1e3
    return split


def train_full_width() -> tuple:
    """h2o-danube-1.8b at full width through ``launch.train.train`` from
    the claims stream: launches, every gradient, the warm step's wall,
    tokens/s and peak memory, and one traced step."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import claims_token_stream, train
    from repro_torch.models import get_bundle
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.train_step import loss_and_grads

    bundle = get_bundle(DANUBE)
    cfg = bundle.cfg
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = train(DANUBE, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, reduced=False, device="cuda", log_every=1)
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    if len(losses) != TRAIN_STEPS or not all(
            x == x and abs(x) < float("inf") for x in losses):
        fail(f"training: losses {losses}")
    n_attn = cfg.n_layers
    want = {"flash_attention": 2 * n_attn * TRAIN_STEPS,    # remat: twice
            "flash_attention_bwd": n_attn * TRAIN_STEPS, "flash_decode": 0}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"training: B6 launches {got}, want {want} ({TRAIN_STEPS} "
             f"steps, remat on)")
    state = out["state"]
    # one more batch of the stream: every parameter must get a gradient
    stream = claims_token_stream(TRAIN_SEQ, TRAIN_BATCH, cfg.vocab_size, 0,
                                 device="cuda")
    for _ in range(TRAIN_STEPS):
        next(stream)
    batch = next(stream)
    before = dict(launch_counts)
    loss, grads = loss_and_grads(bundle, state["params"], batch)
    n_leaves = _finite_nonzero(grads, "training (full width)")
    if launch_counts["flash_attention_bwd"] - before["flash_attention_bwd"] \
            != n_attn:
        fail("training: the gradient pass did not launch B6's backward once "
             "a layer")
    del grads
    valid = float(batch["loss_mask"].sum())
    step_fn = make_train_step(bundle, AdamWConfig(total_steps=TRAIN_STEPS
                                                  + 2, **TRAIN_OPT))
    torch.cuda.synchronize()
    with profiled() as prof:
        t1 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        traced_us = (time.perf_counter() - t1) * 1e6
    lines = trace_report("train_step", prof, traced_us)
    for line in lines:
        log(line)
    split = _device_split(REPO / "chiprun_out" / "train_step_trace.json",
                          "train_step.")
    # autograd launches the backward's kernels from its own thread, outside
    # the host range: the backward is what the forward and optimizer leave
    split["train_step.backward"] = split["device_busy"] - split.get(
        "train_step.forward", 0.0) - split.get("train_step.optimizer", 0.0)
    warm = out["step_times"][-1]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    info = dict(losses=losses, step_s=out["step_times"], warm_step_s=warm,
                tokens_per_s=tokens / warm, peak_gib=peak / 2 ** 30,
                launcher_wall_s=wall, grad_leaves=n_leaves,
                loss_tokens=valid, split_ms=split,
                traced_step_ms=traced_us / 1e3, idle=lines[0])
    log(f"training: {DANUBE} at full width ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim_}, window {cfg.window}, bf16, remat) from the claims "
        f"stream, {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
        f"({valid:.0f} of {tokens} tokens in the loss mask of the checked "
        f"batch): losses {losses}, step walls {out['step_times']} s; warm "
        f"step {warm:.3f} s = {tokens / warm:.1f} tokens/s; peak device "
        f"memory {peak / 2 ** 30:.2f} GiB; launcher wall {wall:.3f} s "
        f"(stream build included); B6 launches {got}; {n_leaves} gradient "
        f"leaves all finite and nonzero; traced step {traced_us / 1e3:.3f} "
        f"ms, device time by part {json.dumps(split)}")
    del state, out, batch, stream
    gc.collect()
    torch.cuda.empty_cache()
    return launches, info


def train_engines(batch) -> dict:
    """danube at full width cut to ``ENGINE_LAYERS`` layers: the cuda
    engine against the torch engine in fp32 (loss, every gradient leaf),
    then in bf16 against the fp32 loss (``bf16_gate``)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.interop import tree_map
    from repro_torch.models.registry import ModelBundle
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import loss_and_grads

    cfg = dataclasses.replace(get_config(DANUBE), n_layers=ENGINE_LAYERS,
                              dtype="float32")
    b = ModelBundle(cfg)
    params = b.init(2, device="cuda")
    res = {}
    for engine in ("cuda", "torch"):
        t0 = time.perf_counter()
        res[engine] = loss_and_grads(b, params, batch, engine)
        torch.cuda.synchronize()
        log(f"training: engines, fp32 {engine}: loss "
            f"{float(res[engine][0])}, loss and gradients in "
            f"{time.perf_counter() - t0:.3f} s")
    lc, lt = float(res["cuda"][0]), float(res["torch"][0])
    loss_err = abs(lc - lt) / abs(lt)
    grad_err = 0.0
    for gc_, gt in zip(tree_leaves(res["cuda"][1]),
                       tree_leaves(res["torch"][1])):
        top = max(float(gt.abs().max()), 1e-30)
        grad_err = max(grad_err, float((gc_ - gt).abs().max()) / top)
    _finite_nonzero(res["cuda"][1], "training engines (cuda, fp32)")
    del res
    if not (loss_err <= TRAIN_ENGINE_GATE["loss"]
            and grad_err <= TRAIN_ENGINE_GATE["grad"]):
        fail(f"training engines (fp32, {ENGINE_LAYERS} layers at full "
             f"width): loss relative error {loss_err} (gate "
             f"{TRAIN_ENGINE_GATE['loss']}), worst gradient leaf error over "
             f"its largest |value| {grad_err} (gate "
             f"{TRAIN_ENGINE_GATE['grad']})")
    b16 = ModelBundle(dataclasses.replace(cfg, dtype="bfloat16"))
    p16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    l16 = {e: float(loss_and_grads(b16, p16, batch, e)[0])
           for e in ("cuda", "torch")}
    d_torch, d_cuda = abs(l16["torch"] - lt), abs(l16["cuda"] - lt)
    gate = bf16_gate(d_torch, abs(lt))
    if not d_cuda <= gate:
        fail(f"training engines (bf16): the cuda engine's loss {l16['cuda']}"
             f" is {d_cuda} from the fp32 loss {lt}, past {gate} (the torch "
             f"engine's {d_torch})")
    out = dict(fp32_loss_rel=loss_err, fp32_grad_rel=grad_err,
               bf16_cuda_vs_fp32=d_cuda, bf16_torch_vs_fp32=d_torch,
               bf16_gate=gate, loss_fp32=lt)
    log(f"training: engines at full width, {ENGINE_LAYERS} layers, "
        f"{tuple(batch['tokens'].shape)} tokens: {json.dumps(out)} (gates "
        f"{json.dumps(TRAIN_ENGINE_GATE)}, bf16_gate)")
    return out


def train_card_vs_cpu() -> dict:
    """Reduced danube, deepseek-moe and seamless in fp32 end to end
    (``param_dtype`` fp32: at the default bf16 cast, ROADMAP C16, the second
    step's forward runs in bf16, where the card's and the CPU's roundings
    differ), ``TRAIN_CPU_STEPS`` steps under the cuda engine on the card
    and on the CPU (B6's plain versions) from the same weights: every
    step's loss, the first step's gradients (of each leaf's largest
    |value|; later ones are printed) and the master weights after the last
    step within ``TRAIN_CPU_GATE``.
    The master gate skips the elements whose CPU gradient was nonzero but
    under ``ADAM_FLOOR`` of its leaf's largest at some step: Adam divides
    each step by the gradient's own size, so there the devices' fp32
    rounding (~1e-6 of the largest) moves the weight by up to 2 lr; they
    are counted, and their gradients are held by the gradient gate.  Then
    the reference's restart test on the card: reduced xlstm, 6 steps
    against 3 + save + restore + 3, bit for bit."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.interop import tree_map
    from repro_torch.models import get_bundle
    from repro_torch.models.registry import ModelBundle
    from repro_torch.train import (AdamWConfig, adamw_init,
                                   init_train_state, make_train_step,
                                   restore_checkpoint, save_checkpoint)
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import loss_and_grads

    out = {}
    for arch in TRAIN_CPU_ARCHS:
        b = ModelBundle(dataclasses.replace(get_bundle(arch, reduced=True).cfg,
                                            dtype="float32"))
        rng = np.random.default_rng(6)
        batches = []
        for _ in range(TRAIN_CPU_STEPS):
            bt = family_batch(b.cfg, 2, 64, rng, "cpu")
            batches.append({k: v if k == "tokens" else v.float()
                            for k, v in bt.items()})
        runs = {}
        for name, dev in (("cpu", "cpu"), ("card", "cuda")):
            params = tree_map(lambda t: t.to(dev), b.init(0, device="cpu"))
            state = {"params": params, "opt": adamw_init(params)}
            step = make_train_step(b, AdamWConfig(total_steps=10,
                                                  **TRAIN_OPT),
                                   engine="cuda", param_dtype=torch.float32)
            losses, grads = [], []
            for bt in batches:
                bt = {k: v.to(dev) for k, v in bt.items()}
                grads.append([g.cpu() for g in tree_leaves(
                    loss_and_grads(b, state["params"], bt, "cuda")[1])])
                state, m = step(state, bt)
                losses.append(float(m["loss"]))
            runs[name] = (losses, grads, [x.cpu() for x in tree_leaves(
                state["opt"]["master"])])
        (lc, gc_, mc), (lg, gg, mg) = runs["cpu"], runs["card"]
        loss_err = max(abs(a - c) / abs(c) for a, c in zip(lg, lc))
        rel = [max(float((a - c).abs().max())
                   / max(float(c.abs().max()), 1e-30)
                   for a, c in zip(ga, gc1)) for ga, gc1 in zip(gg, gc_)]
        grad_err = rel[0]       # later steps start from unequal masters
        master_err, skipped = 0.0, 0
        for i, (a, c) in enumerate(zip(mg, mc)):
            ill = torch.zeros(c.shape, dtype=torch.bool)
            for g in (step_g[i] for step_g in gc_):
                ill |= (g != 0) & (g.abs() < ADAM_FLOOR * g.abs().max())
            skipped += int(ill.sum())
            d = (a - c).abs()[~ill]
            master_err = max(master_err, float(d.max()) if d.numel() else 0.0)
        n = sum(x.numel() for x in mc)
        out[arch] = dict(loss_rel=loss_err, grad_rel=rel,
                         master_abs=master_err, master_skipped=skipped,
                         master_elements=n, losses=lg)
        if not (loss_err <= TRAIN_CPU_GATE and grad_err <= TRAIN_CPU_GATE
                and master_err <= TRAIN_CPU_GATE):
            fail(f"training card vs CPU ({arch}, fp32, {TRAIN_CPU_STEPS} "
                 f"steps): loss relative error {loss_err}, gradient error "
                 f"{grad_err}, master error {master_err} over {n - skipped} "
                 f"of {n} elements (gate {TRAIN_CPU_GATE})")
    b = get_bundle(RESTART_ARCH, reduced=True)
    step = make_train_step(b, AdamWConfig(lr_peak=1e-3, warmup_steps=2,
                                          total_steps=10))
    rng = np.random.default_rng(100)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        3, b.cfg.vocab_size, (4, 32)).astype(np.int32)).cuda()}
        for _ in range(6)]
    state_a = init_train_state(b, 0, "cuda")
    for bt in batches:
        state_a, _ = step(state_a, bt)
    state_b = init_train_state(b, 0, "cuda")
    for bt in batches[:3]:
        state_b, _ = step(state_b, bt)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, 3, state_b, meta={"arch": RESTART_ARCH})
        state_b, _ = restore_checkpoint(tmp, 3, state_b, device="cuda")
    for bt in batches[3:]:
        state_b, _ = step(state_b, bt)
    la, lb = tree_leaves(state_a), tree_leaves(state_b)
    if len(la) != len(lb) or not all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb)):
        fail(f"training restart ({RESTART_ARCH} on the card): 3 + restore "
             f"+ 3 steps differ from 6")
    out["restart"] = f"{RESTART_ARCH}: {len(la)} leaves bit for bit"
    log(f"training: card vs CPU (fp32, {TRAIN_CPU_STEPS} steps, gate "
        f"{TRAIN_CPU_GATE}) and restart: {json.dumps(out)}")
    return out


def training_phase(reps: int, rate: float):
    """Phase 16: B6's backward battery, full-width danube training from the
    claims stream, the engines, card against CPU, the restart, and B6's
    backward timed at danube's training shape and at recurrentgemma's
    (head dim 256).  Returns the launches of
    the training run, the backward's timing record and a summary."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import claims_token_stream

    worst = backward_battery(torch.device("cuda"))
    launches, info = train_full_width()
    stream = claims_token_stream(TRAIN_SEQ, TRAIN_BATCH,
                                 get_config(DANUBE).vocab_size, 0,
                                 device="cuda")
    engines = train_engines(next(stream))
    del stream
    gc.collect()
    torch.cuda.empty_cache()
    cpu = train_card_vs_cpu()
    q, k, v, _ = _bwd_inputs(BWD_DANUBE, torch.bfloat16,
                             torch.device("cuda"), 3, True)
    timing = time_attention_backward("danube training", q, k, v,
                                     _attn_kwargs(BWD_DANUBE), reps, rate)
    # the fp32 kernels (csrc/swa_attention.cu's flash_f32 writing the LSE,
    # csrc/swa_backward.cu; CUDA cores) at the same shape: what the fp32
    # gates of phases 15-17 and fp32 training run
    q, k, v, _ = _bwd_inputs(BWD_DANUBE, torch.float32, torch.device("cuda"),
                             3, True)
    fwd32 = time_attention("danube training, fp32", q, k, v,
                           _attn_kwargs(BWD_DANUBE), BWD_LIBRARY_REPS, rate,
                           lse=True)
    fp32 = time_attention_backward("danube training, fp32", q, k, v,
                                   _attn_kwargs(BWD_DANUBE),
                                   BWD_LIBRARY_REPS, rate)
    q, k, v, _ = _bwd_inputs(BWD_WIDE, torch.bfloat16, torch.device("cuda"),
                             4, True)
    wide = time_attention_backward("recurrentgemma, head dim 256", q, k, v,
                                   _attn_kwargs(BWD_WIDE), reps, rate)
    del q, k, v
    torch.cuda.empty_cache()
    return launches, timing, dict(run=info, engines=engines, card_vs_cpu=cpu,
                                  battery=worst, backward_d256=wide,
                                  backward_fp32=fp32, forward_fp32=fwd32)


# ---------------------------------------------------------------------------
# phase 17: sharded models (A9-shard)
# ---------------------------------------------------------------------------
SHARD_MOE = "deepseek-moe-16b"
SHARD_PREFILL = 4096         # phase 15's prefill: 1 x 4,096, its tokens
SHARD_FP32_LAYERS = 2        # the fp32 gates' depth, at full width
SHARD_PREFILL_GATE = 1e-3    # fp32 logits, sharded vs one rank
SHARD_TRAIN_STEPS = 3
SHARD_TRAIN_GATE = {"loss": 1e-5, "grad": 1e-3}    # fp32, vs one rank
PIPE_MICRO, PIPE_SEQ = 4, 2048
PIPE_GATE = 1e-4             # pipelined vs sequential, fp32
SHARD_MODELS_TIMEOUT = 900.0
FAMILY_REF = {}              # phase 15's logits and bf16 gates, by arch
# part (d): the families whose TP layouts came last, each on these meshes;
# at (1, 4) recurrentgemma's 10 heads do not divide and its attention runs
# whole on every rank, at (2, 2) they split 5 a rank
SHARD_FAMILIES = {"recurrentgemma-2b": ((1, 4), (2, 2)),
                  "xlstm-125m": ((1, 4),),
                  "seamless-m4t-medium": ((1, 4),),
                  "phi-3-vision-4.2b": ((1, 4),)}
# the depth of each family's fp32 check in part (d): a period of every
# layer kind (recurrentgemma's attention is its third layer; the
# encoder-decoder keeps as many encoder layers)
SHARD_FAMILY_FP32 = {"recurrentgemma-2b": 3, "xlstm-125m": 2,
                     "seamless-m4t-medium": 2, "phi-3-vision-4.2b": 2}
# part (e): recurrentgemma-2b cut to two periods and the tail (8 of 26
# layers), 2 x 4,096 claims tokens a step; its fp32 check at one period (3
# layers: two RG-LRU and the attention) on 2 x 1,024 of them
SHARD_RG = "recurrentgemma-2b"
SHARD_RG_LAYERS, SHARD_RG_SEQ = 8, 4096
SHARD_RG_FP32 = (3, 1024)
POD_MESH = (2, 1, 2)         # part (f): (pod, data, model)
POD_FLIP_SHARE = 1e-2        # elements whose int8 bin may differ
POD_GRID = 1e-3              # of a bin: a step's gradient on its int8 grid
PARTS = ("prefill", "train", "pipe", "families", "rg_train", "pod",
         "decode")


def _part_stats(t0: float, launches=None, call=None) -> dict:
    """A part's wall from ``t0``, this rank's peak device memory (GiB) and
    the collectives and staging since ``comm.reset_stats``; ``call``: the
    part's call that part (h) dry-runs (``_call_start``), whose peak
    counts."""
    import torch

    from repro_torch.distributed import comm

    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = max(torch.cuda.max_memory_allocated(),
               call["part_peak"] if call else 0)
    out = dict(wall_s=wall, peak_gib=peak / 2 ** 30, comm=dict(comm.stats),
               staging_share=comm.stats["staging_s"] / wall)
    if launches is not None:
        out["launches"] = launches
    return out


def _part_start() -> float:
    import torch

    from repro_torch.distributed import comm

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    comm.reset_stats()
    return time.perf_counter()


def _call_start() -> dict:
    """Before the one call of a part that part (h) dry-runs: the
    collectives so far and the part's device peak so far; the device's
    peak counts from here."""
    import torch

    from repro_torch.distributed import comm

    torch.cuda.synchronize()
    out = dict(comm=dict(comm.stats),
               part_peak=torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    return out


def _call_end(start: dict, argument_bytes: int) -> dict:
    """After that call: its collectives by kind (count and bytes, as the
    dry run counts them), ``argument_bytes`` (the bytes of all the inputs
    the rank holds for the call, ``dryrun.tree_bytes`` of them before it;
    ``dryrun_phase`` says why not only those it reads), its device peak
    and the part's peak before it."""
    import torch

    from repro_torch.distributed import comm
    from repro_torch.launch.dryrun import collective_counts

    torch.cuda.synchronize()
    return dict(collectives=collective_counts(
        {k: v - start["comm"][k] for k, v in comm.stats.items()}),
        argument_bytes=argument_bytes,
        peak_bytes=torch.cuda.max_memory_allocated(),
        part_peak=start["part_peak"])


def _grad_err(got, want) -> float:
    """The worst gradient leaf's max |difference| over its largest |value|
    (``want``'s)."""
    from repro_torch.train.optimizer import tree_leaves

    err = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        top = max(float(b.abs().max()), 1e-30)
        err = max(err, float((a.float() - b.float()).abs().max()) / top)
    return err


def shard_prefill(group, device, twin_layers: int) -> dict:
    """Part (a): deepseek-moe-16b at full width and depth, bf16, on a
    (1, 4) mesh, each rank's blocks drawn leaf by leaf from phase 15's
    seed: the 1 x 4,096 prefill of phase 15's tokens (B6 once a layer on
    every rank), the same at phase 15's twin depth, then the model cut to
    ``SHARD_FP32_LAYERS`` in fp32 (rank 0 also runs it on one rank)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import hints, launch as dl
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models import get_bundle
    from repro_torch.models.registry import ModelBundle
    from repro_torch.train.optimizer import tree_leaves

    rank = dist.get_rank(group)
    mesh = dl.make_mesh(group, (1, 4))
    cfg = get_bundle(SHARD_MOE).cfg
    bundle = ModelBundle(cfg)
    batch = family_batch(cfg, 1, SHARD_PREFILL, np.random.default_rng(11),
                         device)
    t0 = _part_start()
    params = bundle.init(0, device, mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = sum(t.numel() for t in tree_leaves(params))
    with hints.use_mesh(mesh), torch.no_grad():
        reset_launch_counts()
        call = _call_start()
        t1 = time.perf_counter()
        logits = bundle.prefill(params, batch, engine="cuda")
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        call = _call_end(call, tree_bytes((params, batch)))
        launches = dict(launch_counts)
        out = _part_stats(t0, launches, call)
        twin = ModelBundle(dataclasses.replace(cfg, n_layers=twin_layers))
        cut = twin.prefill(dict(params, layers=params["layers"][
            :twin.cfg.n_layers]), batch, engine="cuda")
    del params
    torch.cuda.empty_cache()
    b32 = ModelBundle(dataclasses.replace(cfg, n_layers=SHARD_FP32_LAYERS,
                                          dtype="float32"))
    p32 = b32.init(0, device, mesh)
    with hints.use_mesh(mesh), torch.no_grad():
        l32 = b32.prefill(p32, batch, engine="cuda")
    del p32
    out.update(init_s=init_s, prefill_s=prefill_s, params_held=held,
               call=call)
    if rank == 0:
        single = b32.init(0, device)
        with torch.no_grad():
            ref = b32.prefill(single, batch, engine="cuda")
        del single
        out.update(logits=logits.float().cpu().numpy(),
                   cut=cut.float().cpu().numpy(),
                   fp32_err=float((l32 - ref).abs().max()),
                   fp32_max_logit=float(ref.abs().max()),
                   finite=bool(torch.isfinite(logits).all()))
    torch.cuda.empty_cache()
    return out


def shard_train(group, device, arch: str = DANUBE, layers=None,
                seq: int = TRAIN_SEQ,
                fp32=(SHARD_FP32_LAYERS, None)) -> dict:
    """Parts (b) and (e): ``arch`` at full width (depth cut to ``layers``
    where given), bf16, remat, on a (2, 2) mesh with ZeRO-1, phase 16's
    seed and claims stream (2 x ``seq`` tokens, a sequence a data rank),
    ``SHARD_TRAIN_STEPS`` steps; then cut to ``fp32`` = (layers, tokens a
    sequence or None for all) in fp32, the loss and gathered gradients
    (rank 0 also on one rank, as phase 16's engines check)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import hints, launch as dl, sharding
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.train import claims_token_stream
    from repro_torch.models.registry import ModelBundle
    from repro_torch.train import AdamWConfig, init_train_state, \
        make_train_step
    from repro_torch.train.train_step import loss_and_grads

    rank = dist.get_rank(group)
    mesh = dl.make_mesh(group, (2, 2))
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    bundle = ModelBundle(cfg)
    specs = sharding.batch_shardings(cfg, mesh, {"tokens": (TRAIN_BATCH,
                                                            seq)})

    def mine(b):
        return {k: sharding.own_block(v, specs["tokens"], mesh)
                for k, v in b.items()}

    t0 = _part_start()
    stream = claims_token_stream(seq, TRAIN_BATCH, cfg.vocab_size, 0,
                                 device=device)
    state = init_train_state(bundle, 0, device, mesh)
    step = make_train_step(bundle, AdamWConfig(
        total_steps=SHARD_TRAIN_STEPS + 2, **TRAIN_OPT))
    setup_s = time.perf_counter() - t0
    losses, walls, per_step, first, call = [], [], [], None, None
    with hints.use_mesh(mesh):
        for _ in range(SHARD_TRAIN_STEPS):
            batch = next(stream)
            first = batch if first is None else first
            reset_launch_counts()
            own = mine(batch)
            start = None if call else (_call_start(),       # step 1
                                       tree_bytes((state, own)))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step(state, own)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            if start:
                call = _call_end(*start)
            per_step.append({k: launch_counts[k] for k in (
                "flash_attention", "flash_attention_bwd", "flash_decode")})
    out = _part_stats(t0, {k: sum(s[k] for s in per_step)
                           for k in per_step[0]}, call)
    out.update(losses=losses, step_s=walls, per_step=per_step, call=call,
               setup_s=setup_s, grad_norm=float(m["grad_norm"]),
               tokens_per_s=TRAIN_BATCH * seq / walls[-1])
    del state, stream
    torch.cuda.empty_cache()
    n32, s32 = fp32
    b32 = ModelBundle(dataclasses.replace(cfg, n_layers=n32,
                                          dtype="float32"))
    first = {k: v[:, :s32] for k, v in first.items()}
    p32 = b32.init(2, device, mesh)
    with hints.use_mesh(mesh):
        loss, grads = loss_and_grads(b32, p32, mine(first), "cuda")
        grads = sharding.gather_tree(grads, sharding.param_shardings(
            b32.cfg, mesh, b32.abstract_params()), mesh)
    del p32
    if rank == 0:
        single = b32.init(2, device)
        l1, g1 = loss_and_grads(b32, single, first, "cuda")
        out.update(fp32_loss_rel=abs(float(loss) - float(l1)) / abs(
            float(l1)), fp32_grad_rel=_grad_err(grads, g1))
        del single, g1
    del grads
    torch.cuda.empty_cache()
    return out


def shard_families(group, device) -> dict:
    """Part (d): each family of ``SHARD_FAMILIES`` at full width and depth,
    bf16, on each of its meshes, each rank's blocks drawn leaf by leaf from
    phase 15's seed: the prefill of phase 15's tokens, frames and images
    (1 x 4,096; xlstm 1 x 1,024) under the cuda engine; then the model cut
    to ``SHARD_FAMILY_FP32`` layers in fp32 (rank 0 also on one rank)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import hints, launch as dl
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import get_bundle
    from repro_torch.models.registry import ModelBundle
    from repro_torch.train.optimizer import tree_leaves

    rank = dist.get_rank(group)
    runs, total = {}, {}
    for arch, meshes in SHARD_FAMILIES.items():
        bundle = get_bundle(arch)
        seq = next(f[3] for f in FAMILIES if f[0] == arch)
        batch = family_batch(bundle.cfg, 1, seq, np.random.default_rng(11),
                             device)
        for shape in meshes:
            mesh = dl.make_mesh(group, shape)
            t0 = _part_start()
            params = bundle.init(0, device, mesh)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            held = sum(t.numel() for t in tree_leaves(params))
            with hints.use_mesh(mesh), torch.no_grad():
                reset_launch_counts()
                t1 = time.perf_counter()
                logits = bundle.prefill(params, batch, engine="cuda")
                torch.cuda.synchronize()
                prefill_s = time.perf_counter() - t1
                rec = _part_stats(t0, dict(launch_counts))
            rec.update(init_s=init_s, prefill_s=prefill_s, params_held=held,
                       seq=seq)
            if rank == 0:
                rec.update(logits=logits.float().cpu().numpy(),
                           finite=bool(torch.isfinite(logits).all()))
            del params, logits
            torch.cuda.empty_cache()
            # the model cut to a few layers in fp32, against one rank
            n32 = SHARD_FAMILY_FP32[arch]
            cut = {"n_layers": n32}
            if bundle.cfg.is_encdec:
                cut["n_encoder_layers"] = n32
            b32 = ModelBundle(dataclasses.replace(bundle.cfg, dtype="float32",
                                                  **cut))
            batch32 = {k: v if k == "tokens" else v.float()
                       for k, v in batch.items()}
            p32 = b32.init(2, device, mesh)
            with hints.use_mesh(mesh), torch.no_grad():
                l32 = b32.prefill(p32, batch32, engine="cuda")
            del p32
            if rank == 0:
                single = b32.init(2, device)
                with torch.no_grad():
                    one = b32.prefill(single, batch32, engine="cuda")
                rec.update(fp32_err=float((l32 - one).abs().max()),
                           fp32_max_logit=float(one.abs().max()))
                del single
            torch.cuda.empty_cache()
            runs[arch, shape] = rec
            for k, n in rec["launches"].items():
                total[k] = total.get(k, 0) + n
    return {"runs": runs, "launches": total}


def shard_pod(group, device) -> dict:
    """Part (f), A9-pod: h2o-danube-1.8b at full width cut to
    ``SHARD_FP32_LAYERS`` in fp32 on a (pod, data, model) = ``POD_MESH``
    mesh, one step with ``compress_crosspod=True`` on phase 16's first
    batch (a sequence a (pod, data) rank); rank 0 also runs it on one rank
    and compares the two (``pod_compare``) through what each step produced:
    its loss, its clipping norm and its optimizer state."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import hints, launch as dl, sharding
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import claims_token_stream
    from repro_torch.models.registry import ModelBundle
    from repro_torch.train import AdamWConfig, init_train_state, \
        make_train_step
    from repro_torch.train.train_step import state_shardings

    rank = dist.get_rank(group)
    mesh = dl.make_mesh(group, POD_MESH)
    cfg = dataclasses.replace(get_config(DANUBE), n_layers=SHARD_FP32_LAYERS,
                              dtype="float32")
    bundle = ModelBundle(cfg)
    batch = next(claims_token_stream(TRAIN_SEQ, TRAIN_BATCH, cfg.vocab_size,
                                     0, device=device))
    bspec = sharding.batch_shardings(cfg, mesh, batch)["tokens"]
    mine = {k: sharding.own_block(v, bspec, mesh) for k, v in batch.items()}
    opt = AdamWConfig(total_steps=SHARD_TRAIN_STEPS + 2, **TRAIN_OPT)

    def make():
        return make_train_step(bundle, opt, compress_crosspod=True,
                               pod_axis="pod", engine="cuda",
                               param_dtype=torch.float32)

    specs = state_shardings(bundle, mesh)["opt"]
    t0 = _part_start()
    state = init_train_state(bundle, 2, device, mesh)
    with hints.use_mesh(mesh):
        reset_launch_counts()
        t1 = time.perf_counter()
        state, m = make()(state, mine)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t1
        launches = {k: launch_counts[k] for k in (
            "flash_attention", "flash_attention_bwd", "flash_decode",
            *F32_KINDS)}
        out = _part_stats(t0, launches)
        got = {k: sharding.gather_tree(state["opt"][k], specs[k], mesh)
               for k in ("master", "m")}
    out.update(step_s=step_s, loss=float(m["loss"]),
               grad_norm=float(m["grad_norm"]))
    del state
    torch.cuda.empty_cache()
    if rank == 0:
        single = init_train_state(bundle, 2, device)
        single, m1 = make()(single, batch)
        out.update(pod_compare(got, m, single["opt"], m1, opt))
        del single
    del got
    torch.cuda.empty_cache()
    return out


def pod_compare(got, met, want, met1, opt) -> dict:
    """Part (f)'s readings: a compressed step (``got``: its gathered
    ``master`` and ``m``; ``met``: its metrics) against the one-rank
    compressed step.  From zero moments a first step's m is (1 - b1) x the
    clipping factor x the compressed gradient, so over a logical tensor
    m x 127 / max |m| is the tensor's int8 bins: ``grid`` says how far that
    lies from integers (it does only where the whole tensor was quantized
    with its one scale), ``flip_share`` and ``bin_err`` how the bins of the
    two steps differ.  ``grad_rel``: the compressed gradients where the bins
    agree, ``scale_rel`` the scales (each tensor's largest |value|), both
    over the one-rank tensor's largest; the masters where the bins agree
    and where they do not."""
    import torch

    from repro_torch.train.optimizer import tree_leaves

    def factor(m):              # (1 - b1) x the clipping factor
        return (1.0 - opt.b1) * min(1.0, opt.grad_clip / max(
            float(m["grad_norm"]), 1e-12))

    c, c1 = factor(met), factor(met1)
    flips = n = 0
    grid = bin_err = grad_rel = scale_rel = master_same = master_flip = 0.0
    for ma, mb, wa, wb in zip(tree_leaves(got["m"]), tree_leaves(want["m"]),
                              tree_leaves(got["master"]),
                              tree_leaves(want["master"])):
        ta, tb = float(ma.abs().max()), float(mb.abs().max())
        xa = ma.double() * 127.0 / max(ta, 1e-30)
        xb = mb.double() * 127.0 / max(tb, 1e-30)
        ba, bb = torch.round(xa), torch.round(xb)
        grid = max(grid, float((xa - ba).abs().max()),
                   float((xb - bb).abs().max()))
        flip = ba != bb
        flips += int(flip.sum())
        n += flip.numel()
        bin_err = max(bin_err, float((ba - bb).abs().max()))
        top = max(tb / c1, 1e-30)
        scale_rel = max(scale_rel, abs(ta / c - tb / c1) / top)
        dm = (wa - wb).abs()
        if bool((~flip).any()):
            grad_rel = max(grad_rel, float(
                (ma.double() / c - mb.double() / c1).abs()[~flip].max())
                / top)
            master_same = max(master_same, float(dm[~flip].max()))
        if bool(flip.any()):
            master_flip = max(master_flip, float(dm[flip].max()))
    loss1, norm1 = float(met1["loss"]), float(met1["grad_norm"])
    return dict(loss_rel=abs(float(met["loss"]) - loss1) / abs(loss1),
                grad_norm_rel=abs(float(met["grad_norm"]) - norm1) / norm1,
                grad_rel=grad_rel, scale_rel=scale_rel, grid=grid,
                flip_share=flips / n, bin_err=bin_err,
                master_same=master_same, master_flip=master_flip,
                lr=float(met1["lr"]))


def shard_pipe(group, device) -> dict:
    """Part (c): ``pipeline_transformer`` over a 4-rank "pipe" mesh, one
    danube decoder layer (fp32, B6) a stage, ``PIPE_MICRO`` microbatches
    of 1 x ``PIPE_SEQ``: the output and the gradient of its sum with
    respect to this stage's layer, against the sequential run of the 4
    layers on this rank."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import launch as dl
    from repro_torch.distributed.pipeline import pipeline_transformer
    from repro_torch.interop import tree_map
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.models.registry import ModelBundle
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten

    n = dist.get_world_size(group)
    mesh = dl.make_mesh(group, (n,), ("pipe",))
    stage = mesh.coords["pipe"]
    cfg = dataclasses.replace(get_config(DANUBE), n_layers=n,
                              dtype="float32", remat=False)
    layers = ModelBundle(cfg).init(5, device)["layers"]
    gen = torch.Generator(device=device).manual_seed(13)
    mbs = torch.randn((PIPE_MICRO, 1, PIPE_SEQ, cfg.d_model), generator=gen,
                      device=device)
    pos = torch.arange(PIPE_SEQ, dtype=torch.int32, device=device)[None]

    def layer(lp, x):
        return lm._layer_apply(lp, x, cfg.pattern[0], "dense", cfg, pos,
                               None, None, "cuda")[0]

    own = [t.detach().requires_grad_(True) for t in tree_leaves(
        layers[stage])]
    stacked = tree_map(lambda a: a[None, None],
                       tree_unflatten(layers[stage], own))
    t0 = _part_start()
    reset_launch_counts()
    out = pipeline_transformer(layer, mesh, n)(stacked, mbs)
    grads = torch.autograd.grad(out.sum(), own)
    rec = _part_stats(t0, {k: launch_counts[k] for k in (
        "flash_attention", "flash_attention_bwd", "flash_decode")})
    # the sequential run: the 4 layers in order over the 4 microbatches
    ref_own = [t.detach().requires_grad_(True) for t in own]
    x = mbs[:, 0]
    for s in range(n):
        lp = tree_unflatten(layers[s], ref_own) if s == stage else layers[s]
        x = layer(lp, x)
    ref_grads = torch.autograd.grad(x.sum(), ref_own)
    rec.update(fwd_err=float((out[:, 0] - x).detach().abs().max()),
               grad_err=_grad_err(grads, ref_grads))
    return rec


# part (g), A9-sp: the sharded decode of three cells at full width, seeded
# weights (phase 15's seed 0) and a seeded cache: the arch, the mesh, the
# batch, kv_len, the positions (a token a step), the main bf16 run's depth
# (None: the config's), the depth whose bf16 run is gated (None: the main
# run's) and the fp32 cut's depth
#   g1: gemma3-12b's long_500k cell, batch 1, the sequence over every axis
#       of (2, 2); 12 layers (two periods: 10 rings of 1,024 slots and 2
#       global caches of 4.03 GB, 1.01 GB a rank) for memory, four ranks
#       sharing the card; first positions where the ranks past the first
#       block see no key of a global cache, then the cache's last 8
#   g2: recurrentgemma-2b at decode_32k's batch on (1, 4), its 26 layers:
#       the MQA ring of 2,048 slots 512 a rank on "model", the RG-LRU
#       states whole; past the window, so that the ring wraps
#   g3: deepseek-moe-16b on (1, 4) with part (a)'s rank weights: KV heads
#       a rank, EP MoE at decode; its full depth reported and not gated
#       (bf16 routing flips spread through the whole model, as in part
#       (a)), phase 15's twin depth gated
DECODE_PARTS = {
    "g1": dict(arch="gemma3-12b", shape=(2, 2), batch=1, kv_len=524_288,
               positions=(1_000, 131_071, 131_072)
               + tuple(range(524_280, 524_288)),
               layers=12, gated=None, fp32_layers=6),
    "g2": dict(arch="recurrentgemma-2b", shape=(1, 4), batch=128,
               kv_len=32_768, positions=tuple(range(5_000, 5_008)),
               layers=None, gated=None, fp32_layers=3),
    "g3": dict(arch="deepseek-moe-16b", shape=(1, 4), batch=4, kv_len=4_096,
               positions=tuple(range(2_000, 2_008)), layers=None,
               gated=TWIN_LAYERS, fp32_layers=SHARD_FP32_LAYERS),
}
DECODE_CHUNK = 4096          # slots of a seeded chunk of a decode cache
DECODE_SEED = 5              # the caches' draws
DECODE_GATE = 1e-3           # fp32 cut against one rank: logits, slots, states
DECODE_KINDS = ("flash_attention", "flash_decode", "flash_decode_lse")
# part (h), A9-dryrun: the calls of parts (a), (b) and (g3) that the dry run
# (``repro_torch.launch.dryrun``) traces on meta tensors in a fake world of
# their mesh's ranks, each at its part's mesh, shapes and depth (g3: its
# main bf16 run's first token); then danube's production cells on 16 x 16
DRYRUN_DECODE = ("g3", "bf16")
DRYRUN_CALLS = {
    "a": dict(arch=SHARD_MOE, kind="prefill", mesh=(1, 4), batch=1,
              seq_len=SHARD_PREFILL),
    "b": dict(arch=DANUBE, kind="train", mesh=(2, 2), batch=TRAIN_BATCH,
              seq_len=TRAIN_SEQ, loss_mask=True),
    "g3": dict(arch=DECODE_PARTS["g3"]["arch"], kind="decode",
               mesh=DECODE_PARTS["g3"]["shape"],
               batch=DECODE_PARTS["g3"]["batch"],
               seq_len=DECODE_PARTS["g3"]["kv_len"],
               pos=DECODE_PARTS["g3"]["positions"][0]),
}
DRYRUN_CELLS = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_BUDGET = 90.0         # the subprocesses' wall, printed beside it
DRYRUN_WAIT = 300.0          # left to them once phase 17 ends, then a fault
DRYRUN_NICE = 10             # below the build and the phases they overlap
DRYRUN_CODE = """
import json, sys
from repro_torch.launch import dryrun as D
kw = json.loads(sys.argv[1])
kw["mesh"] = tuple(kw["mesh"])
print(json.dumps(D.trace_call(D.Call(**kw))))
"""


def _decode_leaves(cache, specs=None) -> list:
    """``(leaf, spec, layer index, index in the layer)`` of a decoder LM's
    cache, in order (``specs`` None: the whole cache)."""
    return [(t, None if specs is None else specs[i][k], i, k)
            for i, layer in enumerate(cache) for k, t in enumerate(layer)]


def _ranges(t, spec, mesh):
    """A block's logical shape and the rank's ``[lo, hi)`` on each dim
    (``spec`` None: the whole leaf)."""
    from repro_torch.distributed import sharding

    if spec is None:
        return tuple(t.shape), [(0, n) for n in t.shape]
    shape = tuple(n * sharding.n_blocks(e, mesh)
                  for n, e in zip(t.shape, spec))
    return shape, [sharding.block_range(n, e, mesh)
                   for n, e in zip(shape, spec)]


def seeded_leaf(t, spec, mesh, j: int, round_to=None):
    """Leaf ``j`` of a seeded decode cache as a new tensor like ``t``: the
    logical values drawn in fp32 in fixed chunks of ``DECODE_CHUNK`` slots
    (dim 1; a leaf of fewer dims than a KV cache's four is one chunk),
    chunk ``c`` from its own seed, this rank drawing only the chunks its
    block meets and keeping its block, rounded through ``round_to`` and
    stored in t's type.  The one-rank twin draws the same chunks."""
    import torch

    shape, ranges = _ranges(t, spec, mesh)
    out = torch.empty_like(t)
    step = min(DECODE_CHUNK, shape[1]) if t.dim() == 4 else shape[1]
    lo, hi = ranges[1]
    for c0 in range(0, shape[1], step):
        a, b = max(c0, lo), min(c0 + step, hi)
        if a >= b:
            continue
        g = torch.Generator(device=t.device).manual_seed(
            DECODE_SEED * 1_000_003 + j * 4_099 + c0 // step)
        full = torch.randn((shape[0], step) + shape[2:], generator=g,
                           device=t.device)
        idx = [slice(r0, r1) for r0, r1 in ranges]
        idx[1] = slice(a - c0, b - c0)
        blk = full[tuple(idx)]
        out[:, a - lo:b - lo] = blk if round_to is None \
            else blk.to(round_to)
        del full, blk
    return out


def fill_decode_cache(cache, specs, mesh, round_to=None) -> None:
    """Every leaf of a decoder LM's cache (the rank's blocks under
    ``specs``; ``specs`` None: the whole cache) in place from
    ``seeded_leaf``."""
    for j, (t, spec, _, _) in enumerate(_decode_leaves(cache, specs)):
        t.copy_(seeded_leaf(t, spec, mesh, j, round_to))


def _kv_slots(cfg, cache, specs, mesh, positions) -> dict:
    """``{leaf index: logical slots the steps wrote}`` of every KV leaf: the
    position in a full cache, ``pos % window`` in a ring."""
    from repro_torch.models.lm import ATTENTION_KINDS, layer_kinds

    kinds = layer_kinds(cfg)
    out = {}
    for j, (t, spec, i, _) in enumerate(_decode_leaves(cache, specs)):
        kind = kinds[i][0]
        if kind in ATTENTION_KINDS:
            S = _ranges(t, spec, mesh)[0][1]
            ring = kind == "swa" and cfg.window > 0 and S == cfg.window
            out[j] = sorted({p % S if ring else p for p in positions})
    return out


def logical_slots(t, spec, mesh, slots):
    """The logical values ``[:, slots]`` of a KV leaf (fp32, every head and
    batch row), on every rank from the ranks' blocks (one sum over the
    mesh, each value divided by the number of ranks that hold it)."""
    import torch

    from repro_torch.distributed import comm

    if spec is None:
        return t[:, slots].float()
    shape, ranges = _ranges(t, spec, mesh)
    out = torch.zeros((shape[0], len(slots)) + shape[2:], device=t.device)
    lo, hi = ranges[1]
    held = [n for n, s in enumerate(slots) if lo <= s < hi]
    if held:
        idx = [slice(r0, r1) for r0, r1 in ranges]
        idx[1] = torch.tensor(held, device=t.device)
        out[tuple(idx)] = t[:, [slots[n] - lo for n in held]].float()
    split = 1
    for n, m in zip(shape, t.shape):
        split *= n // m
    return comm.all_reduce_sum(out, mesh.group) / (mesh.size // split)


def seeded_err(cache, specs, mesh, slots: dict) -> float:
    """The largest difference between a KV leaf's block and its seeded
    draw outside the slots the steps wrote (0: nothing else moved)."""
    import torch

    err = 0.0
    for j, (t, spec, _, _) in enumerate(_decode_leaves(cache, specs)):
        if j not in slots:
            continue
        d = (t.float() - seeded_leaf(t, spec, mesh, j).float()).abs()
        lo, hi = _ranges(t, spec, mesh)[1][1]
        mine = [s - lo for s in slots[j] if lo <= s < hi]
        if mine:
            d[:, torch.tensor(mine, device=t.device)] = 0
        err = max(err, float(d.max()))
        del d
    return err


def predicted_decode(cfg, cache, specs, mesh, pos: int) -> dict:
    """B6's launches a decode step at ``pos`` makes on this rank, from its
    blocks alone: one a layer whose KV cache is whole on the sequence
    (heads a rank, or every head), the decode route with the LSE where the
    sequence is split and the rank's block holds a key the query sees
    (none where it holds none)."""
    from repro_torch.models.lm import ATTENTION_KINDS, layer_kinds

    kinds = layer_kinds(cfg)
    n = lse = 0
    for t, spec, i, k in _decode_leaves(cache, specs):
        kind = kinds[i][0]
        if k or kind not in ATTENTION_KINDS:
            continue
        if spec is None or spec[1] is None:
            n += 1
            continue
        S = _ranges(t, spec, mesh)[0][1]
        lo, hi = _ranges(t, spec, mesh)[1][1]
        window = cfg.window if kind == "swa" else 0
        if window and S == window:                 # a ring
            seen = lo < min(pos + 1, S)
        else:
            seen = lo <= pos and (not window or hi - 1 > pos - window)
        n += seen
        lse += seen
    return {"flash_attention": n, "flash_decode": n, "flash_decode_lse": lse}


def decode_steps(bundle, params, cache, toks, positions, mesh, device,
                 engine: str = "cuda", keep: bool = True, measured=None):
    """``make_serve_step`` at each position (``toks``: the whole batch's
    tokens a step, cut to the rank's rows under ``mesh``); the whole batch's
    logits a step (fp32, on the device; none unless ``keep``), the host
    wall a step (to ``synchronize``), B6's launches a step, the cache.
    ``measured`` (a dict): filled with the first step's ``_call_end``."""
    import contextlib

    import torch

    from repro_torch.distributed import hints, launch as dl
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.serving.serve_step import make_serve_step

    step = make_serve_step(bundle, engine=engine)
    outs, walls, launches = [], [], []
    ctx = hints.use_mesh(mesh) if mesh is not None \
        else contextlib.nullcontext()
    with torch.no_grad(), ctx:
        for tok, pos in zip(toks, positions):
            b = dl._batch_block(bundle.cfg, mesh, {"tokens": tok}, device) \
                if mesh is not None else {"tokens": torch.from_numpy(
                    tok).to(device)}
            reset_launch_counts()
            # the dry run's position is an int32 scalar (4 bytes), the
            # step's here a Python int
            start = (_call_start(), tree_bytes((params, cache, b)) + 4) \
                if measured is not None and not measured else None
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = step(params, cache, dict(b, pos=int(pos)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if start:
                measured.update(_call_end(*start))
            launches.append({k: launch_counts[k] for k in DECODE_KINDS})
            if mesh is not None:
                logits = dl._rows_whole(logits, bundle.cfg, mesh, len(tok))
            if keep:
                outs.append(logits.float())
    return outs, walls, launches, cache


def _state_leaves(cfg, cache, specs, mesh) -> list:
    """The logical recurrent states (fp32), gathered from the ranks'
    blocks."""
    from repro_torch.distributed import sharding
    from repro_torch.models.lm import ATTENTION_KINDS, layer_kinds

    kinds = layer_kinds(cfg)
    out = []
    for t, spec, i, _ in _decode_leaves(cache, specs):
        if kinds[i][0] in ATTENTION_KINDS:
            continue
        if spec is not None:
            t = sharding.gather_tree(t, spec, mesh)
        out.append(t.float())
    return out


def _max_diff(a, b) -> float:
    return max([float((x - y).abs().max()) for x, y in zip(a, b)] + [0.0])


def _decode_run(group, device, cfg, cell, toks, mesh, keep: bool,
                measured=None) -> dict:
    """One sharded run of a part (g) cell: blocks drawn, cache seeded, the
    steps; its stats, launches against the prediction, the rank's seeded
    error and (``keep``) the logits, written slots and states
    (``measured``: ``decode_steps``')."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.models.registry import ModelBundle

    t0 = _part_start()
    bundle = ModelBundle(cfg)
    params = bundle.init(0, device, mesh)
    cache = bundle.init_cache(cell["batch"], cell["kv_len"], device, mesh)
    specs = sharding.specs_of(cache)
    fill_decode_cache(cache, specs, mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    want = [predicted_decode(cfg, cache, specs, mesh, p)
            for p in cell["positions"]]
    logits, walls, launches, cache = decode_steps(
        bundle, params, cache, toks, cell["positions"], mesh, device,
        keep=keep, measured=measured)
    rec = _part_stats(t0, launches, measured)
    if measured:
        rec["call"] = measured
    slots = _kv_slots(cfg, cache, specs, mesh, cell["positions"])
    kv = {j: logical_slots(t, spec, mesh, slots[j]) for j, (t, spec, _, _)
          in enumerate(_decode_leaves(cache, specs)) if j in slots}
    states = _state_leaves(cfg, cache, specs, mesh)
    rec.update(layers=cfg.n_layers, setup_s=setup_s, step_s=walls,
               predicted=want,
               seeded_err=seeded_err(cache, specs, mesh, slots),
               cache_held=sum(t.numel() * t.element_size()
                              for t, _, _, _ in _decode_leaves(cache)))
    del params, cache
    torch.cuda.empty_cache()
    return rec, (logits, kv, states) if keep else None


def _one_rank(cfg, cell, toks, device, engine="cuda", params=None,
              fp32: bool = False):
    """The part (g) cell on one rank: the whole model (``params``, else
    drawn from the same seed) and cache (the same draws).  ``fp32``: the
    bf16 ``params`` converted in place and run in fp32 on the cache's bf16
    values (the fp32 model of those weights)."""
    import dataclasses

    import torch

    from repro_torch.models.registry import ModelBundle

    if fp32:
        to_fp32_in_place(params)
        cfg = dataclasses.replace(cfg, dtype="float32")
    bundle = ModelBundle(cfg)
    params = bundle.init(0, device) if params is None else params
    cache = bundle.init_cache(cell["batch"], cell["kv_len"], device)
    fill_decode_cache(cache, None, None, torch.bfloat16 if fp32 else None)
    logits, walls, launches, cache = decode_steps(
        bundle, params, cache, toks, cell["positions"], None, device,
        engine=engine)
    slots = _kv_slots(cfg, cache, None, None, cell["positions"])
    kv = {j: t[:, slots[j]].float() for j, (t, _, _, _)
          in enumerate(_decode_leaves(cache)) if j in slots}
    states = _state_leaves(cfg, cache, None, None)
    del cache
    torch.cuda.empty_cache()
    return dict(logits=logits, walls=walls, launches=launches, kv=kv,
                states=states, params=params)


def decode_part(group, device, name: str) -> dict:
    """One cell of part (g) on every rank: the main bf16 run (and, for g3,
    the gated depth's), then the fp32 cut, each sharded; then rank 0 runs
    the gated depth on one rank under the cuda and torch engines and as
    the fp32 model of its bf16 weights, and the fp32 cut, and compares."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import launch as dl

    cell = DECODE_PARTS[name]
    rank = dist.get_rank(group)
    mesh = dl.make_mesh(group, cell["shape"])
    base = get_config(cell["arch"])
    main = dataclasses.replace(base, n_layers=cell["layers"] or base.n_layers)
    gated_n = cell["gated"] or main.n_layers
    gated = dataclasses.replace(base, n_layers=gated_n)
    cut = dataclasses.replace(base, n_layers=cell["fp32_layers"],
                              dtype="float32")
    rng = np.random.default_rng(13)
    toks = [rng.integers(3, base.vocab_size, (cell["batch"], 1)).astype(
        np.int32) for _ in cell["positions"]]
    runs = [("bf16", main)] + ([("bf16_gated", gated)] if cell["gated"]
                               else []) + [("fp32", cut)]
    rec, kept = {}, {}
    for tag, cfg in runs:
        rec[tag], kept[tag] = _decode_run(
            group, device, cfg, cell, toks, mesh, keep=rank == 0,
            measured={} if (name, tag) == DRYRUN_DECODE else None)
    rec["launches"] = {k: sum(s[k] for s in rec["bf16"]["launches"])
                       for k in DECODE_KINDS}
    if rank:
        return rec
    sh16 = kept["bf16_gated" if cell["gated"] else "bf16"]
    if cell["gated"]:
        rec["bf16"]["finite"] = bool(all(torch.isfinite(x).all()
                                         for x in kept["bf16"][0]))
    del kept["bf16"]
    one = _one_rank(gated, cell, toks, device)
    torch_eng = _one_rank(gated, cell, toks, device, engine="torch",
                          params=one["params"])
    del torch_eng["params"]
    f32 = _one_rank(gated, cell, toks, device, params=one.pop("params"),
                    fp32=True)
    del f32["params"]
    logits16, kv16, states16 = sh16
    rec["gate"] = dict(depth=gated_n, finite=bool(all(
        torch.isfinite(x).all() for x in logits16)),
        one_rank_step_s=one["walls"], one_rank_launches=one["launches"])
    # each of the logits, the written cache slots and the recurrent states
    # against one rank's cuda engine and the fp32 model, within bf16_gate
    # of the torch engine's distance from the fp32 model (built alike)
    for what, got in (("logits", logits16), ("kv", list(kv16.values())),
                      ("states", states16)):
        def of(r):
            return r[what] if what != "kv" else list(r["kv"].values())

        top = max([float(x.abs().max()) for x in of(f32)] + [0.0])
        rec["gate"][what] = dict(
            vs_one_rank=_max_diff(got, of(one)),
            vs_fp32=_max_diff(got, of(f32)),
            torch_vs_fp32=_max_diff(of(torch_eng), of(f32)), largest=top,
            bound=bf16_gate(_max_diff(of(torch_eng), of(f32)), top)
            if top > 0 else 0.0)
    del one, torch_eng, f32
    torch.cuda.empty_cache()
    c32 = _one_rank(cut, cell, toks, device)
    del c32["params"]
    lg, kv, states = kept["fp32"]
    rec["fp32_cut"] = dict(
        depth=cut.n_layers, vs_one_rank=_max_diff(lg, c32["logits"]),
        max_logit=max(float(x.abs().max()) for x in c32["logits"]),
        cache_vs_one_rank=_max_diff(list(kv.values()),
                                    list(c32["kv"].values())),
        states_vs_one_rank=_max_diff(states, c32["states"]),
        greedy_equal=all(torch.equal(a.argmax(-1), b.argmax(-1))
                         for a, b in zip(lg, c32["logits"])))
    del c32, kept
    torch.cuda.empty_cache()
    return rec


def shard_decode(group, device) -> dict:
    """Part (g), A9-sp: each cell of ``DECODE_PARTS`` in turn; the part's
    launches are its main bf16 runs'."""
    out = {name: decode_part(group, device, name) for name in DECODE_PARTS}
    out["launches"] = {k: sum(out[n]["launches"][k] for n in DECODE_PARTS)
                       for k in DECODE_KINDS}
    return out


def sharded_models_rank(group, device, twin_layers: int,
                        parts=PARTS) -> dict:
    """One rank of phase 17 (run by ``distributed.launch.spawn``): the
    parts in turn (``parts``: all of ``PARTS`` unless a probe asks for
    fewer)."""
    run = {"prefill": lambda: shard_prefill(group, device, twin_layers),
           "train": lambda: shard_train(group, device),
           "pipe": lambda: shard_pipe(group, device),
           "families": lambda: shard_families(group, device),
           "rg_train": lambda: shard_train(
               group, device, SHARD_RG, SHARD_RG_LAYERS, SHARD_RG_SEQ,
               SHARD_RG_FP32),
           "pod": lambda: shard_pod(group, device),
           "decode": lambda: shard_decode(group, device)}
    read = tally_launches()
    out = {part: run[part]() for part in parts}
    out["f32_launches"] = read()
    return out


def loss_gate(bundle, batch) -> dict:
    """The bf16 gate of a step-1 loss, built as ``bf16_gate`` is: the
    seeded weights' (``bundle.init(0)``) loss on ``batch`` in fp32 and the
    bf16 torch engine's distance from it."""
    import dataclasses

    import torch

    from repro_torch.interop import tree_map
    from repro_torch.models.registry import ModelBundle

    p = bundle.init(0, device="cuda")
    with torch.no_grad():
        l16 = float(bundle.train_loss(p, batch, engine="torch"))
        p32 = tree_map(lambda t: t.float(), p)
        del p
        b32 = ModelBundle(dataclasses.replace(bundle.cfg, dtype="float32"))
        l32 = float(b32.train_loss(p32, batch, engine="torch"))
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    return dict(loss_fp32=l32, loss_bf16_torch=l16,
                gate=bf16_gate(abs(l16 - l32), abs(l32)))


def sharded_models_phase(step1_loss: float, parts=PARTS):
    """Phase 17: the sharded models on ``SHARDS`` gloo ranks of the one
    card (``sharded_models_rank``), after the bf16 gates of the step-1
    losses of parts (b) and (e) are built on the card alone.  Returns the
    B6 launches of the parts' main runs, summed over ranks, and a
    summary."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import launch as dl
    from repro_torch.launch.train import claims_token_stream
    from repro_torch.models import get_bundle
    from repro_torch.models.registry import ModelBundle

    gates = {}
    rg = ModelBundle(dataclasses.replace(get_config(SHARD_RG),
                                         n_layers=SHARD_RG_LAYERS))
    for part, bundle, seq in (("train", get_bundle(DANUBE), TRAIN_SEQ),
                              ("rg_train", rg, SHARD_RG_SEQ)):
        if part in parts:
            stream = claims_token_stream(seq, TRAIN_BATCH,
                                         bundle.cfg.vocab_size, 0,
                                         device="cuda")
            gates[part] = loss_gate(bundle, next(stream))
            del stream
            gc.collect()
            torch.cuda.empty_cache()
    ref = FAMILY_REF
    bad = []                     # every part's failed gates, reported at once
    t0 = time.perf_counter()
    ranks = dl.spawn(sharded_models_rank, SHARDS,
                     (ref.get(SHARD_MOE, {}).get("twin"), parts),
                     device="cuda", timeout=SHARD_MODELS_TIMEOUT)
    wall = time.perf_counter() - t0
    summary = {"wall_s": wall}

    def show(r):
        c = r["comm"]
        return (f"rank wall {r['wall_s']:.3f} s, peak {r['peak_gib']:.2f} "
                f"GiB, staged {c['staged_bytes'] / 2 ** 30:.3f} GiB in "
                f"{c['staging_s']:.3f} s ({100 * r['staging_share']:.1f} % "
                f"of the wall), collectives " + json.dumps(
                    {k: v for k, v in c.items()
                     if k not in ("staged_bytes", "staging_s")}))

    def train_gates(part, what, loss_ref, gate):
        """Parts (b) and (e): B6 a step on every rank, step 1's loss
        within ``gate`` of ``loss_ref``, the fp32 cut against one rank."""
        r0 = ranks[0][part]
        n_attn = attention_calls(what, decode=False)
        want = {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn,
                "flash_decode": 0}
        for i, r in enumerate(ranks):
            for j, got in enumerate(r[part]["per_step"]):
                if got != want:
                    bad.append(f"sharded training ({part}), rank {i}, step "
                               f"{j + 1}: B6 {got}, want {want}")
            log(f"sharded models ({part}) {what.name} training, rank {i}: "
                f"losses {r[part]['losses']}, step walls "
                f"{r[part]['step_s']} s, set-up {r[part]['setup_s']:.3f} s; "
                + show(r[part]))
        losses = r0["losses"]
        d = abs(losses[0] - loss_ref)
        rec = dict(losses=losses, step1_vs_ref=d,
                   step1_vs_fp32=abs(losses[0] - gate["loss_fp32"]),
                   loss_gate=gate,
                   fp32_loss_rel=r0["fp32_loss_rel"],
                   fp32_grad_rel=r0["fp32_grad_rel"],
                   warm_step_s=r0["step_s"][-1],
                   tokens_per_s=r0["tokens_per_s"],
                   walls=[r[part]["wall_s"] for r in ranks],
                   peaks=[r[part]["peak_gib"] for r in ranks])
        ok = (all(np.isfinite(losses)) and d <= gate["gate"]
              and r0["fp32_loss_rel"] <= SHARD_TRAIN_GATE["loss"]
              and r0["fp32_grad_rel"] <= SHARD_TRAIN_GATE["grad"])
        return rec, want, ok

    if "prefill" in parts:       # (a) deepseek prefill
        dref = ref[SHARD_MOE]
        a0 = ranks[0]["prefill"]
        n_moe = get_bundle(SHARD_MOE).cfg.n_layers
        for i, r in enumerate(ranks):
            got = r["prefill"]["launches"]
            if got["flash_attention"] != n_moe or got["flash_decode"]:
                bad.append(f"sharded prefill, rank {i}: B6 "
                           f"{got['flash_attention']} calls (want {n_moe}), "
                           f"decode route {got['flash_decode']}")
            log(f"sharded models (a) {SHARD_MOE} prefill, rank {i}: "
                f"{r['prefill']['params_held']} parameters held, drawn in "
                f"{r['prefill']['init_s']:.3f} s, prefill "
                f"{r['prefill']['prefill_s']:.3f} s; " + show(r["prefill"]))
        full = float(np.abs(a0["logits"] - dref["full_cuda"]).max())
        cut_cuda = float(np.abs(a0["cut"] - dref["cut_cuda"]).max())
        cut_fp32 = float(np.abs(a0["cut"] - dref["cut_fp32"]).max())
        summary["prefill"] = pre = dict(
            full_vs_one_rank=full, cut_vs_one_rank=cut_cuda,
            cut_vs_fp32=cut_fp32, bf16_gate=dref["bound"],
            fp32_err=a0["fp32_err"], fp32_max_logit=a0["fp32_max_logit"],
            walls=[r["prefill"]["wall_s"] for r in ranks],
            prefill_s=[r["prefill"]["prefill_s"] for r in ranks],
            peaks=[r["prefill"]["peak_gib"] for r in ranks])
        log(f"sharded models (a): {SHARD_MOE} at full width and depth, "
            f"bf16, (1, 4) mesh, 1 x {SHARD_PREFILL} tokens: last-token "
            f"logits finite {a0['finite']}, max |sharded - one rank (phase "
            f"15's cuda engine)| {full} at {n_moe} layers (not gated: bf16 "
            f"routing flips spread through the whole model, phase 15); at "
            f"phase 15's {dref['twin']}-layer twin {cut_cuda} from the "
            f"one-rank cuda engine and {cut_fp32} from the fp32 model (gate "
            f"{dref['bound']} on both, phase 15's bf16_gate for "
            f"{SHARD_MOE}); cut to {SHARD_FP32_LAYERS} layers in fp32 max "
            f"|sharded - one rank| {a0['fp32_err']} (gate "
            f"{SHARD_PREFILL_GATE}); B6 {n_moe} prefill launches on every "
            f"rank")
        if not (a0["finite"] and cut_cuda <= dref["bound"]
                and cut_fp32 <= dref["bound"]
                and a0["fp32_err"] <= SHARD_PREFILL_GATE):
            bad.append(f"sharded prefill gates: {json.dumps(pre)}")

    if "train" in parts:         # (b) danube training
        gate = gates["train"]
        summary["train"], want, ok = train_gates(
            "train", get_bundle(DANUBE).cfg, step1_loss, gate)
        tr = summary["train"]
        log(f"sharded models (b): {DANUBE} at full width and depth, bf16, "
            f"remat, (2, 2) mesh, ZeRO-1, {SHARD_TRAIN_STEPS} steps of "
            f"{TRAIN_BATCH} x {TRAIN_SEQ} claims tokens: step-1 loss "
            f"{tr['losses'][0]} against phase 16's one-rank {step1_loss}: "
            f"{tr['step1_vs_ref']} (gate {gate['gate']}, bf16_gate of the "
            f"fp32 loss {gate['loss_fp32']} and the bf16 torch engine's "
            f"{gate['loss_bf16_torch']}); warm step {tr['warm_step_s']:.3f} "
            f"s = {tr['tokens_per_s']:.1f} tokens/s; cut to "
            f"{SHARD_FP32_LAYERS} layers in fp32: loss relative "
            f"{tr['fp32_loss_rel']}, worst gathered gradient leaf "
            f"{tr['fp32_grad_rel']} of its largest (gates "
            f"{json.dumps(SHARD_TRAIN_GATE)}); B6 {want} a step on every "
            f"rank")
        if not ok:
            bad.append(f"sharded training gates: {json.dumps(tr)}")

    if "pipe" in parts:          # (c) GPipe
        for i, r in enumerate(ranks):
            c = r["pipe"]
            log(f"sharded models (c) pipeline, stage {i}: forward max "
                f"|pipelined - sequential| {c['fwd_err']}, gradient "
                f"{c['grad_err']} of its largest (gate {PIPE_GATE}); B6 "
                f"{c['launches']}; " + show(c))
            if not (c["fwd_err"] <= PIPE_GATE
                    and c["grad_err"] <= PIPE_GATE):
                bad.append(f"pipeline stage {i}: forward {c['fwd_err']}, "
                           f"gradients {c['grad_err']} (gate {PIPE_GATE})")
        summary["pipe"] = dict(
            fwd_err=max(r["pipe"]["fwd_err"] for r in ranks),
            grad_err=max(r["pipe"]["grad_err"] for r in ranks),
            walls=[r["pipe"]["wall_s"] for r in ranks],
            peaks=[r["pipe"]["peak_gib"] for r in ranks])

    if "families" in parts:      # (d) the families' prefill
        fam = summary["families"] = {}
        for (arch, shape), r0 in ranks[0]["families"]["runs"].items():
            fref = ref[arch]
            cfg = get_bundle(arch).cfg
            n_attn = attention_calls(cfg, decode=False)
            tag = f"{arch} on ({shape[0]}, {shape[1]})"
            for i, r in enumerate(ranks):
                rec = r["families"]["runs"][arch, shape]
                got = rec["launches"]
                if got["flash_attention"] != n_attn or got["flash_decode"]:
                    bad.append(f"sharded prefill of {tag}, rank {i}: B6 "
                               f"{got['flash_attention']} calls (want "
                               f"{n_attn}), decode route "
                               f"{got['flash_decode']}")
                log(f"sharded models (d) {tag}, rank {i}: "
                    f"{rec['params_held']} parameters held, drawn in "
                    f"{rec['init_s']:.3f} s, prefill 1 x {rec['seq']} "
                    f"{rec['prefill_s']:.3f} s; " + show(rec))
            one = float(np.abs(r0["logits"] - fref["full_cuda"]).max())
            f32 = float(np.abs(r0["logits"] - fref["fp32"]).max())
            fam[f"{arch} {shape[0]}x{shape[1]}"] = d = dict(
                vs_one_rank=one, vs_fp32=f32, bf16_gate=fref["bound"],
                finite=r0["finite"], b6_a_rank=n_attn,
                fp32_err=r0["fp32_err"],
                fp32_max_logit=r0["fp32_max_logit"],
                prefill_s=[r["families"]["runs"][arch, shape]["prefill_s"]
                           for r in ranks],
                peaks=[r["families"]["runs"][arch, shape]["peak_gib"]
                       for r in ranks])
            log(f"sharded models (d): {tag}, full width and depth, bf16: "
                f"last-token logits finite {r0['finite']}, max |sharded - "
                f"one rank (phase 15's cuda engine)| {one}, max |sharded - "
                f"fp32 model| {f32} (gate {fref['bound']} on both: "
                f"phase 15's bf16_gate for {arch}); "
                f"cut to "
                f"{SHARD_FAMILY_FP32[arch]} layers in fp32 max |sharded - "
                f"one rank| {r0['fp32_err']} (gate {SHARD_PREFILL_GATE}); "
                f"B6 {n_attn} prefill launches on every rank")
            if not (r0["finite"] and one <= fref["bound"]
                    and f32 <= fref["bound"]
                    and r0["fp32_err"] <= SHARD_PREFILL_GATE):
                bad.append(f"sharded prefill gates of {tag}: "
                           f"{json.dumps(d)}")

    if "rg_train" in parts:      # (e) recurrentgemma training
        gate = gates["rg_train"]
        summary["rg_train"], want, ok = train_gates(
            "rg_train", rg.cfg, gate["loss_fp32"], gate)
        tr = summary["rg_train"]
        log(f"sharded models (e): {SHARD_RG} at full width cut to "
            f"{SHARD_RG_LAYERS} of {get_config(SHARD_RG).n_layers} layers "
            f"(two periods and the tail), bf16, remat, (2, 2) mesh (5 of 10 "
            f"heads of 256 a rank, MQA), ZeRO-1, {SHARD_TRAIN_STEPS} steps "
            f"of {TRAIN_BATCH} x {SHARD_RG_SEQ} claims tokens: step-1 loss "
            f"{tr['losses'][0]} against the fp32 model's "
            f"{gate['loss_fp32']}: {tr['step1_vs_ref']} (gate "
            f"{gate['gate']}, bf16_gate of it and the bf16 torch engine's "
            f"{gate['loss_bf16_torch']}; from that: "
            f"{abs(tr['losses'][0] - gate['loss_bf16_torch'])}); warm step "
            f"{tr['warm_step_s']:.3f} s = {tr['tokens_per_s']:.1f} "
            f"tokens/s; cut to {SHARD_RG_FP32[0]} layers in fp32 on "
            f"{TRAIN_BATCH} x {SHARD_RG_FP32[1]} tokens: loss relative "
            f"{tr['fp32_loss_rel']}, worst gathered gradient leaf "
            f"{tr['fp32_grad_rel']} of its largest (gates "
            f"{json.dumps(SHARD_TRAIN_GATE)}); B6 {want} a step on every "
            f"rank")
        if not ok:
            bad.append(f"sharded recurrentgemma training gates: "
                       f"{json.dumps(tr)}")

    if "pod" in parts:           # (f) A9-pod
        f0 = ranks[0]["pod"]
        for i, r in enumerate(ranks):
            log(f"sharded models (f) pod step, rank {i}: step "
                f"{r['pod']['step_s']:.3f} s, B6 {r['pod']['launches']}; "
                + show(r["pod"]))
            # the fp32 step runs B6's fp32 forward and backward kernels
            if any(r["pod"]["launches"][k] <= 0 for k in F32_KINDS):
                bad.append(f"pod step, rank {i}: B6's fp32 kernels "
                           f"{r['pod']['launches']}, not launched")
        keys = ("loss_rel", "grad_norm_rel", "grad_rel", "scale_rel",
                "grid", "flip_share", "bin_err", "master_same",
                "master_flip", "lr")
        summary["pod"] = pod = {k: f0[k] for k in keys}
        pod.update(walls=[r["pod"]["wall_s"] for r in ranks],
                   peaks=[r["pod"]["peak_gib"] for r in ranks])
        log(f"sharded models (f): {DANUBE} cut to {SHARD_FP32_LAYERS} "
            f"layers in fp32 on a (pod, data, model) = {POD_MESH} mesh, one "
            f"step with compress_crosspod on {TRAIN_BATCH} x {TRAIN_SEQ} "
            f"claims tokens against the one-rank compressed step, read "
            f"from each step's first moment and master: loss relative "
            f"{f0['loss_rel']}, compressed gradient where the bins agree "
            f"{f0['grad_rel']} and each leaf's int8 scale "
            f"{f0['scale_rel']} of their largest (gates "
            f"{json.dumps(SHARD_TRAIN_GATE)}); every logical tensor on "
            f"the int8 grid of its one scale within {f0['grid']} of a bin "
            f"(gate {POD_GRID}); compressed gradients at most "
            f"{f0['bin_err']} int8 bins apart (gate 1), "
            f"{f0['flip_share']} of the elements in another bin (gate "
            f"{POD_FLIP_SHARE}); clipping norm relative "
            f"{f0['grad_norm_rel']}; master after the step within "
            f"{f0['master_same']} where the bins agree (gate 1e-5) and "
            f"{f0['master_flip']} where they do not (gate lr "
            f"{f0['lr']} + 1e-5)")
        if not (f0["loss_rel"] <= SHARD_TRAIN_GATE["loss"]
                and f0["grad_rel"] <= SHARD_TRAIN_GATE["grad"]
                and f0["scale_rel"] <= SHARD_TRAIN_GATE["grad"]
                and f0["grid"] <= POD_GRID
                and f0["bin_err"] <= 1.0
                and f0["flip_share"] <= POD_FLIP_SHARE
                and f0["master_same"] <= 1e-5
                and f0["master_flip"] <= f0["lr"] + 1e-5):
            bad.append(f"pod step gates: {json.dumps(pod)}")

    if "decode" in parts:        # (g) A9-sp
        summary["decode"] = decode_gates(ranks, bad, show)

    # rank 0's calls that part (h) dry-runs
    r0 = ranks[0]
    summary["dryrun_calls"] = {name: call for name, call in (
        ("a", r0.get("prefill", {}).get("call")),
        ("b", r0.get("train", {}).get("call")),
        ("g3", r0.get("decode", {}).get("g3", {}).get("bf16", {})
         .get("call"))) if call}

    launches = {k: sum(r[part]["launches"].get(k, 0) for r in ranks
                       for part in parts)
                for k in KERNELS}
    # the fp32 kernels' launches over the ranks' whole run (fp32 cuts too)
    summary["f32_launches"] = {k: sum(r["f32_launches"][k] for r in ranks)
                               for k in F32_KINDS}
    log(f"sharded models: {SHARDS} ranks in {wall:.3f} s; B6 launches "
        f"summed over ranks {json.dumps(launches)}")
    if bad:
        fail(" | ".join(bad))
    return launches, summary


def decode_gates(ranks, bad: list, show) -> dict:
    """Part (g)'s gates and log lines: on every rank, each run's B6
    launches a step as ``predicted_decode`` says (none where the rank's
    block holds no key the query sees) and its KV blocks, outside the
    written slots, equal to their seeded draw; rank 0's comparisons with
    one rank: the gated bf16 run within ``bf16_gate`` of the one-rank cuda
    engine and of the fp32 model (logits, the written cache slots and the
    recurrent states), the fp32 cut within ``DECODE_GATE`` and its greedy
    tokens equal."""
    out = {}
    for name, cell in DECODE_PARTS.items():
        r0 = ranks[0]["decode"][name]
        tags = [t for t in ("bf16", "bf16_gated", "fp32") if t in r0]
        for i, r in enumerate(ranks):
            for tag in tags:
                run = r["decode"][name][tag]
                if run["launches"] != run["predicted"]:
                    bad.append(f"sharded decode {name} {tag}, rank {i}: B6 "
                               f"{run['launches']}, predicted "
                               f"{run['predicted']}")
                if run["seeded_err"] != 0.0:
                    bad.append(f"sharded decode {name} {tag}, rank {i}: a "
                               f"cache slot the steps did not write moved "
                               f"by {run['seeded_err']}")
                log(f"sharded models (g) {name} {cell['arch']} {tag} on "
                    f"{cell['shape']}, rank {i}: set-up "
                    f"{run['setup_s']:.3f} s, wall a token "
                    f"{json.dumps([round(x, 4) for x in run['step_s']])} s, "
                    f"cache held {run['cache_held'] / 2 ** 30:.3f} GiB, "
                    f"B6 a step {json.dumps(run['launches'])}; " + show(run))
        g, c = r0["gate"], r0["fp32_cut"]
        main = r0["bf16"]
        ok = (g["finite"] and main.get("finite", True)
              and all(max(g[w]["vs_one_rank"], g[w]["vs_fp32"])
                      <= g[w]["bound"] for w in ("logits", "kv", "states"))
              and max(c["vs_one_rank"], c["cache_vs_one_rank"],
                      c["states_vs_one_rank"]) <= DECODE_GATE
              and c["greedy_equal"])
        out[name] = rec = dict(
            arch=cell["arch"], shape=cell["shape"], batch=cell["batch"],
            kv_len=cell["kv_len"], gate=g, fp32_cut=c,
            token_s=sum(main["step_s"]) / len(main["step_s"]),
            one_rank_token_s=sum(g["one_rank_step_s"])
            / len(g["one_rank_step_s"]),
            peaks=[r["decode"][name]["bf16"]["peak_gib"] for r in ranks],
            launches=[r["decode"][name]["launches"] for r in ranks])
        del g["one_rank_step_s"], g["one_rank_launches"]
        log(f"sharded models (g) {name}: {cell['arch']} at full width "
            f"({main['layers']} layers), batch {cell['batch']}, kv_len "
            f"{cell['kv_len']}, {cell['shape']} mesh, "
            f"{len(cell['positions'])} tokens at {cell['positions'][0]}.."
            f"{cell['positions'][-1]}: bf16 at {g['depth']} layers max "
            f"|sharded - one rank (cuda)| / |sharded - fp32 model| (bound: "
            f"bf16_gate of the one-rank torch engine's distance from the "
            f"fp32 model) of the logits {g['logits']['vs_one_rank']} / "
            f"{g['logits']['vs_fp32']} ({g['logits']['bound']}), the "
            f"written cache slots {g['kv']['vs_one_rank']} / "
            f"{g['kv']['vs_fp32']} ({g['kv']['bound']}), the recurrent "
            f"states {g['states']['vs_one_rank']} / "
            f"{g['states']['vs_fp32']} ({g['states']['bound']}); fp32 cut to "
            f"{c['depth']} layers: logits {c['vs_one_rank']} (largest "
            f"{c['max_logit']}), cache slots {c['cache_vs_one_rank']}, "
            f"states {c['states_vs_one_rank']} (gate {DECODE_GATE}), greedy "
            f"tokens equal {c['greedy_equal']}; wall a token "
            f"{rec['token_s']:.4f} s sharded, {rec['one_rank_token_s']:.4f} "
            f"s on one rank; B6 launches of the main run, by rank "
            f"{json.dumps(rec['launches'])}")
        if not ok:
            bad.append(f"sharded decode gates of {name}: "
                       f"{json.dumps(rec)}")
    return out


def dryrun_start() -> dict:
    """Part (h)'s subprocesses, started together before the kernel build:
    the dry run of each call of ``DRYRUN_CALLS`` (each starts its own fake
    world, never inside the gloo ranks) and the command line on danube's
    production cells (records under ``chiprun_out/dryrun/``).  None sees a
    card (``CUDA_VISIBLE_DEVICES`` empty) and none reads what phase 17
    measures, so they run while the build and the first phases leave the
    host's cores idle, niced below them, one thread each, and end long
    before ``dryrun_phase`` reads them; every one still running at exit is
    killed."""
    import atexit
    import os
    import threading

    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    out_dir = REPO / "chiprun_out" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds = {name: [sys.executable, "-c", DRYRUN_CODE, json.dumps(kw)]
            for name, kw in DRYRUN_CALLS.items()}
    cmds.update({shape: [sys.executable, "-m", "repro_torch.launch.dryrun",
                         "--arch", DANUBE, "--shape", shape, "--out",
                         str(out_dir)] for shape in DRYRUN_CELLS})
    started = dict(t0=time.perf_counter(), out_dir=out_dir, procs={},
                   ends={})

    def stop():
        for p in started["procs"].values():
            if p.poll() is None:
                p.kill()
                p.wait()

    def watch(k, p):
        p.wait()
        started["ends"][k] = time.perf_counter()

    atexit.register(stop)
    for k, cmd in cmds.items():
        with open(out_dir / f"{k}.out", "w") as o, \
                open(out_dir / f"{k}.err", "w") as e:
            p = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=o, stderr=e)
        os.setpriority(os.PRIO_PROCESS, p.pid, DRYRUN_NICE)
        started["procs"][k] = p
        threading.Thread(target=watch, args=(k, p), daemon=True).start()
    return started


def dryrun_phase(started: dict, measured: dict) -> dict:
    """Part (h) of phase 17, A9-dryrun, once its ranks end: the results of
    ``dryrun_start``'s subprocesses (``measured``: rank 0's calls from phase
    17).  Gates: each call's collectives by kind, count and bytes, and its
    argument bytes equal to rank 0's exactly; each production cell ``ok``.
    The dry run's argument bytes are those of the inputs the traced call
    reads; rank 0's are those of all the inputs it holds for the call
    (``_call_end``), as timing the call under a dispatch mode that sees its
    reads would move the part's walls.  The reads are a subset of the
    holdings, so the equality shows that these three calls read every
    input they hold, as ``tests/test_torch_dryrun.py`` shows on real CPU
    ranks for calls of the same kinds.  The predicted peak (argument bytes
    and ``temp_bytes``) is printed beside the call's measured
    ``max_memory_allocated``, with no gate."""
    t0 = time.perf_counter()
    out_dir, done = started["out_dir"], {}
    try:
        for k, p in started["procs"].items():
            left = DRYRUN_WAIT - (time.perf_counter() - t0)
            p.wait(timeout=max(left, 1.0))
            done[k] = (p.returncode, (out_dir / f"{k}.out").read_text(),
                       (out_dir / f"{k}.err").read_text())
    except subprocess.TimeoutExpired as e:
        fail(f"part (h): a dry run still runs {DRYRUN_WAIT} s after phase "
             f"17 ended: {e.cmd}")
    ends = {k: started["ends"].get(k, time.perf_counter())
            for k in started["procs"]}
    wall = max(ends.values()) - started["t0"]
    bad, summary = [], {"wall_s": wall, "budget_s": DRYRUN_BUDGET,
                        "waited_s": time.perf_counter() - t0,
                        "ends_s": {k: v - started["t0"]
                                   for k, v in ends.items()}}
    for name in (n for n in DRYRUN_CALLS if n in measured):
        rc, o, e = done[name]
        if rc:
            bad.append(f"dry run of part ({name}) exited {rc}: {e[-2000:]}")
            continue
        dry = json.loads(o.strip().splitlines()[-1])
        got = measured[name]
        mem = dry["memory"]
        predicted = mem["argument_bytes"] + mem["temp_bytes"]
        summary[name] = rec = dict(
            collectives_equal=dry["collectives"] == got["collectives"],
            argument_bytes=mem["argument_bytes"],
            measured_argument_bytes=got["argument_bytes"],
            predicted_peak_gib=predicted / 2 ** 30,
            measured_peak_gib=got["peak_bytes"] / 2 ** 30,
            flops=dry["cost"]["flops"], lower_s=dry["lower_s"],
            compile_s=dry["compile_s"])
        log(f"dry run (h) part ({name}) {json.dumps(DRYRUN_CALLS[name])}: "
            f"collectives {json.dumps(dry['collectives'])}, rank 0 "
            f"measured {json.dumps(got['collectives'])}; argument bytes "
            f"{mem['argument_bytes']}, rank 0 held {got['argument_bytes']}; "
            f"peak predicted {rec['predicted_peak_gib']:.3f} GiB (arguments "
            f"+ temp_bytes), measured max_memory_allocated "
            f"{rec['measured_peak_gib']:.3f} GiB (no gate); {dry['cost']} "
            f"in {dry['lower_s']:.1f} + {dry['compile_s']:.1f} s")
        if not (rec["collectives_equal"] and mem["argument_bytes"]
                == got["argument_bytes"]):
            bad.append(f"dry run of part ({name}) against rank 0: "
                       f"{json.dumps(dry['collectives'])} / "
                       f"{json.dumps(got['collectives'])}, argument bytes "
                       f"{mem['argument_bytes']} / {got['argument_bytes']}")
    for shape in DRYRUN_CELLS:
        rc, o, e = done[shape]
        path = out_dir / f"{DANUBE}__{shape}__16x16.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        summary[shape] = dict(ok=bool(rec.get("ok")),
                              total_s=rec.get("total_s"))
        log(f"dry run (h) {DANUBE} {shape} on 16x16 (the command line): "
            f"rc {rc}, {o.strip()}")
        if rc or not rec.get("ok"):
            bad.append(f"dry run of {DANUBE} {shape}: rc {rc}, "
                       f"{rec.get('error')} {e[-1000:]}")
    missing = [n for n in DRYRUN_CALLS if n not in measured]
    if missing:
        bad.append(f"phase 17 measured no call of parts {missing}")
    log(f"dry run (h): the subprocesses' wall {wall:.3f} s from their start "
        f"(budget {DRYRUN_BUDGET} s), each's end {json.dumps(summary['ends_s'])}"
        f"; {summary['waited_s']:.3f} s waited after phase 17")
    if bad:
        fail(" | ".join(bad))
    return summary


KERNELS = {
    "predicate_bitset": ("src/repro_torch/csrc/predicate.cu",
                         "src/repro/kernels/predicate.py:358"),
    "filter_compact": ("src/repro_torch/csrc/filter_compact.cu",
                       "src/repro/kernels/filter_compact.py:72"),
    "bitset_op": ("src/repro_torch/csrc/bitset_ops.cu",
                  "src/repro/kernels/bitset_ops.py:42"),
    "segmented_scan": ("src/repro_torch/csrc/segment_scan.cu",
                       "src/repro/kernels/segment_scan.py:89"),
    "flash_attention": ("src/repro_torch/csrc/swa_prefill.cu",
                        "src/repro/kernels/swa_attention.py:98"),
    "flash_decode": ("src/repro_torch/csrc/swa_decode.cu",
                     "src/repro/kernels/swa_attention.py:98"),
    # the decode route's launches that also write each row's log-sum-exp
    # (a sequence-sharded decode's blocks; counted in flash_decode too)
    "flash_decode_lse": ("src/repro_torch/csrc/swa_decode.cu",
                         "src/repro/kernels/swa_attention.py:98"),
    "hash_partition_plan": ("src/repro_torch/csrc/hash_partition.cu",
                            "src/repro/kernels/hash_partition.py:44"),
    "filter_compact_mask": ("src/repro_torch/csrc/filter_compact.cu",
                            "src/repro/kernels/filter_compact.py:113"),
    # no Pallas backward: the reference differentiates its XLA attention.
    # bf16 at every head dim; fp32 runs src/repro_torch/csrc/swa_backward.cu
    "flash_attention_bwd": ("src/repro_torch/csrc/swa_backward_bf16.cu",
                            "src/repro/models/layers.py:130"),
    # B6's fp32 kernels on the CUDA cores (counted in flash_attention and
    # flash_attention_bwd too): the fp32 gates and fp32 training run them
    "flash_attention_f32": ("src/repro_torch/csrc/swa_attention.cu",
                            "src/repro/kernels/swa_attention.py:98"),
    "flash_attention_bwd_f32": ("src/repro_torch/csrc/swa_backward.cu",
                                "src/repro/models/layers.py:130"),
}
F32_KINDS = ("flash_attention_f32", "flash_attention_bwd_f32")


def tally_launches():
    """Count the fp32 kernels' launches over the rest of this process's
    run, through every ``reset_launch_counts`` (which the phases call
    before each main path): returns a function that reads the counts since
    this call."""
    from repro_torch import kernels

    counts = kernels.launch_counts
    tally = {k: -counts[k] for k in F32_KINDS}
    reset = kernels.reset_launch_counts

    def counted_reset():
        for k in tally:
            tally[k] += counts[k]
        reset()

    kernels.reset_launch_counts = counted_reset
    return lambda: {k: tally[k] + counts[k] for k in tally}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-patients", type=int, default=2_000_000)
    # the reference's design-matrix index is int32 and wraps above 466,033
    # patients at (36, 128) (ROADMAP C7); 400,000 stays below it
    ap.add_argument("--cohort-patients", type=int, default=400_000)
    # four ranks share the card, each keeping its own block of every output
    ap.add_argument("--sharded-patients", type=int, default=2_000_000)
    # the chunked phase reuses the quickstart's star at the same scale
    ap.add_argument("--chunked-patients", type=int, default=2_000_000)
    args = ap.parse_args()

    if not (REPO / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: the repository's src/repro_torch is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # the whole log, for runners that keep only the tail of the output
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    LOG["file"] = open(out / "chip_smoke.log", "w")
    # full fp32 products for every plain version and the torch engines
    # (the default, stated): TF32 would keep about three decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: environment + kernel build
    t_all = time.perf_counter()
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, card {name}, {smi}")
    from repro_torch.kernels import build

    f32_launches = tally_launches()
    # part (h)'s dry runs need no card and nothing that runs before them
    dry_started = dryrun_start()
    t0 = time.perf_counter()
    build.library()
    info = build.build_info()
    log(f"env: kernel library {info['path']} ready in "
        f"{time.perf_counter() - t0:.3f} s (nvcc {info['seconds']:.3f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "serialized" in line:
            log("ptxas: " + line.strip())
    # the bf16 prefill kernel: the count at launch is 384 threads' share;
    # setmaxnreg then gives the producer 24 and each consumer thread 240
    for D in (80, 96, 240):
        b6 = kernel_registers(info["log"], "flash_wgmma", D)
        log(f"ptxas: B6 bf16 prefill flash_wgmma<{D}>: {b6}")
        # head dim 96 (phi-3-vision's) must keep its state in registers
        if D == 96 and "0 bytes spill stores, 0 bytes spill loads" not in b6:
            fail(f"B6's flash_wgmma<96> spills: {b6}")
    # the bf16 prefill kernel writes the log-sum-exp for the backward now:
    # its danube instantiation must keep 168 registers and no spills
    b6 = kernel_registers(info["log"], "flash_wgmma", 80)
    if "0 bytes spill stores, 0 bytes spill loads" not in b6:
        fail(f"B6's flash_wgmma<80> spills: {b6}")
    # B6's backward: bf16 on the tensor cores at every head dim (no spills,
    # no serialized wgmma, setmaxnreg kept), fp32 on the CUDA cores at
    # danube's head dim and at 256
    bwd_log = info["log"].split("== swa_backward_bf16.cu")[1].split("\n== ")[0]
    if "serialized" in bwd_log or "ignored" in bwd_log:
        fail("B6's bf16 backward: ptxas serializes its wgmma or ignores "
             "setmaxnreg: " + " | ".join(
                 x.strip() for x in bwd_log.splitlines()
                 if "serialized" in x or "ignored" in x))
    from repro_torch.kernels.swa_attention import HEAD_DIMS

    for D in HEAD_DIMS:
        for kern in ("bwd_dq_wgmma", "bwd_dkdv_wgmma"):
            rep = kernel_registers(info["log"], kern, D)
            log(f"ptxas: B6 backward {kern}<{D}>: {rep}")
            if "0 bytes spill stores, 0 bytes spill loads" not in rep:
                fail(f"B6's bf16 backward {kern}<{D}> spills: {rep}")
    # B6's fp32 kernels on the CUDA cores (the forward, the backward's two
    # launches) at every head dim
    for D in HEAD_DIMS:
        for kern in ("flash_f32", "bwd_dq", "bwd_dkdv"):
            log(f"ptxas: B6 fp32 {kern}<{D}>: "
                + kernel_registers(info["log"], kern, D))
    # B1 must keep its whole state in registers and shared memory
    for rows in (16, 8):
        b1 = ptxas_report(info["log"], f"predicate_kernelILi{rows}E")
        log(f"ptxas: B1 predicate_kernel<{rows}>: {b1}")
        if not b1.startswith("0 bytes stack frame, 0 bytes spill stores, "
                             "0 bytes spill loads"):
            fail(f"B1's kernel uses local memory: {b1}")
    log(f"ptxas: B4 seg_scan_kernel: "
        f"{ptxas_report(info['log'], 'seg_scan_kernel')}")
    # B3 keeps every op's result and count in registers, at every length
    for k in range(1, 9):
        b3 = ptxas_report(info["log"], f"bitset_expr_kernelILi{k}E")
        log(f"ptxas: B3 bitset_expr_kernel<{k}>: {b3}")
        if not b3.startswith("0 bytes stack frame, 0 bytes spill stores, "
                             "0 bytes spill loads"):
            fail(f"B3's {k}-op kernel uses local memory: {b3}")
    rate = mem_rate(name)
    seconds = {"build": time.perf_counter() - t_all}

    def timed(phase, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[phase] = time.perf_counter() - t
        log(f"phase {phase}: {seconds[phase]:.3f} s")
        return out

    timed("kernels", kernel_battery, torch.device("cuda"))
    timed("segmented_scan", segment_scan_battery, torch.device("cuda"))
    q_launches, timing, study, dcir, qres = timed(
        "quickstart", study_phase, args.n_patients, REPS, rate)
    qstar = dcir            # the service phase serves the quickstart's star
    timed("quickstart_profile", profile_phase, "quickstart",
          lambda: study.run(dict(dcir), engine="cuda",
                            predicate_engine="cuda", device="cuda"))
    store_dir = REPO / ".chunk_store"
    try:
        chunk_resident, peak = q_launches, PEAKS["quickstart"]
        if args.chunked_patients != args.n_patients:
            del study, dcir, qres
            torch.cuda.empty_cache()
            study, dcir, qres, chunk_resident, peak = timed(
                "chunked_resident", resident_run, args.chunked_patients)
        prep = timed("chunked_prepare", chunked_prepare, study, dcir, qres,
                     store_dir, peak)
        del study, dcir, qres
        torch.cuda.empty_cache()
        k_launches = timed("chunked", chunked_phase, prep, chunk_resident,
                           store_dir)
        del prep
        torch.cuda.empty_cache()
        f_launches = timed("spec", spec_phase, store_dir / "spec")
    finally:
        import shutil

        shutil.rmtree(store_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    v_launches = timed("service", service_phase, qstar, args.n_patients)
    del qstar
    gc.collect()
    torch.cuda.empty_cache()
    c_launches, c_timing, cstudy, ctables = timed(
        "cohort", cohort_phase, args.cohort_patients, REPS, rate)
    timed("cohort_profile", profile_phase, "cohort_study",
          lambda: cstudy.run(dict(ctables), engine="cuda",
                             predicate_engine="cuda", device="cuda"))
    del cstudy, ctables
    torch.cuda.empty_cache()
    timed("cpu", cpu_phase, CPU_PATIENTS)
    timed("attention", attention_battery, torch.device("cuda"))
    lse_timing = timed("attention_lse", decode_lse_battery,
                       torch.device("cuda"), REPS, rate)
    s_launches, s_timing, decode, tf, prefill_err, cpu_err = timed(
        "serving", serving_phase, REPS, rate)
    torch.cuda.empty_cache()
    g_launches, g_timing, gemma_err, ring_err = timed(
        "gemma3", gemma3_phase, REPS, rate)
    torch.cuda.empty_cache()
    mask_timing = timed("partition", partition_battery, torch.device("cuda"),
                        REPS, rate)
    h_launches, h_timing, sv_launches = timed(
        "sharded", sharded_phase, args.sharded_patients, CPU_PATIENTS, REPS,
        rate)
    gc.collect()
    torch.cuda.empty_cache()
    m_launches, f_timing, families = timed("families", families_phase,
                                             REPS, rate)
    gc.collect()
    torch.cuda.empty_cache()
    t_launches, b_timing, training = timed("training", training_phase, REPS,
                                           rate)
    gc.collect()
    torch.cuda.empty_cache()
    p_launches, shard_models = timed("sharded_models", sharded_models_phase,
                                     training["run"]["losses"][0])
    dryrun = timed("dryrun", dryrun_phase, dry_started,
                   shard_models.pop("dryrun_calls"))
    # B1-B3 are timed at the quickstart's (larger) shapes, B4 at the cohort
    # study's, B6's prefill kernel at the prefill's and its decode route at
    # the batcher's full-ring shape (L2 cleared); launches are summed over
    # both studies' first runs, the serving path (prefill + batcher) and the
    # sharded run
    timing.update({"segmented_scan": c_timing["segmented_scan"],
                   "flash_attention": s_timing, "flash_decode": decode,
                   "hash_partition_plan": h_timing,
                   "filter_compact_mask": mask_timing,
                   "flash_attention_bwd": b_timing,
                   "flash_decode_lse": lse_timing["gemma3 block"],
                   "flash_attention_f32": training["forward_fp32"],
                   "flash_attention_bwd_f32": training["backward_fp32"]})
    log(f"launches: quickstart {q_launches}, chunked {k_launches}, spec "
        f"corpus {f_launches}, service {v_launches}, cohort study "
        f"{c_launches}, serving {s_launches}, gemma3 prefill "
        f"{g_launches}, sharded (summed over ranks) {h_launches}, sharded "
        f"service (summed over ranks) {sv_launches}, families "
        f"{m_launches}, training {t_launches}")
    log(f"serving: B6 at the batcher's decode shape {json.dumps(decode)}")
    log(f"serving: B6 prefill at danube's shape {json.dumps(s_timing)}")
    for label, t in g_timing.items():
        log(f"gemma3: B6 prefill at {label}'s shape {json.dumps(t)}")
    for label, t in f_timing.items():
        log(f"families: B6 at {label}'s shape {json.dumps(t)}")
    log(f"families: {json.dumps(families)}")
    for label, t in lse_timing.items():
        log(f"sharded decode: B6's decode route with the LSE at {label}'s "
            f"shape {json.dumps(t)}")
    log(f"training: B6 backward at danube's training shape "
        f"{json.dumps(b_timing)}")
    log(f"training: {json.dumps(training)}")
    log(f"sharded models: {json.dumps(shard_models)}")
    log(f"dry run: {json.dumps(dryrun)}")
    log(f"serving: gates prefill {prefill_err}, teacher-forced "
        f"{json.dumps(tf)}, card vs CPU {cpu_err}; gemma3 prefill "
        f"{json.dumps(gemma_err)}, ring decode {json.dumps(ring_err)}")
    log(f"phases: {json.dumps({k: round(v, 3) for k, v in seconds.items()})}"
        f", total {time.perf_counter() - t_all:.3f} s")
    whole = f32_launches()
    ranks = shard_models["f32_launches"]
    log(f"launches: B6's fp32 kernels over the whole run (every phase, the "
        f"gates too): {json.dumps({k: whole[k] + ranks[k] for k in whole})}"
        f" ({json.dumps(ranks)} of them in phase 17's ranks)")

    launches = {k: sum(ph.get(k, 0) for ph in (
        q_launches, k_launches, f_launches, v_launches, c_launches,
        s_launches, g_launches, h_launches, sv_launches, m_launches,
        t_launches, p_launches)) for k in KERNELS}
    # the flash_attention count takes one per call on both of B6's routes:
    # its prefill kernel launched on the calls the decode route did not take
    launches["flash_attention"] -= launches["flash_decode"]
    records = []
    for k, (source, replaces) in KERNELS.items():
        t = timing[k]
        records.append({"name": k, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[k],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t.get("bound_by", "bytes"),
                        "library_ms": t["library_ms"]})
    log(smi)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    LOG["file"].close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
