"""The port's serving path against the reference's (``repro.serving``):
greedy decode against the prefill argmax, the same requests through both
``ContinuousBatcher``s in float32 giving identical tokens, the batcher's two
reference faults reproduced (ROADMAP C9), the ``SlotScheduler`` tests of
``tests/test_service.py`` run against the port's class, and the launcher."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as RLM
from repro.models.registry import ModelBundle as RefBundle
from repro.serving.batching import ContinuousBatcher as RefBatcher
from repro.serving.batching import Request as RefRequest
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import get_bundle
from repro_torch.models.registry import ModelBundle
from repro_torch.serving import (ContinuousBatcher, Request, SlotScheduler,
                                 make_serve_step)

ENGINES = ["torch", "cuda"]


def _f32_bundles(arch):
    """The reduced config in float32, as a reference and a port bundle with
    the same (reference-initialised) weights."""
    from repro.configs.archs import reduced_config as rrc
    from repro_torch.configs import reduced_config

    rcfg = dataclasses.replace(rrc(arch), dtype="float32")
    pcfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    ref = jax.tree.map(np.asarray, RLM.init_params(rcfg, jax.random.key(0)))
    return (RefBundle(rcfg), jax.tree.map(jnp.asarray, ref),
            ModelBundle(pcfg), lm_params_from_numpy(ref, pcfg, "cpu"))


def _prompts(n, lo, hi, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [[1] + rng.integers(8, vocab, size=rng.integers(lo, hi)).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("engine", ENGINES)
def test_greedy_decode_matches_prefill_argmax(engine):
    b = get_bundle("qwen2-1.5b", reduced=True)
    params = b.init(0, device="cpu")
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        3, b.cfg.vocab_size, (B, S)).astype(np.int32))
    pre = b.prefill(params, {"tokens": toks}, engine=engine)
    want = torch.argmax(pre[:, -1], dim=-1)
    cache = b.init_cache(B, 32, device="cpu")
    step = make_serve_step(b, engine=engine)
    for t in range(S):
        logits, cache = step(params, cache,
                             {"tokens": toks[:, t:t + 1], "pos": t})
    assert torch.equal(torch.argmax(logits[:, 0], dim=-1), want)


# the reference batcher's tokens by (arch, kv_len): run once for both
# engines' cases
_REF_TOKENS = {}


def _ref_tokens(arch, kv_len, rb, rparams, prompts):
    if (arch, kv_len) not in _REF_TOKENS:
        ref = RefBatcher(rb, rparams, n_slots=2, kv_len=kv_len)
        reqs = [RefRequest(rid=i, prompt=p, max_new=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            ref.submit(r)
        ref.run(max_steps=200)
        _REF_TOKENS[arch, kv_len] = [r.out for r in reqs]
    return _REF_TOKENS[arch, kv_len]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("arch,kv_len", [("h2o-danube-1.8b", 32),
                                         ("qwen2-1.5b", 48),
                                         ("deepseek-moe-16b", 48),
                                         ("recurrentgemma-2b", 32)])
def test_batcher_gives_the_reference_tokens(arch, kv_len, engine):
    """Six requests over two slots: reduced h2o-danube's caches are 16-slot
    rings that wrap (prompts up to 20 tokens, 8 new), qwen2's full caches,
    deepseek's MoE layers (capacity 1 at two tokens a step: colliding
    choices drop) and recurrentgemma's RG-LRU states beside 16-slot
    rings."""
    rb, rparams, pb, pparams = _f32_bundles(arch)
    prompts = _prompts(6, 4, 20, rb.cfg.vocab_size)
    port = ContinuousBatcher(pb, pparams, n_slots=2, kv_len=kv_len,
                             engine=engine)
    preqs = [Request(rid=i, prompt=p, max_new=8)
             for i, p in enumerate(prompts)]
    for p in preqs:
        port.submit(p)
    port.run(max_steps=200)
    assert all(r.done for r in preqs)
    assert [r.out for r in preqs] == _ref_tokens(arch, kv_len, rb, rparams,
                                                 prompts)


def _layer0(cache_port, cache_ref):
    """Layer 0's K cache from both: the port's list, the reference's first
    period, slot 0."""
    return (cache_port[0][0].numpy(),
            np.asarray(cache_ref["periods"]["slot0"][0][0]))


def test_admission_writes_into_every_slot_as_the_reference_does():
    """ROADMAP C9 (reference-side): admitting a prompt decodes every slot,
    so token 0's K/V lands at the prompt's positions in the other slot's
    cache too.  The port matches the reference."""
    rb, rparams, pb, pparams = _f32_bundles("llama3.2-3b")
    prompt = _prompts(1, 6, 7, rb.cfg.vocab_size)[0]
    ref = RefBatcher(rb, rparams, n_slots=2, kv_len=16)
    port = ContinuousBatcher(pb, pparams, n_slots=2, kv_len=16, engine="cuda")
    ref.submit(RefRequest(rid=0, prompt=prompt))
    port.submit(Request(rid=0, prompt=prompt))
    ref._admit()
    port._admit()
    got, want = _layer0(port.cache, ref.cache)
    n = len(prompt) - 1
    assert np.abs(got[1, :n]).min() > 0 and not got[1, n:].any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_step_decodes_every_slot_at_the_first_live_position():
    """ROADMAP C9 (reference-side): one step decodes all live slots at the
    first live slot's position, so slot 1 (prompt of 7) writes its new K/V
    at position 3, where slot 0 (prompt of 4) stands.  The port matches."""
    rb, rparams, pb, pparams = _f32_bundles("llama3.2-3b")
    prompts = [[1, 9, 10, 11], [1, 12, 13, 14, 15, 16, 17]]
    ref = RefBatcher(rb, rparams, n_slots=2, kv_len=16)
    port = ContinuousBatcher(pb, pparams, n_slots=2, kv_len=16, engine="cuda")
    for i, p in enumerate(prompts):
        ref.submit(RefRequest(rid=i, prompt=p))
        port.submit(Request(rid=i, prompt=p))
    port._admit()
    before = port.cache[0][0][1].clone()
    port.step()
    ref.step()
    after = port.cache[0][0][1]
    changed = [t for t in range(16) if not torch.equal(before[t], after[t])]
    assert changed == [3]
    got, want = _layer0(port.cache, ref.cache)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_launcher_serves_on_the_cpu(capsys):
    reqs = serve.main(["--arch", "h2o-danube-1.8b", "--requests", "3",
                       "--slots", "2", "--kv-len", "32", "--max-new", "4",
                       "--device", "cpu"])
    assert all(r.done and 1 <= len(r.out) <= 4 for r in reqs)
    assert "3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen2-moe-a2.7b",
                                  "recurrentgemma-2b", "xlstm-125m",
                                  "phi-3-vision-4.2b", "seamless-m4t-medium"])
def test_launcher_serves_every_family(arch, capsys):
    reqs = serve.main(["--arch", arch, "--requests", "3", "--slots", "2",
                       "--kv-len", "32", "--max-new", "4", "--device", "cpu"])
    assert all(r.done and 1 <= len(r.out) <= 4 for r in reqs)
    assert "3 requests" in capsys.readouterr().out


def test_batcher_defaults_to_the_parameters_device():
    b = get_bundle("qwen2-1.5b", reduced=True)
    params = b.init(0, device="cpu")
    eng = ContinuousBatcher(b, params, n_slots=2, kv_len=16)
    assert eng.cache[0][0].device.type == "cpu"


# ---------------------------------------------------------------------------
# SlotScheduler: tests/test_service.py's admission tests, on the port's class
# ---------------------------------------------------------------------------
def test_slot_scheduler_priority_then_fifo():
    sched = SlotScheduler(2)
    sched.submit("low1", key="a", priority=0)
    sched.submit("hi", key="b", priority=5)
    sched.submit("low2", key="a", priority=0)
    assert [x for x, _ in sched.admit()] == ["hi", "low1"]
    sched.release("b")
    assert [x for x, _ in sched.admit()] == ["low2"]


def test_slot_scheduler_per_key_quota_keeps_fifo_within_key():
    sched = SlotScheduler(4, per_key_quota=1)
    for i in range(3):
        sched.submit(f"a{i}", key="a")
    sched.submit("b0", key="b")
    assert [x for x, _ in sched.admit()] == ["a0", "b0"]  # a1/a2 over quota
    assert sched.queued() == 2
    sched.release("a")
    assert [x for x, _ in sched.admit()] == ["a1"]        # FIFO within key
    sched.release("a")
    assert [x for x, _ in sched.admit()] == ["a2"]


def test_slot_scheduler_bounded_queue():
    sched = SlotScheduler(1, max_queue=2)
    assert sched.submit("x") and sched.submit("y")
    assert not sched.submit("z")
    assert sched.queued() == 2


def test_slot_scheduler_fifo_with_non_comparable_items():
    sched = SlotScheduler(4)
    items = [{"q": i} for i in range(4)]          # dict: no __lt__
    for it in items:
        sched.submit(it, key="a", priority=3)     # all ties
    assert [x for x, _ in sched.admit()] == items
