"""The port's training runtime (``repro_torch.train``,
``repro_torch.launch.train``) against the reference's (``repro.train``,
``repro.launch.train``) on the CPU: the learning-rate schedule, AdamW
(seeded trees, bias correction, clipping), the global norm, int8 gradient
compression (exact) and its psum over two gloo ranks, one train step of
reduced h2o-danube-1.8b in fp32 from the same state (master, m, v,
grad_norm, lr, loss) with and without microbatches, the bf16 cast of every
parameter after a step (ROADMAP C16, matched), checkpoints (round trip,
bit-deterministic restart, the async writer's ``keep``), the launcher's
resume, and the claims token stream (the reference's first batches,
exactly).

Tolerances: 1e-6 relative for the optimizer's arithmetic on equal inputs
(XLA and torch round exp/pow/cos within an ulp); after one train step, m
and v within 1e-5 of their largest |value| and master within 1e-5
absolute (the gradients agree to ~2e-6 of their largest |value|; step 1
moves each element by lr g / (|g| + eps), lr = 5e-5 here)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import reduced_config as ref_reduced_config
from repro.launch import train as RLT
from repro.models import lm as RLM
from repro.models.registry import ModelBundle as RefBundle
from repro.train import grad_compression as RGC
from repro.train import optimizer as RO
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.distributed import launch as dlaunch
from repro_torch.interop import lm_params_from_numpy, train_state_from_numpy
from repro_torch.launch import train as LT
from repro_torch.models.registry import ModelBundle, get_bundle
from repro_torch.train import (AdamWConfig, AsyncCheckpointer, adamw_init,
                               adamw_update, cosine_lr, init_train_state,
                               latest_step, make_train_step,
                               restore_checkpoint, save_checkpoint)
from repro_torch.train import grad_compression as GC
from repro_torch.train.optimizer import _global_norm, tree_leaves

OPT = dict(lr_peak=1e-3, warmup_steps=20, total_steps=100)  # the launcher's


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_cosine_lr_matches_reference():
    cfg = dict(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = cosine_lr(AdamWConfig(**cfg), torch.tensor(s, dtype=torch.int32))
        want = RO.cosine_lr(RO.AdamWConfig(**cfg), jnp.int32(s))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-12)


def _trees(rng):
    """A parameter tree (bf16 and fp32 leaves, nested lists) and two
    gradient trees, the first large enough to be clipped."""
    shapes = {"a": (7, 5), "b": [(3,), (4, 6)], "c": {"d": (2, 3, 4)}}

    def make(scale, dtype):
        def leaf(sh):
            return (scale * rng.normal(size=sh)).astype(dtype)
        return {"a": leaf(shapes["a"]),
                "b": [leaf(s) for s in shapes["b"]],
                "c": {"d": leaf(shapes["c"]["d"])}}

    return make(0.5, np.float32), make(3.0, np.float32), make(0.01, np.float32)


def test_adamw_update_matches_reference():
    """Two steps (bias correction, clipping of the first, weight decay):
    new params (bf16), master, m, v, step, lr and grad_norm."""
    rng = np.random.default_rng(0)
    params, g1, g2 = _trees(rng)
    cfg = dict(lr_peak=1e-2, warmup_steps=1, total_steps=10, grad_clip=1.0)
    rstate = RO.adamw_init(jax.tree.map(jnp.asarray, params))
    pparams = jax.tree.map(torch.from_numpy, params)
    pstate = adamw_init(pparams)
    for g in (g1, g2):
        rnew, rstate, rm = RO.adamw_update(RO.AdamWConfig(**cfg),
                                           jax.tree.map(jnp.asarray, g),
                                           rstate)
        pnew, pstate, pm = adamw_update(AdamWConfig(**cfg),
                                        jax.tree.map(torch.from_numpy, g),
                                        pstate)
        assert int(pstate["step"]) == int(rstate["step"])
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(pm[key]), float(rm[key]),
                                       rtol=1e-6)
        for name in ("master", "m", "v"):
            for a, b in zip(tree_leaves(pstate[name]),
                            jax.tree.leaves(rstate[name])):
                np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                           atol=1e-9)
        for a, b in zip(tree_leaves(pnew), jax.tree.leaves(rnew)):
            assert a.dtype == torch.bfloat16 and str(b.dtype) == "bfloat16"
            np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                       rtol=2 ** -8)
    assert float(pm["grad_norm"]) < 1.0 < float(
        _global_norm(jax.tree.map(torch.from_numpy, g1)))


def test_global_norm_matches_reference():
    _, g, _ = _trees(np.random.default_rng(1))
    got = _global_norm(jax.tree.map(torch.from_numpy, g))
    want = RO._global_norm(jax.tree.map(jnp.asarray, g))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_adamw_update_in_place_keeps_buffers():
    """The state's tensors take the update in place (the reference donates
    its state); parameters of ``param_dtype`` too."""
    params = {"w": torch.ones(4, 3, dtype=torch.bfloat16)}
    state = adamw_init(params)
    master = state["master"]["w"]
    new, state2, _ = adamw_update(AdamWConfig(lr_peak=0.1, warmup_steps=1),
                                  {"w": torch.ones(4, 3)}, state,
                                  params=params)
    assert state2 is state and state["master"]["w"] is master
    assert new["w"] is params["w"] and not torch.equal(
        params["w"], torch.ones(4, 3, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------
def _grad_arrays(seed, n=4096):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n).astype(np.float32) * rng.uniform(0.1, 10.0)


def test_quantize_int8_matches_reference_exactly():
    for seed in range(3):
        x = _grad_arrays(seed)
        q, s = GC.quantize_int8(torch.from_numpy(x))
        rq, rs = RGC.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)
        np.testing.assert_array_equal(GC.dequantize_int8(q, s).numpy(),
                                      np.asarray(RGC.dequantize_int8(rq, rs)))
    q, s = GC.quantize_int8(torch.zeros(5))
    assert float(s) == float(np.float32(1e-12) / np.float32(127.0))


def test_error_feedback_and_crosspod_match_reference():
    err = torch.zeros(4096)
    rerr = jnp.zeros(4096, jnp.float32)
    for t in range(5):
        g = _grad_arrays(10 + t)
        sent, err = GC.ef_compress_step(torch.from_numpy(g), err)
        rsent, rerr = RGC.ef_compress_step(jnp.asarray(g), rerr)
        np.testing.assert_array_equal(sent.numpy(), np.asarray(rsent))
        np.testing.assert_array_equal(err.numpy(), np.asarray(rerr))
    tree = {"a": _grad_arrays(20), "b": [_grad_arrays(21, 17)]}
    got = GC.compress_grads_crosspod(jax.tree.map(torch.from_numpy, tree))
    want = RGC.compress_grads_crosspod(jax.tree.map(jnp.asarray, tree),
                                       "pod")
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_psum_compressed_on_two_gloo_ranks():
    """int32 sum of both ranks' int8 payloads times the larger scale, on
    every rank."""
    arrays = [_grad_arrays(30), _grad_arrays(31)]
    out = dlaunch.spawn(GC.psum_rank, 2, (arrays,), device="cpu",
                        timeout=120.0)
    qs = [RGC.quantize_int8(jnp.asarray(a)) for a in arrays]
    total = sum(np.asarray(q, np.int32) for q, _ in qs)
    want = total.astype(np.float32) * max(np.float32(s) for _, s in qs)
    for got in out:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _danube_state(seed=0):
    rcfg = dataclasses.replace(ref_reduced_config("h2o-danube-1.8b"),
                               dtype="float32")
    pcfg = dataclasses.replace(reduced_config("h2o-danube-1.8b"),
                               dtype="float32")
    ref = jax.tree.map(np.asarray, RLM.init_params(rcfg, jax.random.key(seed)))
    rstate = {"params": ref, "opt": jax.tree.map(np.asarray,
                                                 RO.adamw_init(ref))}
    return rcfg, pcfg, rstate


def _batch(cfg, seed, B=4, S=32):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(3, cfg.vocab_size, (B, S)
                                   ).astype(np.int32),
            "loss_mask": (rng.random((B, S)) < 0.9).astype(np.float32)}


_STEP = {}


def _ref_step(microbatches):
    """The reference's first train step of reduced danube in fp32:
    (configs, state before, batch, state after, metrics), once per
    ``microbatches``."""
    if microbatches not in _STEP:
        rcfg, pcfg, rstate = _danube_state()
        batch = _batch(rcfg, 1)
        step = jax.jit(ref_make_train_step(
            RefBundle(rcfg), RO.AdamWConfig(**OPT), microbatches=microbatches))
        rnew, rm = step(jax.tree.map(jnp.asarray, rstate),
                        {k: jnp.asarray(v) for k, v in batch.items()})
        _STEP[microbatches] = (pcfg, rstate, batch, rnew, rm)
    return _STEP[microbatches]


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_train_step_matches_reference(microbatches, engine):
    """One step of reduced danube in fp32 from the same state (carried by
    ``interop.train_state_from_numpy``)."""
    pcfg, rstate, batch, rnew, rm = _ref_step(microbatches)
    state = train_state_from_numpy(rstate, pcfg, "cpu")
    pstep = make_train_step(ModelBundle(pcfg), AdamWConfig(**OPT),
                            microbatches=microbatches, engine=engine)
    new, m = pstep(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-5)
    assert float(m["lr"]) == float(rm["lr"])
    assert int(new["opt"]["step"]) == 1
    for name, atol in (("m", None), ("v", None), ("master", 1e-5)):
        want = lm_params_from_numpy(jax.tree.map(np.asarray,
                                                 rnew["opt"][name]),
                                    pcfg, "cpu")
        for a, b in zip(tree_leaves(new["opt"][name]), tree_leaves(want)):
            tol = atol if atol is not None else \
                1e-5 * max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) <= tol, (name, a.shape)


def test_train_step_casts_params_to_bf16_as_the_reference_does():
    """ROADMAP C16: ``adamw_update``'s ``param_dtype`` defaults to bf16 and
    the train step never passes another, so after one step every parameter
    of an fp32 model is bf16 in both packages (the fp32 routers and gates
    of bf16 models too); the port's master stays fp32, a second step runs
    the fp32 model on bf16 weights as the reference's does, and
    ``param_dtype=torch.float32`` keeps them fp32."""
    pcfg, rstate, batch, rnew, _ = _ref_step(1)
    assert {str(x.dtype) for x in jax.tree.leaves(rnew["params"])} == \
        {"bfloat16"}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    state = train_state_from_numpy(rstate, pcfg, "cpu")
    assert {x.dtype for x in tree_leaves(state["params"])} == {torch.float32}
    step = make_train_step(ModelBundle(pcfg), AdamWConfig(**OPT))
    new, _ = step(state, tb)
    assert {x.dtype for x in tree_leaves(new["params"])} == {torch.bfloat16}
    assert {x.dtype for x in tree_leaves(new["opt"]["master"])} == \
        {torch.float32}
    new, m = step(new, tb)
    assert torch.isfinite(m["loss"])
    state = train_state_from_numpy(rstate, pcfg, "cpu")
    kept, _ = make_train_step(ModelBundle(pcfg), AdamWConfig(**OPT),
                              param_dtype=torch.float32)(state, tb)
    assert {x.dtype for x in tree_leaves(kept["params"])} == {torch.float32}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
ARCH = "xlstm-125m"   # the reference's training tests' (bf16 with fp32 gates)


def _small_batch(cfg, seed, B=4, S=32):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(
        3, cfg.vocab_size, (B, S)).astype(np.int32))}


def _leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_round_trip(tmp_path):
    b = get_bundle(ARCH, reduced=True)
    state = init_train_state(b, 0, "cpu")
    state, _ = make_train_step(b, AdamWConfig(**OPT))(
        state, _small_batch(b.cfg, 1))
    path = save_checkpoint(str(tmp_path), 1, state, meta={"arch": ARCH})
    assert os.path.basename(path) == "step_00000001"
    assert latest_step(str(tmp_path)) == 1
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    restored, manifest = restore_checkpoint(str(tmp_path), 1, state,
                                            device="cpu")
    assert manifest["arch"] == ARCH and manifest["step"] == 1
    dtypes = {v["dtype"] for v in manifest["leaves"].values()}
    assert dtypes == {"bfloat16", "float32", "int32"}
    assert _leaves_equal(restored, state)
    with pytest.raises(ValueError, match="shape"):
        bad = {"params": {"embed": torch.zeros(3)}, "opt": state["opt"]}
        restore_checkpoint(str(tmp_path), 1, bad, device="cpu")


def test_checkpoint_restart_is_bit_deterministic(tmp_path):
    """Train 6 steps; against train 3, checkpoint, restore, train 3: the
    same parameters and optimizer state, bit for bit (the reference's
    test)."""
    b = get_bundle(ARCH, reduced=True)
    step = make_train_step(b, AdamWConfig(lr_peak=1e-3, warmup_steps=2,
                                          total_steps=10))
    batches = [_small_batch(b.cfg, 100 + t) for t in range(6)]
    state_a = init_train_state(b, 0, "cpu")
    for t in range(6):
        state_a, _ = step(state_a, batches[t])
    state_b = init_train_state(b, 0, "cpu")
    for t in range(3):
        state_b, _ = step(state_b, batches[t])
    save_checkpoint(str(tmp_path), 3, state_b, meta={"arch": ARCH})
    restored, manifest = restore_checkpoint(str(tmp_path), 3, state_b,
                                            device="cpu")
    assert manifest["arch"] == ARCH
    for t in range(3, 6):
        restored, _ = step(restored, batches[t])
    assert _leaves_equal(restored, state_a)


def test_async_checkpointer_keeps_the_newest(tmp_path):
    b = get_bundle(ARCH, reduced=True)
    state = init_train_state(b, 0, "cpu")
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        ck.save(s, state)
        # the state is on the host when save returns: changing it now
        # does not reach the checkpoint
        state["opt"]["step"].add_(1)
    ck.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [20, 30]
    restored, _ = restore_checkpoint(str(tmp_path), 30, state, device="cpu")
    assert int(restored["opt"]["step"]) == 2


# ---------------------------------------------------------------------------
# the launcher and the claims stream
# ---------------------------------------------------------------------------
_STREAM = {}


def _streams():
    """The first 3 batches of both packages' claims streams (64 patients,
    4 x 64 tokens, vocab 512), built once."""
    if not _STREAM:
        kw = dict(seq_len=64, batch=4, vocab=512, seed=3, n_patients=64)
        ref = RLT.claims_token_stream(**kw)
        port = LT.claims_token_stream(**kw, device="cpu")
        _STREAM["pairs"] = [(next(ref), next(port)) for _ in range(3)]
    return _STREAM["pairs"]


@pytest.mark.parametrize("t", range(3))
def test_claims_token_stream_matches_reference(t):
    want, got = _streams()[t]
    assert got["tokens"].dtype == torch.int32
    assert got["loss_mask"].dtype == torch.float32
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["loss_mask"].numpy(),
                                  np.asarray(want["loss_mask"]))
    assert got["loss_mask"].sum() > 0


def test_launcher_resumes_where_it_stopped(tmp_path):
    """4 steps with a checkpoint every 2, then a second call to 6 steps:
    it restores step 4, replays the data cursor, and ends on the losses
    and state of one 6-step run (reduced danube: every leaf bf16)."""
    arch = "h2o-danube-1.8b"
    kw = dict(batch=2, seq_len=32, seed=1, device="cpu", n_patients=64,
              log_every=100)
    full = LT.train(arch, steps=6, **kw)
    LT.train(arch, steps=4, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    assert latest_step(str(tmp_path)) == 4
    rest = LT.train(arch, steps=6, ckpt_dir=str(tmp_path), ckpt_every=2,
                    **kw)
    assert len(rest["losses"]) == 2
    assert rest["losses"] == full["losses"][4:]
    assert _leaves_equal(rest["state"], full["state"])
    with pytest.raises(ValueError, match="frames"):
        LT.train("seamless-m4t-medium", steps=1, **kw)


def test_restore_takes_the_templates_dtypes_as_the_reference_does(tmp_path):
    """ROADMAP C16's corollary: the launcher restores into a fresh state,
    whose fp32-declared leaves (xlstm's gates) take the checkpoint's bf16
    values back as fp32, as the reference's ``restore_checkpoint`` casts to
    its template; a step later every parameter is bf16 again."""
    b = get_bundle(ARCH, reduced=True)
    fresh = init_train_state(b, 0, "cpu")
    step = make_train_step(b, AdamWConfig(**OPT))
    state, _ = step(init_train_state(b, 0, "cpu"), _small_batch(b.cfg, 7))
    save_checkpoint(str(tmp_path), 1, state)
    restored, _ = restore_checkpoint(str(tmp_path), 1, fresh, device="cpu")
    gates = [(a, c) for a, c in zip(tree_leaves(restored["params"]),
                                    tree_leaves(state["params"]))
             if a.dtype == torch.float32]
    assert gates and all(c.dtype == torch.bfloat16 and torch.equal(
        a, c.float()) for a, c in gates)
    again, _ = step(restored, _small_batch(b.cfg, 8))
    assert {x.dtype for x in tree_leaves(again["params"])} == \
        {torch.bfloat16}
