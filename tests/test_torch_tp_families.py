"""Tensor-parallel layouts of the RG-LRU, xLSTM, encoder-decoder and vision
families, and the "pod" axis in a sharded step, on 4 gloo ranks on the
CPU against the port unsharded and against the reference on the same
inputs.

One spawn of 4 ranks (``launch.tasks_rank`` of the package's rank
functions) runs every sharded case.  Weights are the reference's reduced
configs' (``init_params`` from one key, fp32), carried to each rank's
blocks under the reference's rules (``interop.lm_params_from_numpy``).

* The families: ``train_loss``, its gradients (gathered) and ``prefill`` of
  reduced recurrentgemma-2b, xlstm-125m, seamless-m4t-medium and
  phi-3-vision-4.2b on (data, model) meshes (2, 2) and (1, 4), within
  ``test_torch_model_parallel.py``'s tolerances (loss 1e-5, each gradient
  leaf 1e-4 of its largest, logits 1e-5); the loss and gradients also
  against the reference's ``jax.value_and_grad`` of its ``train_loss`` on
  the same weights and batch, within the same tolerances.  (2, 2) runs
  the ``torch`` attention engine, (1, 4) the ``cuda`` one (B6's plain
  version on CPU tensors).  Every head divides here: 4 heads,
  recurrentgemma's one KV head shared; the loss mask puts 5 and 48 tokens
  on the data shards.
* Heads that do not divide: xLSTM with 2 heads on (1, 4), where mLSTM's
  and sLSTM's column blocks split heads and every rank runs the whole
  layer from gathered weights.
* One ZeRO-1 AdamW step of reduced recurrentgemma on (2, 2) against the
  unsharded step and the reference's step (its optimizer state and
  metrics: the reference's step leaves bf16 parameters).
* A9-pod: one compressed step (``compress_crosspod=True``) of reduced
  recurrentgemma on a (pod, data, model) = (2, 1, 2) mesh against the
  unsharded compressed step and the reference's compressed step (its
  step's body on its gradient: ``compress_grads_crosspod``, then
  ``adamw_update``).  The gradients differ by fp32 rounding,
  so an element within 1e-3 of a quantum from a rounding boundary of its
  int8 grid may land in the next bin: those are left out of the state's
  comparison (the rounding moves the gradients by ~1e-6 of their largest,
  1.3e-4 of a quantum).  The quantization itself is exact: a sharded
  leaf's blocks, quantized on their ranks with the logical scale, are the
  logical leaf's quantization bit for bit (the port's and the reference's
  ``compress_grads_crosspod`` of the whole leaf), and the rank whose block
  holds the largest |value| gives its scale to every rank.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import reduced_config as ref_reduced_config
from repro.models import encdec as RED
from repro.models import lm as RLM
from repro.models.registry import ModelBundle as RefBundle
from repro.train import grad_compression as RGC
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.optimizer import adamw_update as ref_adamw_update
from repro_torch.configs.archs import reduced_config
from repro_torch.distributed import launch
from repro_torch.interop import (lm_params_from_numpy, train_state_from_numpy,
                                 tree_map)
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models.registry import ModelBundle
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train import grad_compression as GC
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_step import loss_and_grads

N_RANKS = 4
TIMEOUT = 300
FAMILIES = ("recurrentgemma-2b", "xlstm-125m", "seamless-m4t-medium",
            "phi-3-vision-4.2b")
MESHES = ((2, 2), (1, 4))
ENGINE = {(2, 2): "torch", (1, 4): "cuda"}
TWO_HEADS = {"n_heads": 2}            # xLSTM heads that do not divide 4
CASE_CFG = {"two heads": ("xlstm-125m", TWO_HEADS)}    # else (arch, {})
STEP_ARCH = "recurrentgemma-2b"
POD_MESH = (2, 1, 2)
OPT = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)
ADAM_FLOOR = 1e-4            # chip_smoke's train_card_vs_cpu rule
BIN_EDGE = 1e-3              # of a quantum: int8 rounding boundaries
# a sharded leaf ("model" on its columns) whose largest |value| lies in
# the block of model rank 1, and a replicated leaf
CROSSPOD_SPECS = {"w": (None, "model"), "b": (None,)}


def _cfgs(arch, **kw):
    """The reference's and the port's reduced config of ``arch``, fp32."""
    return (dataclasses.replace(ref_reduced_config(arch), dtype="float32",
                                **kw),
            dataclasses.replace(reduced_config(arch), dtype="float32", **kw))


def _ref_params(arch, **kw):
    rcfg, _ = _cfgs(arch, **kw)
    init = RED.init_params if rcfg.is_encdec else RLM.init_params
    return jax.tree.map(np.asarray, init(rcfg, jax.random.key(0)))


def _batch(cfg, seed=1):
    """Tokens (4, 32), a loss mask whose data shards at (2, 2) (rows 0-1
    and 2-3) hold 5 and 48 tokens, and the frontend's input: 64 encoder
    frames, or one embedding a vision token."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (4, 32)
                                    ).astype(np.int32)}
    if cfg.is_encdec:        # the encoder-decoder's loss takes no mask
        batch["frames"] = rng.standard_normal(
            (4, 64, cfg.frontend_dim)).astype(np.float32)
        return batch
    mask = np.zeros((4, 32), np.float32)
    mask[0, 3:8] = 1
    mask[2:, 4:28] = 1
    batch["loss_mask"] = mask
    if cfg.frontend == "vision_patches":
        batch["image_embeds"] = rng.standard_normal(
            (4, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


def _state(params):
    return {"params": params,
            "opt": {"master": tree_map(lambda a: a.astype(np.float32),
                                       params),
                    "m": tree_map(np.zeros_like, params),
                    "v": tree_map(np.zeros_like, params),
                    "step": np.zeros((), np.int32)}}


def _crosspod_arrays():
    rng = np.random.default_rng(7)
    w = rng.standard_normal((8, 16)).astype(np.float32)
    w[3, 12] = 9.5           # columns 8-15: model rank 1's block
    return {"w": w, "b": rng.standard_normal(16).astype(np.float32)}


@pytest.fixture(scope="module")
def runs():
    cases = {}
    for arch in FAMILIES:
        _, pcfg = _cfgs(arch)
        cases[arch] = (_ref_params(arch), _batch(pcfg), pcfg)
    _, xcfg = _cfgs("xlstm-125m", **TWO_HEADS)
    cases["two heads"] = (_ref_params("xlstm-125m", **TWO_HEADS),
                          _batch(xcfg), xcfg)
    tasks = []
    for arch in FAMILIES:
        params, batch, pcfg = cases[arch]
        tasks += [(launch.loss_grads_rank, (pcfg, shape, params, batch,
                                            ENGINE[shape]))
                  for shape in MESHES]
    params, batch, pcfg = cases["two heads"]
    tasks.append((launch.loss_grads_rank, (pcfg, (1, 4), params, batch,
                                           ENGINE[(1, 4)])))
    params, batch, pcfg = cases[STEP_ARCH]
    state = _state(params)
    tasks.append((launch.train_step_rank, (pcfg, (2, 2), state, [batch],
                                           OPT)))
    tasks.append((launch.train_step_rank, (pcfg, POD_MESH, state, [batch],
                                           OPT, "float32", "torch", 1,
                                           True)))
    arrays = _crosspod_arrays()
    tasks.append((GC.crosspod_rank, (POD_MESH, arrays, CROSSPOD_SPECS)))
    got = launch.spawn(launch.tasks_rank, N_RANKS, (tasks,), device="cpu",
                       timeout=TIMEOUT)[0]
    it = iter(got)
    out = {"cases": cases, "state": state, "arrays": arrays}
    for arch in FAMILIES:
        for shape in MESHES:
            out[arch, shape] = next(it)
    out["two heads"] = next(it)
    out["zero"] = next(it)
    out["pod"] = next(it)
    out["crosspod"] = next(it)
    return out


def _unsharded(params, batch, pcfg, engine):
    p = lm_params_from_numpy(params, pcfg, "cpu")
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = loss_and_grads(ModelBundle(pcfg), p, b, engine)
    with torch.no_grad():
        logits = ModelBundle(pcfg).prefill(p, b, engine)
    return float(loss), grads, logits.numpy()


def _ref_cfg(key):
    arch, kw = CASE_CFG.get(key, (key, {}))
    return _cfgs(arch, **kw)[0]


_REF = {}


def _reference_raw(runs, key):
    """The reference's ``jax.value_and_grad`` of its ``train_loss`` on a
    case's weights and batch, once a case."""
    if key not in _REF:
        params, batch, _ = runs["cases"][key]
        _REF[key] = jax.jit(jax.value_and_grad(
            RefBundle(_ref_cfg(key)).train_loss))(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    return _REF[key]


def _reference(runs, key):
    """The reference's loss and gradients, in the port's layout."""
    loss, grads = _reference_raw(runs, key)
    return float(loss), lm_params_from_numpy(
        jax.tree.map(np.asarray, grads), runs["cases"][key][2], "cpu")


def _close_grads(got, loss, grads):
    assert abs(got["loss"] - loss) <= 1e-5, (got["loss"], loss)
    for a, g in zip(tree_leaves(got["grads"]), tree_leaves(grads)):
        g = g.numpy()
        assert a.shape == g.shape
        assert float(np.abs(a - g).max()) <= 1e-4 * max(
            float(np.abs(g).max()), 1e-30)


def _close(got, loss, grads, logits):
    _close_grads(got, loss, grads)
    assert got["prefill"].shape == logits.shape
    assert float(np.abs(got["prefill"] - logits).max()) <= 1e-5


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_grads_prefill_equal_unsharded(runs, arch, shape):
    params, batch, pcfg = runs["cases"][arch]
    _close(runs[arch, shape], *_unsharded(params, batch, pcfg,
                                          ENGINE[shape]))
    _close_grads(runs[arch, shape], *_reference(runs, arch))


def test_xlstm_heads_that_do_not_divide_run_whole(runs):
    params, batch, pcfg = runs["cases"]["two heads"]
    assert pcfg.n_heads % 4 and pcfg.d_model % 4 == 0   # split heads
    _close(runs["two heads"], *_unsharded(params, batch, pcfg,
                                          ENGINE[(1, 4)]))
    _close_grads(runs["two heads"], *_reference(runs, "two heads"))


def _step(state_np, batch, pcfg, compress):
    """The unsharded step: the new state, its metrics and the gradient
    of the step's batch."""
    state = train_state_from_numpy(state_np, pcfg, "cpu")
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = loss_and_grads(ModelBundle(pcfg), state["params"], b,
                           "torch")[1]
    step = make_train_step(ModelBundle(pcfg), AdamWConfig(**OPT),
                           compress_crosspod=compress,
                           pod_axis="pod" if compress else None,
                           engine="torch", param_dtype=torch.float32)
    state, m = step(state, b)
    return state, m, grads


def _ill(g, compress):
    """Elements left out of a state comparison: gradients under
    ``ADAM_FLOOR`` of their leaf's largest (Adam turns their rounding into
    a fraction of lr), or, compressed, within ``BIN_EDGE`` of a quantum
    from an int8 rounding boundary."""
    g = g.numpy()
    top = np.abs(g).max()
    if not compress:
        return (g != 0) & (np.abs(g) < ADAM_FLOOR * top)
    frac = np.abs(g / (max(top, 1e-12) / 127.0)) % 1.0
    return np.abs(frac - 0.5) < BIN_EDGE


def _same_step(got, state, m, grads, compress):
    """The sharded step's metrics and state against the unsharded one's.
    Compressed, the elements that changed bins move the clipping norm
    (by ``norm``, relative, at most 1e-4): m scales with the clipping
    factor and v with its square, so their bounds widen by ``norm`` and
    twice ``norm``."""
    assert abs(got["metrics"][0]["loss"] - float(m["loss"])) <= 1e-5
    norm = abs(got["metrics"][0]["grad_norm"] - float(m["grad_norm"])) \
        / float(m["grad_norm"])
    assert norm <= (1e-4 if compress else 1e-5)
    slack = {"master": 0.0, "m": norm, "v": 2 * norm} if compress \
        else dict.fromkeys(("master", "m", "v"), 0.0)
    for key in ("master", "m", "v"):
        for a, b, g in zip(tree_leaves(got["state"]["opt"][key]),
                           tree_leaves(state["opt"][key]),
                           tree_leaves(grads)):
            b, ill = b.numpy(), _ill(g, compress)
            top = max(float(np.abs(b).max()), 1e-30)
            assert float(np.abs(a - b)[~ill].max(initial=0.0)) <= (
                1e-5 + slack[key]) * (1.0 if key == "master" else top), key
    if "params" not in state:         # the reference's: bf16 parameters
        return
    for a, b, g in zip(tree_leaves(got["state"]["params"]),
                       tree_leaves(state["params"]), tree_leaves(grads)):
        ill = _ill(g, compress)
        assert float(np.abs(a - b.numpy())[~ill].max(initial=0.0)) <= 1e-5


def _ref_step(runs, compress):
    """The reference's step on the same state and batch, as its
    ``make_train_step`` runs it for one microbatch: its gradient
    (``_reference_raw``), ``compress_grads_crosspod`` over "pod" where
    compressing, ``adamw_update``.  Its optimizer state (in the port's
    layout), its metrics and its gradient."""
    pcfg = runs["cases"][STEP_ARCH][2]
    loss, grads = _reference_raw(runs, STEP_ARCH)
    if compress:
        grads = RGC.compress_grads_crosspod(grads, "pod")
    _, new, m = jax.jit(lambda g, o: ref_adamw_update(
        RefAdamWConfig(**OPT), g, o))(
        grads, jax.tree.map(jnp.asarray, runs["state"]["opt"]))
    opt = {k: lm_params_from_numpy(jax.tree.map(np.asarray, new[k]), pcfg,
                                   "cpu")
           for k in ("master", "m", "v")}
    return {"opt": opt}, dict(m, loss=loss), _reference(runs, STEP_ARCH)[1]


def test_zero1_step_of_recurrentgemma_equals_the_unsharded_step(runs):
    _, batch, pcfg = runs["cases"][STEP_ARCH]
    _same_step(runs["zero"], *_step(runs["state"], batch, pcfg, False),
               compress=False)
    _same_step(runs["zero"], *_ref_step(runs, False), compress=False)


def test_pod_compressed_step_equals_the_unsharded_compressed_step(runs):
    """DP over ("pod", "data"), ZeRO-1 over "data" (of size 1: whole),
    the gradient quantized with each logical tensor's one scale."""
    _, batch, pcfg = runs["cases"][STEP_ARCH]
    state, m, grads = _step(runs["state"], batch, pcfg, True)
    ill = np.concatenate([_ill(g, True).ravel() for g in tree_leaves(grads)])
    assert ill.mean() < 0.01
    _same_step(runs["pod"], state, m, grads, compress=True)
    _same_step(runs["pod"], *_ref_step(runs, True), compress=True)


def test_sharded_leaf_takes_the_logical_scale_on_every_rank(runs):
    got, arrays = runs["crosspod"], runs["arrays"]
    want = GC.compress_grads_crosspod(
        {k: torch.from_numpy(v) for k, v in arrays.items()})
    ref = RGC.compress_grads_crosspod(
        {k: jnp.asarray(v) for k, v in arrays.items()}, "pod")
    for k in arrays:
        np.testing.assert_array_equal(got["out"][k], want[k].numpy())
        np.testing.assert_array_equal(got["out"][k], np.asarray(ref[k]))
    top = np.float32(np.abs(arrays["w"]).max())
    assert np.all(got["scales"]["w"] == np.float32(top / np.float32(127.0)))
    assert np.abs(arrays["w"][:, :8]).max() < top      # rank 0's block
    # the replicated leaf is whole on every rank: its own scale
    assert np.all(got["scales"]["b"] == np.float32(
        np.abs(arrays["b"]).max() / np.float32(127.0)))


class _Rank:
    """A rank of a (1, 2) mesh that raises before any collective."""
    axis_names = ("data", "model")
    shape = {"data": 1, "model": 2}
    coords = {"data": 0, "model": 0}

    def group_of(self, *axes):
        return None


def _decode_step(which):
    _, cfg = _cfgs("recurrentgemma-2b")
    x = torch.zeros((1, 1, cfg.d_model))
    pos = torch.zeros((1, 1), dtype=torch.int32)
    if which == "rglru":
        p = ModelBundle(cfg).init(0, "cpu")["layers"][0]["mixer"]
        return R.rglru(p, x, cfg, state=R.rglru_init_state(
            cfg, 1, torch.float32, "cpu"))
    p = ModelBundle(cfg).init(0, "cpu")["layers"][2]["mixer"]
    kv = torch.zeros((1, 4, cfg.n_kv_heads, cfg.head_dim_))
    if which == "cross":
        return L.cross_attention(p, x, kv, kv, cfg, positions=pos)
    return L.attention(p, x, cfg, kind="attn", positions=pos,
                       cache=(kv, kv.clone()), cache_pos=0)


@pytest.mark.parametrize("which", ["attention", "cross", "rglru"])
def test_decode_under_a_model_axis_waits_for_a9_sp(which):
    """A decode step under a model axis reads its cache's specs
    (``tests/test_torch_sharded_decode.py`` runs it): a bare state, whose
    layout the rank's shapes cannot tell, is refused before any
    collective."""
    from repro_torch.distributed import hints

    with hints.use_mesh(_Rank()), pytest.raises(ValueError,
                                                match="cache's specs"):
        _decode_step(which)
