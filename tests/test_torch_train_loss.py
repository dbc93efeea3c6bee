"""The port's training loss (``ModelBundle.train_loss``) against the
reference's ``jax.value_and_grad`` of its own, on the same numpy-seeded
weights (the reference's initialisers, every 1-d leaf replaced by noise)
and batch, for one reduced model of each family, in fp32, under both
attention engines (``cuda`` runs B6's plain forward and backward through
``FlashAttention`` on the CPU); then remat against no remat, and every
reduced bundle's loss and gradients on the CPU.

Tolerances: the loss within 1e-5 relative, each gradient leaf within 2e-5
of its largest |value| (the two sum in other orders; the largest seen is
5e-6)."""
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
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models.registry import ModelBundle
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_step import loss_and_grads

FAMILIES = ["h2o-danube-1.8b", "deepseek-moe-16b", "recurrentgemma-2b",
            "xlstm-125m", "phi-3-vision-4.2b", "seamless-m4t-medium"]
ENGINES = ["torch", "cuda"]
LOSS_TOL, GRAD_TOL = 1e-5, 2e-5


def _configs(arch, **kw):
    return (dataclasses.replace(ref_reduced_config(arch), dtype="float32",
                                **kw),
            dataclasses.replace(reduced_config(arch), dtype="float32", **kw))


def _case(rcfg, seed=0, B=2, S=32):
    """Noisy reference weights and a batch: tokens, a random loss mask, and
    the frontend's input (frames, image embeddings) where the family has
    one."""
    rng = np.random.default_rng(seed)
    init = RED.init_params if rcfg.is_encdec else RLM.init_params
    ref = jax.tree.map(
        lambda a: (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        if a.ndim == 1 else np.asarray(a),
        init(rcfg, jax.random.key(seed)))
    batch = {"tokens": rng.integers(3, rcfg.vocab_size, (B, S)
                                    ).astype(np.int32),
             "loss_mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if rcfg.is_encdec:
        batch["frames"] = rng.normal(size=(B, 64, rcfg.frontend_dim)
                                     ).astype(np.float32)
    if rcfg.frontend == "vision_patches":
        batch["image_embeds"] = rng.normal(
            size=(B, rcfg.n_frontend_tokens, rcfg.frontend_dim)
        ).astype(np.float32)
    return ref, batch


_REF = {}


def _reference(arch):
    """(cfgs, weights, batch, loss, grads in the port's layout), computed
    once per arch."""
    if arch not in _REF:
        rcfg, pcfg = _configs(arch)
        ref, batch = _case(rcfg)
        loss, grads = jax.jit(jax.value_and_grad(RefBundle(rcfg).train_loss))(
            jax.tree.map(jnp.asarray, ref),
            {k: jnp.asarray(v) for k, v in batch.items()})
        grads = lm_params_from_numpy(jax.tree.map(np.asarray, grads), pcfg,
                                     "cpu")
        _REF[arch] = (pcfg, ref, batch, float(loss), grads)
    return _REF[arch]


def _check(loss, grads, want_loss, want_grads, what):
    assert abs(float(loss) - want_loss) <= LOSS_TOL * abs(want_loss), \
        (what, float(loss), want_loss)
    for g, w in zip(tree_leaves(grads), tree_leaves(want_grads)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, g.shape)
        top = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= GRAD_TOL * top, \
            (what, float((g - w).abs().max()), top)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_grads_match_reference(arch, engine):
    pcfg, ref, batch, want_loss, want_grads = _reference(arch)
    params = lm_params_from_numpy(ref, pcfg, "cpu")
    loss, grads = loss_and_grads(
        ModelBundle(pcfg), params,
        {k: torch.from_numpy(v) for k, v in batch.items()}, engine)
    assert loss.dtype == torch.float32
    _check(loss, grads, want_loss, want_grads, (arch, engine))


def test_moe_aux_loss_is_the_first_period_router():
    """deepseek's load-balance term: 0.01 x the loss of layer
    ``len(head layers)``'s router (the reference's period 0 slot0), equal
    to the reference's on the same embeddings."""
    from repro.models import layers as RL
    from repro_torch.models import layers as L

    pcfg, ref, batch, _, _ = _reference("deepseek-moe-16b")
    rcfg = _configs("deepseek-moe-16b")[0]
    params = lm_params_from_numpy(ref, pcfg, "cpu")
    head = pcfg.first_dense_layers
    assert "router" in params["layers"][head]["ffn"]
    tokens = torch.from_numpy(batch["tokens"])
    got = L.moe_load_balance_loss(params["layers"][head]["ffn"],
                                  params["embed"][tokens], pcfg)
    first = jax.tree.map(lambda a: a[0], ref["periods"]["slot0"])
    want = RL.moe_load_balance_loss(first["ffn"],
                                    jnp.asarray(ref["embed"])[batch["tokens"]],
                                    rcfg)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "seamless-m4t-medium",
                                  "recurrentgemma-2b"])
def test_remat_matches_no_remat(arch, monkeypatch):
    """``cfg.remat`` recomputes each period layer (and each encoder and
    decoder layer) in the backward: the same loss, and the same gradients
    up to the order in which autograd sums a leaf's contributions (1e-6 of
    the largest |value|).  The torch engine's chunked attention, whose
    chunks are checkpointed too, is taken at 16-key chunks."""
    from repro_torch.models import layers as L

    monkeypatch.setattr(L, "_CHUNKED_THRESHOLD", 1 << 10)
    monkeypatch.setattr(L, "_KV_CHUNK", 16)
    rcfg, pcfg = _configs(arch)
    ref, batch = _case(rcfg, seed=3, B=2, S=64)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = lm_params_from_numpy(ref, pcfg, "cpu")
    out = [loss_and_grads(ModelBundle(dataclasses.replace(pcfg, remat=r)),
                          params, tb, "torch") for r in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        top = max(float(a.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-6 * top


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_reduced_bundle_trains_on_the_cpu(arch):
    """Every family's loss is finite and every parameter gets a finite
    gradient, nonzero somewhere (bf16, the reduced configs' own type)."""
    bundle = ModelBundle(reduced_config(arch))
    params = bundle.init(0, device="cpu")
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(
        3, bundle.cfg.vocab_size, (2, 16)).astype(np.int32))}
    if bundle.cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(2, 64, bundle.cfg.frontend_dim)).astype(np.float32))
    if bundle.cfg.frontend == "vision_patches":
        batch["image_embeds"] = torch.from_numpy(rng.normal(
            size=(2, bundle.cfg.n_frontend_tokens, bundle.cfg.frontend_dim)
        ).astype(np.float32))
    loss, grads = loss_and_grads(bundle, params, batch, "cuda")
    assert torch.isfinite(loss)
    for g, p in zip(tree_leaves(grads), tree_leaves(params)):
        assert g.dtype == p.dtype and bool(torch.isfinite(g).all())
    assert sum(bool(g.any()) for g in tree_leaves(grads)) \
        > len(tree_leaves(grads)) // 2
