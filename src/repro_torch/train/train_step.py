"""Train-step builder (the port of ``repro/train/train_step.py``): loss ->
gradients -> clip -> AdamW, with optional microbatch accumulation and
optional cross-pod gradient compression.

A train state is ``{"params": tree, "opt": adamw state}``.  The step
differentiates ``bundle.train_loss`` with ``torch.autograd.grad`` with
respect to detached views of the parameters (so the parameters themselves
never require grad and take their update in place), then updates the state
in place (``optimizer.adamw_update``; the reference donates its state).
Profiler ranges ``train_step.forward``, ``.backward`` and ``.optimizer``
mark the three parts in a trace (no cost without a profiler).

Under an ambient mesh (``distributed.hints.use_mesh``) the state holds
this rank's blocks (``init_train_state(..., mesh=)``, ``state_shardings``)
and the batch its block over the data axes: the loss is the global masked
mean (``models.lm.cross_entropy``), the gradients are summed over the data
axes (one all-reduce a dtype, after the microbatches), and AdamW runs
ZeRO-1 (``train.optimizer``).  Microbatch ``i`` is every data rank's
``i``-th part of its rows, normalized as one batch: the reference's
microbatch ``i`` of the global batch whose rows come in that order.  On a
mesh with a "pod" axis, DP runs over ("pod", "data") (``hints.dp_axes``):
the batch is split and the gradients summed over both, while ZeRO-1 shards
the optimizer's state over "data" only, as the reference's rules do.
Cross-pod compression quantizes the summed, logical gradient, as the
reference's step does after its full DP reduction: a TP-sharded leaf's
int8 scale is the largest |value| over all its blocks
(``grad_compression.compress_grads_crosspod`` with the params' specs).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch.profiler import record_function

from repro_torch.distributed import comm, hints, sharding
from repro_torch.interop import tree_map
from repro_torch.models.registry import ModelBundle
from repro_torch.train.grad_compression import compress_grads_crosspod
from repro_torch.train.optimizer import (AdamWConfig, abstract_opt_state,
                                         adamw_init, adamw_update,
                                         tree_leaves, tree_unflatten)

__all__ = ["TrainState", "make_train_step", "init_train_state",
           "abstract_train_state", "loss_and_grads", "state_shardings",
           "reduce_grads"]

TrainState = Dict[str, Any]  # {"params": ..., "opt": adamw state}


def abstract_train_state(bundle: ModelBundle) -> TrainState:
    """A train state's logical shapes and dtypes as meta tensors."""
    params = bundle.abstract_params()
    return {"params": params, "opt": abstract_opt_state(params)}


def state_shardings(bundle: ModelBundle, mesh) -> Dict[str, Any]:
    """The spec tree of a train state on ``mesh``: TP specs for the
    params, ZeRO-1 specs for master, m and v, the step whole."""
    abstract = bundle.abstract_params()
    opt = sharding.opt_state_shardings(bundle.cfg, mesh, abstract)
    return {"params": sharding.param_shardings(bundle.cfg, mesh, abstract),
            "opt": {"master": opt, "m": opt, "v": opt, "step": ()}}


def init_train_state(bundle: ModelBundle, seed: int = 0, device=None,
                     mesh=None) -> TrainState:
    """Random weights from ``seed`` on ``device`` (None = CUDA) and a fresh
    AdamW state; with a ``mesh``, this rank's blocks of both."""
    params = bundle.init(seed, device=device, mesh=mesh)
    if mesh is None:
        return {"params": params, "opt": adamw_init(params)}
    specs = state_shardings(bundle, mesh)["opt"]["master"]
    return {"params": params, "opt": adamw_init(params, mesh, specs)}


def reduce_grads(grads, mesh):
    """The gradients summed over the mesh's data axes (one all-reduce of
    the concatenated leaves of each dtype)."""
    dp = sharding.data_axes(mesh)
    if not dp:
        return grads
    group = mesh.group_of(*dp)
    leaves = tree_leaves(grads)
    out = list(leaves)
    for dt in sorted({g.dtype for g in leaves}, key=str):
        idx = [i for i, g in enumerate(leaves) if g.dtype == dt]
        flat = comm.all_reduce_sum(
            torch.cat([leaves[i].reshape(-1) for i in idx]), group)
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return tree_unflatten(grads, out)


def loss_and_grads(bundle: ModelBundle, params, batch, engine: str = "auto"):
    """``(loss, grads)`` of ``bundle.train_loss`` at ``params``: the loss
    detached, the gradients a tree shaped as ``params`` in each leaf's dtype
    (zeros for a leaf the loss does not reach, as ``jax.grad`` gives);
    under an ambient mesh, summed over its data axes."""
    loss, grads = _local_loss_and_grads(bundle, params, batch, engine)
    mesh = hints.current_mesh()
    return loss, grads if mesh is None else reduce_grads(grads, mesh)


def _local_loss_and_grads(bundle: ModelBundle, params, batch, engine):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with record_function("train_step.forward"):
        loss = bundle.train_loss(tree_unflatten(params, leaves), batch,
                                 engine=engine)
    with record_function("train_step.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(bundle: ModelBundle, opt_cfg: Optional[AdamWConfig] = None,
                    microbatches: int = 1, compress_crosspod: bool = False,
                    pod_axis=None, engine: str = "auto",
                    param_dtype=torch.bfloat16
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]], Any]:
    """Builds ``train_step(state, batch) -> (state, metrics)``.

    ``microbatches > 1``: the batch is split on axis 0 and the gradients of
    the parts accumulate in fp32 from zeros and are divided by the count
    (the reference's ``lax.scan``), as is the loss.  ``compress_crosspod``
    with a ``pod_axis``: the gradients are quantized to int8 and back
    (``grad_compression``), each logical tensor with one scale.
    ``pod_axis`` is kept for the reference's signature, where the
    compression runs only when both are given; the port reads nothing else
    of it (the reduction over "pod" is ``reduce_grads``'s).  ``engine`` is
    the attention engine of ``models.layers``.  ``param_dtype`` is the type
    the parameters take after a step: bf16, the reference's (it never
    passes another, ROADMAP C16), or fp32 for a run that stays fp32 end to
    end."""
    opt_cfg = opt_cfg or AdamWConfig()
    zero = {}                   # the last mesh's TP and ZeRO-1 specs

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        mesh = hints.current_mesh()
        if microbatches == 1:
            loss, grads = _local_loss_and_grads(bundle, params, batch,
                                                engine)
        else:
            parts = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                  *v.shape[1:]) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = 0.0
            for i in range(microbatches):
                l_i, g_i = _local_loss_and_grads(
                    bundle, params, {k: v[i] for k, v in parts.items()},
                    engine)
                for acc, g in zip(tree_leaves(grads), tree_leaves(g_i)):
                    acc.add_(g)
                loss = loss + l_i
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
        specs = tp = None
        if mesh is not None:
            grads = reduce_grads(grads, mesh)
            if zero.get("mesh") is not mesh:
                both = state_shardings(bundle, mesh)
                zero.update(mesh=mesh, specs=both["opt"]["m"],
                            tp=both["params"])
            specs, tp = zero["specs"], zero["tp"]
        if compress_crosspod and pod_axis is not None:
            grads = compress_grads_crosspod(grads, mesh, tp)
        with record_function("train_step.optimizer"):
            new_params, new_opt, metrics = adamw_update(
                opt_cfg, grads, state["opt"], param_dtype=param_dtype,
                params=params, mesh=mesh, specs=specs)
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
