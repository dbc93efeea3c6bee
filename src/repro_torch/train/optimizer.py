"""AdamW with fp32 master weights and moments (the port of
``repro/train/optimizer.py``).

The state mirrors the port's parameter tree: ``{"master", "m", "v",
"step"}``, the three fp32 trees shaped as the parameters and ``step`` an
int32 scalar.  The arithmetic is the reference's, in its order and in fp32:
the gradient is scaled by ``min(1, clip / max(||g||, 1e-12))`` first, and
the decay joins the Adam step, ``master - lr * (mh / (sqrt(vh) + eps) + wd *
master)`` (``torch.optim.AdamW`` decays before the step, which differs).

``adamw_update`` updates the state in place: the reference donates its
train state, so one copy of it is live, and that is what lets a 1.8B-model
state (16 bytes a parameter) fit on one card.  The new parameters are the
master cast to ``param_dtype``, bf16 by default as in the reference, which
never passes another: an fp32 model, and the fp32 routers of a bf16 MoE
model, train in bf16 from the second step on (ROADMAP C16, matched).

ZeRO-1 (``mesh`` and ``specs``, the ``distributed.sharding.
opt_state_shardings`` tree): the parameters are this rank's TP blocks;
master, m and v hold the further blocks over "data" of those specs; each
data rank updates its block from its block of the (data-summed) gradient,
and the new parameters, cast to ``param_dtype``, are all-gathered over
"data".  The clipping norm is the logical gradient's: each leaf's squares
are summed over the axes its block is sharded on, so a replicated leaf
counts once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch

from repro_torch.distributed import comm
from repro_torch.distributed.sharding import axes_of, block, spec_leaves
from repro_torch.interop import tree_map

__all__ = ["AdamWConfig", "adamw_init", "abstract_opt_state",
           "adamw_update", "cosine_lr", "tree_leaves", "tree_unflatten"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_leaves(tree) -> List[Any]:
    """The leaves of nested dicts (keys in sorted order, as JAX flattens
    them), lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped as ``tree`` holding ``leaves``, given in
    ``tree_leaves``' order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr_peak``, then a cosine to 0 at
    ``total_steps``; an fp32 scalar on step's device."""
    s = step.to(torch.float32)
    warm = s * cfg.lr_peak / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = (0.5 * cfg.lr_peak) * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos).to(torch.float32)


def _data_only(spec):
    return tuple(e if e == "data" else None for e in spec)


def adamw_init(params: Any, mesh=None, specs: Any = None) -> Dict[str, Any]:
    """fp32 copies of the parameters (never aliases, even for fp32 ones)
    and zero moments; with ZeRO-1 ``specs``, of this rank's data blocks."""
    if specs is not None:
        params = tree_unflatten(params, [
            block(p, _data_only(s), mesh) for p, s in
            zip(tree_leaves(params), spec_leaves(params, specs))])
    return {
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                           params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
    }


def abstract_opt_state(params_abstract: Any) -> Dict[str, Any]:
    """The state's logical shapes and dtypes as meta tensors: fp32 master,
    m and v shaped as ``params_abstract``'s leaves, an int32 ``step``."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return {"master": tree_map(f32, params_abstract),
            "m": tree_map(f32, params_abstract),
            "v": tree_map(f32, params_abstract),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _global_norm(grads: Any, mesh=None, specs: List = None
                 ) -> torch.Tensor:
    """The fp32 L2 norm of the logical gradient over every leaf of the
    tree ``grads``; with ``specs`` (each leaf's, in ``tree_leaves``'
    order), the squares of sharded blocks summed over the axes they are
    sharded on."""
    sq = [torch.sum(g.to(torch.float32) ** 2) for g in tree_leaves(grads)]
    if specs is None:
        return torch.sqrt(torch.sum(torch.stack(sq)))
    parts = {}
    for x, spec in zip(sq, specs):
        axes = tuple(a for a in mesh.axis_names
                     if any(a in axes_of(e) for e in spec))
        parts.setdefault(axes, []).append(x)
    total = []
    for axes, xs in sorted(parts.items()):
        x = torch.sum(torch.stack(xs)).reshape(1)
        total.append(comm.all_reduce_sum(x, mesh.group_of(*axes))
                     if axes else x)
    return torch.sqrt(torch.sum(torch.cat(total)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Any, opt_state: Dict[str, Any],
                 param_dtype=torch.bfloat16, params: Any = None,
                 mesh=None, specs: Any = None):
    """One AdamW step.  Returns ``(new_params, opt_state, {"lr",
    "grad_norm"})``; ``opt_state`` is updated in place (its master, m and v
    tensors, and ``step``) and returned.  ``params``, where given, is the
    current parameter tree: a leaf already of ``param_dtype`` takes the new
    value in place, any other is replaced by a new tensor.  ``mesh`` and
    ``specs``: ZeRO-1 (see the module's docstring)."""
    step = opt_state["step"] + 1
    lr = cosine_lr(cfg, step)
    leaf_specs = spec_leaves(grads, specs) if specs is not None else None
    if specs is not None:
        grads = tree_unflatten(grads, [
            block(g, _data_only(s), mesh)
            for g, s in zip(tree_leaves(grads), leaf_specs)])
    gnorm = _global_norm(grads, mesh, leaf_specs)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    old = tree_leaves(params) if params is not None else None
    new_leaves = []
    for i, (g, master, m, v) in enumerate(zip(
            tree_leaves(grads), tree_leaves(opt_state["master"]),
            tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"]))):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        master.sub_(lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * master))
        new = master.to(param_dtype)
        if leaf_specs is not None and "data" in leaf_specs[i]:
            new = comm.all_gather_dim(new, mesh.group_of("data"),
                                      leaf_specs[i].index("data"))
        p = old[i] if old is not None else None
        if p is not None and p.dtype == param_dtype:
            new_leaves.append(p.copy_(new))
        else:
            new_leaves.append(new)
    opt_state["step"] = step
    new_params = tree_unflatten(opt_state["master"], new_leaves)
    return new_params, opt_state, {"lr": lr, "grad_norm": gnorm}
