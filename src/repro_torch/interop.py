"""Star tables and LM weights between numpy and the port.

A star travels as ``{table name: {"columns": {name: ndarray}, "valid":
uint32 words, "count": int, "capacity": int}}`` — the packed validity words
viewed as ``uint32`` exactly as the reference stores them.  The tests feed
one seeded star into both packages through this form.

LM weights travel as the reference's parameter pytree with numpy leaves
(``head_layers``, ``periods`` stacked on a leading axis, ``tail_layers``;
for the encoder-decoder ``enc_layers``/``dec_layers`` stacked); the port
keeps flat lists of layers in the reference's order.  Every leaf keeps its
dtype (fp32 routers and gates inside bf16 models).  bf16 leaves are
``ml_dtypes`` arrays, which ``torch.from_numpy`` refuses: they cross as
their ``uint16`` bits, recognised by the dtype's name.  A train state
(``{"params", "opt": {"master", "m", "v", "step"}}``) crosses tree by tree
(``train_state_from_numpy``), so both packages can start from one step.
Given a ``mesh`` (``launch.mesh.Mesh``), each goes to this rank's blocks
under ``distributed.sharding``'s rules (the optimizer's trees under the
ZeRO-1 ones), cut from the numpy arrays before they reach the device.
``init_shards`` draws a seeded ``init`` one leaf at a time, keeping only
the rank's block of each: the values are ``bundle.init``'s on the same
device, and no rank ever holds the whole model.  A decode cache travels as
the reference's cache tree (``head_layers``, ``periods`` stacked, ``tail_
layers``; the encoder-decoder's stacked dict as it is), and
``cache_from_numpy`` carries it into the port's list of layer states, or
with a ``mesh`` into the rank's blocks under ``cache_shardings``, which the
sharded decode reads.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.columnar import ColumnarTable, as_tensor, resolve_device

__all__ = ["tables_from_numpy", "tables_to_numpy", "lm_params_from_numpy",
           "train_state_from_numpy", "cache_from_numpy", "init_shards",
           "tree_map"]


def tables_from_numpy(star: Mapping[str, Mapping], device=None
                      ) -> Dict[str, ColumnarTable]:
    """Numpy star -> port tables on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    out = {}
    for name, t in star.items():
        cols = {k: as_tensor(np.asarray(v), dev)
                for k, v in t["columns"].items()}
        words = as_tensor(np.asarray(t["valid"], np.uint32), dev)
        out[name] = ColumnarTable(
            cols, words, torch.tensor(int(t["count"]), dtype=torch.int32,
                                      device=dev), int(t["capacity"]))
    return out


def tables_to_numpy(tables: Mapping[str, ColumnarTable]) -> Dict[str, Dict]:
    """Port tables -> numpy star (validity words as uint32)."""
    return {name: {"columns": {k: v.cpu().numpy()
                               for k, v in t.columns.items()},
                   "valid": t.valid.cpu().numpy().view(np.uint32),
                   "count": int(t.count), "capacity": int(t.capacity)}
            for name, t in tables.items()}


def tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaf_to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _top_level(params: Mapping[str, Any], layer_keys, name: str
               ) -> Dict[str, Any]:
    """Every top-level array leaf of the pytree; raises on a container
    that is not one of ``layer_keys`` (a leaf nothing places)."""
    out = {}
    for k, v in params.items():
        if k in layer_keys:
            continue
        if isinstance(v, (dict, list, tuple)):
            raise ValueError(f"{name}: no place for the pytree's {k!r}")
        out[k] = np.asarray(v)
    return out


def _unstack(tree, n: int):
    """A pytree stacked on a leading axis of ``n`` -> a list of ``n``."""
    return [tree_map(lambda a: np.asarray(a)[i], tree) for i in range(n)]


def lm_params_from_numpy(params: Mapping[str, Any], cfg: ModelConfig,
                         device=None, mesh=None, opt: bool = False
                         ) -> Dict[str, Any]:
    """The reference's LM parameter pytree (numpy leaves) -> the port's
    parameters on ``device`` (None = CUDA): periods unstacked into one list
    of layers, head layers, then each period's ``slot0..slotN``, then tail
    layers; every top-level leaf (``embed``, ``final_norm``, ``lm_head``,
    ``img_proj``) as it is.  An encoder-decoder's pytree: ``enc_layers``
    and ``dec_layers`` unstacked.  With a ``mesh``, this rank's blocks
    (the ZeRO-1 ones for an optimizer tree, ``opt``)."""
    from repro_torch.distributed import sharding

    dev = resolve_device(device)
    tree = _port_tree(params, cfg)
    if mesh is not None:
        rules = sharding.opt_state_shardings if opt \
            else sharding.param_shardings
        tree = sharding.shard_tree(tree, rules(cfg, mesh, tree), mesh)
    return tree_map(lambda a: _leaf_to_tensor(a, dev), tree)


def _port_tree(params: Mapping[str, Any], cfg: ModelConfig
               ) -> Dict[str, Any]:
    """The reference's pytree in the port's shape, numpy leaves."""
    from repro_torch.models.lm import _layer_plan

    if cfg.is_encdec:
        return _encdec_tree(params, cfg)
    head, pattern, npd, tail = _layer_plan(cfg)
    layers = list(params["head_layers"])
    periods = _unstack(params["periods"], npd) if npd else []
    for per in periods:
        layers += [per[f"slot{j}"] for j in range(len(pattern))]
    layers += list(params["tail_layers"])
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {len(layers)} layers in the pytree, "
                         f"the config has {cfg.n_layers}")
    out = _top_level(params, ("head_layers", "periods", "tail_layers"),
                     cfg.name)
    out["layers"] = [tree_map(np.asarray, lp) for lp in layers]
    return out


def _encdec_tree(params: Mapping[str, Any], cfg: ModelConfig
                 ) -> Dict[str, Any]:
    """The reference's encoder-decoder pytree in the port's shape: the
    stacked ``enc_layers``/``dec_layers`` unstacked into lists, every
    top-level leaf (``frontend_proj``, ``embed``, ``enc_norm``,
    ``final_norm``, ``lm_head``) as it is."""
    out = _top_level(params, ("enc_layers", "dec_layers"), cfg.name)
    for key, n in (("enc_layers", cfg.n_encoder_layers),
                   ("dec_layers", cfg.n_layers)):
        out[key] = _unstack(params[key], n)
    return out


def cache_from_numpy(cache: Mapping[str, Any], cfg: ModelConfig,
                     device=None, mesh=None):
    """The reference's decode cache (numpy leaves, bf16 as ``ml_dtypes``)
    -> the port's on ``device`` (None = CUDA): for a decoder LM one state a
    layer in the port's order (head layers, each period's
    ``slot0..slotN`` unstacked, tail layers), for the encoder-decoder the
    stacked dict as it is.  With a ``mesh``, this rank's blocks under
    ``sharding.cache_shardings``, cut from the numpy arrays, as a tree that
    carries its specs (``sharding.with_specs``)."""
    from repro_torch.distributed import sharding
    from repro_torch.models.lm import _layer_plan

    dev = resolve_device(device)
    if cfg.is_encdec:
        tree = {k: np.asarray(v) for k, v in cache.items()}
        batch = tree["self_k"].shape[1]
    else:
        head, pattern, npd, tail = _layer_plan(cfg)
        tree = [tree_map(np.asarray, c) for c in cache["head_layers"]]
        for per in (_unstack(cache["periods"], npd) if npd else []):
            tree += [per[f"slot{j}"] for j in range(len(pattern))]
        tree += [tree_map(np.asarray, c) for c in cache["tail_layers"]]
        batch = tree[0][0].shape[0]
    if mesh is None:
        return tree_map(lambda a: _leaf_to_tensor(a, dev), tree)
    specs = sharding.cache_shardings(cfg, mesh, tree, batch)
    blocks = sharding.shard_tree(tree, specs, mesh)
    return sharding.with_specs(
        tree_map(lambda a: _leaf_to_tensor(a, dev), blocks), specs)


def train_state_from_numpy(state: Mapping[str, Any], cfg: ModelConfig,
                           device=None, mesh=None) -> Dict[str, Any]:
    """The reference's train state (numpy leaves) -> the port's on
    ``device`` (None = CUDA): ``params``, and the optimizer's ``master``,
    ``m`` and ``v`` (each shaped as the parameters) through
    ``lm_params_from_numpy``, ``step`` as an int32 scalar; with a
    ``mesh``, this rank's blocks (ZeRO-1 for the optimizer's trees)."""
    dev = resolve_device(device)
    opt = state["opt"]
    return {"params": lm_params_from_numpy(state["params"], cfg, dev, mesh),
            "opt": {**{k: lm_params_from_numpy(opt[k], cfg, dev, mesh,
                                               opt=True)
                       for k in ("master", "m", "v")},
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32, device=dev)}}


def init_shards(bundle, gen, mesh) -> Dict[str, Any]:
    """This rank's blocks of ``bundle.init_from(gen)``: every drawn leaf is
    drawn whole from ``gen``, one at a time, in ``init``'s order (so the
    values are ``init``'s), and only the rank's block of it is kept.  The
    leaves ``init`` does not draw (zero norms and biases, RG-LRU's
    ``lam``) are vectors, which the rules never shard."""
    from repro_torch.distributed import sharding
    from repro_torch.models.layers import Drawer, dense_init
    from repro_torch.train.optimizer import tree_leaves

    class Recorder(Drawer):
        def __init__(self):
            self.drawn = []

        def draw(self, shape, dtype, scale):
            self.drawn.append(super().draw(shape, dtype, scale))
            return self.drawn[-1]

    class Blocks(Drawer):
        def __init__(self, specs):
            self.device, self.specs = gen.device, specs

        def draw(self, shape, dtype, scale):
            return sharding.own_block(dense_init(gen, shape, dtype, scale),
                                      next(self.specs), mesh)

    rec = Recorder()
    abstract = bundle.init_from(rec)
    specs = sharding.param_shardings(bundle.cfg, mesh, abstract)
    of = {id(leaf): spec for leaf, spec in zip(
        tree_leaves(abstract), sharding.spec_leaves(abstract, specs))}
    return bundle.init_from(Blocks(iter([of[id(t)] for t in rec.drawn])))
