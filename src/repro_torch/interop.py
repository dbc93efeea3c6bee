"""Star tables and LM weights between numpy and the port.

A star travels as ``{table name: {"columns": {name: ndarray}, "valid":
uint32 words, "count": int, "capacity": int}}`` — the packed validity words
viewed as ``uint32`` exactly as the reference stores them.  The tests feed
one seeded star into both packages through this form.

LM weights travel as the reference's parameter pytree with numpy leaves
(``head_layers``, ``periods`` stacked on a leading axis, ``tail_layers``);
the port keeps one flat list of layers in the reference's order.  bf16
leaves are ``ml_dtypes`` arrays, which ``torch.from_numpy`` refuses: they
cross as their ``uint16`` bits, recognised by the dtype's name.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.columnar import ColumnarTable, as_tensor, resolve_device

__all__ = ["tables_from_numpy", "tables_to_numpy", "lm_params_from_numpy",
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


def lm_params_from_numpy(params: Mapping[str, Any], cfg: ModelConfig,
                         device=None) -> Dict[str, Any]:
    """The reference's LM parameter pytree (numpy leaves) -> the port's
    parameters on ``device`` (None = CUDA): periods unstacked into one list
    of layers, head layers, then each period's ``slot0..slotN``, then tail
    layers."""
    from repro_torch.models.lm import _layer_plan

    dev = resolve_device(device)
    head, pattern, npd, tail = _layer_plan(cfg)
    layers = list(params["head_layers"])
    for i in range(npd):
        for j in range(len(pattern)):
            layers.append(tree_map(lambda a: np.asarray(a)[i],
                                   params["periods"][f"slot{j}"]))
    layers += list(params["tail_layers"])
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {len(layers)} layers in the pytree, "
                         f"the config has {cfg.n_layers}")
    out = {k: _leaf_to_tensor(params[k], dev)
           for k in ("embed", "final_norm", "lm_head") if k in params}
    out["layers"] = [tree_map(lambda a: _leaf_to_tensor(a, dev), lp)
                     for lp in layers]
    return out
