"""Atomic, asynchronous checkpoints of a train state (the port of
``repro/train/checkpointing.py``).

A checkpoint is a directory ``step_<8 digits>`` holding ``state.npz`` (one
array a leaf, named by its path, ``params/layers/0/mixer/wq``) and
``manifest.json`` (step, time, each leaf's shape and dtype, and the
caller's metadata: arch, seed, data cursor).  bf16 leaves are saved as
their ``uint16`` bits with the dtype recorded, as the reference saves its
ml_dtypes leaves.  Writes go to ``<dir>.tmp`` and are renamed into place,
so a reader never sees half a checkpoint.  ``AsyncCheckpointer`` copies the
state to the host before it returns (the caller goes on updating the
state in place) and writes on a background thread, one write in flight,
keeping the newest ``keep``.

Elastic: given ``shardings`` (a spec tree shaped as the state,
``train_step.state_shardings``) under an ambient mesh, a save gathers the
logical arrays (a collective) and the mesh's first rank writes them in the
same format; a restore reads the logical arrays, whatever mesh saved them,
and keeps this rank's block of each (the template then holds the logical
shapes: meta tensors will do).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.columnar import resolve_device
from repro_torch.distributed import hints, sharding
from repro_torch.train.optimizer import tree_leaves, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "AsyncCheckpointer",
           "latest_step"]

def _names(tree, prefix: str = "") -> List[str]:
    """Each leaf's path, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _names(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _to_numpy(leaf: torch.Tensor, copy: bool = False) -> np.ndarray:
    """A leaf on the host (a copy, where ``copy``, even of a CPU tensor);
    bf16 as its uint16 bits."""
    t = leaf.detach()
    t = t.clone() if copy and t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _host_state(state: Any, copy: bool = False):
    """The state's leaves on the host (bf16 as uint16 bits) and their
    dtypes."""
    leaves = tree_leaves(state)
    return ([_to_numpy(x, copy) for x in leaves],
            [str(x.dtype).replace("torch.", "") for x in leaves])


def _write(ckpt_dir: str, step: int, names, arrays, dtypes,
           meta: Optional[Dict]) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "state.npz"), **dict(zip(names, arrays)))
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": {n: {"shape": list(a.shape), "dtype": d}
                   for n, a, d in zip(names, arrays, dtypes)},
        **(meta or {}),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    meta: Optional[Dict] = None, shardings: Any = None
                    ) -> str:
    """Atomic checkpoint write; returns the final path.  With
    ``shardings``, every rank of the ambient mesh calls it and the logical
    state is written once."""
    if shardings is None:
        arrays, dtypes = _host_state(state)
        return _write(ckpt_dir, step, _names(state), arrays, dtypes, meta)
    import torch.distributed as dist

    mesh = hints.current_mesh()
    whole = sharding.gather_tree(state, shardings, mesh)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if dist.get_rank(mesh.group) == 0:
        arrays, dtypes = _host_state(whole)
        _write(ckpt_dir, step, _names(whole), arrays, dtypes, meta)
    dist.barrier(group=mesh.group)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, state_template: Any,
                       device=None, shardings: Any = None
                       ) -> Tuple[Any, Dict]:
    """``(state, manifest)``: the checkpoint's leaves shaped as
    ``state_template``'s, in the template's dtypes, on ``device`` (None =
    CUDA); with ``shardings``, this rank's block of each on the ambient
    mesh.  Raises on a step or shape that disagrees."""
    dev = resolve_device(device)
    mesh = hints.current_mesh()
    specs = [None] * len(tree_leaves(state_template)) if shardings is None \
        else sharding.spec_leaves(state_template, shardings)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["step"] != step:
        raise ValueError(f"manifest step {manifest['step']} != {step}")
    out = []
    with np.load(os.path.join(path, "state.npz")) as data:
        for n, template, spec in zip(_names(state_template),
                                     tree_leaves(state_template), specs):
            arr = data[n]
            if tuple(arr.shape) != tuple(template.shape):
                raise ValueError(f"{n}: checkpoint shape {arr.shape} != "
                                 f"{tuple(template.shape)}")
            if spec is not None:
                arr = sharding.block(arr, spec, mesh)
            if manifest["leaves"][n]["dtype"] == "bfloat16":
                # undo the npz-safe uint16 view
                t = torch.from_numpy(np.array(arr.view(np.int16), copy=True)
                                     ).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr, copy=True))
            out.append(t.to(device=dev, dtype=template.dtype))
    return tree_unflatten(state_template, out), manifest


class AsyncCheckpointer:
    """Background-thread checkpointer; at most one write in flight."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, state: Any, meta: Optional[Dict] = None
             ) -> None:
        self.wait()
        # on the host before returning: the caller updates the state in place
        names = _names(state)
        arrays, dtypes = _host_state(state, copy=True)

        def work():
            _write(self.ckpt_dir, step, names, arrays, dtypes, meta)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"))
