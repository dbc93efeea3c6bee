"""Sharding rules: DP / TP / EP / SP layouts for every architecture (the
port of ``repro/distributed/sharding.py``), and the blocks they give a
rank.

The production mesh is (data, model) = (16, 16) per pod, with an outer
"pod" axis across pods (``launch.mesh``).  Rules, the reference's:

  * DP   — batch over ("pod", "data").
  * TP   — projections' output features on "model" for the names of
           ``_COL`` and every other ``w*`` name not in ``_ROW``; input
           features for ``_ROW``; vocab on "model" for embed/lm_head; a dim
           that does not divide the axis stays whole.  ``wo`` is not in
           ``_ROW``, so attention's output projection is sharded on its
           *output* features, against the reference's own docstring
           (ROADMAP C17, matched: specs and checkpoints agree with the
           reference's).
  * EP   — MoE expert dim on "model".
  * SP   — KV caches' sequence on "model" where the KV heads do not
           divide it, and over every axis that divides it where the batch
           is too small for the data axes; the decode step
           (``models.layers``) combines the ranks' partial softmax rows.
  * ZeRO-1 — optimizer state also sharded over "data" on the largest dim
           that divides and is not sharded yet.

A spec is a tuple with one entry a dim: None, an axis name, or a tuple of
axis names.  The rules run over the port's trees (flat layer lists), so a
leaf's spec is the reference's without its leading stacking entry; they
take a ``launch.mesh.Mesh`` or ``AbstractMesh`` and trees of tensors,
meta tensors or shapes.  ``shard_tree`` gives a rank's block of every
leaf; ``gather_tree`` (a collective) gives back the logical arrays;
``block_range`` is a rank's ``[lo, hi)`` on a dim its spec splits, and
``regroup`` (a collective) moves a rank's block from one spec to another.
A sharded decode's cache is a tree of blocks that carries its specs
(``with_specs``, ``specs_of``): the rank's local shapes alone cannot tell
the layouts apart (a batch of 1 over four ranks' sequence blocks looks
like a batch of 2 over two ranks' each).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell

__all__ = ["data_axes", "param_shardings", "batch_shardings",
           "cache_shardings", "opt_state_shardings", "map_with_path",
           "shard_tree", "gather_tree", "spec_leaves", "block", "own_block",
           "n_blocks", "block_range", "block_shape", "regroup", "with_specs",
           "specs_of", "axes_of", "Spec"]

Spec = Tuple[Any, ...]


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes that play the DP role (pod+data when multi-pod)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _div(n: int, mesh, axis: str) -> bool:
    return axis in mesh.shape and n % mesh.shape[axis] == 0


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` on every leaf of nested dicts, lists and tuples;
    the path joins keys and indices with ``/``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


# ---------------------------------------------------------------------------
# parameter shardings
# ---------------------------------------------------------------------------
_COL = ("wq", "wk", "wv", "wi", "wr", "wgate", "wx", "shared_i", "wog",
        "in_i", "in_f", "in_z", "in_o")
_ROW = ("wo_f", "wo_r", "wo_m", "wo_s", "shared_o")


def _param_rule(path: str, dims: Tuple[int, ...], mesh) -> Spec:
    """The spec of one (unstacked) parameter."""
    name = path.split("/")[-1]

    def m(n: int):
        return "model" if _div(n, mesh, "model") else None

    if name == "embed":
        return (m(dims[0]), None)
    if name in ("lm_head", "img_proj", "frontend_proj"):
        return (None, m(dims[1]))
    if name in ("we_i", "we_o"):              # EP on the expert dim
        return (m(dims[0]), None, None)
    if name == "router":
        return (None, None)
    if len(dims) <= 1:                        # biases, norms, scalars
        return (None,) * len(dims)
    if name in _COL or (name.startswith("w") and name not in _ROW):
        return (None, m(dims[1]))             # output features
    if name in _ROW:
        return (m(dims[0]), None)             # input features
    if name == "conv":
        return (None, m(dims[1]))
    if len(dims) == 3:                        # per-head (H, hd, hd)
        return (m(dims[0]), None, None)
    return (None,) * len(dims)


def _param_spec(path: str, leaf, mesh) -> Spec:
    dims = _shape(leaf)
    spec = _param_rule(path, dims, mesh)
    if len(spec) > len(dims):                 # the reference's rank check
        spec = (None,) * len(dims)
    return spec


def param_shardings(cfg: ModelConfig, mesh, params) -> Any:
    """A spec tree matching the params tree (leaves: tensors, meta tensors
    included)."""
    return map_with_path(lambda path, leaf: _param_spec(path, leaf, mesh),
                         params)


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------
def _entry(axes):
    """A spec entry for ``axes``, as ``PartitionSpec`` normalizes it: one
    axis by its name, several as a tuple."""
    axes = tuple(axes) if not isinstance(axes, str) else (axes,)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _dp_size(mesh, dp) -> int:
    n = 1
    for a in dp:
        n *= mesh.shape[a]
    return n


def batch_shardings(cfg: ModelConfig, mesh, specs: Dict[str, Any],
                    cell: Optional[ShapeCell] = None) -> Dict[str, Spec]:
    """The batch dim of every input over the DP axes where it divides
    (else over "data" alone where that divides, else whole); ``specs``
    maps each input to a tensor or shape."""
    dp = data_axes(mesh)
    dp_size = _dp_size(mesh, dp)
    out = {}
    for name, s in specs.items():
        shape = _shape(s)
        if not shape:
            out[name] = ()
            continue
        b = shape[0]
        batch_spec = _entry(dp) if b % dp_size == 0 else (
            dp[-1] if b % mesh.shape[dp[-1]] == 0 else None)
        out[name] = (batch_spec,) + (None,) * (len(shape) - 1)
    return out


def cache_shardings(cfg: ModelConfig, mesh, cache, batch: int) -> Any:
    """KV caches: batch on DP axes when it divides; KV heads on "model"
    when they divide, else the sequence dim on "model" (SP); a batch too
    small for the DP axes shards the sequence over every axis that
    divides it.  Other state: batch on the DP axes where it divides.  A
    period layer's state gets the spec the reference gives it stacked,
    without the leading entry (its stacked recurrent states lead with the
    period axis, not the batch, and stay whole)."""
    dp = data_axes(mesh)
    dp_size = _dp_size(mesh, dp)
    tp = mesh.shape.get("model", 1)

    def visit(path, leaf):
        shape = _shape(leaf)
        if len(shape) == 4 and shape[0] == batch:       # (B, S, Hkv, hd)
            b, s, h, _ = shape
            if b % dp_size == 0 and b >= dp_size:
                hspec = "model" if h % tp == 0 else None
                sspec = "model" if hspec is None and s % tp == 0 else None
                return (_entry(dp), sspec, hspec, None)
            axes = list(dp) + (["model"] if s % (dp_size * tp) == 0 else [])
            if s % _dp_size(mesh, axes) == 0:
                return (None, _entry(axes), None, None)
            return (None, None, None, None)
        if len(shape) == 5:            # stacked (L, B, S, H, hd): encdec's
            return (None,) + visit(path, shape[1:])
        if len(shape) >= 1 and shape[0] == batch and batch % dp_size == 0:
            return (_entry(dp),) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    if cfg.is_encdec:           # the port keeps the reference's stacking
        return map_with_path(visit, cache)
    lo, hi, size = _stack_sizes(cfg)["layers"]

    def layer(path, leaf):
        # a period layer's state as the reference sees it: stacked
        if lo <= int(path.split("/")[0]) < hi:
            return visit(path, (size,) + _shape(leaf))[1:]
        return visit(path, leaf)

    return map_with_path(layer, cache)


# ---------------------------------------------------------------------------
# optimizer state (ZeRO-1)
# ---------------------------------------------------------------------------
def _stack_sizes(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference stacks each period slot's layers (and the encoder's
    and decoder's) on a leading axis: ``{tree key: (first, end, size)}``
    of the port's layer lists that it stacks."""
    if cfg.is_encdec:
        return {"enc_layers": (0, cfg.n_encoder_layers, cfg.n_encoder_layers),
                "dec_layers": (0, cfg.n_layers, cfg.n_layers)}
    from repro_torch.models.lm import _layer_plan

    head, pattern, npd, _ = _layer_plan(cfg)
    return {"layers": (len(head), len(head) + npd * len(pattern), npd)}


def opt_state_shardings(cfg: ModelConfig, mesh, params) -> Any:
    """Moments and master: the params' TP spec plus the largest dim not
    already sharded over "data" where it divides (ZeRO-1).  For a layer
    the reference stacks, its stacking axis is a candidate too (first
    among equals, as it leads): where the reference picks it, each layer's
    block stays whole over "data" here, the reference's spec without its
    leading entry."""
    dsz = mesh.shape.get("data", 1)
    stacks = _stack_sizes(cfg)

    def widen(path, leaf):
        dims = _shape(leaf)
        spec = list(_param_spec(path, leaf, mesh))
        spec += [None] * (len(dims) - len(spec))
        cand = [(dims[i], i) for i in range(len(spec)) if spec[i] is None]
        key, _, rest = path.partition("/")
        if key in stacks and rest:
            lo, hi, size = stacks[key]
            if lo <= int(rest.split("/")[0]) < hi:
                cand.append((size, -1))
        for size, i in sorted(cand, reverse=True):
            if size % dsz == 0 and size >= dsz:
                if i >= 0:
                    spec[i] = "data"
                break
        return tuple(spec)

    return map_with_path(widen, params)


# ---------------------------------------------------------------------------
# a rank's blocks
# ---------------------------------------------------------------------------
def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _index(entry, mesh, coords=None) -> Tuple[int, int]:
    """``(this rank's block index, block count)`` over the axes of a spec
    entry, row-major over them as listed (``("data", "model")`` is
    data-major), at ``coords`` (default: this rank's)."""
    coords = mesh.coords if coords is None else coords
    idx, n = 0, 1
    for a in axes_of(entry):
        idx = idx * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return idx, n


def n_blocks(entry, mesh) -> int:
    """The number of blocks a spec entry splits a dim into."""
    return _index(entry, mesh, {a: 0 for a in axes_of(entry)})[1]


def block_range(size: int, entry, mesh, coords=None) -> Tuple[int, int]:
    """``[lo, hi)`` of the rank at ``coords`` (default: this one) on a
    logical dim of ``size`` that a spec entry splits (one axis, a tuple of
    axes, or None: the whole dim), in ``block``'s order."""
    idx, n = _index(entry, mesh, coords)
    b = size // n
    return idx * b, (idx + 1) * b


def block_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of a rank's block of a logical ``shape`` under ``spec``."""
    return tuple(n // n_blocks(e, mesh) for n, e in
                 zip(tuple(shape), tuple(spec) + (None,) * len(shape)))


def block(x, spec: Spec, mesh):
    """This rank's block of the logical ``x`` (a tensor or numpy array)
    under ``spec`` (a view)."""
    for dim, entry in enumerate(spec):
        if axes_of(entry):
            lo, hi = block_range(x.shape[dim], entry, mesh)
            x = x[(slice(None),) * dim + (slice(lo, hi),)]
    return x


def regroup(x: torch.Tensor, src: Spec, dst: Spec, mesh) -> torch.Tensor:
    """This rank's block under ``dst`` from its block ``x`` under ``src``
    (a collective over the axes of each dim whose entry changes: every rank
    of those groups calls it): each such dim is gathered over ``src``'s
    axes, then cut to ``dst``'s block."""
    from repro_torch.distributed import comm

    for dim, (a, b) in enumerate(zip(src, dst)):
        if a != b and axes_of(a):
            x = comm.all_gather_dim(x.contiguous(), mesh.group_of(*axes_of(a)),
                                    dim)
    for dim, (a, b) in enumerate(zip(src, dst)):
        if a != b and axes_of(b):
            lo, hi = block_range(x.shape[dim], b, mesh)
            x = x.narrow(dim, lo, hi - lo)
    return x.contiguous()


class BlockList(list):
    """A list of a rank's blocks that knows their specs (``specs``)."""
    specs = None


class BlockDict(dict):
    """A dict of a rank's blocks that knows their specs (``specs``)."""
    specs = None


def with_specs(tree, specs):
    """``tree`` (a list or dict of blocks) as a ``BlockList`` or
    ``BlockDict`` carrying ``specs``."""
    out = BlockDict(tree) if isinstance(tree, dict) else BlockList(tree)
    out.specs = specs
    return out


def specs_of(tree):
    """The specs a tree of blocks carries (``with_specs``), or None."""
    return getattr(tree, "specs", None)


def own_block(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``x`` as a tensor of its own: a copy where it
    is a part of ``x`` (a row block is a contiguous view, which would keep
    the whole storage alive)."""
    b = block(x, spec, mesh)
    return b.clone(memory_format=torch.contiguous_format) \
        if b.numel() != x.numel() else b


def shard_tree(tree, specs, mesh):
    """Each leaf's block on this rank (tensors of their own; numpy views
    of arrays)."""
    def cut(x, s):
        return own_block(x, s, mesh) if isinstance(x, torch.Tensor) \
            else block(x, s, mesh)

    return _zip_map(cut, tree, specs)


def spec_leaves(tree, specs) -> list:
    """The spec of each leaf of ``tree``, in ``tree_leaves``' order (dict
    keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k],
                                                             specs[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v, s in zip(tree, specs) for x in spec_leaves(v, s)]
    return [specs]


def gather_tree(tree, specs, mesh):
    """The logical arrays of a tree of blocks: each sharded dim gathered
    over its axes (a collective: every rank of the mesh calls it)."""
    from repro_torch.distributed import comm

    def whole(x, spec):
        for dim, entry in enumerate(spec):
            axes = axes_of(entry)
            if axes:
                x = comm.all_gather_dim(x.contiguous(),
                                        mesh.group_of(*axes), dim)
        return x

    return _zip_map(whole, tree, specs)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)
