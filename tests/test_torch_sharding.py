"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's, leaf for leaf, on abstract meshes: no rank, no device.

The reference's rules run over ``jax.eval_shape`` of each architecture's
``init`` at full width on ``jax.sharding.AbstractMesh``; the port's over
its meta-tensor params (``ModelBundle.abstract_params``) on its own
``AbstractMesh``.  The port's trees are flat layer lists, so a leaf of the
reference's stacked ``periods``/``enc_layers``/``dec_layers`` is compared
without its leading stacking entry, once for every layer it stacks.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs.base import SHAPES
from repro.distributed import sharding as RS
from repro.models.registry import get_bundle as ref_bundle
from repro_torch.configs.archs import ARCHS
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import get_bundle
from repro_torch.models.lm import _layer_plan
from repro_torch.train.optimizer import tree_leaves

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHE_CELL = SHAPES["decode_32k"]          # batch 128, 32,768 slots


def _spec(named) -> tuple:
    return tuple(named.spec)


def _ref_layers(tree, cfg):
    """The reference's per-layer subtrees in the port's order, each with a
    flag: stacked (its specs carry a leading entry) or not."""
    head, pattern, npd, tail = _layer_plan(cfg)
    out = [(lp, False) for lp in tree["head_layers"]]
    for _ in range(npd):
        out += [(tree["periods"][f"slot{j}"], True)
                for j in range(len(pattern))]
    return out + [(lp, False) for lp in tree["tail_layers"]]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _port_flat(tree, specs, prefix="") -> dict:
    """The port's spec tree by leaf path, walked along its tensor tree (a
    spec is a tuple, as the cache's containers are)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _port_flat(v, specs[k], f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, (v, s) in enumerate(zip(tree, specs))
                for k2, v2 in _port_flat(v, s, f"{prefix}{i}/").items()}
    return {prefix[:-1]: specs}


def _ref_as_port(ref_specs, cfg) -> dict:
    """The reference's spec tree (NamedShardings) as the port's paths and
    spec tuples."""
    out = {}
    if cfg.is_encdec:
        for key in ("enc_layers", "dec_layers"):
            n = cfg.n_encoder_layers if key == "enc_layers" else cfg.n_layers
            for i in range(n):
                for path, sh in _flat(ref_specs[key]).items():
                    out[f"{key}/{i}/{path}"] = _spec(sh)[1:]
        rest = {k: v for k, v in ref_specs.items()
                if k not in ("enc_layers", "dec_layers")}
    else:
        for i, (lp, stacked) in enumerate(_ref_layers(ref_specs, cfg)):
            for path, sh in _flat(lp).items():
                out[f"layers/{i}/{path}"] = _spec(sh)[1:] if stacked \
                    else _spec(sh)
        rest = {k: v for k, v in ref_specs.items()
                if k not in ("head_layers", "periods", "tail_layers")}
    out.update({k: _spec(v) for k, v in _flat(rest).items()})
    return out


def _ref_cache_as_port(ref_specs, cfg) -> dict:
    if cfg.is_encdec:                 # the port keeps the stacked dict
        return {k: _spec(v) for k, v in _flat(ref_specs).items()}
    out = {}
    for i, (lc, stacked) in enumerate(_ref_layers(ref_specs, cfg)):
        for path, sh in _flat(lc).items():
            out[f"{i}/{path}" if path else str(i)] = _spec(sh)[1:] \
                if stacked else _spec(sh)
    return out


@pytest.fixture(scope="module")
def abstract():
    """Each architecture's reference and port parameters, shapes only."""
    out = {}
    for arch in sorted(ARCHS):
        rb = ref_bundle(arch)
        out[arch] = (rb, jax.eval_shape(rb.init, jax.random.key(0)),
                     get_bundle(arch).abstract_params())
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_equal_the_reference(abstract, arch):
    rb, ref_p, port_p = abstract[arch]
    cfg = get_bundle(arch).cfg
    for label, (shape, names) in MESHES.items():
        rmesh, pmesh = JaxAbstractMesh(shape, names), AbstractMesh(shape,
                                                                   names)
        want = _ref_as_port(RS.param_shardings(rb.cfg, rmesh, ref_p), cfg)
        got = _port_flat(port_p, sharding.param_shardings(cfg, pmesh,
                                                          port_p))
        assert got == want, (arch, label, "params")
        want = _ref_as_port(RS.opt_state_shardings(rb.cfg, rmesh, ref_p),
                            cfg)
        got = _port_flat(port_p, sharding.opt_state_shardings(cfg, pmesh,
                                                              port_p))
        assert got == want, (arch, label, "opt state")
        specs = rb.input_specs(SHAPES["train_4k"])
        want = {k: _spec(v) for k, v in RS.batch_shardings(
            rb.cfg, rmesh, specs, SHAPES["train_4k"]).items()}
        got = sharding.batch_shardings(
            cfg, pmesh, {k: tuple(v.shape) for k, v in specs.items()})
        assert got == want, (arch, label, "batch")
        B, S = CACHE_CELL.global_batch, CACHE_CELL.seq_len
        want = _ref_cache_as_port(RS.cache_shardings(
            rb.cfg, rmesh, rb.abstract_cache(B, S), B), cfg)
        cache = get_bundle(arch).init_cache(B, S, device="meta")
        got = _port_flat(cache, sharding.cache_shardings(cfg, pmesh, cache,
                                                         B))
        assert got == want, (arch, label, "cache")


def test_attention_wo_is_column_sharded_in_both_packages(abstract):
    """ROADMAP C17: ``wo`` falls to the column rule in the reference (not
    in ``_ROW``, against its docstring), and the port keeps it so."""
    rb, ref_p, port_p = abstract["h2o-danube-1.8b"]
    rspec = RS.param_shardings(rb.cfg, JaxAbstractMesh((16, 16),
                                                       ("data", "model")),
                               ref_p)["periods"]["slot0"]["mixer"]["wo"]
    pspec = sharding.param_shardings(
        rb.cfg, AbstractMesh((16, 16), ("data", "model")),
        port_p)["layers"][0]["mixer"]["wo"]
    assert tuple(rspec.spec)[1:] == pspec == (None, "model")


def test_production_mesh_is_abstract_without_a_group():
    m = make_production_mesh()
    assert isinstance(m, AbstractMesh) and m.shape == {"data": 16,
                                                       "model": 16}
    m = make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model") and m.size == 512


def test_a_split_head_is_in_the_rules():
    """gemma3-12b's ``wk`` is 8 heads of 240: at 16 ranks a block is 120
    columns, half a head, and the rules shard it all the same."""
    b = get_bundle("gemma3-12b")
    spec = sharding.param_shardings(
        b.cfg, AbstractMesh((16, 16), ("data", "model")),
        b.abstract_params())["layers"][0]["mixer"]["wk"]
    assert spec == (None, "model")
    assert (b.cfg.n_kv_heads * b.cfg.head_dim_ // 16) % b.cfg.head_dim_


class _Coords(AbstractMesh):
    def __init__(self, shape, names, coords):
        super().__init__(shape, names)
        self.coords = dict(zip(names, coords))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_blocks_tile_the_logical_arrays(shape):
    """Every rank's ``shard_tree`` block put back in its place gives the
    logical arrays bit for bit (the blocks tile them, nothing twice)."""
    rng = np.random.default_rng(0)
    arrays = {"a": torch.from_numpy(rng.standard_normal((8, 12)).astype(
        np.float32)), "b": torch.arange(32, dtype=torch.int32).reshape(4, 8)}
    specs = {"a": ("data", "model"), "b": (None, ("data", "model"))}
    names = ("data", "model")
    back = {k: torch.full_like(v, -1) for k, v in arrays.items()}
    for coords in np.ndindex(*shape):
        mesh = _Coords(shape, names, coords)
        blocks = sharding.shard_tree(arrays, specs, mesh)
        for k, v in back.items():
            view = sharding.block(v, specs[k], mesh)
            assert bool((view == -1).all())
            view.copy_(blocks[k])
    for k in arrays:
        assert torch.equal(back[k], arrays[k])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "recurrentgemma-2b",
                                  "seamless-m4t-medium"])
def test_a_seeded_init_drawn_by_blocks_is_the_init_cut(arch):
    """``bundle.init(seed, device, mesh)`` draws one leaf at a time and
    keeps the rank's block: the blocks of the whole ``init``, bit for
    bit, on every coordinate of a (1, 2) mesh."""
    bundle = get_bundle(arch, reduced=True)
    full = bundle.init(3, "cpu")
    for coords in ((0, 0), (0, 1)):
        mesh = _Coords((1, 2), ("data", "model"), coords)
        want = sharding.shard_tree(full, sharding.param_shardings(
            bundle.cfg, mesh, full), mesh)
        got = bundle.init(3, "cpu", mesh=mesh)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
