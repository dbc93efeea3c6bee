"""Sharded decode: KV caches split by heads or by sequence and recurrent
states in the rules' blocks, on 4 gloo ranks on the CPU, against the
reference's own sharded decode and the port's one-rank decode.

One spawn of 4 ranks (``launch.tasks_rank`` of ``launch.decode_rank``)
runs every case while one subprocess runs the reference's decode on a
forced 4-device CPU mesh, ``jax.jit(bundle.decode, in_shardings=(
param_shardings, cache_shardings, batch_shardings))`` under
``jax.set_mesh``, as ``repro/launch/dryrun.py`` lowers it.  Weights are
the reference's reduced configs' (fp32), the caches seeded numpy in the
reference's tree (``interop.cache_from_numpy`` carries both to each rank's
blocks).  Each case runs 3-4 steps of ``make_serve_step``; the logits and
the gathered cache must equal the reference's and the one-rank port's
within 1e-5 of the largest |value| (the ranks' combine sums the softmax
in another order), and every rank's blocks must be ``shard_tree`` of the
gathered cache exactly.  (2, 2) runs the ``torch`` attention engine,
(1, 4) the ``cuda`` one (B6's plain version on CPU tensors, with its
log-sum-exp).

* heads: h2o-danube-1.8b on (2, 2), batch 4, its 2 KV heads one a model
  rank, the window's ring past its wrap;
* sequence on "model": recurrentgemma-2b on (1, 4), its one KV head's ring
  4 slots a rank past the wrap, the RG-LRU states whole on every rank;
* sequence over every axis: gemma3-12b on (2, 2) at batch 1, the global
  cache and the ring, at positions where some ranks see no key of either;
* deepseek-moe-16b on (1, 4): heads, and the expert-parallel MoE at
  decode's 4 tokens (its shared experts' ``shared_o`` zeroed, as
  ``test_torch_model_parallel.py`` does: the reference's EP pairs their
  columns otherwise, ROADMAP C18);
* xlstm-125m on (1, 4) at batch 4 and on (2, 2) at batch 1: mLSTM's ``C``
  split on its third dim and on its heads over every axis (ROADMAP C20);
* seamless-m4t-medium on (2, 2): the stacked self caches and the cross
  caches (the reference's ``prefill_cross`` of its encoded frames), by
  heads;
* whole: qwen2-1.5b on (1, 4) with 30 slots, where neither its 2 KV heads
  nor the sequence divide the model axis: every rank holds the whole
  cache and gathers the projections' column blocks.

Without ranks: ``layers.combine_partials`` against one-block attention
over random splits, blocks that a row cannot see included; the decode
route's plain split/combine with its LSE against B6's plain version; and
the registry's ``input_specs``, ``supports``, ``abstract_cache`` and
``all_archs`` against the reference's for every arch and shape cell.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as REF_ARCHS
from repro.configs.archs import reduced_config as ref_reduced_config
from repro.configs.base import SHAPES
from repro.distributed import sharding as RS
from repro.models import encdec as RED
from repro.models import lm as RLM
from repro.models.registry import all_archs as ref_all_archs
from repro.models.registry import get_bundle as ref_bundle
from repro_torch.configs.archs import reduced_config
from repro_torch.distributed import launch, sharding
from repro_torch.interop import cache_from_numpy, lm_params_from_numpy
from repro_torch.kernels import swa_attention as swa
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import layers as L
from repro_torch.models.registry import ModelBundle, all_archs, get_bundle

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
N_RANKS = 4
TIMEOUT = 300
TOL = 1e-5                       # of the largest |value|
ENGINE = {(2, 2): "torch", (1, 4): "cuda"}
# name: (arch, config overrides, mesh, batch, kv_len, positions)
CASES = {
    "heads": ("h2o-danube-1.8b", {}, (2, 2), 4, 64, (20, 21, 22)),
    "sequence on model": ("recurrentgemma-2b", {}, (1, 4), 4, 64,
                          (30, 31, 32)),
    "sequence over every axis": ("gemma3-12b", {}, (2, 2), 1, 64,
                                 (5, 6, 40, 63)),
    "ep": ("deepseek-moe-16b", {}, (1, 4), 4, 32, (10, 11, 12)),
    "xlstm (1, 4)": ("xlstm-125m", {}, (1, 4), 4, 16, (3, 4, 5)),
    "xlstm (2, 2) batch 1": ("xlstm-125m", {}, (2, 2), 1, 16, (3, 4, 5)),
    "seamless": ("seamless-m4t-medium", {}, (2, 2), 4, 32, (7, 8, 9)),
    "whole": ("qwen2-1.5b", {}, (1, 4), 4, 30, (10, 11, 29)),
}

REFERENCE = textwrap.dedent("""
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.archs import reduced_config
    from repro.distributed import sharding as RS
    from repro.models.registry import ModelBundle

    with open(sys.argv[1], "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, (arch, kw, shape, params, cache, steps) in cases.items():
        cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                                  **kw)
        bundle = ModelBundle(cfg)
        B = steps[0][0].shape[0]
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(
            jax.sharding.AxisType.Auto,) * 2)
        with jax.set_mesh(mesh):
            specs = {"tokens": jax.ShapeDtypeStruct((B, 1), jnp.int32),
                     "pos": jax.ShapeDtypeStruct((), jnp.int32)}
            c_sh = RS.cache_shardings(cfg, mesh, cache, B)
            fn = jax.jit(bundle.decode, in_shardings=(
                RS.param_shardings(cfg, mesh, params), c_sh,
                RS.batch_shardings(cfg, mesh, specs, None)))
            logits = []
            for toks, pos in steps:
                lg, cache = fn(params, cache, {"tokens": toks,
                                               "pos": np.int32(pos)})
                logits.append(np.asarray(lg))
                # the next step takes the cache in the rules' layout
                cache = jax.device_put(cache, c_sh)
        out[name] = (logits, jax.tree.map(np.asarray, cache))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def _cfgs(arch, **kw):
    """The reference's and the port's reduced config of ``arch``, fp32."""
    return (dataclasses.replace(ref_reduced_config(arch), dtype="float32",
                                **kw),
            dataclasses.replace(reduced_config(arch), dtype="float32", **kw))


def _case(name):
    """The case's weights, seeded cache (the reference's tree) and steps."""
    arch, kw, shape, B, kv_len, positions = CASES[name]
    rcfg, pcfg = _cfgs(arch, **kw)
    key = jax.random.key(0)
    rng = np.random.default_rng(list(CASES).index(name) + 1)
    if rcfg.is_encdec:
        params = jax.tree.map(np.asarray, RED.init_params(rcfg, key))
        abstract = RED.abstract_cache(rcfg, B, kv_len, max(64, kv_len // 4))
    else:
        params = jax.tree.map(np.asarray, RLM.init_params(rcfg, key))
        abstract = RLM.abstract_cache(rcfg, B, kv_len)
    if rcfg.n_shared_experts:          # C18
        params = jax.tree_util.tree_map_with_path(
            lambda path, a: np.zeros_like(a) if path[-1].key == "shared_o"
            else a, params)
    # positive values: an sLSTM normaliser below 0 would blow its output up
    cache = jax.tree.map(lambda a: rng.uniform(0.25, 1.25, a.shape).astype(
        np.float32), abstract)
    if rcfg.is_encdec:       # the cross caches of encoded frames
        frames = rng.standard_normal((B, cache["cross_k"].shape[2],
                                      rcfg.frontend_dim)).astype(np.float32)
        ck, cv = RED.prefill_cross(params, rcfg, RED.encode(params, rcfg,
                                                            frames))
        cache = dict(cache, cross_k=np.asarray(ck), cross_v=np.asarray(cv))
    steps = [(rng.integers(3, rcfg.vocab_size, (B, 1)).astype(np.int32), p)
             for p in positions]
    return params, cache, steps, pcfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_decode")
    cases = {name: _case(name) for name in CASES}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({name: (CASES[name][0], CASES[name][1], CASES[name][2],
                            params, cache, steps)
                     for name, (params, cache, steps, _) in cases.items()}, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE,
                            str(tmp / "in.pkl"), str(tmp / "out.pkl")],
                           env=env, stderr=subprocess.PIPE, text=True)
    tasks = [(launch.decode_rank, (pcfg, CASES[name][2], params, cache,
                                   steps, ENGINE[CASES[name][2]]))
             for name, (params, cache, steps, pcfg) in cases.items()]
    try:
        got = launch.spawn(launch.tasks_rank, N_RANKS, (tasks,),
                           device="cpu", timeout=TIMEOUT)[0]
    finally:
        _, err = ref.communicate(timeout=TIMEOUT)
    assert ref.returncode == 0, err[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        reference = pickle.load(f)
    return {"cases": cases, "reference": reference,
            "port": dict(zip(CASES, got))}


def _one_rank(params, cache, steps, pcfg, engine):
    """The port's decode on one rank: each step's logits and the cache."""
    bundle = ModelBundle(pcfg)
    p = lm_params_from_numpy(params, pcfg, "cpu")
    c = cache_from_numpy(cache, pcfg, "cpu")
    logits = []
    with torch.no_grad():
        for toks, pos in steps:
            lg, c = bundle.decode(p, c, {"tokens": torch.from_numpy(toks),
                                         "pos": pos}, engine)
            logits.append(lg.numpy())
    return logits, c


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                       else tree, np.float32)]


def _close(got, want, what):
    assert got.shape == want.shape, what
    top = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= TOL * max(top, 1e-30), what


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_matches_the_reference_and_one_rank(runs, name):
    params, cache, steps, pcfg = runs["cases"][name]
    got = runs["port"][name]
    ref_logits, ref_cache = runs["reference"][name]
    one_logits, one_cache = _one_rank(params, cache, steps, pcfg,
                                      ENGINE[CASES[name][2]])
    for i, lg in enumerate(got["out"]):
        _close(lg, np.asarray(ref_logits[i], np.float32),
               f"{name} step {i} vs the reference")
        _close(lg, one_logits[i], f"{name} step {i} vs one rank")
    want_ref = _flat(cache_from_numpy(ref_cache, pcfg, "cpu"))
    want_one = _flat(one_cache)
    mine = _flat(got["cache"])
    assert len(mine) == len(want_ref) == len(want_one)
    for j, (a, b, c) in enumerate(zip(mine, want_ref, want_one)):
        _close(a, b, f"{name} cache leaf {j} vs the reference")
        _close(a, c, f"{name} cache leaf {j} vs one rank")
    # every rank held exactly its blocks of the gathered cache
    assert got["block_err"] == 0.0


def test_the_cases_cover_every_layout():
    """The rules give each case the layout it is named for (C20: mLSTM's
    ``C`` on its third dim at batch 4, on its heads over every axis at
    batch 1)."""
    def specs(name):
        arch, kw, shape, B, kv_len, _ = CASES[name]
        _, pcfg = _cfgs(arch, **kw)
        cache = ModelBundle(pcfg).abstract_cache(B, kv_len)
        return sharding.cache_shardings(pcfg, AbstractMesh(
            shape, ("data", "model")), cache, B)

    assert specs("heads")[0][0] == ("data", None, "model", None)
    assert specs("sequence on model")[2][0] == ("data", "model", None, None)
    assert specs("sequence on model")[0][0] == (None, None)     # RG-LRU h
    gemma = specs("sequence over every axis")
    assert gemma[0][0] == gemma[5][0] == (None, ("data", "model"), None,
                                          None)
    assert specs("ep")[1][0] == ("data", None, "model", None)
    assert specs("xlstm (1, 4)")[0][0] == ("data", None, "model", None)
    assert specs("xlstm (2, 2) batch 1")[0][0] == (None, ("data", "model"),
                                                   None, None)
    assert specs("seamless")["cross_k"] == (None, "data", None, "model",
                                            None)
    assert specs("whole")[0][0] == ("data", None, None, None)


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_combine_partials_equals_one_block_attention(seed):
    """Random key blocks of a causal, windowed or ring decode, blocks that
    a row cannot see included: ``combine_partials`` of each block's plain
    (out, LSE) equals B6's plain version over the whole cache."""
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, D = 2, 4, 2, 16
    n = int(rng.choice([2, 4, 8]))
    size = n * int(rng.integers(2, 9))
    Sq = int(rng.integers(1, 4))
    window = int(rng.choice([0, 5]))
    ring = seed == 3
    pos = int(rng.integers(0, size - Sq)) if not ring else int(
        rng.integers(0, 3 * size))
    q = torch.from_numpy(rng.standard_normal((B, Hq, Sq, D)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, size, D)).astype(
        np.float32)) for _ in range(2))
    if ring:
        kw = dict(causal=False, window=0, q_offset=pos,
                  kv_len=min(pos + 1, size))
    else:
        kw = dict(causal=True, window=window, q_offset=pos, kv_len=size)
    want = swa.flash_swa_attention_plain(q, k, v, **kw)
    visible = L.decode_visible(Sq, pos, size, n, causal=kw["causal"],
                               window=window, ring=ring)
    assert not all(all(r) for r in visible) or ring
    b = size // n
    outs, lses = [], []
    for r in range(n):
        lo = r * b
        local = max(0, min(kw["kv_len"] - lo, b)) if ring \
            else max(0, min(pos + Sq - lo, b))
        o, lse = swa.flash_swa_attention_plain(
            q, k[:, :, lo:lo + b], v[:, :, lo:lo + b], causal=kw["causal"],
            window=kw["window"], q_offset=pos - lo, kv_len=local,
            return_lse=True)
        # a row that sees no key of the block: output 0, LSE 0
        for i, seen in enumerate(visible[r]):
            if not seen:
                assert float(o[:, :, i].abs().max()) == 0.0
                assert float(lse[:, :, i].abs().max()) == 0.0
        outs.append(o.transpose(1, 2))
        lses.append(lse)
    got = L.combine_partials(torch.stack(outs), torch.stack(lses),
                             torch.tensor(visible))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want.numpy(),
                               atol=1e-6, rtol=0)


def test_an_empty_block_weighs_nothing():
    """A block no row sees has LSE 0, which ``exp`` would weigh as 1: the
    combine takes it from visibility, so the result is the other block's
    output whatever the empty block's row holds."""
    out = torch.randn(2, 1, 1, 2, 8)
    lse = torch.tensor([-30.0, 0.0]).reshape(2, 1, 1, 1).expand(2, 1, 2, 1)
    got = L.combine_partials(out, lse.contiguous(),
                             torch.tensor([[True], [False]]))
    torch.testing.assert_close(got, out[0], rtol=0, atol=0)


DECODE_LSE_CASES = [
    # B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len
    (1, 16, 8, 1, 512, 240, True, 0, 511, 512),       # gemma3's block
    (2, 10, 1, 1, 512, 256, False, 0, 700, 512),      # recurrentgemma's ring
    (1, 16, 8, 1, 256, 240, True, 0, -5, 0),          # an empty block
    (2, 32, 8, 2, 4096, 80, True, 4096, 4094, 4096),  # danube
    (3, 4, 4, 3, 300, 64, True, 50, 200, 300),
]


@pytest.mark.parametrize("case", DECODE_LSE_CASES, ids=str)
def test_decode_route_lse_matches_the_plain_version(case):
    """The decode route's split and combine with the LSE
    (``partials_plain`` then ``combine_partials_plain(return_lse=True)``)
    equal ``flash_swa_attention_plain(return_lse=True)``: outputs within
    1e-6, LSEs within 1e-5 (log2 and natural log sums in another order);
    the empty block is 0 in both."""
    B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len = case
    rng = np.random.default_rng(Skv)
    q = torch.from_numpy(rng.standard_normal((B, Hq, Sq, D)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, Skv, D)).astype(
        np.float32)) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    assert Hq // Hkv * Sq <= swa.DECODE_ROWS
    m, l, o = swa.partials_plain(q, k, v, **kw)
    out, lse = swa.combine_partials_plain(m, l, o, Hq, Sq, q.dtype,
                                          return_lse=True)
    want, want_lse = swa.flash_swa_attention_plain(q, k, v, return_lse=True,
                                                   **kw)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-5,
                               rtol=1e-6)
    if kv_len == 0:
        assert float(out.abs().max()) == 0 == float(lse.abs().max())


def test_flash_attention_return_lse_on_the_cpu():
    """``ops.flash_attention(return_lse=True)`` runs the plain version on CPU
    tensors, and refuses a call that autograd records."""
    from repro_torch.kernels import ops

    q = torch.randn(1, 4, 1, 16)
    k, v = torch.randn(1, 2, 32, 16), torch.randn(1, 2, 32, 16)
    out, lse = ops.flash_attention(q, k, v, q_offset=31, return_lse=True)
    want, want_lse = swa.flash_swa_attention_plain(q, k, v, q_offset=31,
                                                   return_lse=True)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)
    with pytest.raises(ValueError, match="autograd"):
        ops.flash_attention(q.requires_grad_(True), k, v, return_lse=True)


def _meta(t):
    return (tuple(t.shape), str(t.dtype).replace("torch.", ""))


def _ref_meta(s):
    return (tuple(s.shape), str(s.dtype))


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_registry_functions_equal_the_reference(arch):
    """``input_specs``, ``supports`` and ``abstract_cache`` of every cell
    equal the reference's (shapes and dtypes; the cache in the port's
    layout, ``interop.cache_from_numpy``'s order)."""
    rb, pb = ref_bundle(arch), get_bundle(arch)
    for name, cell in SHAPES.items():
        assert pb.supports(cell) == rb.supports(cell), (arch, name)
        got = {k: _meta(v) for k, v in pb.input_specs(cell).items()}
        want = {k: _ref_meta(v) for k, v in rb.input_specs(cell).items()}
        assert got == want, (arch, name)
        if cell.kind != "decode":
            continue
        ref = rb.abstract_cache(cell.global_batch, cell.seq_len)
        port = pb.abstract_cache(cell.global_batch, cell.seq_len)
        want = [_ref_meta(s) for s in _ref_layers(ref, rb.cfg)]
        got = [_meta(t) for t in _port_leaves(port)]
        assert got == want, (arch, name)
        assert all(t.device.type == "meta" for t in _port_leaves(port))


def _ref_layers(cache, cfg):
    """The reference cache's leaves in the port's order (periods
    unstacked: each slot's leaves without the stacking axis)."""
    if cfg.is_encdec:
        return [cache[k] for k in sorted(cache)]
    head, pattern, npd, _ = RLM._layer_plan(cfg)
    out = [x for c in cache["head_layers"] for x in jax.tree.leaves(c)]
    for _ in range(npd):
        for j in range(len(pattern)):
            out += [jax.ShapeDtypeStruct(s.shape[1:], s.dtype)
                    for s in jax.tree.leaves(cache["periods"][f"slot{j}"])]
    out += [x for c in cache["tail_layers"] for x in jax.tree.leaves(c)]
    return out


def _port_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _port_leaves(v)]
    return [tree]


def test_all_archs_equals_the_reference():
    assert all_archs() == ref_all_archs()


def test_init_cache_on_a_mesh_is_the_rules_blocks():
    """``init_cache(..., mesh=)`` allocates each leaf's block only, with
    the initial values (mLSTM's and sLSTM's ``m`` at -1e30), and carries
    the rules' specs."""
    class Rank(AbstractMesh):
        coords = {"data": 1, "model": 2}

    mesh = Rank((2, 4), ("data", "model"))
    for arch, B in (("gemma3-12b", 1), ("xlstm-125m", 4),
                    ("seamless-m4t-medium", 4)):
        _, pcfg = _cfgs(arch)
        bundle = ModelBundle(pcfg)
        blocks = bundle.init_cache(B, 64, device="cpu", mesh=mesh)
        whole = bundle.init_cache(B, 64, device="cpu")
        specs = sharding.cache_shardings(pcfg, mesh, whole, B)
        assert sharding.specs_of(blocks) == specs
        for a, b in zip(_port_leaves(blocks), _port_leaves(
                sharding.shard_tree(whole, specs, mesh))):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b)
