"""The sharded models on 4 gloo ranks on the CPU, against the port
unsharded and against the reference's own sharded paths.

One spawn of 4 ranks a module (``launch.tasks_rank`` of the package's rank
functions) runs every sharded case; the reference's expert-parallel MoE
runs at the same time in one subprocess on a forced 4-device CPU mesh (as
``tests/test_distributed.py`` runs it).  All fp32 unless stated.

* EP: ``moe_ffn`` of reduced deepseek-moe-16b and qwen2-moe-a2.7b (their
  shared experts' ``shared_o`` zeroed) on (data, model) meshes (2, 2),
  (1, 4) and (4, 1) against the reference's ``moe_ffn`` under
  ``jax.set_mesh`` on the same mesh, within 1e-5 of the largest |output|
  (outputs reach ~80, where one fp32 ulp is 7.6e-6 and the two packages
  sum the d = 64 products in different orders); at (4, 1) tokens drop
  (per-group capacity).  C18's pin: with the shared experts, the port's EP
  equals its dense path at (1, 4), where the reference's does not.
* TP and DP: ``train_loss``, its gradients (gathered) and ``prefill`` of
  reduced qwen2-1.5b, gemma3-12b (tied embedding) and deepseek-moe-16b on
  (2, 2) and (1, 4) against the unsharded port (loss within 1e-5, each
  gradient leaf within 1e-4 of its largest); qwen2's 2 KV heads of 16 at 4
  ranks give each rank half a head of ``wk``/``wv``.  deepseek's capacity
  factor is raised to 4, where every expert's capacity exceeds a group's
  tokens, so that per-group capacity (which drops other tokens than the
  global one, by design) cannot tell the meshes apart.  The loss mask
  puts unequal counts on the data shards.
* One ZeRO-1 AdamW step on (2, 2), with and without microbatches, against
  the unsharded step; elastic
  restore of a state saved from (2, 2) onto (1, 4), (4, 1) and one rank,
  bit for bit, and the reference's ``restore_checkpoint`` reading the same
  directory; ``gather_tree(shard_tree(x))`` is ``x``.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import reduced_config as ref_reduced_config
from repro.models import layers as RL
from repro.models import lm as RLM
from repro.train.checkpointing import restore_checkpoint as ref_restore
from repro_torch.configs.archs import reduced_config
from repro_torch.distributed import launch
from repro_torch.interop import (lm_params_from_numpy, train_state_from_numpy,
                                 tree_map)
from repro_torch.models import layers as L
from repro_torch.models.registry import ModelBundle
from repro_torch.train import AdamWConfig, make_train_step, restore_checkpoint
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_step import abstract_train_state, loss_and_grads

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
N_RANKS = 4
TIMEOUT = 300
EP_ARCHS = ("deepseek-moe-16b", "qwen2-moe-a2.7b")
EP_MESHES = ((2, 2), (1, 4), (4, 1))
TP_ARCHS = ("qwen2-1.5b", "gemma3-12b", "deepseek-moe-16b")
TP_MESHES = ((2, 2), (1, 4))
DP_ARCHS = ("recurrentgemma-2b", "xlstm-125m")     # model axis of size 1
RESTORE_MESHES = ((1, 4), (4, 1))
OPT = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)
ADAM_FLOOR = 1e-4            # chip_smoke's train_card_vs_cpu rule
ROOMY = {"deepseek-moe-16b": 4.0}     # capacity factor of the TP/DP case
EP_TOL = 1e-5                # of the largest |output|

REFERENCE = textwrap.dedent("""
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.archs import reduced_config
    from repro.models import layers as RL

    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    out = {}
    for arch, (params, zeroed, x) in inp["ep"].items():
        cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
        run = jax.jit(RL.moe_ffn, static_argnums=2)
        out[arch, "dense"] = np.asarray(RL.moe_ffn(params, x, cfg))
        for shape in inp["meshes"]:
            mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(
                jax.sharding.AxisType.Auto,) * 2)
            with jax.set_mesh(mesh):
                out[arch, shape] = np.asarray(run(zeroed, x, cfg))
                if shape == (1, 4):
                    out[arch, "shared"] = np.asarray(run(params, x, cfg))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def _cfgs(arch, **kw):
    """The reference's and the port's reduced config of ``arch``, fp32."""
    return (dataclasses.replace(ref_reduced_config(arch), dtype="float32",
                                **kw),
            dataclasses.replace(reduced_config(arch), dtype="float32", **kw))


def _moe_case(arch):
    rcfg, _ = _cfgs(arch)
    p = jax.tree.map(np.asarray, RL.moe_params(jax.random.key(3), rcfg,
                                                jnp.float32))
    zeroed = dict(p, shared_o=np.zeros_like(p["shared_o"]))
    x = np.random.default_rng(5).standard_normal(
        (4, 32, rcfg.d_model)).astype(np.float32)
    return p, zeroed, x


def _batch(cfg, seed=1):
    """Tokens (4, 32) and a loss mask whose data shards (rows 0-1 and 2-3
    at (2, 2)) hold 5 and 48 tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, cfg.vocab_size, (4, 32)).astype(np.int32)
    mask = np.zeros((4, 32), np.float32)
    mask[0, 3:8] = 1
    mask[2:, 4:28] = 1
    return {"tokens": toks, "loss_mask": mask}


def _ref_params(arch, seed=0, **kw):
    rcfg, _ = _cfgs(arch, **kw)
    return jax.tree.map(np.asarray, RLM.init_params(rcfg,
                                                     jax.random.key(seed)))


def _ref_state(params):
    return {"params": params,
            "opt": {"master": tree_map(lambda a: a.astype(np.float32),
                                       params),
                    "m": tree_map(np.zeros_like, params),
                    "v": tree_map(np.zeros_like, params),
                    "step": np.zeros((), np.int32)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_parallel")
    ep = {arch: _moe_case(arch) for arch in EP_ARCHS}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"ep": ep, "meshes": EP_MESHES}, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE,
                            str(tmp / "in.pkl"), str(tmp / "out.pkl")],
                           env=env, stderr=subprocess.PIPE, text=True)
    tasks = []
    for arch in EP_ARCHS:
        _, pcfg = _cfgs(arch)
        p, zeroed, x = ep[arch]
        tasks += [(launch.moe_rank, (pcfg, shape, zeroed, x))
                  for shape in EP_MESHES]
        tasks.append((launch.moe_rank, (pcfg, (1, 4), p, x)))
    tp = {}
    for arch in TP_ARCHS:
        kw = {"capacity_factor": ROOMY[arch]} if arch in ROOMY else {}
        _, pcfg = _cfgs(arch, **kw)
        tp[arch] = (_ref_params(arch, **kw), _batch(pcfg), pcfg)
        tasks += [(launch.loss_grads_rank, (pcfg, shape, tp[arch][0],
                                            tp[arch][1]))
                  for shape in TP_MESHES]
    dp = {}
    for arch in DP_ARCHS:
        _, pcfg = _cfgs(arch)
        dp[arch] = (_ref_params(arch), _batch(pcfg), pcfg)
        tasks.append((launch.loss_grads_rank, (pcfg, (4, 1), dp[arch][0],
                                               dp[arch][1])))
    _, qcfg = _cfgs("qwen2-1.5b")
    state = _ref_state(tp["qwen2-1.5b"][0])
    tasks.append((launch.train_step_rank, (qcfg, (2, 2), state,
                                           [tp["qwen2-1.5b"][1]], OPT)))
    tasks.append((launch.train_step_rank, (qcfg, (2, 2), state,
                                           [tp["qwen2-1.5b"][1]], OPT,
                                           "float32", "torch", 2)))
    bf16 = reduced_config("gemma3-12b")
    tasks.append((launch.checkpoint_rank, (bf16, (2, 2), RESTORE_MESHES, 7,
                                           str(tmp / "ckpt"))))
    arrays = {"a": np.arange(64, dtype=np.float32).reshape(8, 8),
              "b": np.arange(32, dtype=np.int32).reshape(4, 8)}
    specs = {"a": ("data", "model"), "b": (None, ("data", "model"))}
    tasks += [(launch.shard_gather_rank, (arrays, specs, shape))
              for shape in ((2, 2), (1, 4))]
    try:
        got = launch.spawn(launch.tasks_rank, N_RANKS, (tasks,),
                           device="cpu", timeout=TIMEOUT)[0]
    finally:
        _, err = ref.communicate(timeout=TIMEOUT)
    assert ref.returncode == 0, err[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        reference = pickle.load(f)
    it = iter(got)
    out = {"reference": reference, "ep": ep, "tp": tp, "dp": dp,
           "tmp": tmp, "arrays": arrays, "qwen_state": state}
    for arch in EP_ARCHS:
        for shape in EP_MESHES:
            out["ep", arch, shape] = next(it)
        out["shared", arch] = next(it)
    for arch in TP_ARCHS:
        for shape in TP_MESHES:
            out["tp", arch, shape] = next(it)
    for arch in DP_ARCHS:
        out["dp", arch] = next(it)
    out["zero"] = next(it)
    out["zero_micro"] = next(it)
    out["ckpt"] = next(it)
    out["gather"] = [next(it), next(it)]
    return out


def _port_moe(arch, params, x):
    _, pcfg = _cfgs(arch)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    with torch.no_grad():
        return L.moe_ffn(p, torch.from_numpy(x), pcfg).numpy()


@pytest.mark.parametrize("shape", EP_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", EP_ARCHS)
def test_ep_matches_the_reference_ep(runs, arch, shape):
    got, want = runs["ep", arch, shape], runs["reference"][arch, shape]
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= EP_TOL * np.abs(want).max()


@pytest.mark.parametrize("arch", EP_ARCHS)
def test_tokens_drop_per_group_at_4x1(runs, arch):
    """At (4, 1) each data shard is a group of 32 tokens with its own
    capacity: some choices drop, so the EP path is not the dense one."""
    _, pcfg = _cfgs(arch)
    p, zeroed, x = runs["ep"][arch]
    dropped = 0
    for row in x:
        xt = torch.from_numpy(row)
        _, experts = L.moe_route({"router": torch.tensor(p["router"])},
                                 xt, pcfg)
        _, _, keep, _ = L.moe_dispatch(xt, experts, pcfg,
                                       L.moe_capacity(pcfg, xt.shape[0]))
        dropped += int((~keep).sum())
    assert dropped > 0
    dense = _port_moe(arch, zeroed, x)
    assert float(np.abs(runs["ep", arch, (4, 1)] - dense).max()) > 1e-3


@pytest.mark.parametrize("arch", EP_ARCHS)
def test_c18_port_ep_keeps_the_dense_shared_experts(runs, arch):
    """ROADMAP C18 (departed): with its shared experts, the port's EP at
    (1, 4) (one group: the dense path's capacity) equals its dense path;
    the reference's EP pairs each rank's half-block gate with half-block
    up and lands more than 1.0 from its own dense path."""
    p, _, x = runs["ep"][arch]
    dense = _port_moe(arch, p, x)
    top = np.abs(dense).max()
    assert float(np.abs(runs["shared", arch] - dense).max()) <= EP_TOL * top
    ref = runs["reference"]
    assert float(np.abs(ref[arch, "shared"] - ref[arch, "dense"]).max()) \
        > 1.0
    assert float(np.abs(dense - ref[arch, "dense"]).max()) <= EP_TOL * top


def _unsharded(params, batch, pcfg):
    p = lm_params_from_numpy(params, pcfg, "cpu")
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = loss_and_grads(ModelBundle(pcfg), p, b, "torch")
    with torch.no_grad():
        logits = ModelBundle(pcfg).prefill(p, b, "torch")
    return float(loss), grads, logits.numpy()


def _close(got, loss, grads, logits):
    assert abs(got["loss"] - loss) <= 1e-5, (got["loss"], loss)
    for a, g in zip(tree_leaves(got["grads"]), tree_leaves(grads)):
        g = g.numpy()
        assert a.shape == g.shape
        assert float(np.abs(a - g).max()) <= 1e-4 * max(
            float(np.abs(g).max()), 1e-30)
    assert float(np.abs(got["prefill"] - logits).max()) <= 1e-5


@pytest.mark.parametrize("shape", TP_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tp_dp_loss_grads_prefill_equal_unsharded(runs, arch, shape):
    params, batch, pcfg = runs["tp"][arch]
    _close(runs["tp", arch, shape], *_unsharded(params, batch, pcfg))


@pytest.mark.parametrize("arch", DP_ARCHS)
def test_every_family_on_a_data_mesh(runs, arch):
    """Recurrent families shard over "data" (model axis of size 1)."""
    params, batch, pcfg = runs["dp"][arch]
    _close(runs["dp", arch], *_unsharded(params, batch, pcfg))


def test_qwen2_at_four_ranks_splits_a_head():
    _, pcfg = _cfgs("qwen2-1.5b")
    cols = pcfg.n_kv_heads * pcfg.head_dim_ // 4
    assert cols % pcfg.head_dim_ and pcfg.head_dim_ % cols == 0


def test_unsharded_loss_matches_the_reference():
    params = _ref_params("qwen2-1.5b")
    rcfg, pcfg = _cfgs("qwen2-1.5b")
    batch = _batch(pcfg)
    want, _ = jax.jit(jax.value_and_grad(RLM.train_loss), static_argnums=1)(
        params, rcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(_unsharded(params, batch, pcfg)[0] - float(want)) <= 1e-5


def test_the_loss_is_the_global_masked_mean(runs):
    """The data shards hold 5 and 48 loss tokens: the mean of per-shard
    means is far from the global mean the sharded loss equals."""
    params, batch, pcfg = runs["tp"]["qwen2-1.5b"]
    p = lm_params_from_numpy(params, pcfg, "cpu")
    per = [float(ModelBundle(pcfg).train_loss(
        p, {k: torch.from_numpy(v[rows]) for k, v in batch.items()},
        "torch")) for rows in (slice(0, 2), slice(2, 4))]
    loss = _unsharded(params, batch, pcfg)[0]
    assert abs(np.mean(per) - loss) > 1e-3
    assert abs(runs["tp", "qwen2-1.5b", (2, 2)]["loss"] - loss) <= 1e-5


@pytest.mark.parametrize("microbatches", [1, 2])
def test_zero1_step_equals_the_unsharded_step(runs, microbatches):
    """One ZeRO-1 step on (2, 2).  With 2 microbatches, microbatch ``i``
    is each data rank's ``i``-th row pair: the unsharded step takes the
    batch's rows in that order (0, 2, 1, 3 of the 4)."""
    _, pcfg = _cfgs("qwen2-1.5b")
    state = train_state_from_numpy(runs["qwen_state"], pcfg, "cpu")
    order = [0, 1, 2, 3] if microbatches == 1 else [0, 2, 1, 3]
    batch = {k: torch.from_numpy(v[order])
             for k, v in runs["tp"]["qwen2-1.5b"][1].items()}
    n = 4 // microbatches             # the step's gradient: the parts' mean
    parts = [loss_and_grads(ModelBundle(pcfg), state["params"],
                            {k: v[i * n:(i + 1) * n]
                             for k, v in batch.items()}, "torch")[1]
             for i in range(microbatches)]
    grads = [sum(gs) / microbatches
             for gs in zip(*(tree_leaves(p) for p in parts))]
    step = make_train_step(ModelBundle(pcfg), AdamWConfig(**OPT),
                           microbatches, engine="torch",
                           param_dtype=torch.float32)
    state, m = step(state, batch)
    got = runs["zero" if microbatches == 1 else "zero_micro"]
    assert abs(got["metrics"][0]["grad_norm"] - float(m["grad_norm"])) \
        <= 1e-6 * float(m["grad_norm"])
    assert abs(got["metrics"][0]["loss"] - float(m["loss"])) <= 1e-5
    for key in ("master", "m", "v"):
        for a, b, g in zip(tree_leaves(got["state"]["opt"][key]),
                           tree_leaves(state["opt"][key]),
                           tree_leaves(grads)):
            b, g = b.numpy(), g.numpy()
            ill = (g != 0) & (np.abs(g) < ADAM_FLOOR * np.abs(g).max())
            top = max(float(np.abs(b).max()), 1e-30)
            assert float(np.abs(a - b)[~ill].max(initial=0.0)) <= 1e-5 * (
                1.0 if key == "master" else top), key
    for a, b, g in zip(tree_leaves(got["state"]["params"]),
                       tree_leaves(state["params"]), tree_leaves(grads)):
        g = g.numpy()
        ill = (g != 0) & (np.abs(g) < ADAM_FLOOR * np.abs(g).max())
        assert float(np.abs(a - b.numpy())[~ill].max(initial=0.0)) <= 1e-5


@pytest.mark.parametrize("which", [0, 1, "one rank"],
                         ids=["1x4", "4x1", "one_rank"])
def test_elastic_restore_is_bit_for_bit(runs, which):
    saved = runs["ckpt"]["saved"]
    if which == "one rank":
        bundle = ModelBundle(reduced_config("gemma3-12b"))
        st, _ = restore_checkpoint(str(runs["tmp"] / "ckpt"), 1,
                                   abstract_train_state(bundle),
                                   device="cpu")
        from repro_torch.train.checkpointing import _to_numpy

        restored = tree_map(_to_numpy, st)
    else:
        restored = runs["ckpt"]["restored"][which]
    for a, b in zip(tree_leaves(restored), tree_leaves(saved)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_the_reference_reads_a_sharded_save(runs):
    import ml_dtypes

    saved = runs["ckpt"]["saved"]

    def like(a):
        return np.zeros(a.shape, ml_dtypes.bfloat16 if a.dtype == np.uint16
                        else a.dtype)

    state, manifest = ref_restore(str(runs["tmp"] / "ckpt"), 1,
                                  tree_map(like, saved))
    assert manifest["arch"] == "gemma3-12b"
    for a, b in zip(jax.tree_util.tree_leaves(state), tree_leaves(saved)):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            a = a.view(np.uint16)
        assert np.array_equal(a, b)


def test_gather_of_the_blocks_is_the_identity(runs):
    for got in runs["gather"]:
        for k, v in runs["arrays"].items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
