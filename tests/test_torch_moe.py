"""The port's MoE FFN (``repro_torch.models.layers``) against the reference's
(``repro.models.layers``, its no-mesh path ``_moe_ffn_dense``) on the same
numpy-seeded weights and inputs.

Routing (each (token, choice) pair's expert, its rank among the earlier
pairs of that expert, and whether it fits the capacity) must be equal
exactly in fp32; ``moe_ffn`` is held at 1e-4 in fp32 and at the dense
port's bf16 rule (2 ulps of the largest output in the max, a quarter ulp
in the rms).  Cases: reduced deepseek-moe-16b (8 experts, top 2, 2 shared)
and qwen2-moe-a2.7b (with QKV bias elsewhere, the same FFN), the padded
case (6 experts padded to 8: the reduced qwen2-moe pads nothing), and a
decode step of 4 tokens at deepseek's full top-6 over 32 experts, where
the capacity is 1 and colliding choices drop."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import reduced_config as ref_reduced_config
from repro.models import layers as RL
from repro_torch.configs import reduced_config
from repro_torch.interop import tree_map
from repro_torch.models import layers as L

# (arch, config changes, (B, S)): capacity 11, 11, 14 and 1
CASES = [
    ("deepseek-moe-16b", {}, (2, 16)),
    ("qwen2-moe-a2.7b", {}, (2, 16)),
    ("qwen2-moe-a2.7b", dict(n_experts=6, pad_experts_to=4), (2, 16)),
    ("deepseek-moe-16b", dict(n_experts=32, top_k=6), (4, 1)),
]
IDS = ["deepseek", "qwen2_moe", "padded_6_of_8", "decode_capacity_1"]


def _configs(arch, changes, dtype):
    return (dataclasses.replace(ref_reduced_config(arch), dtype=dtype,
                                **changes),
            dataclasses.replace(reduced_config(arch), dtype=dtype,
                                **changes))


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _case(arch, changes, shape, dtype, seed=0):
    rcfg, pcfg = _configs(arch, changes, dtype)
    p = jax.tree.map(np.asarray, RL.moe_params(jax.random.key(seed), rcfg,
                                               jnp.dtype(dtype)))
    # tokens share a component, so that the router favours some experts
    # and their choices overflow the capacity (iid tokens spread evenly
    # enough that nothing drops at these sizes)
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape + (rcfg.d_model,))
         + rng.normal(size=rcfg.d_model)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.dtype(dtype)))
    return rcfg, pcfg, p, x


@pytest.mark.parametrize("arch,changes,shape", CASES, ids=IDS)
def test_routing_matches_reference_exactly(arch, changes, shape):
    """Expert ids, per-expert ranks and the keep mask equal the reference's
    (``jax.lax.top_k``, ``_hierarchical_rank``) exactly, the gates within
    1e-5 relative (fp32 logits summed in another order); no
    choice lands on a padded expert, and at this size some choice is
    dropped."""
    rcfg, pcfg, p, x = _case(arch, changes, shape, "float32")
    xt = x.reshape(-1, rcfg.d_model)
    logits = jnp.asarray(xt) @ p["router"]
    if rcfg.padded_experts != rcfg.n_experts:
        logits = jnp.where(jnp.arange(rcfg.padded_experts)[None, :]
                           >= rcfg.n_experts, -1e30, logits)
    rgates, rexperts = jax.lax.top_k(logits, rcfg.top_k)
    rgates = jax.nn.softmax(rgates, axis=-1)
    flat = rexperts.reshape(-1)
    onehot = (flat[:, None] == jnp.arange(rcfg.padded_experts)[None, :]
              ).astype(jnp.int32)
    rrank = np.asarray(RL._hierarchical_rank(onehot, flat))
    C = int(rcfg.capacity_factor * rcfg.top_k * xt.shape[0]
            / rcfg.n_experts) + 1
    assert L.moe_capacity(pcfg, xt.shape[0]) == C

    gates, experts = L.moe_route({k: _tensor(v) for k, v in p.items()},
                                 _tensor(xt), pcfg)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(rexperts))
    # the router's fp32 products sum in another order: the gates' last bits
    np.testing.assert_allclose(gates.numpy(), np.asarray(rgates), rtol=1e-5,
                               atol=0)
    buf, slot, keep, rank = L.moe_dispatch(_tensor(xt), experts, pcfg, C)
    np.testing.assert_array_equal(rank.numpy(), rrank)
    np.testing.assert_array_equal(keep.numpy(), rrank < C)
    assert int(experts.max()) < pcfg.n_experts
    assert not bool(keep.all()), "no choice was dropped at this size"
    assert buf.shape == (pcfg.padded_experts, C, pcfg.d_model)


def test_top_k_takes_the_lower_index_among_equal_logits():
    """``jax.lax.top_k`` order: among equal logits the lower expert first,
    which ``torch.topk`` does not promise."""
    cfg = dataclasses.replace(reduced_config("deepseek-moe-16b"),
                              dtype="float32")
    router = torch.zeros((cfg.d_model, cfg.padded_experts))
    router[:, 5] = 1.0
    _, experts = L.moe_route({"router": router},
                             torch.ones((3, cfg.d_model)), cfg)
    assert experts.tolist() == [[5, 0]] * 3


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,changes,shape", CASES, ids=IDS)
def test_moe_ffn_matches_reference(arch, changes, shape, dtype):
    """The whole FFN: routed experts (dropped choices contribute nothing),
    the ordered combine and the shared experts."""
    rcfg, pcfg, p, x = _case(arch, changes, shape, dtype, seed=1)
    want = np.asarray(RL.moe_ffn(p, jnp.asarray(x), rcfg), np.float32)
    got = L.moe_ffn({k: _tensor(v) for k, v in p.items()}, _tensor(x), pcfg)
    assert got.dtype == getattr(torch, dtype)
    d = got.float().numpy() - want
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        ulp = _bf16_ulp(float(np.abs(want).max()))
        assert np.abs(d).max() <= 2 * ulp
        assert np.sqrt((d * d).mean()) <= ulp / 4


def test_moe_stages_compose_to_moe_ffn():
    """``moe_ffn`` is its four stages and the shared experts, as
    ``chip_smoke.py`` times them one by one."""
    _, pcfg, p, x = _case("deepseek-moe-16b", {}, (2, 16), "float32")
    pt = tree_map(_tensor, p)
    xt = _tensor(x).reshape(-1, pcfg.d_model)
    gates, experts = L.moe_route(pt, xt, pcfg)
    buf, slot, keep, _ = L.moe_dispatch(xt, experts, pcfg,
                                        L.moe_capacity(pcfg, xt.shape[0]))
    yt = L.moe_combine(L.moe_experts(pt, buf), gates, slot, keep)
    yt = yt + L.ffn({"wi": pt["shared_i"], "wo_f": pt["shared_o"]}, xt)
    assert torch.equal(yt.reshape(_tensor(x).shape),
                       L.moe_ffn(pt, _tensor(x), pcfg))
