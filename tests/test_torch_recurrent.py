"""The port's recurrent mixers (``repro_torch.models.recurrent``: RG-LRU,
mLSTM, sLSTM) against the reference's (``repro.models.recurrent``) on the
same numpy-seeded weights and inputs, in their prefill form and in their
decode form from the prefill's state, and the port's token-by-token decode
against its parallel forward for reduced recurrentgemma-2b and xlstm-125m
(the reference's ``test_models.py::test_decode_matches_parallel``).

Tolerances: fp32 at 1e-4 (the RG-LRU's log-step scan combines in another
tree than ``jax.lax.associative_scan``, and the products sum in another
order: measured 3e-8 to 2e-6); bf16 at the dense port's rule, 2 ulps of
the largest output in the max and a quarter ulp in the rms (measured:
equal bits)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import reduced_config as ref_reduced_config
from repro.models import recurrent as RR
from repro_torch.configs import reduced_config
from repro_torch.models import get_bundle
from repro_torch.models import lm as LM
from repro_torch.models import recurrent as R

KINDS = [("recurrentgemma-2b", "rglru"), ("xlstm-125m", "mlstm"),
         ("xlstm-125m", "slstm")]


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _check(got, want, dtype):
    got, want = _f32(got), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        return
    d = got - want
    ulp = _bf16_ulp(float(np.abs(want).max()))
    assert np.abs(d).max() <= 2 * ulp and np.sqrt((d * d).mean()) <= ulp / 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch,kind", KINDS, ids=[k for _, k in KINDS])
def test_mixer_matches_reference(arch, kind, mode, dtype):
    """Prefill over 24 tokens from no state (outputs and the returned state),
    or a 2-token decode from the reference's prefill state."""
    rcfg = dataclasses.replace(ref_reduced_config(arch), dtype=dtype)
    pcfg = dataclasses.replace(reduced_config(arch), dtype=dtype)
    jdt = jnp.dtype(dtype)
    p = jax.tree.map(np.asarray, getattr(RR, f"{kind}_params")(
        jax.random.key(3), rcfg, jdt))
    pt = {k: _tensor(v) for k, v in p.items()}
    rng = np.random.default_rng(3)
    x = np.asarray(jnp.asarray(rng.normal(size=(2, 24, rcfg.d_model)), jdt))
    ref_fn, port_fn = getattr(RR, kind), getattr(R, kind)
    want, wstate = ref_fn(p, jnp.asarray(x), rcfg)
    if mode == "prefill":
        got, gstate = port_fn(pt, _tensor(x), pcfg)
    else:
        x2 = np.asarray(jnp.asarray(rng.normal(size=(2, 2, rcfg.d_model)),
                                    jdt))
        state = tuple(_tensor(s) for s in wstate)
        want, wstate = ref_fn(p, jnp.asarray(x2), rcfg, state=wstate)
        got, gstate = port_fn(pt, _tensor(x2), pcfg, state=state)
    assert got.dtype == getattr(torch, dtype)
    _check(got, want, dtype)
    assert len(gstate) == len(wstate)
    for g, w in zip(gstate, wstate):
        assert str(g.dtype) == f"torch.{w.dtype}"
        # states are fp32 (RG-LRU's h and conv window in x's type)
        _check(g, w, str(w.dtype))


def test_linear_scan_matches_the_loop():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 5)))
    b = torch.from_numpy(rng.normal(size=(2, 37, 5)))
    h, want = torch.zeros(2, 5, dtype=torch.float64), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(R.linear_scan(a, b), torch.stack(want, 1),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-125m"])
def test_decode_matches_parallel(arch, dtype, engine):
    """24 tokens decoded one by one through the cache (recurrentgemma's
    local layers over 16-slot rings that wrap, its RG-LRU states; xLSTM's
    mLSTM and sLSTM states) against one parallel forward: fp32 within 1e-4,
    bf16 within the reference test's 0.05."""
    b = get_bundle(arch, reduced=True)
    cfg = dataclasses.replace(b.cfg, dtype=dtype)
    bundle = type(b)(cfg)
    params = bundle.init(1, device="cpu")
    B, S = 2, 24
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        3, cfg.vocab_size, (B, S)).astype(np.int32))
    full, _ = LM.forward(params, cfg, toks, engine=engine)
    cache = bundle.init_cache(B, 32, device="cpu")
    maxerr = 0.0
    for t in range(S):
        logits, cache = bundle.decode(params, cache,
                                      {"tokens": toks[:, t:t + 1], "pos": t},
                                      engine=engine)
        maxerr = max(maxerr, float((logits[:, 0].float()
                                    - full[:, t].float()).abs().max()))
    assert maxerr < (1e-4 if dtype == "float32" else 0.05), maxerr
