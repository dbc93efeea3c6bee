"""The port's encoder-decoder (``repro_torch.models.encdec``, seamless-m4t-
medium reduced) against the reference's (``repro.models.encdec``) on the
same numpy-seeded weights and inputs: ``encode`` (bidirectional
attention), the decoder's full pass over the memory (causal self-attention
and cross-attention with more queries than keys), ``prefill_cross``, and
decode steps against a cache whose cross K/V were projected from the
memory; and the served path's zeroed cross K/V, which the port matches
(ROADMAP C14).

Under the ``cuda`` engine the port runs B6 (its plain version on CPU
tensors) where the reference runs ``sdpa``; for the full passes the
reference's ``sdpa`` is swapped for its Pallas B6 (interpret mode), as in
``test_torch_models.py``.  Tolerances: fp32 1e-4; bf16 2 ulps of the
largest output (max) and a quarter ulp (rms), the dense port's rule, the
full passes at one encoder and one decoder layer."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import reduced_config as ref_reduced_config
from repro.kernels import ops as RO
from repro.models import encdec as RED
from repro.models import layers as RL
from repro.models.registry import ModelBundle as RefBundle
from repro_torch.configs import reduced_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models.registry import ModelBundle

ARCH = "seamless-m4t-medium"
ENGINES = ["torch", "cuda"]


def _flash_sdpa(q, k, v, *, causal, window, q_positions, kv_valid_len=None):
    B, Sq, Hq, D = q.shape
    o = RO.flash_attention(*(a.transpose(0, 2, 1, 3) for a in (q, k, v)),
                           causal=causal, window=window, q_offset=0,
                           interpret=True)
    return o.transpose(0, 2, 1, 3).reshape(B, Sq, Hq * D)


def _is_norm(a, cfg) -> bool:
    """A norm scale: (d,), or (layers, d) stacked."""
    return a.shape[-1:] == (cfg.d_model,) and (
        a.ndim == 1 or (a.ndim == 2 and a.shape[0] in (
            cfg.n_layers, cfg.n_encoder_layers)))


def _setup(dtype, seed=0, B=2, S=32, S_src=64, **cut):
    """Reference and port configs (``cut``: config fields replaced, such as
    the depth), weights (norm scales replaced by noise), tokens and
    bf16-valued frames."""
    rcfg = dataclasses.replace(ref_reduced_config(ARCH), dtype=dtype, **cut)
    pcfg = dataclasses.replace(reduced_config(ARCH), dtype=dtype, **cut)
    rng = np.random.default_rng(seed)
    ref = jax.tree.map(np.asarray, RED.init_params(rcfg, jax.random.key(seed)))
    ref = jax.tree.map(lambda a: (0.1 * rng.normal(size=a.shape)).astype(
        a.dtype) if _is_norm(a, rcfg) else a, ref)
    toks = rng.integers(3, rcfg.vocab_size, (B, S)).astype(np.int32)
    frames = np.asarray(jnp.asarray(rng.normal(size=(B, S_src,
                                                     rcfg.frontend_dim)),
                                    jnp.bfloat16), np.float32)
    return rcfg, pcfg, ref, lm_params_from_numpy(ref, pcfg, "cpu"), toks, \
        frames


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _check(got, want, dtype):
    got, want = _f32(got), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        return
    d = got - want
    ulp = 2.0 ** (np.floor(np.log2(float(np.abs(want).max()))) - 7)
    assert np.abs(d).max() <= 2 * ulp and np.sqrt((d * d).mean()) <= ulp / 4


def _frames(frames, dtype):
    return torch.from_numpy(frames).to(getattr(torch, dtype))


# XLA may drop the bf16 roundings between the elementwise ops it fuses;
# compiled without that, the reference rounds after every op, as the port
# does (test_torch_models.py)
_NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}


def _compiled(fn, *args):
    exe = jax.jit(fn).lower(*args).compile(
        compiler_options=_NO_EXCESS_PRECISION)
    return exe(*args)


# bf16 cuts the reduced model (2 encoder + 2 decoder layers) to 1 + 1: one
# 1-ulp flip after the encoder's first layer (a bf16 product summed in
# another order) reaches 5 % of the memory after its second and then the
# logits past the dense rule (test_torch_models.py's _BF16_DEPTH)
_BF16_DEPTH = dict(n_layers=1, n_encoder_layers=1)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_decoder_pass_match_reference(dtype, engine, monkeypatch):
    """``encode`` (64 frames, non-causal) and the decoder's full pass over
    its memory (32 tokens: causal self-attention, then cross-attention of
    32 queries over 64 keys): the memory and every position's logits, in
    both precisions, bf16 at one encoder and one decoder layer
    (``_BF16_DEPTH``)."""
    rcfg, pcfg, ref, params, toks, frames = _setup(
        dtype, **(_BF16_DEPTH if dtype == "bfloat16" else {}))
    if engine == "cuda":
        monkeypatch.setattr(RL, "sdpa", _flash_sdpa)
    rp = jax.tree.map(jnp.asarray, ref)
    mem = _compiled(lambda p, f: RED.encode(p, rcfg, f), rp,
                    jnp.asarray(frames, jnp.dtype(dtype)))
    want = _compiled(lambda p, t, m: RED.decode_forward(p, rcfg, t,
                                                        memory=m)[0],
                     rp, jnp.asarray(toks), mem)
    gmem = ED.encode(params, pcfg, _frames(frames, dtype), engine=engine)
    _check(gmem, mem, dtype)
    got, cache = ED.decode_forward(params, pcfg, torch.from_numpy(toks),
                                   memory=gmem, engine=engine)
    assert cache is None and got.dtype == getattr(torch, dtype)
    _check(got, want, dtype)


def test_cross_attention_with_more_queries_than_keys():
    """Cross-attention of 96 queries over 40 encoder frames under the cuda
    engine (B6 at ``q_offset=0``; its default, ``kv_len - Sq``, is
    negative here) against the reference's attention layer."""
    rcfg, pcfg, ref, params, _, _ = _setup("float32")
    rng = np.random.default_rng(1)
    p = ref["dec_layers"]["cross_attn"]
    p = jax.tree.map(lambda a: a[0], p)
    x = rng.normal(size=(2, 96, rcfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, 40, rcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(96, dtype=np.int32), (2, 96))
    want, _ = RL.attention(p, jnp.asarray(x), rcfg, kind="attn",
                           positions=jnp.asarray(pos),
                           kv_input=jnp.asarray(mem), causal=False)
    for engine in ENGINES:
        got, _ = L.attention(params["dec_layers"][0]["cross_attn"],
                             torch.from_numpy(x), pcfg, kind="attn",
                             positions=torch.from_numpy(pos.copy()),
                             kv_input=torch.from_numpy(mem), causal=False,
                             engine=engine)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("engine,dtype", [("torch", "float32"),
                                          ("cuda", "float32"),
                                          ("torch", "bfloat16")])
def test_decode_steps_match_reference(engine, dtype):
    """``prefill_cross`` of the memory into a 48-slot cache, then 12 decode
    steps: logits, the self-attention K/V written in place, the cross K/V
    kept.  (The reference's decode attends with jnp ``sdpa``, which rounds
    bf16 probabilities before P V where B6 does not: the bf16 cuda engine
    is held by the full pass above.)"""
    rcfg, pcfg, ref, params, toks, frames = _setup(dtype, S=12)
    rp = jax.tree.map(jnp.asarray, ref)
    mem = _compiled(lambda p, f: RED.encode(p, rcfg, f), rp,
                    jnp.asarray(frames, jnp.dtype(dtype)))
    rcache = RED.init_cache(rcfg, 2, 48, 64)
    ck, cv = _compiled(lambda p, m: RED.prefill_cross(p, rcfg, m), rp, mem)
    rcache.update(cross_k=ck, cross_v=cv)
    gmem = torch.from_numpy(np.asarray(mem, np.float32)).to(
        getattr(torch, dtype))
    cache = ED.init_cache(pcfg, 2, 48, 64, torch.device("cpu"))
    gck, gcv = ED.prefill_cross(params, pcfg, gmem)
    _check(gck, ck, dtype)
    cache["cross_k"], cache["cross_v"] = gck, gcv
    self_k = cache["self_k"]
    step = jax.jit(lambda p, c, t, pos: RED.decode_forward(
        p, rcfg, t, cache=c, cache_pos=pos)).lower(
        rp, rcache, jnp.asarray(toks[:, :1]), jnp.int32(0)).compile(
        compiler_options=_NO_EXCESS_PRECISION)
    for t in range(12):
        want, rcache = step(rp, rcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.int32(t))
        got, cache = ED.decode_forward(params, pcfg,
                                       torch.from_numpy(toks[:, t:t + 1]),
                                       cache=cache, cache_pos=t,
                                       engine=engine)
        _check(got, want, dtype)
    assert cache["self_k"] is self_k and cache["cross_k"] is gck
    _check(cache["self_k"], rcache["self_k"], dtype)


def test_served_decode_ignores_the_source_as_the_reference_does():
    """ROADMAP C14 (reference-side): the served path (``bundle.init_cache``
    then ``bundle.decode``, as the batcher drives it) never fills the cross
    K/V, so every decoder layer attends zeros and the source frames play no
    part.  The port's bundle gives the reference bundle's logits, its cross
    K/V stay zero, and its logits equal a decode with the cross-attention
    removed."""
    rcfg, pcfg, ref, params, toks, _ = _setup("float32", S=6)
    rb, pb = RefBundle(rcfg), ModelBundle(pcfg)
    rp = jax.tree.map(jnp.asarray, ref)
    rcache, cache = rb.init_cache(2, 32), pb.init_cache(2, 32, device="cpu")
    assert cache["cross_k"].shape[2] == 64          # src_len(32) = 64
    for t in range(6):
        batch = {"tokens": toks[:, t:t + 1], "pos": t}
        want, rcache = rb.decode(rp, rcache, {"tokens": jnp.asarray(
            batch["tokens"]), "pos": jnp.int32(t)})
        got, cache = pb.decode(params, cache, {"tokens": torch.from_numpy(
            batch["tokens"]), "pos": t}, engine="cuda")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    assert not cache["cross_k"].any() and not cache["cross_v"].any()
    no_cross = [dict(lp, cross_attn=dict(lp["cross_attn"],
                                         wo=torch.zeros_like(
                                             lp["cross_attn"]["wo"])))
                for lp in params["dec_layers"]]
    c2 = pb.init_cache(2, 32, device="cpu")
    for t in range(6):
        alone, c2 = pb.decode(dict(params, dec_layers=no_cross), c2, {
            "tokens": torch.from_numpy(toks[:, t:t + 1]), "pos": t},
            engine="cuda")
    np.testing.assert_array_equal(alone.numpy(), got.numpy())
