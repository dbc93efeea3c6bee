"""The port's decoder LMs against the reference (``repro.models``) on the
same numpy-seeded weights and inputs: the layers in fp32 at 1e-5 under
both attention engines and in all three attention modes (prefill,
full-cache decode, ring-buffer decode); whole-model logits for reduced
h2o-danube-1.8b, llama3.2-3b and qwen2-1.5b, and for the six other
families (MoE, recurrent, xLSTM, vision, encoder-decoder); decode against
the parallel forward with the ring wrapping; the weight converter; and
every reduced bundle's prefill and decode.

Weights come from the reference's own initialisers, with every norm scale
and QKV bias (zero at init) replaced by seeded noise so that both are
exercised, and cross into the port through ``interop``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import reduced_config as ref_reduced_config
from repro.kernels import ops as RO
from repro.models import layers as RL
from repro.models import encdec as RED
from repro.models import lm as RLM
from repro.models.registry import ModelBundle as RefBundle
from repro_torch.configs import reduced_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels import launch_counts
from repro_torch.models import get_bundle
from repro_torch.models import layers as L
from repro_torch.models import lm as LM

ARCHS = ["h2o-danube-1.8b", "llama3.2-3b", "qwen2-1.5b"]
# the families this port added after the dense one
FAMILIES = ["deepseek-moe-16b", "qwen2-moe-a2.7b", "recurrentgemma-2b",
            "xlstm-125m", "phi-3-vision-4.2b", "seamless-m4t-medium"]
ENGINES = ["torch", "cuda"]


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(ref_reduced_config(arch), dtype=dtype),
            dataclasses.replace(reduced_config(arch), dtype=dtype))


def _noisy(tree, rng):
    """Replace every 1-d leaf (norm scales, QKV biases) with noise."""
    return jax.tree.map(
        lambda a: (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        if a.ndim == 1 else a, tree)


def _params(rcfg, pcfg, seed):
    rng = np.random.default_rng(seed)
    init = RED.init_params if rcfg.is_encdec else RLM.init_params
    ref = _noisy(jax.tree.map(np.asarray, init(rcfg, jax.random.key(seed))),
                 rng)
    return ref, lm_params_from_numpy(ref, pcfg, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rmsnorm_rope_ffn_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    scale = (0.3 * rng.normal(size=16)).astype(np.float32)
    np.testing.assert_allclose(
        _np(L.rmsnorm(_t(scale), _t(x), 1e-6)),
        np.asarray(RL.rmsnorm(jnp.asarray(scale), jnp.asarray(x), 1e-6)),
        rtol=1e-5, atol=1e-5)
    pos = (np.arange(7)[None] + np.array([[0], [3000]])).astype(np.int32)
    for theta in (10_000.0, 500_000.0):
        np.testing.assert_allclose(
            _np(L.rope(_t(x), torch.from_numpy(pos), theta)),
            np.asarray(RL.rope(jnp.asarray(x), jnp.asarray(pos), theta)),
            rtol=1e-5, atol=1e-5)
    p = jax.tree.map(np.asarray, RL.ffn_params(jax.random.key(1), 16, 40,
                                               jnp.float32))
    h = x.reshape(2, 28, 16)
    np.testing.assert_allclose(
        _np(L.ffn({k: _t(v) for k, v in p.items()}, _t(h))),
        np.asarray(RL.ffn(p, jnp.asarray(h))), rtol=1e-5, atol=1e-5)


# (kind, S, kv_len of the cache or None, cache_pos): prefill, prefill long
# enough for the chunked formulation, full-cache decode ('attn', and 'swa'
# with kv_len < window), a clamped two-token write, and ring-buffer decode
# before and after the ring wraps
ATTN_CASES = [
    ("attn", 24, None, None),
    ("swa", 24, None, None),
    ("swa", 3072, None, None),
    ("attn", 1, 32, 20),
    ("swa", 1, 12, 9),
    ("attn", 2, 32, 31),
    ("swa", 1, 32, 5),
    ("swa", 1, 32, 40),
]


def _windowed(arch, window):
    return tuple(dataclasses.replace(c, window=window)
                 for c in _configs(arch))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind,S,kv_len,pos", ATTN_CASES)
def test_attention_matches_reference(kind, S, kv_len, pos, engine):
    rcfg, pcfg = _windowed("qwen2-1.5b", 16)      # QKV bias
    _attention_case(rcfg, pcfg, kind, S, kv_len, pos, engine)


def _attention_case(rcfg, pcfg, kind, S, kv_len, pos, engine, B=2,
                    tol=1e-5):
    """One attention layer of both packages on the same noisy weights,
    input and (for ``kv_len``) KV cache; outputs within ``tol`` and the
    updated caches within ``tol / 10`` (K is projected over d_model terms
    and rotated: 1e-6 at the reduced widths)."""
    rng = np.random.default_rng(S + (pos or 0))
    p = _noisy(jax.tree.map(np.asarray, RL.attn_params(
        jax.random.key(2), rcfg, jnp.float32)), rng)
    x = rng.normal(size=(B, S, rcfg.d_model)).astype(np.float32)
    start = pos or 0
    positions = np.broadcast_to(start + np.arange(S, dtype=np.int32), (B, S))
    cache = rcache = None
    if kv_len is not None:
        s_cache = min(rcfg.window, kv_len) if kind == "swa" else kv_len
        shape = (B, s_cache, rcfg.n_kv_heads, rcfg.head_dim_)
        kc = rng.normal(size=shape).astype(np.float32)
        vc = rng.normal(size=shape).astype(np.float32)
        rcache = (jnp.asarray(kc), jnp.asarray(vc))
        cache = (_t(kc), _t(vc))
    want, wcache = RL.attention(p, jnp.asarray(x), rcfg, kind=kind,
                                positions=jnp.asarray(positions),
                                cache=rcache,
                                cache_pos=None if pos is None
                                else jnp.int32(pos))
    got, gcache = L.attention({k: _t(v) for k, v in p.items()}, _t(x), pcfg,
                              kind=kind,
                              positions=torch.from_numpy(positions.copy()),
                              cache=cache, cache_pos=pos, engine=engine)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)
    if kv_len is not None:
        assert gcache[0] is cache[0]                   # written in place
        for g, w in zip(gcache, wcache):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=tol / 10,
                                       atol=tol / 10)


@pytest.mark.parametrize("pos", [5, 14, 40], ids=["before_wrap",
                                               "clamped_write", "after_wrap"])
@pytest.mark.parametrize("S", [1, 3])
def test_cuda_engine_ring_decode_matches_reference(S, pos):
    """Ring-buffer decode under the cuda engine with one or several queries
    (on CPU tensors the plain version runs with the kernel route's
    arguments: no causal or window mask, kv_len = min(pos + 1, W)) against
    the reference's ``_ring_sdpa``, before and after the ring wraps."""
    rcfg, pcfg = _windowed("qwen2-1.5b", 16)
    _attention_case(rcfg, pcfg, "swa", S, 16, pos, "cuda")


def _gemma3_full_width():
    from repro.configs.archs import get_config as ref_get_config
    from repro_torch.configs import get_config

    return (dataclasses.replace(ref_get_config("gemma3-12b"),
                                dtype="float32"),
            dataclasses.replace(get_config("gemma3-12b"), dtype="float32"))


@pytest.mark.parametrize("kind,S,kv_len,pos", [("swa", 5, None, None),
                                               ("attn", 5, None, None),
                                               ("swa", 3, 1024, 1500)],
                         ids=["local_prefill", "global_prefill",
                              "ring_decode"])
def test_gemma3_attention_layer_at_full_width(kind, S, kv_len, pos):
    """One gemma3-12b attention layer at full width (d_model 3,840, 16/8
    heads of 240, window 1,024) under the cuda engine on the CPU, against
    the reference: the head dim that B6 took no kernel for before."""
    rcfg, pcfg = _gemma3_full_width()
    assert (pcfg.d_model, pcfg.head_dim_, pcfg.window) == (3840, 240, 1024)
    _attention_case(rcfg, pcfg, kind, S, kv_len, pos, "cuda", B=1, tol=1e-4)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
# XLA on the CPU may drop the bf16 roundings between the elementwise ops it
# fuses ("excess precision"): the reference's jit'd layer then differs from
# its own op-by-op result in half its bf16 outputs.  Compiled without it, the
# reference rounds after every op, as the port does.
_NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}


def _flash_sdpa(q, k, v, *, causal, window, q_positions, kv_valid_len=None):
    """The reference's prefill attention through its own Pallas kernel B6
    (interpret mode): fp32 probabilities times V, where ``sdpa`` rounds the
    probabilities to bf16 first.  The port's cuda engine computes this."""
    B, Sq, Hq, D = q.shape
    o = RO.flash_attention(*(a.transpose(0, 2, 1, 3) for a in (q, k, v)),
                           causal=causal, window=window, q_offset=0,
                           interpret=True)
    return o.transpose(0, 2, 1, 3).reshape(B, Sq, Hq * D)


def _ref_logits(ref, rcfg, toks, dtype):
    rp = jax.tree.map(lambda a: jnp.asarray(a, jnp.dtype(dtype)), ref)
    rcfg = dataclasses.replace(rcfg, dtype=dtype)
    f = jax.jit(lambda p, t: RLM.forward(p, rcfg, t)[0])
    exe = f.lower(rp, toks).compile(compiler_options=_NO_EXCESS_PRECISION)
    return np.asarray(exe(rp, toks), np.float32)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _max_rms(d):
    return float(np.abs(d).max()), float(np.sqrt((d * d).mean()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype, monkeypatch):
    """Logits of a 32-token prefill.  The torch engine against the
    reference; the cuda engine against the reference with B6's Pallas kernel
    at its attention sites.  fp32 at 1e-4.  bf16 at 2 ulps of the largest
    logit in the max and a quarter ulp in the root mean square: sums in
    another order flip an ulp here and there (measured: at most 1 ulp, 0.031
    for reduced h2o-danube's logits of ~4.8 and 0.004 for llama3.2's and
    qwen2's of ~0.65, and an rms under 0.1 ulp).  Both gates sit below the
    reference's own bf16-vs-fp32 spread (max 0.079-0.090 and 0.011-0.014,
    rms 0.37 and 0.45-0.48 ulp), so a part of the model computed in another
    precision fails them: F.silu, which rounds once where jax.nn.silu rounds
    its logistic first, gives an rms of 0.27-0.36 ulp."""
    rcfg, pcfg = _configs(arch, dtype)
    ref, params = _params(rcfg, pcfg, seed=1)
    toks = np.random.default_rng(1).integers(3, rcfg.vocab_size, (2, 32)
                                             ).astype(np.int32)
    for engine in ENGINES:
        if engine == "cuda":
            monkeypatch.setattr(RL, "sdpa", _flash_sdpa)
        want = _ref_logits(ref, rcfg, toks, dtype)
        tol = (1e-4, np.inf)
        if dtype == "bfloat16":
            ulp = _bf16_ulp(float(np.abs(want).max()))
            tol = (2 * ulp, ulp / 4)
            spread = _max_rms(_ref_logits(ref, rcfg, toks, "float32") - want)
            assert spread[0] > tol[0] and spread[1] > tol[1], \
                (arch, engine, spread, tol)
        got, cache = LM.forward(params, pcfg, torch.from_numpy(toks),
                                engine=engine)
        assert cache is None and got.dtype == getattr(torch, dtype)
        err = _max_rms(_np(got) - want)
        assert err[0] <= tol[0] and err[1] <= tol[1], \
            (arch, dtype, engine, err, tol)


def _family_batch(cfg, seed, B=2, S=32):
    """Tokens, and the frontend's inputs where the family has one (as the
    reference's ``input_specs``: frames of ``max(64, S // 4)``, one image
    embedding a frontend token), fp32 holding bf16 values, so that every
    precision sees the same inputs."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    shapes = {}
    if cfg.is_encdec:
        shapes["frames"] = (B, max(64, S // 4), cfg.frontend_dim)
    if cfg.frontend == "vision_patches":
        shapes["image_embeds"] = (B, cfg.n_frontend_tokens, cfg.frontend_dim)
    for k, shape in shapes.items():
        batch[k] = np.asarray(jnp.asarray(rng.normal(size=shape),
                                          jnp.bfloat16), np.float32)
    return batch


def _ref_family_logits(ref, rcfg, batch, dtype):
    """All positions' logits of the reference's forward (the encoder-decoder:
    encode, then the decoder over the memory), compiled without excess
    precision; in bf16 the fp32 leaves (routers, gates) stay fp32."""
    rp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32)
                      if dtype == "float32" else jnp.asarray(a), ref)
    rcfg = dataclasses.replace(rcfg, dtype=dtype)
    jb = {k: jnp.asarray(v) if k == "tokens" else
          jnp.asarray(v, jnp.dtype(dtype)) for k, v in batch.items()}
    if rcfg.is_encdec:
        def f(p, b):
            mem = RED.encode(p, rcfg, b["frames"])
            return RED.decode_forward(p, rcfg, b["tokens"], memory=mem)[0]
    else:
        def f(p, b):
            return RLM.forward(p, rcfg, b["tokens"],
                               image_embeds=b.get("image_embeds"))[0]
    exe = jax.jit(f).lower(rp, jb).compile(
        compiler_options=_NO_EXCESS_PRECISION)
    return np.asarray(exe(rp, jb), np.float32)


def _port_family_logits(params, pcfg, batch, dtype, engine):
    from repro_torch.models import encdec as ED

    tb = {k: torch.from_numpy(v) if k == "tokens" else
          _t(v).to(getattr(torch, dtype)) for k, v in batch.items()}
    if pcfg.is_encdec:
        mem = ED.encode(params, pcfg, tb["frames"], engine=engine)
        got, _ = ED.decode_forward(params, pcfg, tb["tokens"], memory=mem,
                                   engine=engine)
    else:
        got, _ = LM.forward(params, pcfg, tb["tokens"],
                            image_embeds=tb.get("image_embeds"),
                            engine=engine)
    assert got.dtype == getattr(torch, dtype)
    return _np(got)


# The bf16 case cuts reduced recurrentgemma (5 layers) to one period
# (rglru, rglru, swa) and seamless (2 + 2) to one encoder and one decoder
# layer: deeper, a single 1-ulp flip (a bf16 product summed in another
# order) spreads through later layers' attention (up to 2.75 ulps and 0.52
# ulp rms at seeds 0, 1 and 5, against a reference bf16-vs-fp32 spread of
# 4.3-6.0 and 0.66-0.97).  At the cut depth, seeds 0, 1, 5 and 7, both
# engines: at most 1.5 ulps (max) and 0.19 ulp (rms), against a spread of
# 1.66-4.79 and 0.31-0.73.
_BF16_DEPTH = {"recurrentgemma-2b": dict(n_layers=3),
               "seamless-m4t-medium": dict(n_layers=1, n_encoder_layers=1)}
# fp32 reference logits (through its sdpa) by (arch, cut): the fp32 case's
# reference and the bf16 case's spread, compiled once
_REF32 = {}


def _ref32(arch, ref, rcfg, batch):
    key = (arch, rcfg.n_layers, rcfg.n_encoder_layers)
    if key not in _REF32:
        _REF32[key] = _ref_family_logits(ref, rcfg, batch, "float32")
    return _REF32[key]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_forward_matches_reference(arch, dtype, monkeypatch):
    """Every position's logits of a 32-token prefill of the reduced MoE,
    recurrent, xLSTM, vision and encoder-decoder models, under both engines.
    fp32 at 1e-4, both engines against the reference through its ``sdpa``
    (B6's plain version computes the same function; its summation order
    moves fp32 logits by ~1e-6).  bf16: the torch engine against the
    reference, the cuda engine against the reference with its Pallas B6 at
    every attention site (the encoder's bidirectional and the decoder's
    cross attention included: B6 keeps fp32 probabilities where ``sdpa``
    rounds them to bf16), both at test_forward_matches_reference's gates,
    2 ulps of the largest logit (max) and a quarter ulp (rms), with the
    reference's own bf16-vs-fp32 spread above one of them (asserted;
    reduced phi-3-vision's max spread under B6, 0.061, sits just under 2
    ulps, 0.0625, its rms spread above); recurrentgemma and seamless at the
    depth of ``_BF16_DEPTH``."""
    rcfg, pcfg = _configs(arch, dtype)
    if dtype == "bfloat16" and arch in _BF16_DEPTH:
        rcfg = dataclasses.replace(rcfg, **_BF16_DEPTH[arch])
        pcfg = dataclasses.replace(pcfg, **_BF16_DEPTH[arch])
    ref, params = _params(rcfg, pcfg, seed=5)
    batch = _family_batch(rcfg, seed=5)
    want32 = _ref32(arch, ref, rcfg, batch)
    for engine in ENGINES:
        want, tol = want32, (1e-4, np.inf)
        if dtype == "bfloat16":
            if engine == "cuda":
                monkeypatch.setattr(RL, "sdpa", _flash_sdpa)
            want = _ref_family_logits(ref, rcfg, batch, dtype)
            ulp = _bf16_ulp(float(np.abs(want).max()))
            tol = (2 * ulp, ulp / 4)
            spread = _max_rms(want32 - want)
            assert spread[0] > tol[0] or spread[1] > tol[1], \
                (arch, engine, spread, tol)
        err = _max_rms(_port_family_logits(params, pcfg, batch, dtype,
                                           engine) - want)
        assert err[0] <= tol[0] and err[1] <= tol[1], \
            (arch, dtype, engine, err, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("engine", ENGINES)
def test_decode_matches_parallel_with_ring_wrap(engine, dtype):
    """Token-by-token decode against the parallel forward, in the port:
    reduced h2o-danube (window 16) with a 32-slot kv_len, so every layer's
    cache is a 16-slot ring that wraps after position 15 (the reference's
    ``test_models.py::test_decode_matches_parallel``, same bound in bf16)."""
    b = get_bundle("h2o-danube-1.8b", reduced=True)
    cfg = dataclasses.replace(b.cfg, dtype=dtype)
    bundle = type(b)(cfg)
    params = bundle.init(1, device="cpu")
    B, S = 2, 24
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        3, cfg.vocab_size, (B, S)).astype(np.int32))
    full, _ = LM.forward(params, cfg, toks, engine=engine)
    cache = bundle.init_cache(B, 32, device="cpu")
    assert cache[0][0].shape == (B, cfg.window, cfg.n_kv_heads, cfg.head_dim_)
    maxerr = 0.0
    for t in range(S):
        logits, cache = bundle.decode(params, cache,
                                      {"tokens": toks[:, t:t + 1], "pos": t},
                                      engine=engine)
        maxerr = max(maxerr, float((logits[:, 0].float()
                                    - full[:, t].float()).abs().max()))
    assert maxerr < (1e-4 if dtype == "float32" else 0.05), maxerr


def test_decode_matches_reference_decode():
    """Reduced h2o-danube in fp32: 24 decode steps through the reference's
    and the port's caches (ring wrapping at 16) give the same logits."""
    rcfg, pcfg = _configs("h2o-danube-1.8b")
    ref, params = _params(rcfg, pcfg, seed=3)
    rp = jax.tree.map(jnp.asarray, ref)
    toks = np.random.default_rng(3).integers(3, rcfg.vocab_size, (2, 24)
                                             ).astype(np.int32)
    rcache = RLM.init_cache(rcfg, 2, 32)
    dec = jax.jit(lambda p, c, t, pos: RLM.forward(p, rcfg, t, cache=c,
                                                   cache_pos=pos))
    caches = {e: LM.init_cache(pcfg, 2, 32, torch.device("cpu"))
              for e in ENGINES}
    for t in range(24):
        want, rcache = dec(rp, rcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        for e in ENGINES:
            got, caches[e] = LM.forward(params, pcfg,
                                        torch.from_numpy(toks[:, t:t + 1]),
                                        cache=caches[e], cache_pos=t,
                                        engine=e)
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                                       atol=1e-4)


def test_cpu_forward_launches_no_kernel():
    rcfg, pcfg = _configs("h2o-danube-1.8b")
    params = LM.init_params(pcfg, torch.Generator().manual_seed(0))
    before = dict(launch_counts)
    LM.forward(params, pcfg, torch.ones(1, 8, dtype=torch.int32),
               engine="cuda")
    assert launch_counts == before


# ---------------------------------------------------------------------------
# weights and registry
# ---------------------------------------------------------------------------
def _ref_layers(ref, rcfg):
    """The reference pytree's layers in the port's order (head layers, then
    period i's slot j as layer i * len(pattern) + j, then tail layers), or
    its unstacked encoder and decoder layers."""
    if rcfg.is_encdec:
        return {key: [jax.tree.map(lambda a: a[i], ref[key])
                      for i in range(n)]
                for key, n in (("enc_layers", rcfg.n_encoder_layers),
                               ("dec_layers", rcfg.n_layers))}
    head, pattern, npd, tail = RLM._layer_plan(rcfg)
    P = len(pattern)
    return {"layers": list(ref["head_layers"]) + [
        jax.tree.map(lambda a: a[n // P], ref["periods"][f"slot{n % P}"])
        for n in range(npd * P)] + list(ref["tail_layers"])}


@pytest.mark.parametrize("arch", ARCHS + ["gemma3-12b"] + FAMILIES)
def test_converter_round_trip(arch):
    """Every leaf of the reference's pytree reaches the port unchanged and in
    its dtype (bf16 by its bits; fp32 routers and gates stay fp32), the
    top-level leaves included (``img_proj``, ``frontend_proj``,
    ``enc_norm``), and the layers come out in the reference's order."""
    rcfg = ref_reduced_config(arch)
    init = RED.init_params if rcfg.is_encdec else RLM.init_params
    ref = jax.tree.map(np.asarray, init(rcfg, jax.random.key(4)))
    params = lm_params_from_numpy(ref, reduced_config(arch), "cpu")
    assert params["embed"].dtype == torch.bfloat16
    want = {k: v for k, v in ref.items()
            if k not in ("head_layers", "periods", "tail_layers",
                         "enc_layers", "dec_layers")}
    want.update(_ref_layers(ref, rcfg))
    assert jax.tree.structure(params) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(params)):
        assert str(b.dtype) == f"torch.{a.dtype}"
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


def test_converter_refuses_a_leaf_it_cannot_place():
    rcfg = ref_reduced_config("phi-3-vision-4.2b")
    ref = jax.tree.map(np.asarray, RLM.init_params(rcfg, jax.random.key(4)))
    ref["extra"] = {"w": ref["img_proj"]}
    with pytest.raises(ValueError, match="extra"):
        lm_params_from_numpy(ref, reduced_config("phi-3-vision-4.2b"), "cpu")


def _cache_leaves(tree):
    """(structure, [(shape, dtype name), ...]) of a cache pytree."""
    leaves, treedef = jax.tree.flatten(tree)
    return treedef, [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
                     for a in leaves]


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefills_and_decodes_on_the_cpu(arch):
    """Each reduced bundle of the families ported after the dense one
    prefills and decodes one step on the CPU under both engines, with
    finite logits; the decoded cache keeps ``init_cache``'s structure,
    shapes and dtypes, which are the reference's cache's, layer by layer
    (fp32 xLSTM states, KV caches and RG-LRU states in the model's type)."""
    b = get_bundle(arch, reduced=True)
    cfg = b.cfg
    params = b.init(0, device="cpu")
    batch = {k: torch.from_numpy(v) if k == "tokens" else
             _t(v).to(torch.bfloat16)
             for k, v in _family_batch(cfg, seed=6).items()}
    rcfg = ref_reduced_config(arch)
    rcache = jax.tree.map(np.asarray, RefBundle(rcfg).init_cache(2, 64))
    want = _cache_leaves(rcache if cfg.is_encdec
                         else _ref_layers(rcache, rcfg)["layers"])
    for engine in ENGINES:
        pre = b.prefill(params, batch, engine=engine)
        assert pre.shape == (2, 1, cfg.padded_vocab)
        assert bool(torch.isfinite(pre.float()).all())
        cache = b.init_cache(2, 64, device="cpu")
        assert _cache_leaves(cache) == want
        logits, new = b.decode(params, cache,
                               {"tokens": batch["tokens"][:, :1], "pos": 3},
                               engine=engine)
        assert logits.shape == (2, 1, cfg.padded_vocab)
        assert bool(torch.isfinite(logits.float()).all())
        assert _cache_leaves(new) == want


def test_bad_engine_raises():
    with pytest.raises(ValueError, match="attention engine"):
        L.resolve_attention_engine("pallas", "cpu")
    assert L.resolve_attention_engine("auto", "cpu") == "torch"
    assert L.resolve_attention_engine("auto", "cuda") == "cuda"
