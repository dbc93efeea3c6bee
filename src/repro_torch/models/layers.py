"""Transformer layers of the dense decoder: norms, RoPE, GQA attention (full
or sliding-window) and the GLU FFN (the port of ``repro/models/layers.py``;
its MoE waits for ROADMAP A9).

Conventions, the reference's: params are plain dicts of tensors (``wq``
``(d, Hq*D)``, ``wi`` ``(d, 2*d_ff)`` with gate || up, ...), activations
``(B, S, d)``, queries ``(B, S, Hq, D)`` and KV caches ``(B, S_cache, Hkv,
D)``.

``attention`` takes an engine (names from ``kernels.ENGINE_NAMES``):

* ``"torch"`` is the reference's own XLA formulation, op for op: ``sdpa``
  (einsums and mask algebra), ``_sdpa_chunked`` (the flash recurrence over
  1,024-key chunks for large score tensors) and ``_ring_sdpa``;
* ``"cuda"`` runs kernel B6 through ``kernels.ops.flash_attention`` (its
  plain version on CPU tensors);
* ``"auto"`` means ``"cuda"`` on CUDA tensors and ``"torch"`` elsewhere.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

__all__ = ["ATTENTION_ENGINES", "resolve_attention_engine", "dense_init",
           "rmsnorm", "rope", "attn_params", "sdpa", "attention",
           "ffn_params", "ffn"]

Params = Dict[str, torch.Tensor]
ATTENTION_ENGINES = ("torch", "cuda", "auto")


def resolve_attention_engine(engine: str, device) -> str:
    """``"auto"`` -> ``"cuda"`` for data on a CUDA device, else ``"torch"``."""
    if engine not in ATTENTION_ENGINES:
        raise ValueError(f"attention engine must be one of "
                         f"{ATTENTION_ENGINES}, got {engine!r}")
    if engine == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    return engine


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Normal(0, 1) * ``scale`` (default ``fan_in ** -0.5``), drawn in fp32 on
    the generator's device, then cast."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * s).to(dtype)


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMS norm in fp32 with the reference's ``1 + scale`` gain (the scales
    are initialised to zero)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S).  Angles in fp32."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs           # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def attn_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, hd = cfg.d_model, cfg.head_dim_
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros(width * hd, dtype=dtype, device=gen.device)
    return p


def _proj_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, cfg.n_heads, hd),
            k.reshape(B, S, cfg.n_kv_heads, hd),
            v.reshape(B, S, cfg.n_kv_heads, hd))


# score tensors larger than this (elements) take the chunked online-softmax
# formulation, as in the reference
_CHUNKED_THRESHOLD = 1 << 22
_KV_CHUNK = 1024


def _masked_scores(qg, k, q_positions, k_lo, causal, window, kv_valid_len):
    """(B,Sq,Hkv,g,D) x (B,bk,Hkv,D) -> masked f32 scores (B,Hkv,g,Sq,bk)."""
    D = qg.shape[-1]
    bk = k.shape[1]
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) \
        / (D ** 0.5)
    kpos = (k_lo + torch.arange(bk, dtype=torch.int32, device=k.device)
            ).reshape(1, 1, 1, 1, bk)
    qpos = q_positions[:, None, None, :, None]
    mask = torch.ones((1, 1, 1, qg.shape[1], bk), dtype=torch.bool,
                      device=k.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    if kv_valid_len is not None:
        mask = mask & (kpos < kv_valid_len[:, None, None, None, None])
    return torch.where(mask, scores, -1e30)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
         window: int, q_positions: torch.Tensor,
         kv_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked attention, the reference's formulation.

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D); q_positions: (B, Sq) absolute
    positions of the queries in KV coordinates; kv_valid_len: (B,) or None.
    Large score tensors use the chunked online-softmax path."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    if Sq * Skv > _CHUNKED_THRESHOLD and Skv % _KV_CHUNK == 0 and Sq > 1:
        return _sdpa_chunked(qg, k, v, causal=causal, window=window,
                             q_positions=q_positions,
                             kv_valid_len=kv_valid_len).reshape(B, Sq, Hq * D)
    scores = _masked_scores(qg, k, q_positions, 0, causal, window,
                            kv_valid_len)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, Hq * D)


def _sdpa_chunked(qg, k, v, *, causal, window, q_positions, kv_valid_len):
    """The flash recurrence over 1,024-key chunks (the reference's
    ``lax.scan``; its accumulator is in v's dtype)."""
    B, Sq, Hkv, g, D = qg.shape
    dev = k.device
    m = torch.full((B, Hkv, g, Sq), -1e30, dtype=torch.float32, device=dev)
    den = torch.zeros((B, Hkv, g, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, g, Sq, D), dtype=v.dtype, device=dev)
    for lo in range(0, k.shape[1], _KV_CHUNK):
        k_i, v_i = k[:, lo:lo + _KV_CHUNK], v[:, lo:lo + _KV_CHUNK]
        s = _masked_scores(qg, k_i, q_positions, lo, causal, window,
                           kv_valid_len)                     # (B,h,g,Sq,bk)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        den = den * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_i.dtype), v_i)
        acc = acc * alpha[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / torch.clamp(den, min=1e-30)[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4)                        # (B,Sq,Hkv,g,D)


def _ring_sdpa(q, kc, vc, ring_pos, cache_pos: int, window: int):
    """Attention over a ring-buffer KV: mask by true slot positions."""
    B, Sq, Hq, D = q.shape
    Hkv = kc.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), kc.float()) \
        / (D ** 0.5)
    valid = (ring_pos <= cache_pos) & (ring_pos > cache_pos - window) \
        & (ring_pos >= 0)
    scores = torch.where(valid[None, None, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(vc.dtype), vc)
    return out.reshape(B, Sq, Hq * D)


def _flash(q, k, v, *, causal, window, q_offset, kv_len):
    """B6 on the model's (B, S, H, D) tensors: transposed views go in, and
    the output comes back in q's layout as (B, Sq, Hq*D)."""
    B, Sq, Hq, D = q.shape
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              q_offset=q_offset, kv_len=kv_len)
    return out.transpose(1, 2).reshape(B, Sq, Hq * D)


def _write_cache(kc, vc, k, v, pos: int) -> None:
    """Write k, v into the caches in place at ``pos`` on the sequence axis.
    The start is clamped so that the update fits, as JAX's
    ``dynamic_update_slice`` clamps it; the reference donates its caches, so
    its update is in place too."""
    S = k.shape[1]
    start = min(max(pos, 0), kc.shape[1] - S)
    kc[:, start:start + S] = k
    vc[:, start:start + S] = v


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
              positions: torch.Tensor,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos: Optional[int] = None, engine: str = "auto"):
    """One self-attention mixer.  kind: 'attn' (full) or 'swa' (window).

    Prefill: cache is None, ``positions`` = [0, S).  Decode: cache = (k_cache,
    v_cache) in layout (B, S_cache, Hkv, D), updated in place at the write
    position ``cache_pos`` (an int), with ``positions`` = cache_pos + [0, S);
    for 'swa' with ``S_cache == window`` the cache is a ring buffer and
    writes wrap.  Returns (out, cache)."""
    engine = resolve_attention_engine(engine, x.device)
    window = cfg.window if kind == "swa" else 0
    q, k, v = _proj_qkv(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    S = x.shape[1]
    if cache is None:
        if engine == "torch":
            out = sdpa(q, k, v, causal=True, window=window,
                       q_positions=positions)
        else:
            out = _flash(q, k, v, causal=True, window=window, q_offset=0,
                         kv_len=S)
        return out @ p["wo"], None

    kc, vc = cache
    S_cache = kc.shape[1]
    pos = int(cache_pos)
    if window > 0 and S_cache == window:
        # ring buffer: absolute position -> slot = pos % window
        _write_cache(kc, vc, k, v, pos % window)
        if engine == "torch":
            # slot i holds the latest position p with p % window == i and
            # p <= pos
            idx = torch.arange(window, dtype=torch.int32, device=kc.device)
            ring_pos = pos - ((pos - idx) % window)
            out = _ring_sdpa(q, kc, vc, ring_pos, pos, window)
        else:
            # The reference masks every one of the S queries by cache_pos =
            # pos alone: ring_pos[i] = pos - ((pos - i) % W) lies in
            # (pos - W, pos] for every slot i <= pos and is i - W < 0 for
            # i > pos, so its valid set (ring_pos >= 0 and inside the window)
            # is exactly the first min(pos + 1, W) slots, the same for all S
            # queries, with no causal order among them.  B6 attends those
            # slots with no causal or window mask (softmax does not care
            # about the slots' order), for any S: group * S <= 16 rows take
            # the decode route, larger calls the prefill kernel.
            out = _flash(q, kc, vc, causal=False, window=0, q_offset=pos,
                         kv_len=min(pos + 1, window))
        return out @ p["wo"], (kc, vc)
    # full cache: write at pos, attend with the causal (and window) mask,
    # which hides the slots not yet written
    _write_cache(kc, vc, k, v, pos)
    if engine == "torch":
        out = sdpa(q, kc, vc, causal=True, window=window,
                   q_positions=positions)
    else:
        out = _flash(q, kc, vc, causal=True, window=window, q_offset=pos,
                     kv_len=S_cache)
    return out @ p["wo"], (kc, vc)


# ---------------------------------------------------------------------------
# FFN (GLU)
# ---------------------------------------------------------------------------
def ffn_params(gen: torch.Generator, d: int, f: int, dtype) -> Params:
    return {"wi": dense_init(gen, (d, 2 * f), dtype),    # fused gate || up
            "wo_f": dense_init(gen, (f, d), dtype)}


def ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    gate, up = (x @ p["wi"]).chunk(2, dim=-1)
    # jax.nn.silu is x * logistic(x), and XLA lowers logistic to
    # 1 / (1 + exp(-x)) with every step rounded to x's type.  F.silu rounds
    # once, which moves 2 in 5 bf16 outputs by an ulp.
    return (gate * (1 / (1 + torch.exp(-gate))) * up) @ p["wo_f"]
