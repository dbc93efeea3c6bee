"""Transformer layers: norms, RoPE, GQA attention (full, sliding-window,
bidirectional or cross), the GLU FFN and the top-k MoE FFN with capacity
dispatch, and the MoE load-balance loss (the port of
``repro/models/layers.py``).

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

Under an ambient mesh (``distributed.hints.use_mesh``) with a "model" axis
the layers run sharded on the blocks ``distributed.sharding`` gives each
rank; activations are whole within the model group.  Attention: each rank
takes a contiguous block of query heads and the KV heads they read; where
a rank's column block of ``wq``/``wk``/``wv`` is not those whole heads
(a block that splits a head, or KV heads that do not divide), the
projection's output is gathered over "model" and the heads cut from it;
``wo``, column-sharded by the rules (ROADMAP C17), is regrouped by one
all-to-all into the rank's heads' rows, and the partial products are
summed over "model".  The GLU FFN's fused ``wi`` is column-sharded as one
block, so a rank's block holds gate or up columns, not pairs: one
all-to-all hands each rank the gate and up columns of its ``f``-range,
the range of its row block of ``wo_f`` (the backward sends the gradient
back to the contiguous block).  Where heads or ``f`` do not divide, the
layer gathers its weights and runs whole on every rank.  The MoE layer
runs expert-parallel (``_moe_ffn_ep``) on any model axis, size 1
included, as the reference's does.  Cross-attention (keys and values from
an encoder's memory) shards as self-attention does.  The recurrent mixers
(``models.recurrent``) use the same helpers: ``_whole``/``_whole_rows``
for a layer that runs whole on every rank, ``_partial_sum`` for a
row-sharded output projection.

A decode step under the mesh takes its cache leaf's spec
(``DecodeShard``: the rules' ``cache_shardings``, which the cache carries,
``sharding.specs_of``), and the rank holds exactly that block.  Three
layouts of a ``(B, S, Hkv, D)`` KV cache, each for a full cache and a
ring (``S == window``):

* heads on "model": the rank's query heads and their KV heads, as a
  prefill's ``_attention_tp``; it writes its heads at ``pos``, runs B6 on
  its block, and ``wo`` is regrouped and summed as in prefill;
* the sequence on "model", or over every axis (a batch too small for the
  data axes): every rank needs every query head and the whole new K/V, so
  the projections' column blocks are gathered over "model"; the new K/V
  goes to the rank whose block holds its slot; each rank attends its
  block with B6's decode route writing each row's log-sum-exp and its
  output in fp32, skipping the launch where no row sees a key of it, and
  ``combine_partials`` merges the ranks' rows (all-gathered over the
  splitting axes) in fp32 and rounds once, a rank whose block a row
  cannot see weighing 0 (its LSE is 0 by the kernel's convention, which
  ``exp`` would count); ``wo`` then runs on whole heads, a column block a
  rank, gathered over "model" (a column-parallel product, exact: no
  partial sums);
* whole (neither divides): every rank attends the whole cache, as one
  rank does, and ``wo`` runs as in the sequence layout.

On a batch-1 mesh with a data axis above 1 the ranks of the data axis
compute the same activations and attend different sequence blocks: the
combine is over every axis, the TP products stay on "model".
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm, hints, sharding
from repro_torch.kernels import ops

__all__ = ["ATTENTION_ENGINES", "resolve_attention_engine", "mm", "dense_init",
           "rmsnorm", "rope", "attn_params", "sdpa", "attention",
           "cross_attention", "DecodeShard", "combine_partials",
           "decode_visible", "logistic", "ffn_params", "ffn", "moe_params",
           "moe_capacity", "moe_route", "moe_dispatch", "moe_experts",
           "moe_combine", "moe_ffn", "moe_load_balance_loss"]

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


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's type promotion: operands of two float types meet
    in the wider one (the reference's fp32 activations against bf16 weights
    after an optimizer step, ROADMAP C16, compute in fp32)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` with ``mm``'s promotion."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.bmm(x, w)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Normal(0, 1) * ``scale`` (default ``fan_in ** -0.5``), drawn in fp32 on
    the generator's device, then cast.  ``gen`` may also be a ``Drawer``,
    which takes the draw over."""
    if not isinstance(gen, torch.Generator):
        return gen.draw(shape, dtype, scale)
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * s).to(dtype)


class Drawer:
    """Stands in for a ``torch.Generator`` in the init functions (which
    read its ``device`` for their zero leaves): ``dense_init`` hands it
    every leaf to draw, in order.  This one draws nothing: each leaf is an
    empty meta tensor (torch has no meta generator)."""
    device = torch.device("meta")

    def draw(self, shape, dtype, scale):
        return torch.empty(shape, dtype=dtype, device="meta")


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
def attn_params(gen: torch.Generator, cfg: ModelConfig, dtype,
                cross: bool = False) -> Params:
    """Q/K/V/O projections; QKV biases (zero) where the config has them,
    never for cross-attention, as in the reference."""
    d, hd = cfg.d_model, cfg.head_dim_
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype),
    }
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros(width * hd, dtype=dtype, device=gen.device)
    return p


def _proj_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
              kv_input: Optional[torch.Tensor] = None):
    """Queries from ``x``, keys and values from ``kv_input`` (default
    ``x``)."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    kv_src = x if kv_input is None else kv_input
    q, k, v = mm(x, p["wq"]), mm(kv_src, p["wk"]), mm(kv_src, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    Skv = kv_src.shape[1]
    return (q.reshape(B, S, cfg.n_heads, hd),
            k.reshape(B, Skv, cfg.n_kv_heads, hd),
            v.reshape(B, Skv, cfg.n_kv_heads, hd))


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


def _chunk_step(m, den, acc, qg, k_i, v_i, q_positions, lo, causal, window,
                kv_valid_len):
    """One 1,024-key chunk of the flash recurrence: the new (max, sum,
    accumulator)."""
    s = _masked_scores(qg, k_i, q_positions, lo, causal, window,
                       kv_valid_len)                         # (B,h,g,Sq,bk)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    den = den * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_i.dtype), v_i)
    return m_new, den, acc * alpha[..., None].to(acc.dtype) + pv


def _sdpa_chunked(qg, k, v, *, causal, window, q_positions, kv_valid_len):
    """The flash recurrence over 1,024-key chunks (the reference's
    ``lax.scan``; its accumulator is in v's dtype).  While autograd records,
    each chunk runs under ``torch.utils.checkpoint``, as the reference's
    scan body runs under ``jax.checkpoint``: the backward keeps one chunk's
    scores at a time, not the whole (Sq, Skv) product."""
    B, Sq, Hkv, g, D = qg.shape
    dev = k.device
    m = torch.full((B, Hkv, g, Sq), -1e30, dtype=torch.float32, device=dev)
    den = torch.zeros((B, Hkv, g, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, g, Sq, D), dtype=v.dtype, device=dev)
    remat = torch.is_grad_enabled()
    for lo in range(0, k.shape[1], _KV_CHUNK):
        args = (m, den, acc, qg, k[:, lo:lo + _KV_CHUNK],
                v[:, lo:lo + _KV_CHUNK], q_positions, lo, causal, window,
                kv_valid_len)
        m, den, acc = checkpoint(_chunk_step, *args, use_reentrant=False) \
            if remat else _chunk_step(*args)
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
    if not q.dtype == k.dtype == v.dtype:   # the reference's sdpa promotes
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                 v.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              q_offset=q_offset, kv_len=kv_len)
    return out.transpose(1, 2).reshape(B, Sq, Hq * D)


def _write_cache(kc, vc, k, v, pos: int, lo: int = 0,
                 size: Optional[int] = None) -> None:
    """Write k, v into the caches in place at ``pos`` on the sequence axis.
    The start is clamped so that the update fits, as JAX's
    ``dynamic_update_slice`` clamps it; the reference donates its caches, so
    its update is in place too.  ``kc``/``vc`` may be the block from ``lo``
    of a logical cache of ``size`` slots: only the slots inside it are
    written."""
    S = k.shape[1]
    size = kc.shape[1] if size is None else size
    start = min(max(pos, 0), size - S)
    a, b = max(start, lo), min(start + S, lo + kc.shape[1])
    if a < b:
        kc[:, a - lo:b - lo] = k[:, a - start:b - start]
        vc[:, a - lo:b - lo] = v[:, a - start:b - start]


def _cache_attend(q, k, v, kc, vc, *, pos: int, window: int, causal: bool,
                  positions, engine: str) -> torch.Tensor:
    """Write the new K/V into a whole cache (the rank's KV heads of it, or
    all of them) at ``pos`` and attend it: a ring buffer where ``window >
    0`` and the cache holds ``window`` slots, else a full cache.  Returns
    (B, Sq, Hq*D)."""
    S_cache = kc.shape[1]
    if window > 0 and S_cache == window:
        # ring buffer: absolute position -> slot = pos % window
        _write_cache(kc, vc, k, v, pos % window)
        if engine == "torch":
            # slot i holds the latest position p with p % window == i and
            # p <= pos
            idx = torch.arange(window, dtype=torch.int32, device=kc.device)
            ring_pos = pos - ((pos - idx) % window)
            return _ring_sdpa(q, kc, vc, ring_pos, pos, window)
        # The reference masks every one of the S queries by cache_pos =
        # pos alone: ring_pos[i] = pos - ((pos - i) % W) lies in
        # (pos - W, pos] for every slot i <= pos and is i - W < 0 for
        # i > pos, so its valid set (ring_pos >= 0 and inside the window)
        # is exactly the first min(pos + 1, W) slots, the same for all S
        # queries, with no causal order among them.  B6 attends those
        # slots with no causal or window mask (softmax does not care
        # about the slots' order), for any S: group * S <= 16 rows take
        # the decode route, larger calls the prefill kernel.
        return _flash(q, kc, vc, causal=False, window=0, q_offset=pos,
                      kv_len=min(pos + 1, window))
    # full cache: write at pos, attend with the causal (and window) mask,
    # which hides the slots not yet written
    _write_cache(kc, vc, k, v, pos)
    if engine == "torch":
        return sdpa(q, kc, vc, causal=causal, window=window,
                    q_positions=positions)
    return _flash(q, kc, vc, causal=causal, window=window, q_offset=pos,
                  kv_len=S_cache)


# ---------------------------------------------------------------------------
# tensor parallelism: the ambient mesh's "model" axis
# ---------------------------------------------------------------------------
DECODE_NEEDS_SPECS = ("a decode step under a model axis needs its cache's "
                      "specs: a cache from init_cache(..., mesh=) or "
                      "interop.cache_from_numpy(..., mesh=)")


@dataclasses.dataclass(frozen=True)
class DecodeShard:
    """Where a layer's decode state lies under the ambient mesh: ``spec``,
    the spec of its cache leaf (a KV cache's keys, or a recurrent state's
    tuple of specs), and ``batch``, the spec entry of the activations'
    batch (the rank's rows of the batch)."""
    spec: Any
    batch: Any = None


def model_axis():
    """``(tp, rank on "model", model group)`` of the ambient mesh, or None
    without a mesh or a "model" axis."""
    mesh = hints.current_mesh()
    if mesh is None or hints.axis("model") is None:
        return None
    return mesh.shape["model"], mesh.coords["model"], mesh.group_of("model")


def tp_size() -> int:
    """The size of the ambient "model" axis (1 without one)."""
    m = model_axis()
    return 1 if m is None else m[0]


def _whole(w: torch.Tensor, width: int) -> torch.Tensor:
    """The logical ``(rows, width)`` weight from this rank's block, which
    the rules shard on its columns where ``width`` divides the model
    axis, for work every rank does alike."""
    tp, _, group = model_axis()
    return w if width % tp else comm.gather(w, group, 1, partial=False)


def _whole_rows(w: torch.Tensor, height: int) -> torch.Tensor:
    """The logical weight of ``height`` rows from this rank's block, which
    the rules shard on its first dim where ``height`` divides the model
    axis (a row-parallel projection, per-head tensors), for work every rank
    does alike."""
    tp, _, group = model_axis()
    return w if height % tp else comm.gather(w, group, 0, partial=False)


def _paired_columns(w: torch.Tensor, f: int) -> torch.Tensor:
    """The gate and up columns of this rank's ``f``-range from the
    contiguous column blocks of a fused gate || up ``(d, 2f)`` weight.
    Global pieces of ``f / tp`` columns: rank ``r`` holds pieces ``2r`` and
    ``2r + 1`` and needs ``r`` (gate) and ``tp + r`` (up); piece ``j`` goes
    to rank ``j % tp``.  One all-to-all; its backward sends the gradient
    back."""
    tp, r, group = model_axis()
    if tp == 1:
        return w
    d, wp = w.shape[0], f // tp
    pieces = w.T.reshape(2, wp, d)
    dest = [(2 * r) % tp, (2 * r + 1) % tp]
    order = sorted(range(2), key=lambda i: dest[i])
    send = torch.cat([pieces[i] for i in order])
    src = [r // 2, (tp + r) // 2]            # gate's owner first
    recv = comm.exchange(
        send, group, [wp * dest.count(t) for t in range(tp)],
        [wp * src.count(t) for t in range(tp)])
    return recv.reshape(2 * wp, d).T


def _head_rows(w: torch.Tensor, n_rows: int) -> torch.Tensor:
    """This rank's ``n_rows`` rows (its heads' block) of every column of a
    weight column-sharded over "model": one all-to-all regroups the column
    blocks into row blocks; its backward regroups the gradient back."""
    tp, _, group = model_axis()
    if tp == 1:
        return w
    recv = comm.exchange(w.contiguous(), group, [n_rows] * tp,
                         [n_rows] * tp)
    c = w.shape[1]
    return recv.reshape(tp, n_rows, c).permute(1, 0, 2).reshape(
        n_rows, tp * c)


def _partial_sum(x: torch.Tensor, w: torch.Tensor, group,
                 extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` summed over the model group, for partial products (a
    rank's heads, or its ``f``-range): half types multiply into fp32 and
    are rounded once, after the sum, as one whole product's fp32
    accumulation is; ``extra``, a partial of its own, joins the sum."""
    dt = torch.promote_types(x.dtype, w.dtype)
    if dt in (torch.bfloat16, torch.float16):
        y = x.float() @ w.float()
        if extra is not None:
            y = y + extra.float()
        return comm.reduce_from(y, group).to(dt)
    y = mm(x, w)
    return comm.reduce_from(y if extra is None else y + extra, group)


def _glu_ffn_tp(wi: torch.Tensor, wo_f: torch.Tensor, f: int,
                x: torch.Tensor) -> torch.Tensor:
    """The GLU FFN on this rank's blocks of ``wi`` (d, 2f) and ``wo_f``
    (f, d); its output is whole on every rank."""
    tp, _, group = model_axis()
    if f % tp == 0:
        xc = comm.copy_to(x, group)
        return _partial_sum(_glu(mm(xc, _paired_columns(wi, f))), wo_f,
                            group)
    return mm(_glu(mm(x, _whole(wi, 2 * f))), wo_f)


def _attention_tp(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  window: int, positions: torch.Tensor, causal: bool,
                  engine: str, kv_input: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Self-attention, or cross-attention over ``kv_input`` (keys and
    values from it, no RoPE), of a full pass (train, prefill) on this
    rank's blocks; the output is whole on every rank."""
    tp, r, group = model_axis()
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    n, g = Hq // tp, Hq // Hkv
    if Hq % tp or (n % g and g % n):
        # heads that do not divide: every rank runs the whole layer
        cols = {"wq": Hq * hd, "wk": Hkv * hd, "wv": Hkv * hd,
                "wo": cfg.d_model}
        pw = {k: _whole(v, cols[k]) if k in cols else v
              for k, v in p.items()}
        return _self_attention(pw, x, cfg, window=window, positions=positions,
                               causal=causal, engine=engine,
                               kv_input=kv_input)
    xc = comm.copy_to(x, group)
    src = xc if kv_input is None else comm.copy_to(kv_input, group)
    q_lo, kv_lo, n_kv = _tp_heads(cfg)
    q = _tp_proj(p, "wq", "bq", Hq, q_lo, n, xc, hd)
    k = _tp_proj(p, "wk", "bk", Hkv, kv_lo, n_kv, src, hd)
    v = _tp_proj(p, "wv", "bv", Hkv, kv_lo, n_kv, src, hd)
    if kv_input is None:              # RoPE for self-attention only
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = _attend(q, k, v, causal=causal, window=window, positions=positions,
                  engine=engine)
    return _tp_out(p, out, cfg)


def _tp_heads(cfg: ModelConfig) -> Tuple[int, int, int]:
    """``(first query head, first KV head, KV heads)`` of this rank's
    contiguous block of ``n_heads / tp`` query heads and the KV heads they
    read."""
    tp, r, _ = model_axis()
    n, g = cfg.n_heads // tp, cfg.n_heads // cfg.n_kv_heads
    return r * n, r * n // g, max(n // g, 1)


def _tp_proj(p: Params, name: str, bias: str, heads: int, lo: int, cnt: int,
             inp: torch.Tensor, hd: int) -> torch.Tensor:
    """Heads ``[lo, lo + cnt)`` of a projection, (B, S, cnt, hd), from this
    rank's column block of ``p[name]`` (``heads`` heads in all)."""
    tp, r, group = model_axis()
    cut = slice(lo * hd, (lo + cnt) * hd)
    if heads * hd % tp == 0:
        y = mm(inp, p[name])
        if not (heads % tp == 0 and lo == r * (heads // tp)
                and cnt == heads // tp):
            # the rank's columns are not the heads it needs (a split head,
            # KV heads that do not divide): gather, then cut
            y = comm.gather(y, group, -1)[..., cut]
    else:
        y = mm(inp, comm.copy_to(p[name], group)[:, cut])
    if bias in p:
        y = y + comm.copy_to(p[bias], group)[cut]
    return y.reshape(inp.shape[0], inp.shape[1], cnt, hd).contiguous()


def _tp_out(p: Params, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``wo`` on this rank's heads' output (B, S, n*hd), summed over
    "model": the rows of its heads, regrouped from the column blocks
    (C17)."""
    tp, _, group = model_axis()
    n, hd = cfg.n_heads // tp, cfg.head_dim_
    q_lo = _tp_heads(cfg)[0]
    if cfg.d_model % tp == 0:                 # wo column-sharded (C17)
        wo = _head_rows(p["wo"], n * hd)
    else:
        wo = comm.copy_to(p["wo"], group)[q_lo * hd:(q_lo + n) * hd]
    return _partial_sum(out, wo, group)


def _attend(q, k, v, *, causal, window, positions, engine):
    """Prefill attention of (B, S, H, D) queries over their own keys."""
    if engine == "torch":
        return sdpa(q, k, v, causal=causal, window=window,
                    q_positions=positions)
    # queries at offset 0: the default kv_len - Sq is negative where a
    # cross-attention's Sq exceeds its Skv
    return _flash(q, k, v, causal=causal, window=window, q_offset=0,
                  kv_len=k.shape[1])


def _self_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    window: int, positions: torch.Tensor, causal: bool,
                    engine: str, kv_input=None) -> torch.Tensor:
    q, k, v = _proj_qkv(p, x, cfg, kv_input)
    if kv_input is None:              # RoPE for self-attention only
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = _attend(q, k, v, causal=causal, window=window, positions=positions,
                  engine=engine)
    return mm(out, p["wo"])


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
              positions: torch.Tensor,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos: Optional[int] = None,
              kv_input: Optional[torch.Tensor] = None, causal: bool = True,
              engine: str = "auto", shard: Optional[DecodeShard] = None):
    """One attention mixer.  kind: 'attn' (full) or 'swa' (window).

    Prefill: cache is None, ``positions`` = [0, S); ``causal=False`` is the
    encoder's bidirectional attention, and ``kv_input`` (B, S_kv, d) makes
    it cross-attention (keys and values from ``kv_input``, no RoPE).
    Decode: cache = (k_cache, v_cache) in layout (B, S_cache, Hkv, D),
    updated in place at the write position ``cache_pos`` (an int), with
    ``positions`` = cache_pos + [0, S); for 'swa' with ``S_cache == window``
    the cache is a ring buffer and writes wrap.  Under the ambient mesh,
    ``shard`` says which block of the logical cache this rank holds (see
    the module's docstring).  Returns (out, cache)."""
    engine = resolve_attention_engine(engine, x.device)
    window = cfg.window if kind == "swa" else 0
    if cache is not None and shard is not None \
            and hints.current_mesh() is not None:
        return _decode_sharded(p, x, cfg, cache, int(cache_pos), shard.spec,
                               window=window, causal=causal,
                               positions=positions, engine=engine)
    if tp_size() > 1:
        if cache is not None:
            raise ValueError(DECODE_NEEDS_SPECS)
        return _attention_tp(p, x, cfg, window=window, positions=positions,
                             causal=causal, engine=engine,
                             kv_input=kv_input), None
    if cache is None:
        return _self_attention(p, x, cfg, window=window, positions=positions,
                               causal=causal, engine=engine,
                               kv_input=kv_input), None
    q, k, v = _proj_qkv(p, x, cfg, kv_input)
    if kv_input is None:              # RoPE for self-attention only
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    kc, vc = cache
    out = _cache_attend(q, k, v, kc, vc, pos=int(cache_pos), window=window,
                        causal=causal, positions=positions, engine=engine)
    return mm(out, p["wo"]), (kc, vc)


def cross_attention(p: Params, x: torch.Tensor, ck: torch.Tensor,
                    cv: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, engine: str = "auto",
                    shard: Optional[DecodeShard] = None) -> torch.Tensor:
    """The decoder's cross-attention at decode time, over keys and values
    projected once (``ck``/``cv``, (B, S_src, Hkv, D)): the reference's
    ``sdpa(q, ck, cv, causal=False)`` on ``x @ wq``, then ``wo``.  Under
    the ambient mesh ``shard`` gives the block of the cross cache this rank
    holds (the layouts of self-attention's caches, every key visible)."""
    engine = resolve_attention_engine(engine, x.device)
    B, S, _ = x.shape
    if shard is not None and hints.current_mesh() is not None:
        _, sspec, hspec, _ = shard.spec
        if hspec is not None:
            q_lo = _tp_heads(cfg)[0]
            tp, _, group = model_axis()
            q = _tp_proj(p, "wq", "bq", cfg.n_heads, q_lo, cfg.n_heads // tp,
                         comm.copy_to(x, group), cfg.head_dim_)
            return _tp_out(p, _cross_attend(q, ck, cv, positions, engine),
                           cfg)
        q = _whole_cols(x, p["wq"], cfg.n_heads * cfg.head_dim_).reshape(
            B, S, cfg.n_heads, cfg.head_dim_)
        if sspec is None:
            out = _cross_attend(q, ck, cv, positions, engine)
        else:
            out = _sequence_attend(q, ck, cv, sspec, kv_len=None, pos=0,
                                   causal=False, window=0, engine=engine)
        return _whole_cols(out, p["wo"], cfg.d_model)
    if tp_size() > 1:
        raise ValueError(DECODE_NEEDS_SPECS)
    q = mm(x, p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim_)
    return mm(_cross_attend(q, ck, cv, positions, engine), p["wo"])


def _cross_attend(q, ck, cv, positions, engine):
    if engine == "torch":
        return sdpa(q, ck, cv, causal=False, window=0, q_positions=positions)
    return _flash(q, ck, cv, causal=False, window=0, q_offset=0,
                  kv_len=ck.shape[1])


# ---------------------------------------------------------------------------
# sharded decode
# ---------------------------------------------------------------------------
def _whole_cols(x: torch.Tensor, w: torch.Tensor, width: int
                ) -> torch.Tensor:
    """``x @ w`` whole on every rank, for a weight of ``width`` columns
    that the rules shard on its columns where ``width`` divides the model
    axis: the rank's columns, gathered over "model" (a column-parallel
    product: each column is the whole product's)."""
    tp = tp_size()
    y = mm(x, w)
    if tp == 1 or width % tp:
        return y
    return comm.gather(y, model_axis()[2], -1, partial=False)


def _whole_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Every head's q, k and v of ``x`` on every rank (``_proj_qkv`` of
    the logical weights, from the rank's column blocks)."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    out = []
    for name, bias, heads in (("wq", "bq", cfg.n_heads),
                              ("wk", "bk", cfg.n_kv_heads),
                              ("wv", "bv", cfg.n_kv_heads)):
        y = _whole_cols(x, p[name], heads * hd)
        if bias in p:
            y = y + p[bias]
        out.append(y.reshape(B, S, heads, hd))
    return tuple(out)


def decode_visible(Sq: int, pos: int, size: int, n_blocks: int, *,
                   causal: bool, window: int, ring: bool,
                   kv_len: Optional[int] = None) -> list:
    """Which of the ``n_blocks`` equal sequence blocks of a ``size``-slot
    cache each query row ``pos + i`` (``i < Sq``) sees a key of: a list of
    ``n_blocks`` lists of ``Sq`` bools.  A ring (``size == window``) holds
    its first ``min(pos + 1, window)`` slots for every row (as one rank's
    decode reads them); a full cache the keys ``j < kv_len`` (default
    ``size``) with ``j <= pos + i`` (``causal``) and ``j > pos + i -
    window`` (``window > 0``)."""
    b = size // n_blocks
    out = []
    for r in range(n_blocks):
        lo, hi = r * b, (r + 1) * b - 1
        row = []
        for i in range(Sq):
            if ring:
                first, last = 0, min(pos + 1, size) - 1
            else:
                last = min(pos + i if causal else size - 1,
                           (size if kv_len is None else kv_len) - 1)
                first = max(0, pos + i - window + 1) if window > 0 else 0
            row.append(max(first, lo) <= min(last, hi))
        out.append(row)
    return out


def combine_partials(outs: torch.Tensor, lses: torch.Tensor,
                     visible: torch.Tensor) -> torch.Tensor:
    """The softmax over the union of ``n`` key blocks from each block's
    rows: ``outs`` (n, B, Sq, H, D), each block's normalised output;
    ``lses`` (n, B, H, Sq), their log-sum-exps; ``visible`` (n, Sq) bool,
    whether row ``i`` sees a key of block ``r``.  In fp32: the weights are
    ``exp(lse_r - max lse)`` over the visible blocks and 0 elsewhere (an
    empty block's LSE is 0 by the kernels' convention, not -inf); a row no
    block shows a key is 0.  Returns (B, Sq, H, D) fp32."""
    vis = visible.to(lses.device)[:, None, :, None]          # (n,1,Sq,1)
    lse = torch.where(vis, lses.float().transpose(2, 3), -torch.inf)
    top = lse.amax(dim=0)
    top = torch.where(torch.isinf(top), torch.zeros_like(top), top)
    w = torch.where(vis, torch.exp(lse - top), torch.zeros_like(lse))
    den = w.sum(dim=0)
    num = (w[..., None] * outs.float()).sum(dim=0)
    return torch.where(den[..., None] > 0,
                       num / torch.where(den > 0, den, 1.0)[..., None],
                       torch.zeros_like(num))


def _sdpa_lse(q, k, v, *, causal, window, q_offset, kv_len):
    """The torch engine's partial softmax of (B, Sq, Hq, D) queries at
    positions ``q_offset + i`` over a block of keys (B, bk, Hkv, D): the
    fp32 output (B, Sq, Hq, D) and each row's log-sum-exp (B, Hq, Sq), the
    einsum formulation of ``sdpa`` (keys at or past ``kv_len`` hidden)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    qpos = (q_offset + torch.arange(Sq, dtype=torch.int32, device=q.device)
            ).expand(B, Sq)
    valid = torch.full((B,), kv_len, dtype=torch.int32, device=q.device)
    s = _masked_scores(qg, k, qpos, 0, causal, window, valid)
    lse = torch.logsumexp(s, dim=-1)                          # (B,h,g,Sq)
    out = torch.einsum("bhgqk,bkhd->bqhgd", torch.exp(s - lse[..., None]),
                       v.float())
    return out.reshape(B, Sq, Hq, D), lse.reshape(B, Hq, Sq)


def _sequence_attend(q, kc, vc, entry, *, kv_len: Optional[int], pos: int,
                     causal: bool, window: int, engine: str,
                     ring: bool = False) -> torch.Tensor:
    """Attention of every head of q (B, Sq, Hq, D) over a cache whose
    sequence is split over the axes of ``entry``, this rank holding block
    ``kc``/``vc``: each rank's partial rows (B6's decode route with its
    log-sum-exp; no launch where no row sees a key of the block), gathered
    over those axes and merged by ``combine_partials``.  Returns (B, Sq,
    Hq*D) in q's type, rounded once."""
    mesh = hints.current_mesh()
    B, Sq, Hq, D = q.shape
    n, b = sharding.n_blocks(entry, mesh), kc.shape[1]
    size = b * n
    lo = sharding.block_range(size, entry, mesh)[0]
    visible = decode_visible(Sq, pos, size, n, causal=causal, window=window,
                             ring=ring, kv_len=kv_len)
    if ring:
        causal, local_len = False, max(0, min(min(pos + 1, size) - lo, b))
    elif causal:
        local_len = max(0, min(pos + Sq - lo, b))
    else:
        local_len = max(0, min((size if kv_len is None else kv_len) - lo, b))
    mine = visible[lo // b]
    if any(mine):
        kw = dict(causal=causal, window=0 if ring else window,
                  q_offset=pos - lo, kv_len=local_len)
        if engine == "torch":
            out, lse = _sdpa_lse(q, kc, vc, **kw)
        else:
            if not q.dtype == kc.dtype == vc.dtype:
                dt = torch.promote_types(q.dtype, kc.dtype)
                q, kc, vc = q.to(dt), kc.to(dt), vc.to(dt)
            # the block's output unrounded (fp32): the merge rounds once
            out, lse = ops.flash_attention(
                q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                return_lse=True, out_dtype=torch.float32, **kw)
            out = out.transpose(1, 2)
    else:                  # the block is hidden from every row: no launch
        out = torch.zeros((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
        lse = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device)
    flat = torch.cat([out.float().reshape(B, -1), lse.reshape(B, -1)], dim=1)
    got = comm.all_gather_cat(flat[None], mesh.group_of(
        *sharding.axes_of(entry)))                           # (n, B, ...)
    outs = got[:, :, :Sq * Hq * D].reshape(n, B, Sq, Hq, D)
    lses = got[:, :, Sq * Hq * D:].reshape(n, B, Hq, Sq)
    merged = combine_partials(outs, lses, torch.tensor(visible))
    return merged.to(q.dtype).reshape(B, Sq, Hq * D)


def _decode_sharded(p: Params, x: torch.Tensor, cfg: ModelConfig, cache,
                    pos: int, spec, *, window: int, causal: bool, positions,
                    engine: str):
    """A self-attention decode step on this rank's block of the logical
    cache under ``spec`` (B, S, Hkv, D); the output is whole on every rank
    of the model group."""
    kc, vc = cache
    _, sspec, hspec, _ = spec
    if hspec is not None:                    # heads on "model"
        tp, _, group = model_axis()
        q_lo, kv_lo, n_kv = _tp_heads(cfg)
        xc = comm.copy_to(x, group)
        hd = cfg.head_dim_
        q = _tp_proj(p, "wq", "bq", cfg.n_heads, q_lo, cfg.n_heads // tp, xc,
                     hd)
        k = _tp_proj(p, "wk", "bk", cfg.n_kv_heads, kv_lo, n_kv, xc, hd)
        v = _tp_proj(p, "wv", "bv", cfg.n_kv_heads, kv_lo, n_kv, xc, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        out = _cache_attend(q, k, v, kc, vc, pos=pos, window=window,
                            causal=causal, positions=positions, engine=engine)
        return _tp_out(p, out, cfg), (kc, vc)
    q, k, v = _whole_qkv(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if sspec is None:                        # the whole cache on every rank
        out = _cache_attend(q, k, v, kc, vc, pos=pos, window=window,
                            causal=causal, positions=positions, engine=engine)
    else:
        mesh = hints.current_mesh()
        size = kc.shape[1] * sharding.n_blocks(sspec, mesh)
        lo = sharding.block_range(size, sspec, mesh)[0]
        ring = window > 0 and size == window
        # the new K/V goes to the rank whose block holds its slot
        _write_cache(kc, vc, k, v, pos % window if ring else pos, lo, size)
        out = _sequence_attend(q, kc, vc, sspec, kv_len=None, pos=pos,
                               causal=causal, window=window, engine=engine,
                               ring=ring)
    return _whole_cols(out, p["wo"], cfg.d_model), (kc, vc)


# ---------------------------------------------------------------------------
# FFN (GLU) and MoE
# ---------------------------------------------------------------------------
def logistic(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA lowers it, ``1 / (1 + exp(-x))`` with every
    step rounded to x's type (``torch.sigmoid`` rounds once, which moves
    some bf16 outputs by an ulp)."""
    return 1 / (1 + torch.exp(-x))


def _glu(gu: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up of a fused gate || up product."""
    gate, up = gu.chunk(2, dim=-1)
    return gate * logistic(gate) * up


def ffn_params(gen: torch.Generator, d: int, f: int, dtype) -> Params:
    return {"wi": dense_init(gen, (d, 2 * f), dtype),    # fused gate || up
            "wo_f": dense_init(gen, (f, d), dtype)}


def ffn(p: Params, x: torch.Tensor, d_ff: Optional[int] = None
        ) -> torch.Tensor:
    """The GLU FFN.  Under a model axis above 1 it runs on this rank's
    blocks and needs the logical width ``d_ff``."""
    if tp_size() > 1:
        if d_ff is None:
            raise ValueError("a tensor-parallel FFN needs its d_ff")
        return _glu_ffn_tp(p["wi"], p["wo_f"], d_ff, x)
    # jax.nn.silu is x * logistic(x), and XLA lowers logistic to
    # 1 / (1 + exp(-x)) with every step rounded to x's type.  F.silu rounds
    # once, which moves 2 in 5 bf16 outputs by an ulp.
    return mm(_glu(mm(x, p["wi"])), p["wo_f"])


def moe_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    """Router (fp32, over the padded experts), the experts' fused gate || up
    and down projections, and the shared experts' (fused into one FFN of
    ``d_ff * n_shared_experts``).  The padded experts get weights too; the
    router never picks them."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.padded_experts
    p = {"router": dense_init(gen, (d, e), torch.float32),
         "we_i": dense_init(gen, (e, d, 2 * f), dtype),
         "we_o": dense_init(gen, (e, f, d), dtype)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_i"] = dense_init(gen, (d, 2 * fs), dtype)
        p["shared_o"] = dense_init(gen, (fs, d), dtype)
    return p


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert, the reference's Python float arithmetic."""
    return int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts) + 1


def moe_route(p: Params, xt: torch.Tensor, cfg: ModelConfig):
    """Router: fp32 logits over the padded experts (padded ones at -1e30),
    the top-k experts of each token, lower index first among equal logits
    (``jax.lax.top_k``'s order: a stable descending sort), and their gates,
    a softmax over the k logits in fp32 cast to x's type.  Returns
    ``(gates (T, k), experts (T, k) int64)``."""
    logits = mm(xt.float(), p["router"])
    if cfg.padded_experts != cfg.n_experts:
        pad = torch.arange(cfg.padded_experts, device=xt.device) \
            >= cfg.n_experts
        logits = torch.where(pad[None, :], -1e30, logits)
    top, experts = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, experts = top[:, :cfg.top_k], experts[:, :cfg.top_k]
    return torch.softmax(top, dim=-1).to(xt.dtype), experts


def moe_dispatch(xt: torch.Tensor, experts: torch.Tensor, cfg: ModelConfig,
                 capacity: int, e_lo: int = 0, n_local: Optional[int] = None):
    """Each (token, choice) pair's rank among the earlier pairs (flat
    ``T * k`` order) that chose the same expert; pairs ranked past
    ``capacity`` are dropped; the kept ones of experts ``[e_lo, e_lo +
    n_local)`` (default: all) are copied into their expert's buffer row.
    Returns ``(buf (n_local, C, d), slot (T*k,), keep (T*k,), rank
    (T*k,))``: ``slot`` is ``(expert - e_lo) * C + rank`` where kept and
    local, ``n_local * C`` elsewhere.  Nothing here waits for the
    device."""
    e_pad, k = cfg.padded_experts, cfg.top_k
    n_local = e_pad if n_local is None else n_local
    T, d = xt.shape
    flat_e = experts.reshape(-1)
    onehot = (torch.arange(e_pad, device=xt.device)[:, None] == flat_e[None, :]
              ).to(torch.int32)                               # (E, T*k)
    # exclusive per-expert count, exact in int64, scanned along each
    # expert's row
    excl = torch.cumsum(onehot, dim=1, dtype=torch.int64) - onehot
    rank = excl.gather(0, flat_e[None, :])[0]
    keep = (rank < capacity) & (flat_e >= e_lo) & (flat_e < e_lo + n_local)
    slot = torch.where(keep, (flat_e - e_lo) * capacity + rank,
                       n_local * capacity)
    token_idx = torch.arange(T, device=xt.device).repeat_interleave(k)
    # kept slots are distinct; every other pair lands on the spare last
    # row, which is cut off
    buf = torch.zeros((n_local * capacity + 1, d), dtype=xt.dtype,
                      device=xt.device)
    buf.index_copy_(0, slot, xt[token_idx])
    return buf[:-1].reshape(n_local, capacity, d), slot, keep, rank


def moe_experts(p: Params, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's GLU FFN on its buffer: two batched products over the
    expert axis ((E, C, d) -> (E, C, d))."""
    return bmm(_glu(bmm(buf, p["we_i"])), p["we_o"])


def moe_combine(out_e: torch.Tensor, gates: torch.Tensor, slot: torch.Tensor,
                keep: torch.Tensor) -> torch.Tensor:
    """Each token's kept choices, weighted by their gates in x's type, summed
    in choice order from zeros with a rounding to x's type after each add:
    the reference's ``zeros.at[token_idx].add(...)``, whose updates for one
    token are consecutive, with no atomics (one result on every device).
    Returns (T, d)."""
    E, C, d = out_e.shape
    T, k = gates.shape
    flat = out_e.reshape(E * C, d)
    gathered = flat[slot.clamp(0, E * C - 1)]
    gathered = torch.where(keep[:, None], gathered, 0)
    contrib = (gathered * gates.reshape(-1)[:, None]).reshape(T, k, d)
    yt = torch.zeros((T, d), dtype=out_e.dtype, device=out_e.device)
    for j in range(k):
        yt = yt + contrib[:, j]
    return yt


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE with capacity dispatch.  Under an ambient mesh with a
    "model" axis (of any size, as in the reference) the expert-parallel
    path ``_moe_ffn_ep``; else the reference's dense-buffer path
    (``_moe_ffn_dense``, one global capacity over the call's tokens), then
    the shared experts added after the routed sum.  x: (B, S, d)."""
    if hints.axis("model"):
        return _moe_ffn_ep(p, x, cfg)
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    gates, experts = moe_route(p, xt, cfg)
    buf, slot, keep, _ = moe_dispatch(xt, experts, cfg,
                                      moe_capacity(cfg, B * S))
    buf = hints.constrain(buf, "model", None, None)
    out_e = hints.constrain(moe_experts(p, buf), "model", None, None)
    yt = hints.constrain(moe_combine(out_e, gates, slot, keep),
                         hints.dp_axes(), None)
    if "shared_i" in p:
        yt = yt + ffn({"wi": p["shared_i"], "wo_f": p["shared_o"]}, xt)
    return yt.reshape(B, S, d)


def _moe_ffn_ep(p: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """The reference's explicit expert-parallel MoE (``_moe_ffn_ep``) on
    this rank: its block of ``padded_experts / tp`` experts, the tokens of
    its data shard (activations whole over "model"), the per-group
    capacity ``int(cf * k * T_loc / E) + 1`` of those ``T_loc`` tokens
    (GShard's group: one data shard's tokens; the whole batch where the
    data axes do not divide it, since the batch then is whole on every
    rank), routing on every rank alike, the slot-indexed dispatch of the
    rank's own experts, and one sum over "model".  Its combine adds a
    token's kept choices in choice order (``moe_combine``), where the
    reference's scatter adds them in slot order: the same sum, rounded
    apart in the last place.  The shared experts are the dense path's,
    gate column ``j`` paired with up column ``j + fs`` (ROADMAP C18,
    departed: the reference's EP pairs each rank's contiguous block half
    with half, a different model on every mesh).  The reference gathers
    and scatters sequence-sharded residuals around the layer; the port's
    residuals are whole over "model", so it has nothing to move there."""
    tp, r, group = model_axis()
    e_pad = cfg.padded_experts
    if e_pad % tp:
        raise ValueError(f"{e_pad} experts do not divide a model axis of {tp}")
    B, S, d = x.shape
    n_local = e_pad // tp
    xt = comm.copy_to(x, group).reshape(B * S, d)
    gates, experts = moe_route({"router": comm.copy_to(p["router"], group)},
                               xt, cfg)
    buf, slot, keep, _ = moe_dispatch(xt, experts, cfg,
                                      moe_capacity(cfg, B * S),
                                      e_lo=r * n_local, n_local=n_local)
    yt = moe_combine(moe_experts(p, buf), gates, slot, keep)
    fs = cfg.d_ff * cfg.n_shared_experts
    if "shared_i" in p and fs % tp == 0:     # rides the routed experts' sum
        h = _glu(mm(xt, _paired_columns(p["shared_i"], fs)))
        return _partial_sum(h, p["shared_o"], group, extra=yt).reshape(
            B, S, d)
    y = comm.reduce_from(yt, group)
    if "shared_i" in p:
        y = y + _glu_ffn_tp(p["shared_i"], p["shared_o"], fs,
                            x.reshape(B * S, d))
    return y.reshape(B, S, d)


def moe_load_balance_loss(p: Params, x: torch.Tensor, cfg: ModelConfig
                          ) -> torch.Tensor:
    """The reference's auxiliary load-balance loss: ``n_experts * sum_e
    (share of tokens routed to e) * (mean router probability of e)``, with
    the fp32 router over the padded experts (padded ones at -1e30) and the
    top-k by ``moe_route``'s stable descending sort.  x: (B, S, d)."""
    xt = x.reshape(-1, x.shape[-1])
    logits = mm(xt.float(), p["router"])
    if cfg.padded_experts != cfg.n_experts:
        pad = torch.arange(cfg.padded_experts, device=x.device) \
            >= cfg.n_experts
        logits = torch.where(pad[None, :], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(logits, dim=-1, descending=True, stable=True)[1]
    onehot = torch.nn.functional.one_hot(
        top[:, :cfg.top_k], cfg.padded_experts).to(torch.float32).sum(1)
    mesh, dp = hints.current_mesh(), hints.dp_axes()
    if dp is None:
        return cfg.n_experts * torch.sum(onehot.mean(0) * probs.mean(0))
    # means over the global batch: the counts summed over the data axes,
    # the probabilities too, with each rank's gradient its own tokens'
    group = mesh.group_of(*dp)
    n = comm.all_reduce_sum(torch.tensor([float(xt.shape[0])],
                                         device=x.device), group)
    frac_tokens = comm.all_reduce_sum(onehot.sum(0), group) / n
    frac_probs = comm.reduce_from(probs.sum(0), group) / n
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs)
