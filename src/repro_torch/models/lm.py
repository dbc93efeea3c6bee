"""Decoder-only LM of the dense family (the port of ``repro/models/lm.py``).

The reference groups layers into the config's repeating pattern period and
``lax.scan``s over stacked period parameters; the port walks one flat list
of layers in the reference's order (head layers, each period's
``slot0..slotN``, tail layers), so ``params["layers"][i]`` and
``cache[i]`` are layer ``i``'s.  Layer kinds ``"attn"`` and ``"swa"`` with a
dense GLU FFN are ported; the recurrent kinds, MoE FFNs, the vision
frontend and the training loss wait (ROADMAP A9).

Serving: ``init_cache`` builds one ``(k, v)`` pair per layer, a full KV
cache for ``"attn"`` and a ring buffer of ``window`` slots for ``"swa"``
when ``kv_len >= window``; ``forward(..., cache=..., cache_pos=...)`` is the
decode step and updates the caches in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

__all__ = ["PORTED_KINDS", "layer_kinds", "init_params", "init_cache",
           "forward"]

Params = Dict[str, Any]
PORTED_KINDS = ("attn", "swa")


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _layer_plan(cfg: ModelConfig):
    """(head_kinds, pattern, n_periods, tail_kinds) with ffn types, as the
    reference's ``_layer_plan``."""
    def ffn_type(layer_idx: int) -> str:
        if cfg.d_ff == 0:
            return "none"
        if cfg.n_experts:
            return "dense_first" if layer_idx < cfg.first_dense_layers else "moe"
        return "dense"

    head = [(cfg.pattern[i % len(cfg.pattern)], ffn_type(i))
            for i in range(cfg.first_dense_layers)]
    eff = cfg.n_layers - cfg.first_dense_layers
    npd = eff // len(cfg.pattern)
    tail_n = eff % len(cfg.pattern)
    pattern = [(k, ffn_type(cfg.first_dense_layers)) for k in cfg.pattern]
    tail = [(cfg.pattern[i], ffn_type(cfg.n_layers - tail_n + i))
            for i in range(tail_n)]
    return head, pattern, npd, tail


def layer_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """``(kind, ffn_type)`` of every layer in the reference's order; raises
    ``NotImplementedError`` for a kind or FFN the port does not have yet."""
    head, pattern, npd, tail = _layer_plan(cfg)
    kinds = head + pattern * npd + tail
    for kind, ft in kinds:
        if kind not in PORTED_KINDS or ft not in ("dense", "none"):
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} with a {ft!r} FFN is not "
                f"ported yet (ROADMAP A9)")
    return kinds


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_layer(gen: torch.Generator, cfg: ModelConfig, dtype, ffn_type: str
                ) -> Params:
    dev = gen.device
    p: Params = {"norm1": torch.zeros(cfg.d_model, dtype=dtype, device=dev),
                 "mixer": L.attn_params(gen, cfg, dtype)}
    if ffn_type == "dense":
        p["norm2"] = torch.zeros(cfg.d_model, dtype=dtype, device=dev)
        p["ffn"] = L.ffn_params(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights drawn from ``gen`` on its device (the reference's
    initialisers; ``jax.random`` and torch draw different numbers)."""
    dtype = _dtype(cfg)
    kinds = layer_kinds(cfg)
    p: Params = {
        "embed": L.dense_init(gen, (cfg.padded_vocab, cfg.d_model), dtype,
                              scale=0.02),
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.padded_vocab), dtype)
    p["layers"] = [_init_layer(gen, cfg, dtype, ft) for _, ft in kinds]
    return p


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, kv_len: int,
               device: torch.device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One zeroed ``(k, v)`` pair per layer, each ``(batch, S_cache, Hkv,
    D)``: ``S_cache`` is ``kv_len`` for ``"attn"`` and ``min(window,
    kv_len)`` for ``"swa"``."""
    cache = []
    for kind, _ in layer_kinds(cfg):
        s = min(cfg.window, kv_len) if kind == "swa" and cfg.window else kv_len
        shape = (batch, s, cfg.n_kv_heads, cfg.head_dim_)
        cache.append((torch.zeros(shape, dtype=_dtype(cfg), device=device),
                      torch.zeros(shape, dtype=_dtype(cfg), device=device)))
    return cache


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _layer_apply(lp: Params, x, kind: str, ffn_type: str, cfg: ModelConfig,
                 positions, cache, cache_pos, engine: str):
    mixer_in = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    out, new_cache = L.attention(lp["mixer"], mixer_in, cfg, kind=kind,
                                 positions=positions, cache=cache,
                                 cache_pos=cache_pos, engine=engine)
    x = x + out
    if ffn_type != "none":
        x = x + L.ffn(lp["ffn"], L.rmsnorm(lp["norm2"], x, cfg.norm_eps))
    return x, new_cache


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: Optional[List] = None, cache_pos: Optional[int] = None,
            return_cache: bool = False, logits_slice: Optional[int] = None,
            engine: str = "auto"):
    """Returns (logits over the padded vocab, cache or None).

    Prefill: cache=None; positions are [0, S).  Decode: cache + cache_pos
    (an int, the write position); positions are cache_pos + [0, S) and the
    caches are updated in place."""
    kinds = layer_kinds(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens]
    start = 0 if cache_pos is None else int(cache_pos)
    positions = (start + torch.arange(S, dtype=torch.int32,
                                      device=x.device)).expand(B, S)
    new_cache = []
    for i, ((kind, ft), lp) in enumerate(zip(kinds, params["layers"])):
        x, nc = _layer_apply(lp, x, kind, ft, cfg, positions,
                             cache[i] if cache is not None else None,
                             cache_pos, engine)
        new_cache.append(nc)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice is not None:
        x = x[:, -logits_slice:, :]
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    return logits, (new_cache if (return_cache or cache is not None) else None)
