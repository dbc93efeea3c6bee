"""Encoder-decoder backbone, seamless-m4t-medium (the port of
``repro/models/encdec.py``).

Encoder: bidirectional attention over precomputed audio-frame embeddings
(the modality frontend is a stub: ``frames`` (B, S_src, frontend_dim) are
given).  Decoder: causal self-attention, cross-attention to the encoder's
memory, FFN.  The reference stacks the layers for ``lax.scan``; the port
keeps lists, ``params["enc_layers"][i]`` and ``params["dec_layers"][i]``.

Decode caches the growing self-attention K/V and the cross-attention K/V,
stacked over the decoder layers as the reference's are: ``{"self_k",
"self_v": (n_layers, B, kv_len, Hkv, D), "cross_k", "cross_v": (n_layers,
B, src_len, Hkv, D)}``; a decode step writes its self-attention K/V in
place.  ``init_cache`` zeroes the cross K/V and nothing on the reference's
serving path fills them (``prefill_cross`` does, when a caller asks): the
reference's served enc-dec attends zeros (ROADMAP C14), and the port
matches it.

Training: ``train_loss`` encodes the frames, runs the decoder over the
tokens and takes ``lm.cross_entropy`` of the next token (every position but
the last).  With ``cfg.remat`` each encoder layer and each decoder layer
runs under ``torch.utils.checkpoint`` while autograd records, as the
reference's scan bodies run under ``jax.checkpoint``.

Sharded (under ``distributed.hints.use_mesh``), as ``models.lm``: a full
pass runs on this rank's blocks.  ``frontend_proj`` is a column block of
``d``, gathered over "model" after the projection; the encoder's
bidirectional attention, the decoder's causal self-attention and its
cross-attention over the memory (whole on every rank) run on the rank's
heads (``layers.attention``); the embedding, ``lm_head`` and the loss are
vocab-parallel (``lm.embed``, ``lm.output_logits``,
``lm.sharded_cross_entropy``: the global masked mean over the data axes).
A decode step under the mesh takes the rank's blocks of the stacked caches
under ``sharding.cache_shardings`` (``init_cache(..., mesh=)``, a
``sharding.BlockDict`` that carries the specs): each layer's self and
cross caches, ``(B, S, H, D)`` slices of them, take the layouts of
``models.layers`` (heads, sequence or whole; every cross key visible), and
the logits are whole over the vocab, as ``lm.forward``'s.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm, hints, sharding
from repro_torch.models import layers as L
from repro_torch.models import lm as LM

__all__ = ["init_params", "encode", "init_cache", "prefill_cross",
           "decode_forward", "train_loss"]

Params = Dict[str, Any]


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights drawn from ``gen`` on its device."""
    dtype = _dtype(cfg)
    d = cfg.d_model
    dev = gen.device

    def zeros():
        return torch.zeros(d, dtype=dtype, device=dev)

    def enc_layer():
        return {"norm1": zeros(), "attn": L.attn_params(gen, cfg, dtype),
                "norm2": zeros(),
                "ffn": L.ffn_params(gen, d, cfg.d_ff, dtype)}

    def dec_layer():
        return {"norm1": zeros(),
                "self_attn": L.attn_params(gen, cfg, dtype),
                "norm_x": zeros(),
                "cross_attn": L.attn_params(gen, cfg, dtype, cross=True),
                "norm2": zeros(),
                "ffn": L.ffn_params(gen, d, cfg.d_ff, dtype)}

    return {
        "frontend_proj": L.dense_init(gen, (cfg.frontend_dim, d), dtype),
        "embed": L.dense_init(gen, (cfg.padded_vocab, d), dtype, scale=0.02),
        "enc_layers": [enc_layer() for _ in range(cfg.n_encoder_layers)],
        "dec_layers": [dec_layer() for _ in range(cfg.n_layers)],
        "enc_norm": zeros(),
        "final_norm": zeros(),
        "lm_head": L.dense_init(gen, (d, cfg.padded_vocab), dtype),
    }


def _positions(B: int, S: int, start: int, device) -> torch.Tensor:
    return (start + torch.arange(S, dtype=torch.int32, device=device)
            ).expand(B, S)


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor, *,
           engine: str = "auto") -> torch.Tensor:
    """frames: (B, S_src, frontend_dim) -> memory (B, S_src, d)."""
    x = L.mm(frames.to(_dtype(cfg)), params["frontend_proj"])
    if x.shape[-1] != cfg.d_model:           # the rank's column block
        x = comm.gather(x, L.model_axis()[2], -1, partial=False)
    B, S, _ = x.shape
    positions = _positions(B, S, 0, x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["enc_layers"]:
        x = checkpoint(_enc_layer, lp, x, cfg, positions, engine,
                       use_reentrant=False) if remat \
            else _enc_layer(lp, x, cfg, positions, engine)
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _enc_layer(lp, x, cfg, positions, engine):
    h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    out, _ = L.attention(lp["attn"], h, cfg, kind="attn",
                         positions=positions, causal=False, engine=engine)
    x = x + out
    return x + L.ffn(lp["ffn"], L.rmsnorm(lp["norm2"], x, cfg.norm_eps),
                     cfg.d_ff)


def _dec_layer(lp, x, memory, cfg, positions, engine):
    """One decoder layer of a full pass (no cache)."""
    h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    out, _ = L.attention(lp["self_attn"], h, cfg, kind="attn",
                         positions=positions, engine=engine)
    x = x + out
    h = L.rmsnorm(lp["norm_x"], x, cfg.norm_eps)
    out, _ = L.attention(lp["cross_attn"], h, cfg, kind="attn",
                         positions=positions, kv_input=memory, causal=False,
                         engine=engine)
    x = x + out
    return x + L.ffn(lp["ffn"], L.rmsnorm(lp["norm2"], x, cfg.norm_eps),
                     cfg.d_ff)


def init_cache(cfg: ModelConfig, batch: int, kv_len: int, src_len: int,
               device, mesh=None) -> Params:
    """Zeroed self-attention K/V of ``kv_len`` and cross K/V of
    ``src_len`` slots, stacked over the decoder layers; with a ``mesh``,
    this rank's blocks of them (``lm.init_blocks``), never the logical
    cache."""
    def make(b, n, src, dev):
        def kv(s):
            return torch.zeros((cfg.n_layers, b, s, cfg.n_kv_heads,
                                cfg.head_dim_), dtype=_dtype(cfg), device=dev)

        return {"self_k": kv(n), "self_v": kv(n), "cross_k": kv(src),
                "cross_v": kv(src)}

    if mesh is None:
        return make(batch, kv_len, src_len, device)
    logical = make(batch, kv_len, src_len, "meta")
    return LM.init_blocks(logical, make(1, 1, 1, "cpu"),
                          sharding.cache_shardings(cfg, mesh, logical, batch),
                          mesh, device)


def prefill_cross(params: Params, cfg: ModelConfig, memory: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the encoder's memory into every decoder layer's cross K/V
    (done once): ``(ck, cv)``, each (n_layers, B, S_src, Hkv, D)."""
    B, S, _ = memory.shape
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim_)
    ck = [L.mm(memory, lp["cross_attn"]["wk"]).reshape(shape)
          for lp in params["dec_layers"]]
    cv = [L.mm(memory, lp["cross_attn"]["wv"]).reshape(shape)
          for lp in params["dec_layers"]]
    return torch.stack(ck), torch.stack(cv)


def decode_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                   memory: Optional[torch.Tensor] = None,
                   cache: Optional[Params] = None,
                   cache_pos: Optional[int] = None,
                   logits_slice: Optional[int] = None, engine: str = "auto"):
    """The decoder: a full pass (cache=None, ``memory`` given; prefill) or
    a decode step (cache given, the cross K/V read from it, the
    self-attention K/V written in place at ``cache_pos``).  Returns
    (logits, cache or None)."""
    shard, gather_batch = LM.decode_shards(cache, 1)
    if gather_batch is not None:
        tokens = comm.all_gather_dim(tokens, hints.current_mesh().group_of(
            *sharding.axes_of(gather_batch)), 0)
    B, S = tokens.shape
    x = LM.embed(params, cfg, tokens)
    positions = _positions(B, S, 0 if cache_pos is None else int(cache_pos),
                           x.device)
    self_shard = cross_shard = None
    if shard is not None:         # a layer's (B, S, H, D) slice of a leaf
        self_shard = L.DecodeShard(shard.spec["self_k"][1:], shard.batch)
        cross_shard = L.DecodeShard(shard.spec["cross_k"][1:], shard.batch)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, lp in enumerate(params["dec_layers"]):
        if cache is None:
            x = checkpoint(_dec_layer, lp, x, memory, cfg, positions, engine,
                           use_reentrant=False) if remat \
                else _dec_layer(lp, x, memory, cfg, positions, engine)
            continue
        h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
        out, _ = L.attention(lp["self_attn"], h, cfg, kind="attn",
                             positions=positions,
                             cache=(cache["self_k"][i], cache["self_v"][i]),
                             cache_pos=cache_pos, engine=engine,
                             shard=self_shard)
        x = x + out
        h = L.rmsnorm(lp["norm_x"], x, cfg.norm_eps)
        x = x + L.cross_attention(lp["cross_attn"], h, cache["cross_k"][i],
                                  cache["cross_v"][i], cfg,
                                  positions=positions, engine=engine,
                                  shard=cross_shard)
        x = x + L.ffn(lp["ffn"], L.rmsnorm(lp["norm2"], x, cfg.norm_eps),
                      cfg.d_ff)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice is not None:
        x = x[:, -logits_slice:, :]
    logits = LM.output_logits(params, cfg, x, logits_slice is not None
                              or cache is not None)
    if gather_batch is not None:             # the rank's rows again
        logits = sharding.own_block(logits, (gather_batch,),
                                    hints.current_mesh())
    return logits, cache


def train_loss(params: Params, cfg: ModelConfig,
               batch: Dict[str, torch.Tensor], engine: str = "auto"
               ) -> torch.Tensor:
    """The reference's loss: encode ``batch["frames"]``, decode
    ``batch["tokens"]`` over the memory, next-token cross entropy with the
    last position masked; an fp32 scalar."""
    memory = encode(params, cfg, batch["frames"], engine=engine)
    tokens = batch["tokens"]
    logits, _ = decode_forward(params, cfg, tokens, memory=memory,
                               engine=engine)
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return LM.sharded_cross_entropy(logits, labels, mask, cfg)
