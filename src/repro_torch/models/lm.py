"""Decoder-only LM of the dense, MoE, hybrid, ssm and vlm families (the
port of ``repro/models/lm.py``).

The reference groups layers into the config's repeating pattern period and
``lax.scan``s over stacked period parameters; the port walks one flat list
of layers in the reference's order (head layers, each period's
``slot0..slotN``, tail layers), so ``params["layers"][i]`` and
``cache[i]`` are layer ``i``'s.  Mixers: ``"attn"``, ``"swa"`` (attention),
``"rglru"``, ``"mlstm"``, ``"slstm"`` (``models.recurrent``); FFNs: dense
GLU, ``"dense_first"`` (deepseek's first layer, ``dense_d_ff`` wide),
``"moe"`` or none.  The vision frontend projects precomputed patch
embeddings (``img_proj``) into the first positions.

Training: ``train_loss`` is the reference's next-token cross entropy
(``cross_entropy``: padded vocab at -1e30, logsumexp in fp32; the last
position and the image positions masked) plus, for MoE models, 0.01 x the
load-balance loss of the reference's choice of router (period 0's
``slot0``, layer ``len(head layers)`` of the flat list) on the token
embeddings.  With ``cfg.remat`` each period layer (not the head or tail
layers, as in the reference) runs under ``torch.utils.checkpoint`` while
autograd records, so its activations are recomputed in the backward.

Sharded (under ``distributed.hints.use_mesh``): the params are this
rank's blocks (``distributed.sharding.param_shardings``) and the batch its
block over the data axes (``batch_shardings``).  The embedding is
vocab-parallel (a masked lookup of the rank's rows, summed over "model"),
the logits stay vocab-sharded (``lm_head``, or gemma3's tied ``embed``),
and ``cross_entropy`` reduces over the sharded vocab: a max over "model"
(no gradient), a sum of exps, the target's logit from the rank that owns
it.  The loss is the global masked mean: numerator and mask count are
summed over the data axes before the division, so unequal counts on the
data shards weigh as one batch.  ``train_loss`` returns it on every rank;
its gradient on a rank is that rank's share, which the train step sums
over the data axes.  The recurrent mixers shard as ``models.recurrent``
says; the vision frontend's ``img_proj`` is a column block of ``d``, so
the projected image block is gathered over "model" before it replaces the
first positions.

A decode step under the mesh takes a cache of the rank's blocks that
carries its specs (``init_cache(..., mesh=)``, ``interop.
cache_from_numpy(..., mesh=)``; ``sharding.cache_shardings``' blocks) and
returns the cache in the same blocks; each layer reads its leaf's spec
(``layers.DecodeShard``; ``models.layers`` and ``models.recurrent`` say
what each layout does).  Decode logits are whole over the padded vocab on
every rank (gathered over "model" where ``vocab_sharded``), for the rank's
batch rows (``batch_shardings``'); where a KV cache's batch is whole while
the tokens are split (a batch that divides "data" but not the data axes
together), the tokens are gathered, the step runs on the whole batch and
the logits are cut to the rank's rows.  An MoE layer runs
``layers._moe_ffn_ep`` with the per-group capacity of the decode step's
tokens.

Serving: ``init_cache`` builds each layer's own state: a ``(k, v)`` pair
(a full KV cache for ``"attn"``, a ring buffer of ``window`` slots for
``"swa"`` when ``kv_len >= window``), or a recurrent state tuple;
``forward(..., cache=..., cache_pos=...)`` is the decode step: it updates
KV caches in place and returns each recurrent state anew.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm, hints, sharding
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R

__all__ = ["LAYER_KINDS", "ATTENTION_KINDS", "layer_kinds", "init_params",
           "init_cache", "forward", "cross_entropy", "sharded_cross_entropy",
           "train_loss"]

Params = Dict[str, Any]
ATTENTION_KINDS = ("attn", "swa")
LAYER_KINDS = ATTENTION_KINDS + ("rglru", "mlstm", "slstm")


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
    ``ValueError`` for a layer kind the reference does not have."""
    head, pattern, npd, tail = _layer_plan(cfg)
    kinds = head + pattern * npd + tail
    for kind, _ in kinds:
        if kind not in LAYER_KINDS:
            raise ValueError(f"{cfg.name}: unknown layer kind {kind!r}")
    return kinds


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
_MIXER_PARAMS = {"attn": L.attn_params, "swa": L.attn_params,
                 "rglru": R.rglru_params, "mlstm": R.mlstm_params,
                 "slstm": R.slstm_params}


def _init_layer(gen: torch.Generator, cfg: ModelConfig, dtype, kind: str,
                ffn_type: str) -> Params:
    dev = gen.device
    p: Params = {"norm1": torch.zeros(cfg.d_model, dtype=dtype, device=dev),
                 "mixer": _MIXER_PARAMS[kind](gen, cfg, dtype)}
    if ffn_type != "none":
        p["norm2"] = torch.zeros(cfg.d_model, dtype=dtype, device=dev)
    if ffn_type == "dense":
        p["ffn"] = L.ffn_params(gen, cfg.d_model, cfg.d_ff, dtype)
    elif ffn_type == "dense_first":
        p["ffn"] = L.ffn_params(gen, cfg.d_model, cfg.dense_d_ff or cfg.d_ff,
                                dtype)
    elif ffn_type == "moe":
        p["ffn"] = L.moe_params(gen, cfg, dtype)
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
    if cfg.frontend == "vision_patches":
        p["img_proj"] = L.dense_init(gen, (cfg.frontend_dim, cfg.d_model),
                                     dtype)
    p["layers"] = [_init_layer(gen, cfg, dtype, kind, ft)
                   for kind, ft in kinds]
    return p


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------
def _init_layer_cache(kind: str, cfg: ModelConfig, batch: int, kv_len: int,
                      dtype, device):
    if kind in ATTENTION_KINDS:
        s = min(cfg.window, kv_len) if kind == "swa" and cfg.window \
            else kv_len
        shape = (batch, s, cfg.n_kv_heads, cfg.head_dim_)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))
    if kind == "rglru":
        return R.rglru_init_state(cfg, batch, dtype, device)
    if kind == "mlstm":
        return R.mlstm_init_state(cfg, batch, device)
    return R.slstm_init_state(cfg, batch, device)


def init_cache(cfg: ModelConfig, batch: int, kv_len: int,
               device: torch.device, mesh=None) -> List[Tuple[torch.Tensor, ...]]:
    """Each layer's zeroed state: a ``(k, v)`` pair of ``(batch, S_cache,
    Hkv, D)`` (``S_cache`` is ``kv_len`` for ``"attn"`` and ``min(window,
    kv_len)`` for ``"swa"``), or its recurrent state (``models.recurrent``:
    RG-LRU's in the model's type, mLSTM's and sLSTM's fp32 with ``m`` at
    -1e30).  With a ``mesh``, this rank's blocks of it under
    ``sharding.cache_shardings`` (a ``sharding.BlockList`` that carries
    the specs); the logical cache is never allocated."""
    def make(b, n, dev):
        return [_init_layer_cache(kind, cfg, b, n, _dtype(cfg), dev)
                for kind, _ in layer_kinds(cfg)]

    if mesh is None:
        return make(batch, kv_len, device)
    logical = make(batch, kv_len, "meta")
    return init_blocks(logical, make(1, 1, "cpu"), sharding.cache_shardings(
        cfg, mesh, logical, batch), mesh, device)


def init_blocks(logical, fills, specs, mesh, device):
    """The rank's blocks of a cache whose leaves are constants: each
    leaf of ``logical`` (meta tensors) under ``specs``, filled with the
    value of the same leaf of ``fills`` (a small cache of the same tree),
    carrying ``specs``."""
    def leaf(t, f, spec):
        return torch.full(sharding.block_shape(t.shape, spec, mesh),
                          f.reshape(-1)[0].item(), dtype=t.dtype,
                          device=device)

    def walk(t, f, spec):
        if isinstance(t, dict):
            return {k: walk(t[k], f[k], spec[k]) for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(a, b, c) for a, b, c in zip(t, f, spec))
        return leaf(t, f, spec)

    return sharding.with_specs(walk(logical, fills, specs), specs)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
_RECURRENT = {"rglru": R.rglru, "mlstm": R.mlstm, "slstm": R.slstm}


def _layer_apply(lp: Params, x, kind: str, ffn_type: str, cfg: ModelConfig,
                 positions, cache, cache_pos, engine: str, shard=None):
    if cache is None:
        x = hints.constrain(x, hints.dp_axes(), "model", None)
    mixer_in = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    if kind in ATTENTION_KINDS:
        if shard is not None:            # the keys' spec (the values' too)
            shard = L.DecodeShard(shard.spec[0], shard.batch)
        out, new_cache = L.attention(lp["mixer"], mixer_in, cfg, kind=kind,
                                     positions=positions, cache=cache,
                                     cache_pos=cache_pos, engine=engine,
                                     shard=shard)
    else:
        out, new_cache = _RECURRENT[kind](lp["mixer"], mixer_in, cfg,
                                          state=cache, shard=shard)
    x = x + out
    if ffn_type != "none":
        h = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
        x = x + (L.moe_ffn(lp["ffn"], h, cfg) if ffn_type == "moe"
                 else L.ffn(lp["ffn"], h, cfg.dense_d_ff or cfg.d_ff
                            if ffn_type == "dense_first" else cfg.d_ff))
    return x, new_cache


def _remat_layer(lp, x, kind, ft, cfg, positions, engine):
    return _layer_apply(lp, x, kind, ft, cfg, positions, None, None,
                        engine)[0]


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            image_embeds: Optional[torch.Tensor] = None,
            cache: Optional[List] = None, cache_pos: Optional[int] = None,
            return_cache: bool = False, logits_slice: Optional[int] = None,
            engine: str = "auto"):
    """Returns (logits over the padded vocab, cache or None).

    Prefill: cache=None; positions are [0, S).  Decode: cache + cache_pos
    (an int, the write position); positions are cache_pos + [0, S); KV
    caches are updated in place, recurrent states replaced in the returned
    list.  ``image_embeds`` (B, n_img, frontend_dim), for the vision
    frontend: projected by ``img_proj`` into positions [0, n_img)."""
    kinds = layer_kinds(cfg)
    shards, gather_batch = decode_shards(cache, 0, [
        kind in ATTENTION_KINDS for kind, _ in kinds])
    if gather_batch is not None:
        tokens = comm.all_gather_dim(tokens, hints.current_mesh().group_of(
            *sharding.axes_of(gather_batch)), 0)
    B, S = tokens.shape
    x = embed(params, cfg, tokens)
    if cfg.frontend == "vision_patches" and image_embeds is not None:
        img = L.mm(image_embeds.to(x.dtype), params["img_proj"])
        if img.shape[-1] != cfg.d_model:     # the rank's column block
            img = comm.gather(img, L.model_axis()[2], -1, partial=False)
        x = torch.cat([img, x[:, img.shape[1]:]], dim=1)
    start = 0 if cache_pos is None else int(cache_pos)
    positions = (start + torch.arange(S, dtype=torch.int32,
                                      device=x.device)).expand(B, S)
    new_cache = []
    head, pattern, npd, _ = _layer_plan(cfg)
    periods = range(len(head), len(head) + npd * len(pattern))
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for i, ((kind, ft), lp) in enumerate(zip(kinds, params["layers"])):
        if remat and i in periods:
            # per layer, as the reference's jax.checkpoint: the backward
            # holds one layer's activations at a time
            x = checkpoint(_remat_layer, lp, x, kind, ft, cfg, positions,
                           engine, use_reentrant=False)
            new_cache.append(None)
            continue
        x, nc = _layer_apply(lp, x, kind, ft, cfg, positions,
                             cache[i] if cache is not None else None,
                             cache_pos, engine, shards and shards[i])
        new_cache.append(nc)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice is not None:
        x = x[:, -logits_slice:, :]
    logits = output_logits(params, cfg, x,
                           logits_slice is not None or cache is not None)
    if shards:
        new_cache = sharding.with_specs(new_cache, sharding.specs_of(cache))
        if gather_batch is not None:         # the rank's rows again
            logits = sharding.own_block(logits, (gather_batch,),
                                        hints.current_mesh())
    return logits, (new_cache if (return_cache or cache is not None) else None)


def decode_shards(cache, batch_dim: int, is_kv=None):
    """A sharded decode's ``layers.DecodeShard``s: one a layer of a list
    cache (``is_kv`` marks the layers whose state is a KV cache), one for
    a dict cache (every leaf a KV cache) carrying its whole spec tree;
    None without an ambient mesh or a cache that carries specs.  Also the
    batch entry over which the tokens must be gathered, or None.  Each
    leaf's batch is its dim ``batch_dim``; the activations' rows are
    ``batch_shardings``' of the logical batch, which a leaf's block and
    spec give.  Where a KV cache holds the batch otherwise (whole while
    those rows are a part of it), the step runs on the whole batch."""
    mesh = hints.current_mesh()
    specs = sharding.specs_of(cache) if cache is not None else None
    if mesh is None or specs is None:
        return None, None
    pairs = []                                    # (leaf, spec, a KV cache)

    def walk(t, spec, kv):
        if isinstance(t, torch.Tensor):
            pairs.append((t, spec, kv))
        elif isinstance(t, dict):
            for k in t:
                walk(t[k], spec[k], kv)
        else:
            for a, b in zip(t, spec):
                walk(a, b, kv)

    if isinstance(cache, dict):
        walk(cache, specs, True)
    else:
        for c, spec, kv in zip(cache, specs, is_kv):
            walk(c, spec, kv)
    t, spec, _ = pairs[0]
    batch = t.shape[batch_dim] * sharding.n_blocks(spec[batch_dim], mesh)
    rows = sharding.batch_shardings(None, mesh, {"b": (batch,)})["b"][0]
    gather = rows if rows is not None and any(
        kv and spec[batch_dim] != rows for _, spec, kv in pairs) else None
    if gather is not None:
        rows = None
    if isinstance(cache, dict):
        return L.DecodeShard(specs, rows), gather
    return [L.DecodeShard(spec, rows) for spec in specs], gather


# ---------------------------------------------------------------------------
# vocab-parallel embedding and logits
# ---------------------------------------------------------------------------
def vocab_sharded(cfg: ModelConfig) -> bool:
    """Whether this rank holds a vocab block of the unembedding (a model
    axis above 1 that divides the padded vocab)."""
    tp = L.tp_size()
    return tp > 1 and cfg.padded_vocab % tp == 0


def embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor
          ) -> torch.Tensor:
    """Token embeddings; where ``vocab_sharded``, a lookup of this rank's
    block of rows (other tokens zero) summed over "model"."""
    table = params["embed"]
    if not vocab_sharded(cfg):
        return table[tokens]
    _, r, group = L.model_axis()
    lo = r * table.shape[0]
    mine = (tokens >= lo) & (tokens < lo + table.shape[0])
    local = table[torch.where(mine, tokens - lo, 0)]
    local = torch.where(mine[..., None], local,
                        torch.zeros((), dtype=local.dtype, device=local.device))
    return comm.reduce_from(local, group)


def output_logits(params: Params, cfg: ModelConfig, x: torch.Tensor,
                  whole: bool) -> torch.Tensor:
    """``vocab_logits``, gathered over "model" where ``whole`` (a prefill's
    sliced logits) and ``vocab_sharded``."""
    logits = hints.constrain(vocab_logits(params, cfg, x), hints.dp_axes(),
                             None, "model")
    if whole and vocab_sharded(cfg):
        logits = comm.gather(logits, L.model_axis()[2], -1, partial=False)
    return logits


def vocab_logits(params: Params, cfg: ModelConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    """Logits over the padded vocab (this rank's block of it where
    ``vocab_sharded``)."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if vocab_sharded(cfg):
        x = comm.copy_to(x, L.model_axis()[2])
    return L.mm(x, w)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, vocab_size: int,
                  vocab_lo: Optional[int] = None) -> torch.Tensor:
    """Masked mean next-token NLL over (possibly padded) logits: the padded
    vocab at -1e30, the logsumexp in fp32.  ``vocab_lo``: the logits are
    this rank's vocab block starting there, reduced over "model".  Under
    an ambient mesh with data axes the mean is the global one, returned on
    every rank (see the module's docstring)."""
    x = logits.float()
    V = x.shape[-1]
    lo = 0 if vocab_lo is None else vocab_lo
    vidx = lo + torch.arange(V, device=x.device)
    if lo + V > vocab_size:
        x = torch.where(vidx < vocab_size, x, -1e30)
    if vocab_lo is None:
        lse = torch.logsumexp(x, dim=-1)
        gold = x.gather(-1, labels.long()[..., None])[..., 0]
    else:
        group = L.model_axis()[2]
        top = comm.all_reduce_max(x.detach().amax(dim=-1), group)
        total = comm.reduce_from(torch.exp(x - top[..., None]).sum(-1), group)
        lse = top + torch.log(total)
        gold = comm.reduce_from(torch.where(
            vidx == labels.long()[..., None], x, 0.0).sum(-1), group)
    nll = ((lse - gold) * mask).sum()
    dp = hints.dp_axes()
    if dp is None:
        return nll / torch.clamp(mask.sum(), min=1.0)
    group = hints.current_mesh().group_of(*dp)
    count = comm.all_reduce_sum(mask.sum().reshape(1), group)[0]
    return comm.reduce_from(nll / torch.clamp(count, min=1.0), group)


def sharded_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor, cfg: ModelConfig
                          ) -> torch.Tensor:
    """``cross_entropy`` of logits from ``vocab_logits``: this rank's vocab
    block where ``vocab_sharded``."""
    return cross_entropy(logits, labels, mask, cfg.vocab_size,
                         vocab_lo=L.model_axis()[1] * logits.shape[-1]
                         if vocab_sharded(cfg) else None)


def train_loss(params: Params, cfg: ModelConfig,
               batch: Dict[str, torch.Tensor], engine: str = "auto"
               ) -> torch.Tensor:
    """The reference's training loss: ``batch["tokens"]`` (B, S), optional
    ``loss_mask`` (B, S) and ``image_embeds``; an fp32 scalar."""
    tokens = batch["tokens"]
    logits, _ = forward(params, cfg, tokens,
                        image_embeds=batch.get("image_embeds"),
                        engine=engine)
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    mask = batch.get("loss_mask")
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=tokens.device) if mask is None \
        else mask.to(torch.float32).clone()
    mask[:, -1] = 0.0
    if cfg.frontend == "vision_patches":
        is_img = torch.arange(tokens.shape[1], device=tokens.device) \
            < cfg.n_frontend_tokens
        mask = mask * (~is_img)[None, :].to(torch.float32)
    loss = sharded_cross_entropy(logits, labels, mask, cfg)
    head, _, npd, _ = _layer_plan(cfg)
    if cfg.n_experts and npd:
        # the reference's cheap proxy: the first period's slot0 router (not
        # "the first MoE layer") on the token embeddings
        first = params["layers"][len(head)]
        if "router" in first.get("ffn", {}):
            h = embed(params, cfg, tokens)
            loss = loss + 0.01 * L.moe_load_balance_loss(first["ffn"], h,
                                                         cfg)
    return loss
