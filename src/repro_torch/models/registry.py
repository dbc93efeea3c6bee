"""Architecture registry: ``--arch <id>`` -> model functions (the port of
``repro/models/registry.py``).

  bundle = get_bundle("h2o-danube-1.8b")
  bundle.init(seed, device)                     -> params
  bundle.prefill(params, batch, engine)         -> last-token logits
  bundle.decode(params, cache, batch, engine)   -> (logits, cache)
  bundle.init_cache(batch, kv_len, device)      -> cache
  bundle.abstract_cache(batch, kv_len)          -> cache of meta tensors
  bundle.input_specs(cell)                      -> {name: meta tensor}
  bundle.train_loss(params, batch, engine)      -> loss

``engine`` is the attention engine of ``models.layers`` (``"torch"``,
``"cuda"`` or ``"auto"``).  Every family serves: decoder LMs through
``models.lm`` (``batch["image_embeds"]`` for the vision frontend), the
encoder-decoder through ``models.encdec`` (``batch["frames"]``, encoder
frames; its caches hold ``src_len(kv_len)`` cross slots).
``bundle.train_loss(params, batch, engine)`` is the training loss of
either (``repro_torch.train`` differentiates it).

Under an ambient mesh (``distributed.hints.use_mesh``) ``train_loss``,
``prefill`` and ``decode`` run sharded on this rank's blocks of the params
and of the batch (``distributed.sharding``; ``bundle.init(seed, device,
mesh)`` draws the blocks): ``train_loss`` is the global loss on every rank
(its gradient on a rank is that rank's share, summed over the data axes by
the train step), ``prefill`` the last-token logits of the rank's batch
block, whole over the vocab.  ``decode`` takes the rank's blocks of the
cache under ``cache_shardings`` (``init_cache(..., mesh=)`` or
``interop.cache_from_numpy(..., mesh=)``: a tree that carries its specs),
``batch["tokens"]`` the rank's rows and ``batch["pos"]`` a host int; it
returns the rank's rows' logits whole over the vocab and the cache in the
same blocks, which ``sharding.gather_tree`` makes the one-rank cache.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.configs.archs import (ARCHS, LONG_CONTEXT_OK, get_config,
                                       reduced_config)
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.columnar import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM

__all__ = ["ModelBundle", "get_bundle", "src_len", "all_archs"]


def src_len(seq_len: int) -> int:
    """Encoder frame count for enc-dec shapes (audio frames ~ seq / 4)."""
    return max(64, seq_len // 4)


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig

    def __post_init__(self):
        if not self.cfg.is_encdec:
            LM.layer_kinds(self.cfg)

    def init(self, seed: int = 0, device=None, mesh=None) -> Any:
        """Random weights from a ``torch.Generator`` seeded with ``seed`` on
        ``device`` (None = CUDA); with a ``mesh``, this rank's blocks of the
        same weights, drawn one leaf at a time (``interop.init_shards``)."""
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(int(seed))
        if mesh is not None:
            from repro_torch.interop import init_shards

            return init_shards(self, gen, mesh)
        return self.init_from(gen)

    def init_from(self, gen) -> Any:
        """The params drawn from ``gen`` (a generator or a
        ``layers.Drawer``)."""
        if self.cfg.is_encdec:
            return ED.init_params(self.cfg, gen)
        return LM.init_params(self.cfg, gen)

    def abstract_params(self) -> Any:
        """The params' logical shapes and dtypes as meta tensors (nothing
        allocated, nothing drawn)."""
        from repro_torch.models.layers import Drawer

        return self.init_from(Drawer())

    def train_loss(self, params, batch, engine: str = "auto"
                   ) -> torch.Tensor:
        """The reference's training loss (next-token cross entropy, MoE
        load balance), an fp32 scalar that autograd differentiates."""
        if self.cfg.is_encdec:
            return ED.train_loss(params, self.cfg, batch, engine=engine)
        return LM.train_loss(params, self.cfg, batch, engine=engine)

    def prefill(self, params, batch, engine: str = "auto") -> torch.Tensor:
        """Full-sequence forward emitting the last position's logits."""
        if self.cfg.is_encdec:
            memory = ED.encode(params, self.cfg, batch["frames"],
                               engine=engine)
            logits, _ = ED.decode_forward(params, self.cfg, batch["tokens"],
                                          memory=memory, logits_slice=1,
                                          engine=engine)
            return logits
        logits, _ = LM.forward(params, self.cfg, batch["tokens"],
                               image_embeds=batch.get("image_embeds"),
                               logits_slice=1, engine=engine)
        return logits

    def decode(self, params, cache, batch, engine: str = "auto"):
        """One decode step at ``batch["pos"]`` against the cache (KV caches
        are updated in place, recurrent states returned anew); under a mesh
        on this rank's blocks (see the module's docstring)."""
        if self.cfg.is_encdec:
            return ED.decode_forward(params, self.cfg, batch["tokens"],
                                     cache=cache, cache_pos=batch["pos"],
                                     engine=engine)
        return LM.forward(params, self.cfg, batch["tokens"], cache=cache,
                          cache_pos=batch["pos"], engine=engine)

    def init_cache(self, batch: int, kv_len: int, device=None, mesh=None):
        """The zeroed cache of ``batch`` sequences of ``kv_len`` slots on
        ``device`` (None = CUDA); with a ``mesh``, this rank's blocks of it
        under ``sharding.cache_shardings``, carrying their specs (the
        logical cache is never allocated)."""
        dev = resolve_device(device)
        if self.cfg.is_encdec:
            return ED.init_cache(self.cfg, batch, kv_len, src_len(kv_len),
                                 dev, mesh)
        return LM.init_cache(self.cfg, batch, kv_len, dev, mesh)

    def abstract_cache(self, batch: int, kv_len: int):
        """The cache's logical shapes and dtypes as meta tensors."""
        return self.init_cache(batch, kv_len, device="meta")

    def input_specs(self, cell: ShapeCell):
        """Meta-tensor stand-ins (shape and dtype) for every model input of
        the cell, the reference's: tokens (and the frontend's frames or
        image embeddings, bf16) for train and prefill; one new token and
        the write position for decode."""
        B, S = cell.global_batch, cell.seq_len

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        if cell.kind == "decode":
            return {"tokens": meta((B, 1), torch.int32),
                    "pos": meta((), torch.int32)}
        specs = {"tokens": meta((B, S), torch.int32)}
        if self.cfg.is_encdec:
            specs["frames"] = meta((B, src_len(S), self.cfg.frontend_dim),
                                   torch.bfloat16)
        if self.cfg.frontend == "vision_patches":
            specs["image_embeds"] = meta(
                (B, self.cfg.n_frontend_tokens, self.cfg.frontend_dim),
                torch.bfloat16)
        return specs

    def supports(self, cell: ShapeCell) -> bool:
        """Whether the arch runs the cell: ``long_500k`` only for the
        long-context archs."""
        if cell.name == "long_500k":
            return self.cfg.name in LONG_CONTEXT_OK
        return True


@functools.lru_cache(maxsize=None)
def get_bundle(name: str, reduced: bool = False) -> ModelBundle:
    cfg = reduced_config(name) if reduced else get_config(name)
    return ModelBundle(cfg)


def all_archs():
    """Every architecture id, sorted."""
    return sorted(ARCHS)
