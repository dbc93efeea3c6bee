"""Architecture registry: ``--arch <id>`` -> model functions (the port of
``repro/models/registry.py``).

  bundle = get_bundle("h2o-danube-1.8b")
  bundle.init(seed, device)                     -> params
  bundle.prefill(params, batch, engine)         -> last-token logits
  bundle.decode(params, cache, batch, engine)   -> (logits, cache)
  bundle.init_cache(batch, kv_len, device)      -> cache

``engine`` is the attention engine of ``models.layers`` (``"torch"``,
``"cuda"`` or ``"auto"``).  The dense decoder family is ported; a config of
another family (MoE, hybrid, ssm, vlm, audio) or with unported layer kinds
raises ``NotImplementedError`` (ROADMAP A9).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.configs.archs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.columnar import resolve_device
from repro_torch.models import lm as LM

__all__ = ["ModelBundle", "get_bundle"]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig

    def __post_init__(self):
        c = self.cfg
        if c.family != "dense" or c.is_encdec or c.frontend != "none" \
                or c.n_experts:
            raise NotImplementedError(
                f"{c.name}: the {c.family!r} family is not ported yet "
                f"(ROADMAP A9)")
        LM.layer_kinds(c)

    def init(self, seed: int = 0, device=None) -> Any:
        """Random weights from a ``torch.Generator`` seeded with ``seed`` on
        ``device`` (None = CUDA)."""
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(int(seed))
        return LM.init_params(self.cfg, gen)

    def prefill(self, params, batch, engine: str = "auto") -> torch.Tensor:
        """Full-sequence forward emitting the last position's logits."""
        logits, _ = LM.forward(params, self.cfg, batch["tokens"],
                               logits_slice=1, engine=engine)
        return logits

    def decode(self, params, cache, batch, engine: str = "auto"):
        """One decode step at ``batch["pos"]`` against the cache, which is
        updated in place."""
        return LM.forward(params, self.cfg, batch["tokens"], cache=cache,
                          cache_pos=batch["pos"], engine=engine)

    def init_cache(self, batch: int, kv_len: int, device=None):
        return LM.init_cache(self.cfg, batch, kv_len, resolve_device(device))


@functools.lru_cache(maxsize=None)
def get_bundle(name: str, reduced: bool = False) -> ModelBundle:
    cfg = reduced_config(name) if reduced else get_config(name)
    return ModelBundle(cfg)
