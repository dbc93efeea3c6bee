"""Serving steps: prefill, and the one-token decode the continuous batcher
drives (the port of ``repro/serving/serve_step.py``).

The reference jits the decode step and donates its KV cache, so decode is
in place on the device; the port's decode writes the cache in place
(``models.layers._write_cache``) and hands the same tensors back, so
steady-state serving memory is exactly one cache here too.

Under an ambient mesh (``distributed.hints.use_mesh``) both steps run
sharded, as ``ModelBundle.prefill``/``decode`` do: the serve step takes the
rank's blocks of the params, of the cache (a tree that carries its specs,
``init_cache(..., mesh=)``) and of the batch's rows, and its logits are
whole over the vocab, so ``greedy_sample`` picks the same token on every
rank of the model group.  The batcher (``serving.batching``) and
``launch.serve`` stay on one device, as the reference's do.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.registry import ModelBundle

__all__ = ["make_prefill_step", "make_serve_step", "greedy_sample"]


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)


def make_prefill_step(bundle: ModelBundle, engine: str = "auto") -> Callable:
    def prefill_step(params, batch):
        return bundle.prefill(params, batch, engine=engine)

    return prefill_step


def make_serve_step(bundle: ModelBundle, sample: bool = False,
                    engine: str = "auto") -> Callable:
    """decode step: (params, cache, batch{tokens, pos}) -> (out, cache), with
    the cache updated in place; under a mesh on the rank's blocks (the
    module's docstring)."""
    def serve_step(params, cache, batch):
        logits, new_cache = bundle.decode(params, cache, batch, engine=engine)
        out = greedy_sample(logits) if sample else logits
        return out, new_cache

    return serve_step
