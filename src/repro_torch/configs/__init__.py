"""Assigned-architecture configs, copied from the reference as data."""
from repro_torch.configs.base import ModelConfig, ShapeCell, SHAPES
from repro_torch.configs.archs import (ARCHS, LONG_CONTEXT_OK, get_config,
                                       reduced_config)

__all__ = ["ModelConfig", "ShapeCell", "SHAPES", "ARCHS", "LONG_CONTEXT_OK",
           "get_config", "reduced_config"]
