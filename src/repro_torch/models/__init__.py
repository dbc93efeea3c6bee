"""The model-serving stack of the port: the dense decoder LM, its layers and
the registry (the port of ``repro/models``)."""
from repro_torch.models.registry import ModelBundle, get_bundle

__all__ = ["ModelBundle", "get_bundle"]
