"""The model-serving stack of the port: the decoder LMs (dense, MoE,
recurrent hybrids, xLSTM, vision), the encoder-decoder, their layers and
the registry (the port of ``repro/models``)."""
from repro_torch.models.registry import ModelBundle, get_bundle

__all__ = ["ModelBundle", "get_bundle"]
