"""seamless-m4t-medium [arXiv:2308.11596; hf]: encoder-decoder multimodal
backbone.  The speech frontend is a STUB — ``input_specs`` supplies
precomputed frame embeddings (B, S/4, 1024) to the encoder.  Vocab 256206 is
padded to 256256 for the 16-way model axis (Megatron convention)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,                 # decoder layers
    n_encoder_layers=12,
    is_encdec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    pattern=("attn",),
    frontend="audio_frames",
    frontend_dim=1024,
)
