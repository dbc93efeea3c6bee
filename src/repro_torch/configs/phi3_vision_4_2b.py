"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct]: phi3-mini
decoder backbone; the CLIP frontend is a STUB — ``input_specs`` supplies
precomputed patch embeddings (B, 576, 1024) projected into the first 576
sequence positions."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    pattern=("attn",),
    rope_theta=10_000.0,
    frontend="vision_patches",
    frontend_dim=1024,
    n_frontend_tokens=576,
)
