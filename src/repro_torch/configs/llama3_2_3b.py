"""llama3.2-3b [hf:meta-llama/Llama-3.2-3B; unverified]: small llama3."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128_256,
    head_dim=128,
    pattern=("attn",),
    rope_theta=500_000.0,
    tie_embeddings=True,
)
