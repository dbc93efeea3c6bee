"""gemma3-12b [hf:google/gemma-3-12b-pt; unverified]: 5 local (window 1024) :
1 global pattern, 128k context."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,                 # 8 periods of (5×local, global)
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15_360,
    vocab_size=262_144,
    head_dim=240,
    pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
    window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
