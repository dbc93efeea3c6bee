"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 4 shared + 60 routed top-4.

60 routed experts are padded to 64 for the 16-way model axis (router logits of
pad experts are masked to -inf; zero active-parameter change) — the Megatron
vocab/expert padding convention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    pattern=("attn",),
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
