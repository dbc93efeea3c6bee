"""deepseek-moe-16b [arXiv:2401.06066; hf]: fine-grained MoE, 2 shared + 64
routed top-6; first layer dense (inter 10944, per the HF config)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    pattern=("attn",),
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    first_dense_layers=1,
    dense_d_ff=10_944,
    rope_theta=10_000.0,
)
