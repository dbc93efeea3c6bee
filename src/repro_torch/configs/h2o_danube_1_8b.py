"""h2o-danube-1.8b [arXiv:2401.16818; hf]: llama+mistral mix with sliding-
window attention (window 4096)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32_000,
    head_dim=80,
    pattern=("swa",),
    window=4096,
    rope_theta=10_000.0,
)
