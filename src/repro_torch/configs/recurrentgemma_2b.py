"""recurrentgemma-2b [arXiv:2402.19427; hf]: Griffin — RG-LRU recurrent blocks
mixed with local attention at 1 attention : 2 recurrent; window 2048."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,                     # 8 periods of (rglru, rglru, swa) + 2 tail
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,                    # MQA
    d_ff=7680,                       # GeGLU
    vocab_size=256_000,
    head_dim=256,
    pattern=("rglru", "rglru", "swa"),
    window=2048,
    d_rnn=2560,
    conv_width=4,
    tie_embeddings=True,
)
