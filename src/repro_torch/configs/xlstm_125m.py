"""xlstm-125m [arXiv:2405.04517; unverified]: alternating mLSTM (parallel
matrix-memory) and sLSTM (scalar-memory scan) blocks; no separate FFN
(d_ff=0 — projections live inside the blocks)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    pattern=("mlstm", "slstm"),
    tie_embeddings=True,
)
