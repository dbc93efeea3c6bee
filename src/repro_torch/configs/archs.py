"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus reduced
(smoke-test) variants of each family."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2moe
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _danube
from repro_torch.configs.llama3_2_3b import CONFIG as _llama32
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.qwen2_1_5b import CONFIG as _qwen2
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm
from repro_torch.configs.phi3_vision_4_2b import CONFIG as _phi3v
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless

ARCHS = {
    c.name: c
    for c in (
        _deepseek, _qwen2moe, _rgemma, _danube, _llama32,
        _gemma3, _qwen2, _xlstm, _phi3v, _seamless,
    )
}

# long_500k applicability: the archs with sub-quadratic decode
LONG_CONTEXT_OK = {
    "recurrentgemma-2b", "h2o-danube-1.8b", "gemma3-12b", "xlstm-125m",
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str) -> ModelConfig:
    """Smoke-test variant: same family/pattern, tiny dims (CPU-runnable)."""
    c = get_config(name)
    pat_period = len(c.pattern)
    n_layers = max(pat_period, 2)
    if c.n_layers % pat_period:
        n_layers += c.n_layers % pat_period  # keep a tail layer if the real one has one
    return dataclasses.replace(
        c,
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(c.n_kv_heads, 2)) if c.n_kv_heads < c.n_heads else 4,
        head_dim=16,
        d_ff=128 if c.d_ff else 0,
        dense_d_ff=160 if c.dense_d_ff else 0,
        vocab_size=512,
        n_experts=8 if c.n_experts else 0,
        n_shared_experts=min(c.n_shared_experts, 2),
        top_k=min(c.top_k, 2) if c.top_k else 0,
        pad_experts_to=4,
        window=16 if c.window else 0,
        d_rnn=64 if c.d_rnn else 0,
        n_encoder_layers=2 if c.is_encdec else 0,
        frontend_dim=32 if c.frontend != "none" else 0,
        n_frontend_tokens=8 if c.frontend == "vision_patches" else 0,
        pad_vocab_to=64,
        remat=False,
    )
