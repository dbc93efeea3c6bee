"""Model configuration schema for the assigned-architecture zoo (a copy of
the reference's ``configs/base.py``; pure data).

One frozen dataclass drives every family (dense / MoE / hybrid / ssm / vlm /
audio-encdec).  Layer stacking is expressed as a repeating *pattern period*
(e.g. gemma3's 5 local + 1 global); the port's ``models.lm`` walks the layers
in the reference's order (head layers, each period's slots, tail layers).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeCell", "SHAPES"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # layer pattern: one entry per layer within a repeating period.
    # kinds: "attn" (full causal), "swa" (sliding window), "rglru",
    #        "mlstm", "slstm"
    pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                # sliding window for "swa" layers
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # MoE
    n_experts: int = 0             # routed experts (0 = dense FFN)
    n_shared_experts: int = 0
    top_k: int = 0
    first_dense_layers: int = 0    # leading layers with dense FFN
    dense_d_ff: int = 0            # d_ff of those dense layers (0 -> d_ff)
    capacity_factor: float = 1.25

    # recurrent (RG-LRU / xLSTM)
    d_rnn: int = 0                 # recurrence width (0 -> d_model)
    conv_width: int = 4

    # encoder-decoder
    is_encdec: bool = False
    n_encoder_layers: int = 0

    # modality frontend stub (precomputed embeddings supplied as inputs)
    frontend: str = "none"         # none | vision_patches | audio_frames
    frontend_dim: int = 0          # embedding dim of the precomputed frontend
    n_frontend_tokens: int = 0     # tokens contributed by the frontend

    # numerics / parallelism knobs
    dtype: str = "bfloat16"
    remat: bool = True
    # vocab / expert padding so static dims divide the 16-way model axis
    pad_vocab_to: int = 256
    pad_experts_to: int = 16

    # ---- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.pad_vocab_to)

    @property
    def padded_experts(self) -> int:
        if self.n_experts == 0:
            return 0
        return _round_up(self.n_experts, self.pad_experts_to)

    @property
    def d_rnn_(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        """Layers left over when the pattern doesn't divide n_layers."""
        rem = self.n_layers % len(self.pattern)
        return self.pattern[:rem]

    def params_per_token(self) -> int:
        """Active parameters N (for MODEL_FLOPS = 6·N·D roofline term)."""
        d, hd = self.d_model, self.head_dim_
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        n = 0
        counts = {}
        for i in range(self.n_layers):
            kind = (self.pattern + self.tail_pattern)[i % len(self.pattern)] \
                if i < self.n_periods * len(self.pattern) else self.tail_pattern[
                    i - self.n_periods * len(self.pattern)]
            counts[kind] = counts.get(kind, 0) + 1
        for kind, c in counts.items():
            if kind in ("attn", "swa"):
                n += c * attn
            elif kind == "rglru":
                # two in-proj branches + conv + gates + out-proj
                n += c * (2 * d * self.d_rnn_ + self.conv_width * self.d_rnn_
                          + 2 * self.d_rnn_ * self.d_rnn_ + self.d_rnn_ * d)
            elif kind in ("mlstm", "slstm"):
                n += c * (4 * d * d)
        # FFN
        if self.n_experts:
            moe_layers = self.n_layers - self.first_dense_layers
            active = (self.top_k + self.n_shared_experts) * 3 * d * self.d_ff
            n += moe_layers * active
            n += self.first_dense_layers * 3 * d * (self.dense_d_ff or self.d_ff)
        elif self.d_ff:
            n += self.n_layers * 3 * d * self.d_ff
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.is_encdec:
            # encoder layers: self-attn + ffn; decoder already counted above
            n += self.n_encoder_layers * (attn + 3 * d * self.d_ff)
            # decoder cross-attention
            n += self.n_layers * attn
        return n

    def total_params(self) -> int:
        """Total parameters (MoE: all experts)."""
        if not self.n_experts:
            return self.params_per_token()
        d = self.d_model
        active = (self.top_k + self.n_shared_experts) * 3 * d * self.d_ff
        full = (self.n_experts + self.n_shared_experts) * 3 * d * self.d_ff
        moe_layers = self.n_layers - self.first_dense_layers
        return self.params_per_token() + moe_layers * (full - active)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) column of the assignment matrix."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}
