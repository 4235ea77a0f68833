"""Architecture configuration (one instance per architecture).

The port's own copy of the JAX package's ``configs/base.py``, kept as
data: the same fields, defaults, ``__post_init__``, ``smoke()`` and
``param_count()``.  ``smoke()`` derives a reduced config of the same
family for CPU tests (small widths and depths, tiny vocab).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attention-free families
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 → d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rms"              # rms | ln
    act: str = "swiglu"            # swiglu | gelu
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False   # Arctic: dense MLP in parallel
    dense_residual_ff: int = 0
    capacity_factor: float = 1.25

    # --- VLM (M-RoPE backbone; frontend stubbed) ----------------------------
    mrope_sections: Tuple[int, int, int] = ()
    vision_tokens: int = 0             # precomputed patch embeddings fed in

    # --- audio (encoder-decoder; conv frontend stubbed) ----------------------
    n_encoder_layers: int = 0
    n_audio_frames: int = 0            # precomputed frame embeddings fed in

    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_groups: int = 1
    conv_kernel: int = 4

    # --- hybrid (RecurrentGemma / Griffin) ------------------------------------
    lru_width: int = 0
    attn_window: int = 0
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")

    # --- training -------------------------------------------------------------
    remat: bool = True
    optimizer: str = "adamw"           # adamw | adafactor (giant models)
    microbatches: int = 1              # gradient-accumulation steps/batch

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the 500k-token long-context decode shape."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_encdec(self) -> bool:
        return self.family == "audio"

    @property
    def ssm_heads(self) -> int:
        return (self.d_model * self.ssm_expand) // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline bookkeeping)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di = d * self.ssm_expand
            per = (d * (2 * di + 2 * self.ssm_groups * self.ssm_state
                        + self.ssm_heads)
                   + di * d + di)          # in/out proj + dt + conv-ish
            return emb + L * per
        hd = self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        mlp_mult = 3 if self.act == "swiglu" else 2
        if self.family == "moe":
            per_expert = mlp_mult * d * f
            mlp = (self.n_experts * per_expert
                   + self.n_shared_experts * per_expert
                   + (mlp_mult * d * self.dense_residual_ff
                      if self.moe_dense_residual else 0)
                   + d * self.n_experts)   # router
        else:
            mlp = mlp_mult * d * f
        if self.family == "hybrid":
            # pattern-weighted mix of recurrent and attention blocks
            n_attn = sum(1 for i in range(L)
                         if self.block_pattern[i % len(self.block_pattern)]
                         == "attn")
            w = self.lru_width or d
            rec = d * w * 2 + w * d + 3 * w * d // 1 + w * 4   # proj + gates
            return emb + n_attn * (attn + mlp) + (L - n_attn) * (rec + mlp)
        total = emb + L * (attn + mlp)
        if self.family == "audio":
            total += self.n_encoder_layers * (attn + mlp) + L * attn  # cross
        return total

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        mlp_mult = 3 if self.act == "swiglu" else 2
        per_expert = mlp_mult * d * f
        active_mlp = (self.top_k * per_expert
                      + self.n_shared_experts * per_expert
                      + (mlp_mult * d * self.dense_residual_ff
                         if self.moe_dense_residual else 0)
                      + d * self.n_experts)
        hd = self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + active_mlp)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 * max(1, len(self.block_pattern))),
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 2),
            top_k=min(self.top_k, 2),
            dense_residual_ff=64 if self.moe_dense_residual else 0,
            mrope_sections=(2, 3, 3) if self.mrope_sections else (),
            n_encoder_layers=min(self.n_encoder_layers, 2),
            n_audio_frames=16 if self.n_audio_frames else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            lru_width=64 if self.lru_width else 0,
            attn_window=16 if self.attn_window else 0,
            vision_tokens=8 if self.vision_tokens else 0,
        )
