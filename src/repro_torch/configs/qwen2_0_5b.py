"""qwen2-0.5b [arXiv:2407.10671].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936, QKV bias,
tied embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    microbatches=2,
)
