"""mamba2-2.7b [arXiv:2405.21060] — SSD (state-space duality).

64L d_model=2560, attention-free, ssm_state=128, expand=2, head_dim=64.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50304,   # 50280 padded to 128-multiple so 'vocab' shards cleanly
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_groups=1,
    conv_kernel=4,
    microbatches=4,
)
