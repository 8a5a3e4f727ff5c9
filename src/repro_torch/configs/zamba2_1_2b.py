"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64; Mamba2 backbone + weight-shared attention block applied every
2 Mamba layers (19 applications).  [arXiv:2411.15242; hf]"""
from .base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    attn_every=2, sub_quadratic=True,
)
SMOKE = reduce_for_smoke(CONFIG)
