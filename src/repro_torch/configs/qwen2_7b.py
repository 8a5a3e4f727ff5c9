"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, GQA, QKV bias.  [arXiv:2407.10671; hf]"""
from .base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, head_dim=128, qkv_bias=True, rope_theta=1_000_000.0,
)
SMOKE = reduce_for_smoke(CONFIG)
