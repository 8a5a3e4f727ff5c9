"""rwkv6-7b [ssm] — Finch: 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536; data-dependent per-channel decay.  [arXiv:2404.05892; hf]"""
from .base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
    vocab=65536, rwkv_head_dim=64, decay_lora=64, sub_quadratic=True,
)
SMOKE = reduce_for_smoke(CONFIG)
