"""olmo-1b [dense] — 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304,
non-parametric LN, tied embeddings.  [arXiv:2402.00838; hf]"""
from .base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50304, norm="nonparam_ln", tied_embeddings=True,
)
SMOKE = reduce_for_smoke(CONFIG)
