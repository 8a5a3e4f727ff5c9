"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT frontend is a stub (precomputed patch embeddings)
feeding a mistral-nemo backbone.  [hf:mistralai/Pixtral-12B-2409; unverified]"""
from .base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=131072, head_dim=128, rope_theta=1_000_000.0, n_patches=1024,
)
SMOKE = reduce_for_smoke(CONFIG)
