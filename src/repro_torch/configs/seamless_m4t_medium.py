"""seamless-m4t-medium [audio] — enc-dec 12L+12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206; modality frontend is a stub (precomputed frame
embeddings).  [arXiv:2308.11596; hf]"""
from .base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, frame_stride=8,
)
SMOKE = reduce_for_smoke(CONFIG)
