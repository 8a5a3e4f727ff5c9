"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (kv=16) d_ff=1408(expert)
vocab=102400; fine-grained MoE: 2 shared + 64 routed top-6, 1 leading dense
layer (d_ff 10944).  [arXiv:2401.06066; hf]"""
from .base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400, head_dim=128,
    n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
    first_dense=1, d_ff_dense=10944, moe_every=1,
)
SMOKE = reduce_for_smoke(CONFIG)
