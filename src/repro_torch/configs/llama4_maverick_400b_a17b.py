"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192(expert) vocab=202048; MoE every 2nd layer, 128 routed experts
top-1 + 1 shared expert; dense interleave d_ff 16384.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, head_dim=128, rope_theta=500_000.0,
    n_experts=128, top_k=1, n_shared_experts=1, d_ff_expert=8192,
    first_dense=0, d_ff_dense=16384, moe_every=2,
)
SMOKE = reduce_for_smoke(CONFIG)
