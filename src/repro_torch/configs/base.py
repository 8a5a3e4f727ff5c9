"""Architecture / shape / run configuration.

Every assigned architecture lives in its own ``configs/<id>.py`` exporting
``CONFIG`` (exact published shape) and ``SMOKE`` (reduced same-family config
for CPU smoke tests).  ``repro_torch.configs`` resolves ``--arch <id>``.

The configurations are the JAX package's, field for field; the only change
is that ``dtype`` is a dtype name (``"bfloat16"``) instead of a jnp dtype.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | rwkv | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | nonparam_ln
    rope_theta: float = 10000.0
    tied_embeddings: bool = False
    dtype: str = "bfloat16"
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1          # MoE layer every k-th layer (llama4 interleave)
    first_dense: int = 0        # leading dense layers (deepseek-moe)
    d_ff_dense: int = 0         # d_ff of the dense layers in an MoE stack
    capacity_factor: float = 1.25
    # --- hybrid (zamba2-style) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    attn_every: int = 0         # shared attention block every k mamba layers
    # --- rwkv6 ---
    rwkv_head_dim: int = 64
    decay_lora: int = 64
    # --- encoder-decoder ---
    n_enc_layers: int = 0
    frame_stride: int = 8       # audio frames = seq // frame_stride
    # --- vlm ---
    n_patches: int = 1024       # precomputed patch embeddings (frontend stub)
    # --- serving/runtime knobs ---
    kv_cache_dtype: str = "bfloat16"   # "int8" halves the decode working set
    ce_chunk: int = 1024               # tokens per memory-efficient-CE chunk
    attn_chunk: int = 1024
    sub_quadratic: bool = False  # True => long_500k shape is runnable
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# The four assigned LM shapes (identical for all 10 archs).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs, per DESIGN.md §5."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: O(L^2) at 524288 skipped (DESIGN.md §5)"
    return True, ""


def reduce_for_bench(cfg: ModelConfig) -> ModelConfig:
    """Mid-size same-family config for the REAP serving benchmarks:
    arena working sets land in the paper's 8-99MB range (Fig. 4)."""
    return dataclasses.replace(
        reduce_for_smoke(cfg),
        name=cfg.name + "-bench",
        n_layers=max(4, min(6, cfg.n_layers)),
        d_model=256,
        n_heads=8,
        n_kv_heads=4 if cfg.n_kv_heads < cfg.n_heads else 8,
        head_dim=32,
        d_ff=1024,
        vocab=8192,
        n_experts=min(cfg.n_experts, 16),
        top_k=min(cfg.top_k, 2),
        d_ff_expert=256 if cfg.d_ff_expert else 0,
        d_ff_dense=1024 if cfg.d_ff_dense else 0,
        ssm_state=min(cfg.ssm_state, 32) if cfg.ssm_state else 0,
        n_patches=32,
    )


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Same-family reduced config: tiny layers/width/vocab/experts."""
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(4, max(1, cfg.n_kv_heads * 4 // max(cfg.n_heads, 1))),
        head_dim=32,
        d_ff=256,
        vocab=512,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        d_ff_dense=256 if cfg.d_ff_dense else 0,
        first_dense=min(cfg.first_dense, 1),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else cfg.ssm_head_dim,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        rwkv_head_dim=32,
        decay_lora=16,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_patches=16,
        attn_chunk=64,
    )
