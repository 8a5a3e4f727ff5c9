"""Dense GQA decoder-only transformer (qwen/mistral/olmo).

Parameters keep the JAX package's stacked storage: every layer leaf has a
leading "layers" axis, because the snapshot's arena layout depends on it.
The forward loops over that axis where the JAX package uses ``lax.scan``.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..nn import layers as nn
from ..nn.layers import AttentionFn
from ..nn.spec import TensorSpec, map_leaves

# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------


def stack_specs(spec_tree, n: int):
    """Prepend a stacked 'layers' axis to every leaf."""
    return map_leaves(
        lambda _, s: TensorSpec((n,) + s.shape, s.dtype, ("layers",) + s.axes,
                                s.init, s.scale),
        spec_tree,
    )


def layer_spec(cfg: ModelConfig) -> dict:
    hd = cfg.resolved_head_dim
    s = {
        "attn": nn.attention_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd,
                                  cfg.qkv_bias),
        "mlp": nn.mlp_spec(cfg.d_model, cfg.d_ff),
    }
    if cfg.norm == "rmsnorm":
        s["ln1"] = nn.rmsnorm_spec(cfg.d_model)
        s["ln2"] = nn.rmsnorm_spec(cfg.d_model)
    return s


def param_specs(cfg: ModelConfig) -> dict:
    s = {
        "embed": nn.embedding_spec(cfg.vocab, cfg.d_model),
        "layers": stack_specs(layer_spec(cfg), cfg.n_layers),
    }
    if cfg.norm == "rmsnorm":
        s["ln_f"] = nn.rmsnorm_spec(cfg.d_model)
    if not cfg.tied_embeddings:
        s["lm_head"] = nn.lm_head_spec(cfg.d_model, cfg.vocab)
    return s


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_fwd(cfg: ModelConfig, lp: dict, x: torch.Tensor,
               attn: AttentionFn | None) -> torch.Tensor:
    h = nn.apply_norm(cfg.norm, lp.get("ln1"), x)
    x = x + nn.apply_attention(lp["attn"], h, rope_theta=cfg.rope_theta,
                               chunk=cfg.attn_chunk, attn=attn)
    h = nn.apply_norm(cfg.norm, lp.get("ln2"), x)
    return x + nn.apply_mlp(lp["mlp"], h)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked (leading 'layers' axis) param tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = nn.apply_norm(cfg.norm, params.get("ln_f"), x)
    if cfg.tied_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"]["table"])
    return nn.apply_lm_head(params["lm_head"], x)


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            attn: AttentionFn | None = None) -> torch.Tensor:
    """Full scoring forward -> logits (B, S, vocab).

    ``batch["tokens"]`` is an integer array (B, S); it is moved to the
    params' device.  ``attn`` overrides the attention function of every
    layer (see :func:`~repro_torch.nn.layers.apply_attention`).
    """
    table = params["embed"]["table"]
    tokens = torch.as_tensor(batch["tokens"], device=table.device).long()
    x = nn.apply_embedding(params["embed"], tokens)
    for i in range(cfg.n_layers):
        x = _layer_fwd(cfg, _layer(params["layers"], i), x, attn)
    return _logits(cfg, params, x)
