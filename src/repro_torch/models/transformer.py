"""Dense GQA decoder-only transformer (qwen/mistral/olmo) + VLM backbone.

Parameters keep the JAX package's stacked storage: every layer leaf has a
leading "layers" axis, because the snapshot's arena layout depends on it.
So does the KV cache: ``cache["kv"]["k"]`` is (layers, B, max_len, KV, D).
The forward, prefill and decode loop over that axis where the JAX package
uses ``lax.scan``; prefill and decode write the cache in place.

The VLM (pixtral) is this family with a stub frontend: a prompt's
``patch_embeds`` (B, n_patches, d_model), cast to the activations' dtype,
come before its token embeddings, so decode positions continue after
``n_patches + n_txt``.

``plain=True`` runs every kernel's plain version in its stead (see
:mod:`repro_torch.nn.layers`).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..nn import layers as nn
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


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "kv": stack_specs(
            nn.attention_cache_spec(batch, max_len, cfg.n_kv_heads, hd,
                                    nn.kv_cache_dtype(cfg)),
            cfg.n_layers,
        )
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_fwd(cfg: ModelConfig, lp: dict, x: torch.Tensor, cache: dict | None,
               cache_pos: int | None, plain: bool) -> torch.Tensor:
    h = nn.apply_norm(cfg.norm, lp.get("ln1"), x)
    h, _ = nn.apply_attention(lp["attn"], h, rope_theta=cfg.rope_theta,
                              cache=cache, cache_pos=cache_pos,
                              chunk=cfg.attn_chunk, plain=plain)
    x = x + h
    h = nn.apply_norm(cfg.norm, lp.get("ln2"), x)
    return x + nn.apply_mlp(lp["mlp"], h)


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked (leading 'layers' axis) tree: views, so a
    write into a cache slice lands in the stacked cache."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _run_layers(cfg: ModelConfig, params: dict, x: torch.Tensor,
                cache: dict | None, cache_pos: int | None,
                plain: bool) -> torch.Tensor:
    for i in range(cfg.n_layers):
        lc = None if cache is None else layer_slice(cache["kv"], i)
        x = _layer_fwd(cfg, layer_slice(params["layers"], i), x, lc, cache_pos,
                       plain)
    return x


def embed_tokens(params: dict, batch: dict) -> torch.Tensor:
    """``batch["tokens"]`` (B, S) integers, moved to the params' device,
    through the embedding."""
    table = params["embed"]["table"]
    tokens = torch.as_tensor(batch["tokens"], device=table.device).long()
    return nn.apply_embedding(params["embed"], tokens)


def _trunk_in(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """A prompt's embeddings: the VLM's ``patch_embeds`` (moved to the
    params' device, in the activations' dtype) before its tokens'."""
    x = embed_tokens(params, batch)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pe = torch.as_tensor(batch["patch_embeds"]).to(x.device, x.dtype)
        x = torch.cat([pe, x], dim=1)
    return x


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = nn.apply_norm(cfg.norm, params.get("ln_f"), x)
    if cfg.tied_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"]["table"])
    return nn.apply_lm_head(params["lm_head"], x)


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            plain: bool = False) -> torch.Tensor:
    """Full scoring forward -> logits (B, S, vocab)."""
    x = _run_layers(cfg, params, _trunk_in(cfg, params, batch), None, None, plain)
    return _logits(cfg, params, x)


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache: dict, *,
            plain: bool = False):
    """Populate the KV cache from a full prompt (in place); returns the
    last position's logits (B, 1, vocab) and the cache."""
    x = _run_layers(cfg, params, _trunk_in(cfg, params, batch), cache, 0, plain)
    return _logits(cfg, params, x[:, -1:, :]), cache


def decode(cfg: ModelConfig, params: dict, cache: dict, batch: dict, pos: int, *,
           plain: bool = False):
    """One-token decode step at position ``pos`` (the cache is valid up to
    ``pos``, and this step's K/V are written there in place); returns
    logits (B, 1, vocab) and the cache."""
    x = _run_layers(cfg, params, embed_tokens(params, batch), cache, pos, plain)
    return _logits(cfg, params, x), cache
