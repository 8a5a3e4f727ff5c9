"""Zamba2-style hybrid: a Mamba2 backbone with one *shared* attention block
(weight-tied across applications) applied after every ``attn_every`` Mamba
layers.  The JAX package's ``repro.models.zamba``, in PyTorch.

Storage is the JAX package's: ``groups`` stacks (n_groups, attn_every)
Mamba layers, ``shared_attn`` is one attention + MLP block, and the head
is untied.  The cache stacks a Mamba state per Mamba layer and a KV cache
per application of the shared block: one block's weights, 19 caches at
full width.  Prefill and decode update the cache in place.  ``loss`` is
the dense family's chunked next-token CE; ``remat=True`` recomputes each
group (its Mamba layers and the shared block) in the backward.  On the
card the SSD scan's and the attention's gradients are hand-written
backward kernels (``ssd_scan_bwd``, ``flash_attention_bwd``).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..nn import layers as nn
from .mamba2 import apply_mamba2, mamba2_spec, mamba2_state_spec
from .transformer import (_logits, batch_tokens, ce_from_hidden, check_remat_policy,
                          embed_tokens, layer_slice, remat_call, stack_specs)


def n_groups(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple "
                         f"of attn_every {cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


def param_specs(cfg: ModelConfig) -> dict:
    hd = cfg.resolved_head_dim
    group = {
        "mamba": stack_specs(
            {"block": mamba2_spec(cfg), "ln": nn.rmsnorm_spec(cfg.d_model)},
            cfg.attn_every),
    }
    return {
        "embed": nn.embedding_spec(cfg.vocab, cfg.d_model),
        "groups": stack_specs(group, n_groups(cfg)),
        # one shared attention+mlp block, reused by every group
        "shared_attn": {
            "attn": nn.attention_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                      hd, cfg.qkv_bias),
            "mlp": nn.mlp_spec(cfg.d_model, cfg.d_ff),
            "ln1": nn.rmsnorm_spec(cfg.d_model),
            "ln2": nn.rmsnorm_spec(cfg.d_model),
        },
        "ln_f": nn.rmsnorm_spec(cfg.d_model),
        "lm_head": nn.lm_head_spec(cfg.d_model, cfg.vocab),
    }


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "mamba": stack_specs(stack_specs(mamba2_state_spec(cfg, batch),
                                         cfg.attn_every), n_groups(cfg)),
        "attn_kv": stack_specs(
            nn.attention_cache_spec(batch, max_len, cfg.n_kv_heads, hd,
                                    nn.kv_cache_dtype(cfg)),
            n_groups(cfg)),
    }


def _shared_block(cfg, sp, x, cache=None, pos=None, plain=False):
    h = nn.apply_rmsnorm(sp["ln1"], x, plain=plain)
    h, _ = nn.apply_attention(sp["attn"], h, rope_theta=cfg.rope_theta,
                              cache=cache, cache_pos=pos, chunk=cfg.attn_chunk,
                              plain=plain)
    x = x + h
    return x + nn.apply_mlp(sp["mlp"], nn.apply_rmsnorm(sp["ln2"], x, plain=plain),
                            plain=plain)


def _group(cfg, gp, shared, x, gcache, pos, plain):
    """One group: ``attn_every`` Mamba layers, then the shared block."""
    for j in range(cfg.attn_every):
        lp = layer_slice(gp["mamba"], j)
        st = None if gcache is None else layer_slice(gcache["mamba"], j)
        h, _ = apply_mamba2(lp["block"], nn.apply_rmsnorm(lp["ln"], x, plain=plain), cfg,
                            state=st, plain=plain)
        x = x + h
    kv = None if gcache is None else gcache["attn_kv"]
    return _shared_block(cfg, shared, x, cache=kv, pos=pos, plain=plain)


def _run(cfg, params, x, cache, pos, plain, remat=False):
    for g in range(n_groups(cfg)):
        gc = None if cache is None else {"mamba": layer_slice(cache["mamba"], g),
                                         "attn_kv": layer_slice(cache["attn_kv"], g)}
        x = remat_call(remat and cache is None, _group, cfg,
                       layer_slice(params["groups"], g), params["shared_attn"], x,
                       gc, pos, plain)
    return x


def forward(cfg, params, batch, *, plain: bool = False) -> torch.Tensor:
    x = _run(cfg, params, embed_tokens(params, batch), None, None, plain)
    return _logits(cfg, params, x, plain)


def prefill(cfg, params, batch, cache, *, plain: bool = False):
    x = _run(cfg, params, embed_tokens(params, batch), cache, 0, plain)
    return _logits(cfg, params, x[:, -1:, :], plain), cache


def decode(cfg, params, cache, batch, pos, *, plain: bool = False):
    x = _run(cfg, params, embed_tokens(params, batch), cache, pos, plain)
    return _logits(cfg, params, x, plain), cache


def loss(cfg, params, batch, *, remat: bool = False, remat_policy=None,
         plain: bool = False) -> torch.Tensor:
    check_remat_policy(remat_policy)
    x = _run(cfg, params, embed_tokens(params, batch), None, None, plain, remat)
    return ce_from_hidden(cfg, params, x, batch_tokens(batch, x.device))
