"""Encoder-decoder (seamless-m4t-medium backbone).  The JAX package's
``repro.models.encdec``, in PyTorch.

The audio frontend is a stub: the inputs carry precomputed frame
embeddings (B, seq // frame_stride, d_model).  The encoder is a
bidirectional transformer over the frames (the flash kernel without its
causal mask on the card), the decoder a causal transformer with
cross-attention.  Prefill encodes once and fills the cross cache
(``cross_kv``, in ``cfg.dtype`` even beside an int8 self cache) and its
valid length (``enc_len``, int32 per sequence); a decode step's
cross-attention runs the decode kernel over that cache with ``kv_len =
enc_len``.  A prompt's cross-attention (Sq != Skv) runs
``nn.chunked_attention`` on either device, as in the JAX package.  Storage
keeps the stacked ``enc_layers``/``dec_layers`` axes; prefill and decode
write the caches in place.  ``loss`` is the dense family's chunked
next-token CE over the decoder's hidden states; ``remat`` is ignored, as
in the JAX package.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..nn import layers as nn
from ..nn.spec import torch_dtype
from .transformer import (batch_tokens, ce_from_hidden, check_remat_policy,
                          embed_tokens, layer_slice, stack_specs)


def enc_layer_spec(cfg: ModelConfig) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "attn": nn.attention_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd),
        "mlp": nn.mlp_spec(cfg.d_model, cfg.d_ff),
        "ln1": nn.rmsnorm_spec(cfg.d_model),
        "ln2": nn.rmsnorm_spec(cfg.d_model),
    }


def dec_layer_spec(cfg: ModelConfig) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "self_attn": nn.attention_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd),
        "cross_q": nn.tensor(cfg.d_model, cfg.n_heads, hd,
                             axes=("embed", "heads", "head_dim"), init="trunc_fan_in"),
        "cross_k": nn.tensor(cfg.d_model, cfg.n_kv_heads, hd,
                             axes=("embed", "kv_heads", "head_dim"), init="trunc_fan_in"),
        "cross_v": nn.tensor(cfg.d_model, cfg.n_kv_heads, hd,
                             axes=("embed", "kv_heads", "head_dim"), init="trunc_fan_in"),
        "cross_o": nn.tensor(cfg.n_heads, hd, cfg.d_model,
                             axes=("heads", "head_dim", "embed"), init="trunc_fan_in"),
        "mlp": nn.mlp_spec(cfg.d_model, cfg.d_ff),
        "ln1": nn.rmsnorm_spec(cfg.d_model),
        "ln_x": nn.rmsnorm_spec(cfg.d_model),
        "ln2": nn.rmsnorm_spec(cfg.d_model),
    }


def n_enc_layers(cfg: ModelConfig) -> int:
    return cfg.n_enc_layers or cfg.n_layers


def param_specs(cfg: ModelConfig) -> dict:
    return {
        "embed": nn.embedding_spec(cfg.vocab, cfg.d_model),
        "enc_layers": stack_specs(enc_layer_spec(cfg), n_enc_layers(cfg)),
        "dec_layers": stack_specs(dec_layer_spec(cfg), cfg.n_layers),
        "ln_enc": nn.rmsnorm_spec(cfg.d_model),
        "ln_f": nn.rmsnorm_spec(cfg.d_model),
        "lm_head": nn.lm_head_spec(cfg.d_model, cfg.vocab),
    }


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    hd = cfg.resolved_head_dim
    n_frames = max(1, max_len // cfg.frame_stride)
    return {
        "self_kv": stack_specs(
            nn.attention_cache_spec(batch, max_len, cfg.n_kv_heads, hd,
                                    nn.kv_cache_dtype(cfg)),
            cfg.n_layers),
        "cross_kv": stack_specs(
            nn.attention_cache_spec(batch, n_frames, cfg.n_kv_heads, hd, cfg.dtype),
            cfg.n_layers),
        # valid encoder length, the same for every sequence of the batch
        "enc_len": nn.tensor(batch, axes=("batch",), dtype="int32", init="zeros"),
    }


def encode(cfg: ModelConfig, params: dict, frames, plain: bool = False) -> torch.Tensor:
    """Frame embeddings (moved to the params' device and cast to
    ``cfg.dtype``, as the JAX package casts them) through the bidirectional
    encoder."""
    table = params["embed"]["table"]
    x = torch.as_tensor(frames).to(table.device, torch_dtype(cfg.dtype))
    for i in range(n_enc_layers(cfg)):
        lp = layer_slice(params["enc_layers"], i)
        h = nn.apply_bidirectional_attention(
            lp["attn"], nn.apply_rmsnorm(lp["ln1"], x, plain=plain),
            rope_theta=cfg.rope_theta, chunk=cfg.attn_chunk, plain=plain)
        x = x + h
        x = x + nn.apply_mlp(lp["mlp"], nn.apply_rmsnorm(lp["ln2"], x, plain=plain),
                             plain=plain)
    return nn.apply_rmsnorm(params["ln_enc"], x, plain=plain)


def _cross_kv(lp: dict, enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.einsum("bsd,dhk->bshk", enc_out, lp["cross_k"]),
            torch.einsum("bsd,dhk->bshk", enc_out, lp["cross_v"]))


def _cross_attend(cfg, lp, x, enc_k, enc_v, enc_len=None, plain=False):
    q = torch.einsum("bsd,dhk->bshk", x, lp["cross_q"])
    o = nn.cross_attention(q, enc_k, enc_v, enc_len, chunk=cfg.attn_chunk, plain=plain)
    return torch.einsum("bshk,hkd->bsd", o, lp["cross_o"])


def _dec_layer(cfg, lp, x, enc_kv, self_cache=None, pos=None, enc_len=None,
               plain=False):
    h = nn.apply_rmsnorm(lp["ln1"], x, plain=plain)
    h, _ = nn.apply_attention(lp["self_attn"], h, rope_theta=cfg.rope_theta,
                              cache=self_cache, cache_pos=pos, chunk=cfg.attn_chunk,
                              plain=plain)
    x = x + h
    h = nn.apply_rmsnorm(lp["ln_x"], x, plain=plain)
    x = x + _cross_attend(cfg, lp, h, enc_kv[0], enc_kv[1], enc_len, plain)
    return x + nn.apply_mlp(lp["mlp"], nn.apply_rmsnorm(lp["ln2"], x, plain=plain),
                            plain=plain)


def _dec_run(cfg, params, batch, enc_out, cache=None, pos=None, enc_len=None,
             plain=False):
    """The decoder over ``batch["tokens"]``: cross-attention over the fresh
    encoder output without a cache, over the cross cache with one."""
    x = embed_tokens(params, batch)
    for i in range(cfg.n_layers):
        lp = layer_slice(params["dec_layers"], i)
        if cache is None:
            x = _dec_layer(cfg, lp, x, _cross_kv(lp, enc_out), plain=plain)
        else:
            cc = layer_slice(cache["cross_kv"], i)
            x = _dec_layer(cfg, lp, x, (cc["k"], cc["v"]),
                           layer_slice(cache["self_kv"], i), pos, enc_len, plain)
    return x


def _logits(params: dict, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
    return nn.apply_lm_head(params["lm_head"],
                            nn.apply_rmsnorm(params["ln_f"], x, plain=plain))


def forward(cfg, params, batch, *, plain: bool = False) -> torch.Tensor:
    enc_out = encode(cfg, params, batch["frames"], plain)
    return _logits(params, _dec_run(cfg, params, batch, enc_out, plain=plain), plain)


def prefill(cfg, params, batch, cache, *, plain: bool = False):
    """Encode, fill the cross cache once (and ``enc_len``), then run the
    decoder over the prompt tokens; returns the last position's logits."""
    enc_out = encode(cfg, params, batch["frames"], plain)
    n_frames = enc_out.shape[1]
    for i in range(cfg.n_layers):
        cc = layer_slice(cache["cross_kv"], i)
        k, v = _cross_kv(layer_slice(params["dec_layers"], i), enc_out)
        cc["k"][:, :n_frames] = k.to(cc["k"].dtype)
        cc["v"][:, :n_frames] = v.to(cc["v"].dtype)
    cache["enc_len"].fill_(n_frames)
    x = _dec_run(cfg, params, batch, enc_out, cache, 0, n_frames, plain)
    return _logits(params, x[:, -1:, :], plain), cache


def decode(cfg, params, cache, batch, pos, *, plain: bool = False):
    x = _dec_run(cfg, params, batch, None, cache, pos, cache["enc_len"], plain)
    return _logits(params, x, plain), cache


def loss(cfg, params, batch, *, remat: bool = False, remat_policy=None,
         plain: bool = False) -> torch.Tensor:
    del remat                              # as in the JAX package
    check_remat_policy(remat_policy)
    enc_out = encode(cfg, params, batch["frames"], plain)
    x = _dec_run(cfg, params, batch, enc_out, plain=plain)
    return ce_from_hidden(cfg, params, x, batch_tokens(batch, x.device))
