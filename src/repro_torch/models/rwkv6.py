"""RWKV6 ("Finch"): attention-free, data-dependent per-channel decay.  The
JAX package's ``repro.models.rwkv6``, in PyTorch.

Specs, casting points and the chunk rule are the JAX package's.  The WKV6
scan runs the hand-written kernel (``kernels.rwkv6_scan``) on a CUDA
tensor and its plain version, the chunked form, on a CPU tensor and with
``plain=True``.  Storage keeps the stacked ``layers`` axis, looped over
where the JAX package uses ``lax.scan``; prefill and decode write each
layer's state (``wkv``, ``tm_shift``, ``cm_shift``) in place into its
slice of the cache, where the JAX package returns a new one.  The shift
states are bfloat16 in the cache spec, so a float32 run rounds them as the
JAX package does.  ``loss`` is the dense family's chunked next-token CE;
``remat=True`` recomputes each layer in the backward.  On the card the
WKV6 scan's gradients are a hand-written backward kernel
(``wkv6_scan_bwd``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rwkv6_scan import wkv6, wkv6_ref
from ..nn import layers as nn
from ..nn.spec import tensor
from .transformer import (_logits, batch_tokens, ce_from_hidden, check_remat_policy,
                          embed_tokens, layer_slice, remat_call, stack_specs)


def dims(cfg: ModelConfig):
    H = cfg.d_model // cfg.rwkv_head_dim
    return H, cfg.rwkv_head_dim


def time_mix_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H, hd = dims(cfg)
    r = cfg.decay_lora
    return {
        "mu_r": tensor(d, axes=("embed",), dtype="float32", init="zeros"),
        "mu_k": tensor(d, axes=("embed",), dtype="float32", init="zeros"),
        "mu_v": tensor(d, axes=("embed",), dtype="float32", init="zeros"),
        "mu_w": tensor(d, axes=("embed",), dtype="float32", init="zeros"),
        "mu_g": tensor(d, axes=("embed",), dtype="float32", init="zeros"),
        "wr": tensor(d, H, hd, axes=("embed", "heads", "head_dim"), init="trunc_fan_in"),
        "wk": tensor(d, H, hd, axes=("embed", "heads", "head_dim"), init="trunc_fan_in"),
        "wv": tensor(d, H, hd, axes=("embed", "heads", "head_dim"), init="trunc_fan_in"),
        "wg": tensor(d, H, hd, axes=("embed", "heads", "head_dim"), init="trunc_fan_in"),
        "w0": tensor(H, hd, axes=("heads", "head_dim"), dtype="float32", init="zeros"),
        "wA": tensor(d, r, axes=("embed", None), init="trunc_fan_in"),
        "wB": tensor(r, H, hd, axes=(None, "heads", "head_dim"), init="trunc_fan_in"),
        "u": tensor(H, hd, axes=("heads", "head_dim"), dtype="float32", init="zeros"),
        "ln_x": nn.rmsnorm_spec(cfg.d_model),
        "wo": tensor(H, hd, d, axes=("heads", "head_dim", "embed"), init="trunc_fan_in"),
    }


def channel_mix_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "mu_k": tensor(d, axes=("embed",), dtype="float32", init="zeros"),
        "mu_r": tensor(d, axes=("embed",), dtype="float32", init="zeros"),
        "wk": tensor(d, cfg.d_ff, axes=("embed", "mlp"), init="trunc_fan_in"),
        "wv": tensor(cfg.d_ff, d, axes=("mlp", "embed"), init="trunc_fan_in"),
        "wr": tensor(d, d, axes=("embed", None), init="trunc_fan_in"),
    }


def layer_spec(cfg: ModelConfig) -> dict:
    return {
        "ln1": nn.rmsnorm_spec(cfg.d_model),
        "ln2": nn.rmsnorm_spec(cfg.d_model),
        "tm": time_mix_spec(cfg),
        "cm": channel_mix_spec(cfg),
    }


def param_specs(cfg: ModelConfig) -> dict:
    return {
        "embed": nn.embedding_spec(cfg.vocab, cfg.d_model),
        "ln_in": nn.rmsnorm_spec(cfg.d_model),
        "layers": stack_specs(layer_spec(cfg), cfg.n_layers),
        "ln_f": nn.rmsnorm_spec(cfg.d_model),
        "lm_head": nn.lm_head_spec(cfg.d_model, cfg.vocab),
    }


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    H, hd = dims(cfg)
    layer_state = {
        "wkv": tensor(batch, H, hd, hd, axes=("batch", "heads", None, None),
                      dtype="float32", init="zeros"),
        "tm_shift": tensor(batch, cfg.d_model, axes=("batch", "embed"),
                           dtype="bfloat16", init="zeros"),
        "cm_shift": tensor(batch, cfg.d_model, axes=("batch", "embed"),
                           dtype="bfloat16", init="zeros"),
    }
    return {"layers": stack_specs(layer_state, cfg.n_layers)}


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x: (B, L, d); prev: (B, d) last token of the previous segment (None:
    zeros)."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None, :].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix(x, shifted, mu):
    return x + (shifted - x) * torch.sigmoid(mu)


def apply_time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   state: dict | None = None, *, plain: bool = False):
    """x: (B, L, d).  state: {"wkv": (B, H, D, D), "shift": (B, d)}, updated
    in place, or None."""
    B, L, d = x.shape
    H, hd = dims(cfg)
    xs = _token_shift(x, None if state is None else state["shift"])
    xr, xk, xv, xw, xg = (_mix(x, xs, p[m]).to(x.dtype)
                          for m in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"))
    r = torch.einsum("bld,dhk->blhk", xr, p["wr"])
    k = torch.einsum("bld,dhk->blhk", xk, p["wk"])
    v = torch.einsum("bld,dhk->blhk", xv, p["wv"])
    g = torch.einsum("bld,dhk->blhk", xg, p["wg"])
    # data-dependent decay (the RWKV6 signature): w = exp(-exp(w0 + lora(xw)))
    lora = torch.einsum("bld,dr->blr", xw, p["wA"])
    lora = torch.einsum("blr,rhk->blhk", torch.tanh(lora.float()).to(x.dtype), p["wB"])
    logw = -torch.exp(p["w0"][None, None] + lora.float())
    s0 = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
          if state is None else state["wkv"])
    scan = wkv6_ref if plain else wkv6
    y, sT = scan(r, k, v, logw, p["u"], s0, chunk=min(32, max(1, L)))
    y = nn.apply_rmsnorm(p["ln_x"], y.reshape(B, L, d).to(x.dtype), plain=plain)
    y = y * F.silu(g.float()).to(x.dtype).reshape(B, L, d)
    out = torch.einsum("blhk,hkd->bld", y.reshape(B, L, H, hd), p["wo"])
    if state is not None:
        state["wkv"].copy_(sT)
        state["shift"].copy_(x[:, -1])
    return out


def apply_channel_mix(p: dict, x: torch.Tensor, state: torch.Tensor | None = None):
    """x: (B, L, d); state: (B, d) shift, updated in place, or None."""
    xs = _token_shift(x, state)
    xk = _mix(x, xs, p["mu_k"]).to(x.dtype)
    xr = _mix(x, xs, p["mu_r"]).to(x.dtype)
    kk = torch.einsum("bld,df->blf", xk, p["wk"])
    kk = torch.square(F.relu(kk.float())).to(x.dtype)
    val = torch.einsum("blf,fd->bld", kk, p["wv"])
    rr = torch.sigmoid(torch.einsum("bld,de->ble", xr, p["wr"]).float())
    out = (rr * val.float()).to(x.dtype)
    if state is not None:
        state.copy_(x[:, -1])
    return out


def _layer_fwd(cfg, lp, x, ls, plain):
    tm_state = None if ls is None else {"wkv": ls["wkv"], "shift": ls["tm_shift"]}
    x = x + apply_time_mix(lp["tm"], nn.apply_rmsnorm(lp["ln1"], x, plain=plain), cfg,
                           tm_state,
                           plain=plain)
    return x + apply_channel_mix(lp["cm"], nn.apply_rmsnorm(lp["ln2"], x, plain=plain),
                                 None if ls is None else ls["cm_shift"])


def _run(cfg, params, x, cache, plain, remat=False):
    x = nn.apply_rmsnorm(params["ln_in"], x, plain=plain)
    for i in range(cfg.n_layers):
        ls = None if cache is None else layer_slice(cache["layers"], i)
        x = remat_call(remat and cache is None, _layer_fwd, cfg,
                       layer_slice(params["layers"], i), x, ls, plain)
    return x


def forward(cfg, params, batch, *, plain: bool = False) -> torch.Tensor:
    x = _run(cfg, params, embed_tokens(params, batch), None, plain)
    return _logits(cfg, params, x, plain)


def prefill(cfg, params, batch, cache, *, plain: bool = False):
    x = _run(cfg, params, embed_tokens(params, batch), cache, plain)
    return _logits(cfg, params, x[:, -1:, :], plain), cache


def decode(cfg, params, cache, batch, pos, *, plain: bool = False):
    del pos  # the state is position-free
    x = _run(cfg, params, embed_tokens(params, batch), cache, plain)
    return _logits(cfg, params, x, plain), cache


def loss(cfg, params, batch, *, remat: bool = False, remat_policy=None,
         plain: bool = False) -> torch.Tensor:
    check_remat_policy(remat_policy)
    x = _run(cfg, params, embed_tokens(params, batch), None, plain, remat)
    return ce_from_hidden(cfg, params, x, batch_tokens(batch, x.device))
