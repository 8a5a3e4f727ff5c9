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

A traced forward (see :mod:`repro_torch.telemetry`) opens ``embed``, a
``layer`` span per layer (attribute ``i``; the residual adds are its own
time, the ops of :mod:`repro_torch.nn.layers` its children) and ``head``
(its ``norm`` and ``logits``).

``loss`` is the training objective: next-token cross-entropy from the
final hidden states through :func:`ce_from_hidden`, which never holds the
(B, S, vocab) logits.  ``remat=True`` recomputes each layer in the
backward (``torch.utils.checkpoint``) where the JAX package wraps its scan
body in ``jax.checkpoint``; a ``jax.checkpoint`` policy has no counterpart
here, so ``remat_policy`` must be None.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..nn import layers as nn
from ..nn.spec import TensorSpec, map_leaves
from ..telemetry import TELEMETRY

_span = TELEMETRY.span

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
    h = nn.apply_norm(cfg.norm, lp.get("ln1"), x, plain=plain)
    h, _ = nn.apply_attention(lp["attn"], h, rope_theta=cfg.rope_theta,
                              cache=cache, cache_pos=cache_pos,
                              chunk=cfg.attn_chunk, plain=plain)
    x = x + h
    h = nn.apply_norm(cfg.norm, lp.get("ln2"), x, plain=plain)
    return x + nn.apply_mlp(lp["mlp"], h, plain=plain)


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked (leading 'layers' axis) tree: views, so a
    write into a cache slice lands in the stacked cache."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward when ``remat`` (the
    JAX package's ``jax.checkpoint`` around a scan body)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def check_remat_policy(remat_policy) -> None:
    if remat_policy is not None:
        raise ValueError("remat_policy: a jax.checkpoint policy has no PyTorch "
                         "counterpart; pass None (remat=True recomputes whole layers)")


def _run_layers(cfg: ModelConfig, params: dict, x: torch.Tensor,
                cache: dict | None, cache_pos: int | None,
                plain: bool, remat: bool = False) -> torch.Tensor:
    for i in range(cfg.n_layers):
        lc = None if cache is None else layer_slice(cache["kv"], i)
        with _span("layer", i=i):
            x = remat_call(remat and cache is None, _layer_fwd, cfg,
                           layer_slice(params["layers"], i), x, lc, cache_pos, plain)
    return x


def batch_tokens(batch: dict, device) -> torch.Tensor:
    """``batch["tokens"]`` as an int64 tensor on ``device``."""
    return torch.as_tensor(batch["tokens"], device=device).long()


def embed_tokens(params: dict, batch: dict) -> torch.Tensor:
    """``batch["tokens"]`` (B, S) integers, moved to the params' device,
    through the embedding."""
    tokens = batch_tokens(batch, params["embed"]["table"].device)
    return nn.apply_embedding(params["embed"], tokens)


def _trunk_in(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """A prompt's embeddings: the VLM's ``patch_embeds`` (moved to the
    params' device, in the activations' dtype) before its tokens'."""
    with _span("embed"):
        x = embed_tokens(params, batch)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            pe = torch.as_tensor(batch["patch_embeds"]).to(x.device, x.dtype)
            x = torch.cat([pe, x], dim=1)
    return x


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor,
            plain: bool = False) -> torch.Tensor:
    with _span("head"):
        x = nn.apply_norm(cfg.norm, params.get("ln_f"), x, plain=plain)
        with _span("logits"):
            if cfg.tied_embeddings:
                return torch.einsum("bsd,vd->bsv", x, params["embed"]["table"])
            return nn.apply_lm_head(params["lm_head"], x)


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            plain: bool = False) -> torch.Tensor:
    """Full scoring forward -> logits (B, S, vocab)."""
    x = _run_layers(cfg, params, _trunk_in(cfg, params, batch), None, None, plain)
    return _logits(cfg, params, x, plain)


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache: dict, *,
            plain: bool = False):
    """Populate the KV cache from a full prompt (in place); returns the
    last position's logits (B, 1, vocab) and the cache."""
    x = _run_layers(cfg, params, _trunk_in(cfg, params, batch), cache, 0, plain)
    return _logits(cfg, params, x[:, -1:, :], plain), cache


def decode(cfg: ModelConfig, params: dict, cache: dict, batch: dict, pos: int, *,
           plain: bool = False):
    """One-token decode step at position ``pos`` (the cache is valid up to
    ``pos``, and this step's K/V are written there in place); returns
    logits (B, 1, vocab) and the cache."""
    x = _run_layers(cfg, params, embed_tokens(params, batch), cache, pos, plain)
    return _logits(cfg, params, x, plain), cache


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def loss(cfg: ModelConfig, params: dict, batch: dict, *, remat: bool = False,
         remat_policy=None, plain: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy (float32 scalar) over the text tokens;
    a VLM's patch positions are dropped before the head."""
    check_remat_policy(remat_policy)
    x = _run_layers(cfg, params, _trunk_in(cfg, params, batch), None, None, plain,
                    remat)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = x[:, batch["patch_embeds"].shape[1]:, :]
    return ce_from_hidden(cfg, params, x, batch_tokens(batch, x.device))


def _chunk_ce(xc: torch.Tensor, w: torch.Tensor, tc: torch.Tensor):
    """Summed CE and the count of valid targets (>= 0) of one chunk."""
    logits = torch.einsum("bcd,dv->bcv", xc, w).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, torch.clamp(tc, min=0)[..., None])[..., 0]
    valid = (tc >= 0).float()
    return torch.sum((lse - picked) * valid), torch.sum(valid)


def ce_from_hidden(cfg: ModelConfig, params: dict, x: torch.Tensor,
                   tokens: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
    """Memory-efficient next-token CE: the head product and logsumexp run
    per sequence chunk of ``cfg.ce_chunk``, each recomputed in the backward,
    so the (B, S, vocab) logits never exist at once.  Targets past the end
    are padded with -1 and the mean is over the valid ones, as the JAX
    package's scan does."""
    x = nn.apply_norm(cfg.norm, params.get("ln_f"), x)
    w = (params["embed"]["table"].T if cfg.tied_embeddings
         else params["lm_head"]["w"])
    xs = x[:, :-1, :]
    targets = tokens[:, 1:]
    S = xs.shape[1]
    chunk = min(chunk or cfg.ce_chunk, S)
    pad = (-S) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S + pad, chunk):
        s, n = checkpoint(_chunk_ce, xs[:, c:c + chunk], w, targets[:, c:c + chunk],
                          use_reentrant=False)
        tot = tot + s
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Dense-logits CE (the smoke-scale reference of ``ce_from_hidden``)."""
    lf = logits[:, :-1, :].float()
    targets = torch.as_tensor(tokens, device=lf.device).long()[:, 1:]
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, targets[..., None])[..., 0]
    return torch.mean(lse - picked)
