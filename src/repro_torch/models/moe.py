"""Mixture-of-Experts decoders.  The JAX package's ``repro.models.moe``, in
PyTorch.

Covers both MoE shapes of the configs:
  * deepseek-moe-16b  -- fine-grained: 1 leading dense layer, then every layer
    MoE with 64 routed experts (top-6) + 2 shared experts.
  * llama4-maverick   -- coarse: MoE every 2nd layer, 128 routed experts
    (top-1) + 1 shared expert.

Dispatch is the JAX package's capacity-based scatter/gather: tokens are
flattened, ranked into their expert's capacity slots by a cumulative sum
over the top-k assignment (token-major order; assignments past the
capacity are dropped), scattered into an (E, C, d) buffer, run through a
batched expert FFN and gathered back with the router's weights.  The
routing is one function, :func:`route`, which :func:`apply_moe_mlp` looks
up at each call (so a caller can record or replay it).  Attention goes
through ``nn.apply_attention``: the flash kernel on prefill and forward,
the decode kernel on each step.  Storage keeps the stacked axes (``groups``
of one MoE layer and ``moe_every - 1`` dense layers, ``first_dense``),
looped over where the JAX package scans; prefill and decode write the
caches in place.  ``loss`` is the dense family's chunked next-token CE
over the final hidden states; ``remat=True`` recomputes each group (its
dense layers and its MoE layer) in the backward, as the JAX package
checkpoints its group scan's body.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..nn import layers as nn
from .transformer import (_logits, _trunk_in, batch_tokens, ce_from_hidden,
                          check_remat_policy, embed_tokens, layer_slice, remat_call,
                          stack_specs)

# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def moe_mlp_spec(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert or cfg.d_ff
    s = {
        "router": nn.tensor(d, e, axes=("embed", "expert"), dtype="float32",
                            init="trunc_fan_in"),
        "wi_gate": nn.tensor(e, d, f, axes=("expert", "embed", None),
                             init="trunc_fan_in"),
        "wi_up": nn.tensor(e, d, f, axes=("expert", "embed", None),
                           init="trunc_fan_in"),
        "wo": nn.tensor(e, f, d, axes=("expert", None, "embed"),
                        init="trunc_fan_in"),
    }
    if cfg.n_shared_experts:
        s["shared"] = nn.mlp_spec(d, cfg.n_shared_experts * (cfg.d_ff_expert or cfg.d_ff))
    return s


def dense_layer_spec(cfg: ModelConfig, d_ff: int) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "attn": nn.attention_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd,
                                  cfg.qkv_bias),
        "mlp": nn.mlp_spec(cfg.d_model, d_ff),
        "ln1": nn.rmsnorm_spec(cfg.d_model),
        "ln2": nn.rmsnorm_spec(cfg.d_model),
    }


def moe_layer_spec(cfg: ModelConfig) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "attn": nn.attention_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd,
                                  cfg.qkv_bias),
        "moe": moe_mlp_spec(cfg),
        "ln1": nn.rmsnorm_spec(cfg.d_model),
        "ln2": nn.rmsnorm_spec(cfg.d_model),
    }


def _group_spec(cfg: ModelConfig) -> dict:
    """One stacked group: (moe_every - 1) dense layers + 1 MoE layer."""
    g = {"moe_layer": moe_layer_spec(cfg)}
    if cfg.moe_every > 1:
        g["dense_layers"] = stack_specs(
            dense_layer_spec(cfg, cfg.d_ff_dense or cfg.d_ff), cfg.moe_every - 1)
    return g


def n_groups(cfg: ModelConfig) -> int:
    rest = cfg.n_layers - cfg.first_dense
    if rest % cfg.moe_every:
        raise ValueError(f"{cfg.name}: {rest} layers after the first dense ones "
                         f"are not a multiple of moe_every {cfg.moe_every}")
    return rest // cfg.moe_every


def param_specs(cfg: ModelConfig) -> dict:
    s = {
        "embed": nn.embedding_spec(cfg.vocab, cfg.d_model),
        "groups": stack_specs(_group_spec(cfg), n_groups(cfg)),
        "ln_f": nn.rmsnorm_spec(cfg.d_model),
        "lm_head": nn.lm_head_spec(cfg.d_model, cfg.vocab),
    }
    if cfg.first_dense:
        s["first_dense"] = stack_specs(
            dense_layer_spec(cfg, cfg.d_ff_dense or cfg.d_ff), cfg.first_dense)
    return s


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    hd = cfg.resolved_head_dim

    def kv():
        return nn.attention_cache_spec(batch, max_len, cfg.n_kv_heads, hd,
                                       nn.kv_cache_dtype(cfg))
    s = {"group_moe": stack_specs(kv(), n_groups(cfg))}
    if cfg.moe_every > 1:
        s["group_dense"] = stack_specs(stack_specs(kv(), cfg.moe_every - 1), n_groups(cfg))
    if cfg.first_dense:
        s["first_dense"] = stack_specs(kv(), cfg.first_dense)
    return s


# ---------------------------------------------------------------------------
# Routing, dispatch and combine
# ---------------------------------------------------------------------------


def router_probs(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Softmax over the experts of the float32 router logits, (..., E)."""
    logits = torch.einsum("...d,de->...e", x.float(), p["router"])
    return torch.softmax(logits, dim=-1)


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of ``scores`` along the last axis, largest first,
    and their indices: ``lax.top_k``, which puts the lower index first among
    equal values.  ``torch.topk`` promises no order for ties; a stable
    descending sort keeps equal values in index order."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gates_at(probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The router probabilities at the chosen experts, renormalised."""
    gate = torch.gather(probs, -1, idx)
    return gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)


def route(p: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (gates (B, S, k) float32, expert ids (B, S, k)): top-k
    over the router's probabilities, the gates renormalised."""
    probs = router_probs(p, x)
    _, idx = top_k(probs, cfg.top_k)
    return gates_at(probs, idx), idx


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for a call over ``n_tokens`` tokens."""
    return max(int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts), 4)


def slot_ranks(flat_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each assignment's rank among the earlier assignments to its expert
    (token-major order): the cumulative sum over the one-hot assignment,
    held expert-major so that the sum runs along contiguous memory."""
    experts = torch.arange(n_experts, device=flat_idx.device)
    assign = (flat_idx[None, :] == experts[:, None]).long()     # (E, T*k)
    pos = torch.cumsum(assign, dim=1) - assign
    return torch.sum(pos * assign, dim=0)


def apply_moe_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  plain: bool = False) -> torch.Tensor:
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)

    gate, idx = route(p, x, cfg)
    C = capacity(cfg, T)
    flat_idx = idx.reshape(T * k)
    pos = slot_ranks(flat_idx, E)
    keep = pos < C

    token_of = torch.arange(T, device=x.device).repeat_interleave(k)
    safe_pos = torch.where(keep, pos, C - 1)
    buf = torch.zeros((E, C, d), dtype=x.dtype, device=x.device)
    # a kept assignment owns its slot; a dropped one adds zeros to the last
    buf.index_put_((flat_idx, safe_pos), torch.where(keep[:, None], xt[token_of], 0),
                   accumulate=True)

    g = torch.bmm(buf, p["wi_gate"])
    u = torch.bmm(buf, p["wi_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    out_buf = torch.bmm(h, p["wo"])                          # (E, C, d)

    gathered = out_buf[flat_idx, safe_pos]                   # (T*k, d)
    w = (gate.reshape(T * k) * keep).float()
    # the JAX package's float32 scatter-add over each token's k assignments,
    # which lie next to each other (token-major)
    y = (gathered.float() * w[:, None]).reshape(T, k, d).sum(dim=1)
    y = y.to(x.dtype).reshape(B, S, d)

    if "shared" in p:
        y = y + nn.apply_mlp(p["shared"], x, plain=plain)
    return y


def routed_experts(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Per-token routed expert ids, top-k over the router's *logits* (the
    fault schedule's routing, kept apart from :func:`route` as in the JAX
    package: a float32 softmax can round two distinct logits to one
    probability)."""
    logits = torch.einsum("...d,de->...e", x.float(), p["router"])
    return top_k(logits, cfg.top_k)[1]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _dense_fwd(cfg, lp, x, cache=None, pos=None, plain=False):
    h = nn.apply_rmsnorm(lp["ln1"], x, plain=plain)
    h, _ = nn.apply_attention(lp["attn"], h, rope_theta=cfg.rope_theta,
                              cache=cache, cache_pos=pos, chunk=cfg.attn_chunk,
                              plain=plain)
    x = x + h
    return x + nn.apply_mlp(lp["mlp"], nn.apply_rmsnorm(lp["ln2"], x, plain=plain),
                            plain=plain)


def _moe_attn(cfg, lp, x, cache=None, pos=None, plain=False):
    """An MoE layer up to its MLP: the attention sub-block, and the normed
    activations the router and the experts read."""
    h = nn.apply_rmsnorm(lp["ln1"], x, plain=plain)
    h, _ = nn.apply_attention(lp["attn"], h, rope_theta=cfg.rope_theta,
                              cache=cache, cache_pos=pos, chunk=cfg.attn_chunk,
                              plain=plain)
    x = x + h
    return x, nn.apply_rmsnorm(lp["ln2"], x, plain=plain)


def _moe_fwd(cfg, lp, x, cache=None, pos=None, plain=False):
    x, h2 = _moe_attn(cfg, lp, x, cache, pos, plain)
    return x + apply_moe_mlp(lp["moe"], h2, cfg, plain=plain)


def _group_fwd(cfg, gp, x, gcache=None, pos=None, plain=False):
    if "dense_layers" in gp:
        for j in range(cfg.moe_every - 1):
            lc = None if gcache is None else layer_slice(gcache["dense"], j)
            x = _dense_fwd(cfg, layer_slice(gp["dense_layers"], j), x, lc, pos, plain)
    return _moe_fwd(cfg, gp["moe_layer"], x,
                    None if gcache is None else gcache["moe"], pos, plain)


def _run(cfg: ModelConfig, params: dict, x: torch.Tensor, cache: dict | None,
         pos: int | None, plain: bool, remat: bool = False) -> torch.Tensor:
    for i in range(cfg.first_dense):
        lc = None if cache is None else layer_slice(cache["first_dense"], i)
        x = _dense_fwd(cfg, layer_slice(params["first_dense"], i), x, lc, pos, plain)
    for g in range(n_groups(cfg)):
        gc = None
        if cache is not None:
            gc = {"moe": layer_slice(cache["group_moe"], g)}
            if "group_dense" in cache:
                gc["dense"] = layer_slice(cache["group_dense"], g)
        x = remat_call(remat and cache is None, _group_fwd, cfg,
                       layer_slice(params["groups"], g), x, gc, pos, plain)
    return x


def forward(cfg, params, batch, *, plain: bool = False) -> torch.Tensor:
    x = _run(cfg, params, _trunk_in(cfg, params, batch), None, None, plain)
    return _logits(cfg, params, x, plain)


def prefill(cfg, params, batch, cache, *, plain: bool = False):
    x = _run(cfg, params, _trunk_in(cfg, params, batch), cache, 0, plain)
    return _logits(cfg, params, x[:, -1:, :], plain), cache


def decode(cfg, params, cache, batch, pos, *, plain: bool = False):
    x = _run(cfg, params, embed_tokens(params, batch), cache, pos, plain)
    return _logits(cfg, params, x, plain), cache


def loss(cfg, params, batch, *, remat: bool = False, remat_policy=None,
         plain: bool = False) -> torch.Tensor:
    check_remat_policy(remat_policy)
    x = _run(cfg, params, _trunk_in(cfg, params, batch), None, None, plain, remat)
    return ce_from_hidden(cfg, params, x, batch_tokens(batch, x.device))
