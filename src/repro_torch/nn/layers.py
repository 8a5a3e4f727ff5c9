"""Model building blocks, in PyTorch.

The subset of ``repro.nn.layers`` that the port's families use: norms,
embedding, rotary position embedding, GQA self-attention with an optional
KV cache (bfloat16 or int8), bidirectional and cross attention (the
encoder-decoder's), the SwiGLU MLP and the LM head.
Each block is a ``<block>_spec`` giving its parameter spec tree and an
``apply_<block>`` on tensors.  The casting points are the JAX package's:
norms and the attention math run in float32 and cast back, and each block
returns its input's dtype.

Attention over a whole sequence (a forward, or a prefill) runs the
flash-attention kernel on a CUDA tensor and :func:`chunked_attention` on a
CPU one.  A decode step (one token over the cache) runs the
decode-attention kernel on a CUDA tensor and :func:`chunked_attention`
with a single chunk on a CPU one.  An encoder's bidirectional attention
runs the flash kernel without its causal mask; a decode step's
cross-attention over a cache with a valid length runs the decode kernel.
The norms, RoPE (q and k in one launch) and the SwiGLU gate run the
one-pass kernels of :mod:`repro_torch.kernels.elementwise` on CUDA tensors
where no autograd graph is built (serving, prefill and decode), and their
plain versions, the eager float32 chains, on the CPU and in training.
``plain=True`` runs the kernels' plain versions instead, on either device:
that is how a run on the card is held to the plain versions.

Where a thread has a trace current (span recording on, see
:mod:`repro_torch.telemetry`), the norms, the attention's ``qkv``,
``rope``, ``attention`` and ``attn_out`` and the MLP's ``mlp_in``, ``act``
and ``mlp_out`` each open a span, so a device trace's kernels can be
charged to the op that launched them; otherwise each is a shared no-op.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..kernels.decode_attention import gqa_decode, gqa_decode_ref
from ..kernels.elementwise import (nonparam_ln, nonparam_ln_ref, rmsnorm, rmsnorm_ref,
                                   rope_qk, rope_ref, swiglu, swiglu_ref)
from ..kernels.flash_attention import mha, mha_ref
from ..telemetry import TELEMETRY
from .spec import tensor

_span = TELEMETRY.span

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> dict:
    return {"scale": tensor(d, axes=("embed",), dtype="float32", init="ones")}


def _fused(plain: bool, *tensors: torch.Tensor | None) -> bool:
    """Whether the one-pass kernels of ``kernels.elementwise`` take these
    inputs: CUDA tensors outside ``plain``, with no autograd graph to build
    (the kernels have no backward, so training runs the plain chains)."""
    return (not plain and tensors[0].is_cuda
            and not (torch.is_grad_enabled()
                     and any(t is not None and t.requires_grad for t in tensors)))


def apply_rmsnorm(p: dict | None, x: torch.Tensor, eps: float = 1e-6, *,
                  plain: bool = False) -> torch.Tensor:
    scale = None if p is None else p["scale"]
    if _fused(plain, x, scale):
        return rmsnorm(x, scale, eps)
    return rmsnorm_ref(x, scale, eps)


def apply_nonparam_ln(x: torch.Tensor, eps: float = 1e-5, *,
                      plain: bool = False) -> torch.Tensor:
    """OLMo-style non-parametric LayerNorm (no scale, no bias)."""
    if _fused(plain, x):
        return nonparam_ln(x, eps)
    return nonparam_ln_ref(x, eps)


def apply_norm(kind: str, p: dict | None, x: torch.Tensor, *,
               plain: bool = False) -> torch.Tensor:
    with _span("norm"):
        if kind == "rmsnorm":
            return apply_rmsnorm(p, x, plain=plain)
        if kind == "nonparam_ln":
            return apply_nonparam_ln(x, plain=plain)
    raise ValueError(f"unknown norm {kind}")


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embedding_spec(vocab: int, d: int) -> dict:
    return {"table": tensor(vocab, d, axes=("vocab", "embed"), init="embed")}


def apply_embedding(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def lm_head_spec(d: int, vocab: int) -> dict:
    return {"w": tensor(d, vocab, axes=("embed", "vocab"), init="trunc_fan_in")}


def apply_lm_head(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...d,dv->...v", x, p["w"])


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_table(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """positions: (...,) int -> (cos, sin) of shape (..., head_dim//2)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, *, plain: bool = False) -> tuple:
    """q: (B, S, H, D), k: (B, S, KV, D); cos/sin: (S, D/2) or (B, S, D/2).
    Returns the rotated (q, k): one kernel launch for both, or the plain
    version on each."""
    if _fused(plain, q, k):
        return rope_qk(q, k, cos, sin)
    return rope_ref(q, cos, sin), rope_ref(k, cos, sin)


# ---------------------------------------------------------------------------
# Attention (GQA, causal online softmax)
# ---------------------------------------------------------------------------


def attention_spec(d: int, n_heads: int, n_kv: int, head_dim: int,
                   qkv_bias: bool = False) -> dict:
    s = {
        "wq": tensor(d, n_heads, head_dim, axes=("embed", "heads", "head_dim"),
                     init="trunc_fan_in"),
        "wk": tensor(d, n_kv, head_dim, axes=("embed", "kv_heads", "head_dim"),
                     init="trunc_fan_in"),
        "wv": tensor(d, n_kv, head_dim, axes=("embed", "kv_heads", "head_dim"),
                     init="trunc_fan_in"),
        "wo": tensor(n_heads, head_dim, d, axes=("heads", "head_dim", "embed"),
                     init="trunc_fan_in"),
    }
    if qkv_bias:
        s["bq"] = tensor(n_heads, head_dim, axes=("heads", "head_dim"), init="zeros")
        s["bk"] = tensor(n_kv, head_dim, axes=("kv_heads", "head_dim"), init="zeros")
        s["bv"] = tensor(n_kv, head_dim, axes=("kv_heads", "head_dim"), init="zeros")
    return s


def _qkv(p: dict, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0, kv_len: int | None = None,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks (flash semantics).

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D) with H % KV == 0.
    ``q_offset`` -- absolute position of q[0] (for causal masking in decode).
    ``kv_len``   -- valid prefix length of the KV cache (None = all valid).
    Peak activation is O(B * H * Sq * chunk) regardless of Skv.
    """
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KV, G, D).float() * scale
    dev = q.device
    chunk = min(chunk, Skv)
    n_chunks = (Skv + chunk - 1) // chunk
    q_pos = q_offset + torch.arange(Sq, device=dev)
    limit = Skv if kv_len is None else kv_len
    NEG = -1e30

    def block(kb, kv_start):
        """One KV block: scores + additive bias (validity, then causality)."""
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb.float())
        kv_pos = kv_start + torch.arange(kb.shape[1], device=dev)
        zero = torch.zeros((), device=dev)
        bias = torch.where(kv_pos[None, :] < limit, zero, NEG)
        if causal:
            bias = bias + torch.where(kv_pos[None, :] <= q_pos[:, None], zero, NEG)
        return s + bias[None, :, None, None, :]

    if n_chunks == 1:
        s = block(k, 0)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - m)
        out = torch.einsum("bqkgc,bckd->bqkgd", p, v.float())
        out = out / torch.clamp(torch.sum(p, dim=-1)[..., None], min=1e-20)
        return out.reshape(B, Sq, H, D).to(q.dtype)

    m = torch.full((B, Sq, KV, G), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, D), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, Skv)
        kb, vb = k[:, lo:hi], v[:, lo:hi]
        s = block(kb, lo)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # fully-masked rows: m_new is very negative; exp underflows to 0
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-20)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    chunk: int, plain: bool, causal: bool = True) -> torch.Tensor:
    """Attention of a sequence over itself, (B, S, H, D) layout: causal, or
    bidirectional (an encoder's)."""
    if plain:
        return mha_ref(q, k, v, causal=causal)
    if q.is_cuda:
        return mha(q, k, v.contiguous(), causal=causal)
    return chunked_attention(q, k, v, causal=causal, chunk=chunk)


def _decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      pos: int, *, plain: bool) -> torch.Tensor:
    """One query token at position ``pos`` over the cache prefix
    ``[0, pos]``: q (B, 1, H, D), ck/cv (B, max_len, KV, D)."""
    if not (plain or q.is_cuda):
        return chunked_attention(q, ck, cv, causal=True, q_offset=pos,
                                 kv_len=pos + 1, chunk=ck.shape[1])
    kv_len = torch.full((q.shape[0],), pos + 1, dtype=torch.int32, device=q.device)
    return (gqa_decode_ref if plain else gqa_decode)(q, ck, cv, kv_len)


def apply_attention(p: dict, x: torch.Tensor, *, rope_theta: float,
                    cache: dict | None = None, cache_pos: int | None = None,
                    chunk: int = 1024, plain: bool = False):
    """Self-attention.  Returns ``(out, cache)``; ``cache`` is None without
    one.

    With a ``cache`` (per-layer ``k``/``v`` of (B, max_len, KV, D), plus
    ``k_scale``/``v_scale`` of (B, max_len, KV) for an int8 cache), the new
    K/V are written into it at ``cache_pos`` *in place* -- where the JAX
    package returns a new array from ``dynamic_update_slice`` -- and the
    same dict is returned.  A prefill (S > 1, from position 0) attends over
    the fresh K/V; a decode step (S == 1) attends over the cache prefix
    ``[0, cache_pos]``.  An int8 cache is dequantized to a bfloat16
    transient first.  ``plain`` runs the kernels' plain versions.
    """
    _, S, _ = x.shape
    with _span("qkv"):
        q, k, v = _qkv(p, x)
    head_dim = q.shape[-1]
    base = 0 if cache is None else cache_pos
    with _span("rope"):
        positions = base + torch.arange(S, device=x.device)
        cos, sin = rope_table(positions, head_dim, rope_theta)
        q, k = apply_rope(q, k, cos, sin, plain=plain)
    with _span("attention"):
        out = _cached_attention(q, k, v, cache, cache_pos, chunk=chunk,
                                plain=plain)
    with _span("attn_out"):
        y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache


def _cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cache: dict | None, cache_pos: int | None, *, chunk: int,
                      plain: bool) -> torch.Tensor:
    """:func:`apply_attention`'s attention after RoPE: over the fresh K/V
    without a cache; with one, the K/V written into it first."""
    S = q.shape[1]
    if cache is None:
        return _self_attention(q, k, v, chunk=chunk, plain=plain)
    rows = slice(cache_pos, cache_pos + S)
    if "k_scale" in cache:
        for name, t in (("k", k), ("v", v)):
            tq, ts = _quant_kv(t)
            cache[name][:, rows] = tq
            cache[name + "_scale"][:, rows] = ts
        # dequantized views are per-layer transients
        ck = cache["k"].to(torch.bfloat16) * cache["k_scale"][..., None].to(torch.bfloat16)
        cv = cache["v"].to(torch.bfloat16) * cache["v_scale"][..., None].to(torch.bfloat16)
    else:
        cache["k"][:, rows] = k.to(cache["k"].dtype)
        cache["v"][:, rows] = v.to(cache["v"].dtype)
        ck, cv = cache["k"], cache["v"]
    if S == 1:
        return _decode_attention(q, ck, cv, cache_pos, plain=plain)
    # prefill from position 0: attending over the fresh K/V is the
    # same as attending over the cache prefix
    return _self_attention(q, k, v, chunk=chunk, plain=plain)


def apply_bidirectional_attention(p: dict, x: torch.Tensor, *, rope_theta: float,
                                  chunk: int = 1024, plain: bool = False) -> torch.Tensor:
    """Self-attention without a causal mask (an encoder layer's), RoPE at
    positions ``0 .. S-1``."""
    q, k, v = _qkv(p, x)
    cos, sin = rope_table(torch.arange(x.shape[1], device=x.device), q.shape[-1],
                          rope_theta)
    q, k = apply_rope(q, k, cos, sin, plain=plain)
    out = _self_attention(q, k, v, chunk=chunk, plain=plain, causal=False)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Any = None, *, chunk: int = 1024,
                    plain: bool = False) -> torch.Tensor:
    """Attention of q (B, Sq, H, D) over another sequence's k, v (B, Skv,
    KV, D), without a causal mask: a decoder over its encoder's frames.

    ``kv_len`` is the valid prefix of k/v: None (all of it), an int, or a
    (B,) int32 tensor (a cross cache's valid length per sequence).  One
    query token over such a cache runs the decode-attention kernel on a
    CUDA tensor (the kernel's own semantics: validity per row, no
    causality); a CPU tensor, and a prompt on either device (no kernel
    takes Sq != Skv), run :func:`chunked_attention` with one valid length,
    the first row's, as the JAX package reads it."""
    if q.shape[1] == 1 and torch.is_tensor(kv_len) and (plain or q.is_cuda):
        return (gqa_decode_ref if plain else gqa_decode)(q, k, v, kv_len)
    if torch.is_tensor(kv_len):
        kv_len = kv_len[0]
    return chunked_attention(q, k, v, causal=False, kv_len=kv_len, chunk=chunk)


def attention_cache_spec(batch: int, max_len: int, n_kv: int, head_dim: int,
                         dtype: str = "bfloat16") -> dict:
    s = {
        "k": tensor(batch, max_len, n_kv, head_dim,
                    axes=("batch", "seq", None, "head_dim"),
                    dtype=dtype, init="zeros"),
        "v": tensor(batch, max_len, n_kv, head_dim,
                    axes=("batch", "seq", None, "head_dim"),
                    dtype=dtype, init="zeros"),
    }
    if dtype == "int8":
        # per (token, kv-head) quantization scales: an int8 KV cache halves
        # the decode working set against bfloat16
        for n in ("k_scale", "v_scale"):
            s[n] = tensor(batch, max_len, n_kv, axes=("batch", "seq", None),
                          dtype="float32", init="zeros")
    return s


def _quant_kv(x: torch.Tensor):
    """(B, S, KV, D) -> int8 values + per-(token, head) float32 scales.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp(torch.amax(torch.abs(xf), dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def kv_cache_dtype(cfg: Any) -> str:
    return getattr(cfg, "kv_cache_dtype", "bfloat16")


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_spec(d: int, d_ff: int) -> dict:
    return {
        "wi_gate": tensor(d, d_ff, axes=("embed", "mlp"), init="trunc_fan_in"),
        "wi_up": tensor(d, d_ff, axes=("embed", "mlp"), init="trunc_fan_in"),
        "wo": tensor(d_ff, d, axes=("mlp", "embed"), init="trunc_fan_in"),
    }


def apply_mlp(p: dict, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    with _span("mlp_in"):
        g = torch.einsum("bsd,df->bsf", x, p["wi_gate"])
        u = torch.einsum("bsd,df->bsf", x, p["wi_up"])
    with _span("act"):
        h = swiglu(g, u) if _fused(plain, g, u) else swiglu_ref(g, u, x.dtype)
    with _span("mlp_out"):
        return torch.einsum("bsf,fd->bsd", h, p["wo"])
