"""Dense-model building blocks, in PyTorch.

The dense subset of ``repro.nn.layers``: norms, embedding, rotary position
embedding, GQA self-attention without a KV cache, the SwiGLU MLP and the
LM head.  Each block is a ``<block>_spec`` giving its parameter spec tree
and an ``apply_<block>`` on tensors.  The casting points are the JAX
package's: norms and the attention math run in float32 and cast back, and
each block returns its input's dtype.

On a CUDA tensor, attention runs the flash-attention kernel
(``kernels.flash_attention``); on a CPU tensor it runs
:func:`chunked_attention`, the same causal online softmax.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import mha
from .spec import tensor

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> dict:
    return {"scale": tensor(d, axes=("embed",), dtype="float32", init="ones")}


def apply_rmsnorm(p: dict | None, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if p is not None:
        y = y * p["scale"]
    return y.to(x.dtype)


def apply_nonparam_ln(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo-style non-parametric LayerNorm (no scale, no bias)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(kind: str, p: dict | None, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return apply_rmsnorm(p, x)
    if kind == "nonparam_ln":
        return apply_nonparam_ln(x)
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


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:  # (S, half) -> broadcast over batch and heads
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:  # (B, S, half)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


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
                      causal: bool, chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks (flash semantics).

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D) with H % KV == 0; q[0] and k[0]
    are both position 0.  Peak activation is O(B * H * Sq * chunk)
    regardless of Skv.  (The JAX version's ``q_offset``/``kv_len`` serve
    only the decode path, which is not ported.)
    """
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KV, G, D).float() * scale
    dev = q.device
    chunk = min(chunk, Skv)
    n_chunks = (Skv + chunk - 1) // chunk
    q_pos = torch.arange(Sq, device=dev)
    NEG = -1e30

    def block(kb, kv_start):
        """One KV block: scores + additive causal bias."""
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb.float())
        if not causal:
            return s
        kv_pos = kv_start + torch.arange(kb.shape[1], device=dev)
        bias = torch.where(kv_pos[None, :] <= q_pos[:, None],
                           torch.zeros((), device=dev), NEG)
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


AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def apply_attention(p: dict, x: torch.Tensor, *, rope_theta: float,
                    chunk: int = 1024, attn: AttentionFn | None = None) -> torch.Tensor:
    """Causal self-attention over the whole sequence (no KV cache).

    ``attn(q, k, v)`` on (B, S, H, D) / (B, S, KV, D) computes the causal
    attention; None runs the flash-attention kernel on a CUDA tensor and
    :func:`chunked_attention` on a CPU one.
    """
    _, S, _ = x.shape
    q, k, v = _qkv(p, x)
    head_dim = q.shape[-1]
    positions = torch.arange(S, device=x.device)
    cos, sin = rope_table(positions, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if attn is not None:
        out = attn(q, k, v)
    elif x.is_cuda:
        out = mha(q, k, v.contiguous(), causal=True)
    else:
        out = chunked_attention(q, k, v, causal=True, chunk=chunk)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_spec(d: int, d_ff: int) -> dict:
    return {
        "wi_gate": tensor(d, d_ff, axes=("embed", "mlp"), init="trunc_fan_in"),
        "wi_up": tensor(d, d_ff, axes=("embed", "mlp"), init="trunc_fan_in"),
        "wo": tensor(d_ff, d, axes=("mlp", "embed"), init="trunc_fan_in"),
    }


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("bsd,df->bsf", x, p["wi_gate"])
    u = torch.einsum("bsd,df->bsf", x, p["wi_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.einsum("bsf,fd->bsd", h, p["wo"])
