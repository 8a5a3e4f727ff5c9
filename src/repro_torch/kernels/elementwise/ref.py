"""Plain PyTorch versions of the forward's elementwise chains.

The eager code of ``nn/layers.py`` as it ran before the one-pass kernels
(``csrc/elementwise.cu``): the CPU path, the path under autograd and
``plain=True``, and the oracle the kernels are held to on the card.  Each
runs in float32 and rounds where the JAX package's ``repro.nn.layers``
rounds.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor | None = None,
                eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, times the float32 ``scale`` where given."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale
    return y.to(x.dtype)


def nonparam_ln_ref(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo-style non-parametric LayerNorm (no scale, no bias)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def rope_ref(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
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


def swiglu_ref(g: torch.Tensor, u: torch.Tensor,
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """The SwiGLU gate: silu of ``g`` in float32, rounded to ``dtype`` (the
    MLP input's; ``g``'s by default), times ``u``."""
    return F.silu(g.float()).to(dtype or g.dtype) * u
