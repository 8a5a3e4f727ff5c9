"""Plain float32 building blocks of the references, and the control's
precision.

Nothing here imports the program. ``precision="f32"`` multiplies in
float32 with TF32 off (:func:`exact_float32`); ``precision="fp8"`` is the
control: every matrix product's operands rounded to float8 e4m3, the
weights with one scale a matrix and the activations with one a row, and
accumulated in float32 -- the step below the bfloat16 the configurations
state.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Matrix products in float32 proper: TF32 off while the block runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(x: torch.Tensor, per_row: bool) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a scale that maps its largest
    magnitude (of each row, or of the whole tensor) to e4m3's largest."""
    amax = x.abs().amax(dim=-1, keepdim=True) if per_row else x.abs().amax()
    scale = torch.clamp(amax, min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def weight(w: torch.Tensor, precision: str) -> torch.Tensor:
    """A weight as the forward multiplies it."""
    return fp8_round(w, per_row=False) if precision == "fp8" else w


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., k) @ w (k, ...) with w's trailing dims flattened."""
    w2 = weight(w.reshape(w.shape[0], -1), precision)
    if precision == "fp8":
        x = fp8_round(x, per_row=True)
    return (x @ w2).reshape(*x.shape[:-1], *w.shape[1:])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm without scale or bias (OLMo's non-parametric one)."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (S, H, D) at positions 0..S-1, the halves of
    each head rotated as pairs (i, i + D/2)."""
    S, _, D = x.shape
    half = D // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention of q (S, H, D) over k, v (S, KV, D), causal."""
    S, H, D = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(D)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


def attention_block(p: dict, x: torch.Tensor, theta: float, precision: str) -> torch.Tensor:
    """Self-attention of one sequence x (S, d): q, k, v projections,
    rotary embedding, causal softmax, output projection."""
    q = rope(mm(x, p["wq"], precision), theta)
    k = rope(mm(x, p["wk"], precision), theta)
    v = mm(x, p["wv"], precision)
    a = causal_attention(q, k, v)
    return mm(a.reshape(x.shape[0], -1), p["wo"].reshape(-1, p["wo"].shape[-1]), precision)


def swiglu(p: dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    h = F.silu(mm(x, p["wi_gate"], precision)) * mm(x, p["wi_up"], precision)
    return mm(h, p["wo"], precision)


def sub(params: dict, prefix: str, *index: int) -> dict:
    """The leaves under ``prefix/`` (slash-separated paths), indexed along
    their stacked leading axes."""
    out = {}
    for path, t in params.items():
        if path.startswith(prefix + "/"):
            for i in index:
                t = t[i]
            out[path[len(prefix) + 1:]] = t
    return out
