"""Plain PyTorch version of flash attention: exact softmax attention with
GQA.  The CPU path of ``ops.mha`` and the oracle the kernel is held to on
the card: ``flash_attention_ref`` in the JAX oracle's (B, H, S, D) layout,
``mha_ref`` in the model's (B, S, H, D) one.  ``mha_lse_ref`` and
``flash_attention_bwd_ref`` are the backward's oracle: the row
log-sum-exps the forward kernel leaves for it, and the gradients by their
explicit formulas (autograd of ``mha_ref`` computes the same)."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KV, Skv, D)."""
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Sq, D) / math.sqrt(D)
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf)
    if causal:
        mask = torch.tril(torch.ones((Sq, Skv), dtype=torch.bool, device=q.device),
                          Skv - Sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, vf)
    return o.reshape(B, H, Sq, D).to(q.dtype)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True) -> torch.Tensor:
    """``flash_attention_ref`` in the model's layout, as ``ops.mha`` takes
    it: q (B, S, H, D); k, v (B, S, KV, D) -> (B, S, H, D) contiguous."""
    out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2).contiguous()


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled float32 scores (B, KV, G, S, S) of the model's layout, the
    masked ones -inf."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, S, KV, H // KV, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / math.sqrt(D)
    if causal:
        keep = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
        s = s.masked_fill(~keep, float("-inf"))
    return s


def mha_lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """The natural log of each query row's softmax denominator, over the
    scaled scores: (B, H, S) float32, as the forward kernel writes it."""
    B, S, H, _ = q.shape
    return torch.logsumexp(_scores(q, k, causal), dim=-1).reshape(B, H, S)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True):
    """dq, dk, dv (float32, the shapes of q, k, v) of ``mha`` from its
    output ``o``, the row log-sum-exps ``lse`` (B, H, S) and the output's
    gradient ``do``, by the explicit formulas: ``delta = rowsum(dO * O)``,
    ``P = exp(S - lse)``, ``dV = P^T dO``, ``dS = P * (dP - delta)`` with
    ``dP = dO V^T``, ``dQ = dS K * scale``, ``dK = dS^T Q * scale``; dK and
    dV summed over the G query heads of each KV head."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    p = torch.exp(_scores(q, k, causal) - lse.reshape(B, KV, G, S, 1))
    dof = do.float().reshape(B, S, KV, G, D)
    delta = torch.sum(dof * o.float().reshape(B, S, KV, G, D), dim=-1)   # (B, S, KV, G)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().reshape(B, S, KV, G, D)) * scale
    return dq.reshape(B, S, H, D), dk, dv
