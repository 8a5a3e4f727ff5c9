"""Plain PyTorch version of flash attention: exact softmax attention with
GQA.  The CPU path of ``ops.mha`` and the oracle the kernel is held to on
the card."""
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
