"""Plain PyTorch version of decode attention: one query token per sequence
over a KV cache, exact softmax over the valid prefix.  The CPU path of
``ops.gqa_decode`` and the oracle the kernel is held to on the card:
``decode_attention_ref`` in the JAX oracle's (B, KV, G, D) layout,
``gqa_decode_ref`` in the model's (B, 1, H, D) / (B, S, KV, D) one."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """q: (B, KV, G, D); k, v: (B, KV, S, D); kv_len: (B,) -> (B, KV, G, D).

    Positions at or past ``kv_len[b]`` are excluded from the softmax."""
    D = q.shape[-1]
    S = k.shape[2]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k.float()) / math.sqrt(D)
    mask = torch.arange(S, device=q.device)[None, :] < kv_len.to(q.device)[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return o.to(q.dtype)


def gqa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: torch.Tensor) -> torch.Tensor:
    """``decode_attention_ref`` in the model's layout, as ``ops.gqa_decode``
    takes it: q (B, 1, H, D); k, v (B, S, KV, D) -> (B, 1, H, D)."""
    B, _, H, D = q.shape
    KV = k.shape[2]
    out = decode_attention_ref(q[:, 0].reshape(B, KV, H // KV, D), k.transpose(1, 2),
                               v.transpose(1, 2), kv_len)
    return out.reshape(B, 1, H, D)
