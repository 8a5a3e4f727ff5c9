"""Plain PyTorch version of the chunked WKV6 scan (RWKV6 "Finch").  The
CPU path of ``ops.wkv6`` and the oracle the kernel is held to on the card.

It follows the model's path (``repro.models.rwkv6.wkv6_chunked``): the
model's (B, L, H, D) layout, and y and the final state in float32.  The
JAX kernel's wrapper instead returns y in r's dtype; the model never runs
that wrapper.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
             chunk: int = 32):
    """r, k, v, logw: (B, L, H, D) (logw the log decay, < 0); u: (H, D)
    bonus; s0: (B, H, D, D) state, key-major (S[i, j], i the key channel).
    Returns y (B, L, H, D) and sT (B, H, D, D), both float32."""
    B, L, H, D = r.shape
    chunk = min(chunk, L)
    pad = (-L) % chunk
    rf, kf, vf, wf = (a.float() for a in (r, k, v, logw))
    if pad:
        # zero k/v and zero log-decay on padded steps leave the state untouched
        rf, kf, vf, wf = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (rf, kf, vf, wf))
    nc = (L + pad) // chunk
    rc, kc, vc, wc = (a.reshape(B, nc, chunk, H, D) for a in (rf, kf, vf, wf))
    uf = u.float()
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    s = s0.float()
    ys = []
    for c in range(nc):
        rk, kk, vk, wk = rc[:, c], kc[:, c], vc[:, c], wc[:, c]   # (B, Lc, H, D)
        cum = torch.cumsum(wk, dim=1)                  # inclusive d_t
        d_prev = cum - wk                              # exclusive d_{t-1}
        # inter-chunk: y_t += (r_t * exp(d_{t-1}))^T S
        y = torch.einsum("blhi,bhij->blhj", rk * torch.exp(d_prev), s)
        # intra-chunk, strictly causal: A[t,s] = sum_i r_t exp(d_{t-1}-d_s) k_s
        diff = d_prev[:, :, None] - cum[:, None]       # (B, Lc, Lc, H, D)
        dec = torch.where(mask[None, :, :, None, None], torch.exp(diff),
                          torch.zeros((), device=r.device))
        A = torch.einsum("bthi,btshi,bshi->btsh", rk, dec, kk)
        y = y + torch.einsum("btsh,bshj->bthj", A, vk)
        # current token bonus
        y = y + torch.einsum("bthi,bthi->bth", rk, uf * kk)[..., None] * vk
        # state: S' = Diag(exp(cum_L)) S + sum_s exp(cum_L - cum_s) k_s v_s^T
        last = cum[:, -1]                              # (B, H, D)
        kdec = kk * torch.exp(last[:, None] - cum)
        s = s * torch.exp(last)[..., None] + torch.einsum("bshi,bshj->bhij", kdec, vk)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :L], s
