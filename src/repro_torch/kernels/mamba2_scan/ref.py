"""Plain PyTorch version of the chunked Mamba2 SSD scan.  The CPU path of
``ops.ssd_scan`` and the oracle the kernel is held to on the card.

It follows the model's path (``repro.models.mamba2.ssd_chunked`` without
its D residual): y and the final state stay float32.  The JAX kernel's
wrapper instead casts y to x's dtype before the residual; the model never
runs that wrapper.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, h0: torch.Tensor, *,
                 chunk: int = 128):
    """x: (Bz, L, H, P); dt: (Bz, L, H); A: (H,) (negative); B, C:
    (Bz, L, N); h0: (Bz, H, N, P).  Returns y (Bz, L, H, P) and hT
    (Bz, H, N, P), both float32."""
    Bsz, L, H, P = x.shape
    N = B.shape[-1]
    chunk = min(chunk, L)
    pad = (-L) % chunk
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    if pad:
        # zero x/B and zero dt on padded steps leave the state untouched
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    nc = (L + pad) // chunk
    xc = xf.reshape(Bsz, nc, chunk, H, P)
    dtc = dtf.reshape(Bsz, nc, chunk, H)
    Bc = Bf.reshape(Bsz, nc, chunk, N)
    Cc = Cf.reshape(Bsz, nc, chunk, N)
    cum = torch.cumsum(dtc * A.float(), dim=2)        # inclusive log decay
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    h = h0.float()
    ys = []
    for c in range(nc):
        xk, dtk, bk, ck, cumk = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c], cum[:, c]
        # intra-chunk: M[t,s] = (C_t . B_s) * exp(cum_t - cum_s) * dt_s, s <= t
        diff = cumk[:, :, None, :] - cumk[:, None, :, :]      # (B, Lc, Lc, H)
        decay = torch.where(mask[None, :, :, None], torch.exp(diff),
                            torch.zeros((), device=x.device))
        cb = torch.einsum("btn,bsn->bts", ck, bk)
        M = cb[..., None] * decay * dtk[:, None, :, :]
        y = torch.einsum("btsh,bshp->bthp", M, xk)
        # inter-chunk: y_t += exp(cum_t) * C_t @ h
        y = y + torch.einsum("btn,bhnp,bth->bthp", ck, h, torch.exp(cumk))
        last = cumk[:, -1:, :]                                 # (B, 1, H)
        w = torch.exp(last - cumk) * dtk                       # (B, Lc, H)
        h = h * torch.exp(last[:, 0, :])[:, :, None, None] + torch.einsum(
            "bsn,bshp,bsh->bhnp", bk, xk, w)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :L]
    return y, h
