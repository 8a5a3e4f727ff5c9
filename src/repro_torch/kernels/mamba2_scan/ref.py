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
        # above the diagonal diff > 0 can overflow exp, and a where() after
        # it gives 0 * inf = NaN in the backward: mask to -inf first
        decay = torch.exp(diff.masked_fill(~mask[None, :, :, None], float("-inf")))
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


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, h0: torch.Tensor,
                     dy: torch.Tensor, dhT: torch.Tensor | None = None, *,
                     chunk: int = 16):
    """The gradients of ``ssd_scan_ref``'s (y, hT) by an explicit reverse
    pass: the oracle of the backward kernel.  Shapes as ``ssd_scan_ref``;
    dy: (Bz, L, H, P), dhT: (Bz, H, N, P) or None (zeros).  Returns (dx,
    ddt, dA, dB, dC, dh0), all float32.

    The state before each chunk of ``chunk`` steps is computed forward;
    then the chunks are walked backward, each chunk's states recomputed
    from its first, with dh the gradient into h_t (a_t = exp(A dt_t)):

        dC_t = sum_h dy_t h_t^T          dh += C_t (x) dy_t
        dla_t = a_t <dh, h_{t-1}>        ddt_t = A dla_t + <dh, B_t (x) x_t>
        dA += sum_b dt_t dla_t           dB_t = sum_h dt_t dh x_t
        dx_t = dt_t dh^T B_t             dh *= a_t

    and the last dh is dh0.  B and C are shared by the heads, so dB and dC
    sum over them."""
    Bz, L, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Af, Bf, Cf, dyf = (t.float() for t in (x, dt, A, B, C, dy))
    a = torch.exp(dtf * Af)                                   # (Bz, L, H)
    dev = x.device

    def step(h, t):
        return (a[:, t, :, None, None] * h + dtf[:, t, :, None, None]
                * Bf[:, t, None, :, None] * xf[:, t, :, None, :])
    starts, h = [], h0.float()
    for c0 in range(0, L, chunk):
        starts.append(h)
        for t in range(c0, min(c0 + chunk, L)):
            h = step(h, t)
    dx = torch.zeros((Bz, L, H, P), dtype=torch.float32, device=dev)
    ddt = torch.zeros((Bz, L, H), dtype=torch.float32, device=dev)
    dB = torch.zeros((Bz, L, N), dtype=torch.float32, device=dev)
    dC = torch.zeros((Bz, L, N), dtype=torch.float32, device=dev)
    dA = torch.zeros((H,), dtype=torch.float32, device=dev)
    dh = (torch.zeros((Bz, H, N, P), dtype=torch.float32, device=dev)
          if dhT is None else dhT.float().clone())
    for ci in reversed(range(len(starts))):
        c0 = ci * chunk
        states = [starts[ci]]                   # states[s] = h_{c0 + s - 1}
        for t in range(c0, min(c0 + chunk, L)):
            states.append(step(states[-1], t))
        for t in reversed(range(c0, min(c0 + chunk, L))):
            ht, hp = states[t - c0 + 1], states[t - c0]
            dC[:, t] = torch.einsum("bhnp,bhp->bn", ht, dyf[:, t])
            dh = dh + Cf[:, t, None, :, None] * dyf[:, t, :, None, :]
            dla = a[:, t] * (dh * hp).sum((-2, -1))           # (Bz, H)
            dhx = torch.einsum("bhnp,bhp->bhn", dh, xf[:, t])
            ddt[:, t] = Af * dla + torch.einsum("bhn,bn->bh", dhx, Bf[:, t])
            dA += (dtf[:, t] * dla).sum(0)
            dB[:, t] = torch.einsum("bhn,bh->bn", dhx, dtf[:, t])
            dx[:, t] = dtf[:, t, :, None] * torch.einsum("bhnp,bn->bhp", dh, Bf[:, t])
            dh = dh * a[:, t, :, None, None]
    return dx, ddt, dA, dB, dC, dh
