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


def ssd_chunked_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, h0: torch.Tensor,
                        dy: torch.Tensor, dhT: torch.Tensor | None = None, *,
                        chunk: int = 32):
    """The gradients of ``ssd_scan_ref``'s (y, hT) by the chunk-parallel
    decomposition the backward kernel runs: the CPU mirror of its
    arithmetic.  Shapes and results as ``ssd_scan_bwd_ref``.

    (a) the state h_c before each chunk, walked forward over the chunks;
    (b) dh_c, the gradient into the state after each chunk, walked
    backward: dh_in = exp(cum_last) dh_out + C^T diag(exp cum) dy;
    (c) each chunk's gradients from (h_in, dh_out) alone, with
    Lmat[t,s] = exp(cum_t - cum_s) (s <= t), G = C B^T, M = G o Lmat o
    dt_s and w_s = exp(cum_last - cum_s) dt_s:

        dx = M^T dy + (B o w) dh_out
        dM = (dy x^T) o mask,  dG = dM o Lmat o dt_s
        dC = dG B + diag(exp cum) dy h_in^T     (summed over heads)
        dB = dG^T C + diag(w) x dh_out^T        (summed over heads)
        ddt_tau = A S_tau + sum_t (dM o G o Lmat)[t,tau]
                  + exp(cum_last - cum_tau) <B_tau, dh_out x_tau>
        dA = sum dt_tau S_tau

    where S_tau, the gradient into cum_tau's suffix, is taken as a sum of
    its terms over a rectangle, never as a difference of two suffix sums
    that cancel: with E = dM o M, F_t = exp(cum_t) dy_t . (C_t h_in) and
    K_s = w_s <B_s, dh_out x_s>,

        S_tau = sum_{t >= tau > s} E[t,s] + sum_{t >= tau} F_t
                + exp(cum_last) <dh_out, h_in> + sum_{s < tau} K_s.

    Only exp(cum_t - cum_s) for s <= t, exp(cum_t) and exp(cum_last -
    cum_s) appear: no exponent is positive (masked to -inf before exp)."""
    Bz, L, H, P = x.shape
    N = B.shape[-1]
    T = chunk
    pad = (-L) % T
    xf, dtf, Bf, Cf, dyf = (t.float() for t in (x, dt, B, C, dy))
    if pad:
        # zero steps leave the state as it was and take no gradient
        xf, dyf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, dyf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf, Cf = (F.pad(t, (0, 0, 0, pad)) for t in (Bf, Cf))
    nc = (L + pad) // T
    xc = xf.reshape(Bz, nc, T, H, P).permute(0, 3, 1, 2, 4)    # (Bz, H, nc, T, P)
    dyc = dyf.reshape(Bz, nc, T, H, P).permute(0, 3, 1, 2, 4)
    dtc = dtf.reshape(Bz, nc, T, H).permute(0, 3, 1, 2)          # (Bz, H, nc, T)
    Bc = Bf.reshape(Bz, 1, nc, T, N)
    Cc = Cf.reshape(Bz, 1, nc, T, N)
    cum = torch.cumsum(dtc * A.float()[None, :, None, None], dim=-1)
    last = cum[..., -1:]
    e = torch.exp(cum)                                           # exp(cum_t)
    r = torch.exp(last - cum)                                    # exp(cum_last - cum_s)
    w = r * dtc
    decay = torch.exp(last[..., 0])                              # (Bz, H, nc)
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    Lmat = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~mask, float("-inf")))

    # (a) chunk-start states; (b) the gradient after each chunk
    local = torch.einsum("zhcsn,zhcsp,zhcs->zhcnp", Bc.expand(-1, H, -1, -1, -1), xc, w)
    h_in, h = [], h0.float()
    for c in range(nc):
        h_in.append(h)
        h = decay[:, :, c, None, None] * h + local[:, :, c]
    h_in = torch.stack(h_in, dim=2)                              # (Bz, H, nc, N, P)
    inject = torch.einsum("zhctn,zhctp,zhct->zhcnp", Cc.expand(-1, H, -1, -1, -1), dyc, e)
    dh_out = [None] * nc
    g = (torch.zeros((Bz, H, N, P), dtype=torch.float32, device=x.device)
         if dhT is None else dhT.float())
    for c in reversed(range(nc)):
        dh_out[c] = g
        g = decay[:, :, c, None, None] * g + inject[:, :, c]
    dh_out = torch.stack(dh_out, dim=2)

    # (c) every chunk's gradients at once
    G = torch.einsum("zhctn,zhcsn->zhcts", Cc, Bc)               # (Bz, 1, nc, T, T)
    M = G * Lmat * dtc[..., None, :]
    dM = torch.einsum("zhctp,zhcsp->zhcts", dyc, xc) * mask
    dG = dM * Lmat * dtc[..., None, :]
    dx = (torch.einsum("zhcts,zhctp->zhcsp", M, dyc)
          + torch.einsum("zhcsn,zhcnp,zhcs->zhcsp", Bc, dh_out, w))
    Y = torch.einsum("zhctp,zhcnp->zhctn", dyc, h_in)             # dy h_in^T
    Z = torch.einsum("zhcsp,zhcnp->zhcsn", xc, dh_out)            # x dh_out^T
    dC = torch.einsum("zhcts,zhcsn->zhctn", dG, Bc) + e[..., None] * Y
    dB = torch.einsum("zhcts,zhctn->zhcsn", dG, Cc) + w[..., None] * Z
    E = dM * M
    Fv = e * (Cc * Y).sum(-1)
    V = r * (Bc * Z).sum(-1)                                      # <B_s, dh_out x_s> r_s
    K = dtc * V
    rect = torch.stack([E[..., tau:, :tau].sum((-2, -1)) for tau in range(T)], dim=-1)
    fsuf = torch.flip(torch.cumsum(torch.flip(Fv, (-1,)), -1), (-1,))
    kpre = torch.cumsum(K, -1) - K
    c0 = decay * (dh_out * h_in).sum((-2, -1))
    S = rect + fsuf + c0[..., None] + kpre
    ddt = A.float()[None, :, None, None] * S + (dM * G * Lmat).sum(-2) + V
    dA = (dtc * S).sum((0, 2, 3))

    def steps(t):                                                # (Bz, H, nc, T, *) -> (Bz, L, H, *)
        t = t.permute(0, 2, 3, 1, *range(4, t.dim()))
        return t.reshape(Bz, nc * T, H, *t.shape[4:])[:, :L]
    dx = steps(dx)
    ddt = steps(ddt)
    dB = steps(dB).sum(2)
    dC = steps(dC).sum(2)
    return dx, ddt, dA, dB, dC, g
