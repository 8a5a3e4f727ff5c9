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
        # on and above the diagonal diff >= 0 can overflow exp, and a
        # where() after it gives 0 * inf = NaN in the backward: mask to
        # -inf first
        dec = torch.exp(diff.masked_fill(~mask[None, :, :, None, None], float("-inf")))
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


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                 dy: torch.Tensor, dsT: torch.Tensor | None = None, *,
                 chunk: int = 16):
    """The gradients of ``wkv6_ref``'s (y, sT) by an explicit reverse pass:
    the oracle of the backward kernel.  Shapes as ``wkv6_ref``; dy: (B, L,
    H, D), dsT: (B, H, D, D) or None (zeros).  Returns (dr, dk, dv, dlogw,
    du, ds0), all float32.

    The state before each chunk of ``chunk`` steps is computed forward;
    then the chunks are walked backward, each chunk's states recomputed
    from its first, with dS the gradient into S_t (w_t = exp(logw_t)):

        dlogw_t = sum_j dS o w_t o S_{t-1}
        dk_t = dS v_t + u o r_t <dy_t, v_t>
        dv_t = dS^T k_t + <r_t, u o k_t> dy_t
        dr_t = S_{t-1} dy_t + u o k_t <dy_t, v_t>
        du += sum_b r_t o k_t <dy_t, v_t>
        dS = w_t o dS + r_t (x) dy_t

    and the last dS is ds0.  Only decays w_t <= 1 are multiplied: the
    chunk form of dlogw, a reverse cumulative sum of terms that cancel,
    loses float32 digits where this does not."""
    B, L, H, D = r.shape
    rf, kf, vf, dyf = (t.float() for t in (r, k, v, dy))
    w = torch.exp(logw.float())
    uf = u.float()
    dev = r.device

    def step(s, t):
        return w[:, t, :, :, None] * s + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    starts, s = [], s0.float()
    for c0 in range(0, L, chunk):
        starts.append(s)
        for t in range(c0, min(c0 + chunk, L)):
            s = step(s, t)
    dr, dk, dv, dlogw = (torch.zeros((B, L, H, D), dtype=torch.float32, device=dev)
                         for _ in range(4))
    du = torch.zeros((H, D), dtype=torch.float32, device=dev)
    dS = (torch.zeros((B, H, D, D), dtype=torch.float32, device=dev)
          if dsT is None else dsT.float().clone())
    for ci in reversed(range(len(starts))):
        c0 = ci * chunk
        states = [starts[ci]]                   # states[s] = S_{c0 + s - 1}
        for t in range(c0, min(c0 + chunk, L) - 1):
            states.append(step(states[-1], t))
        for t in reversed(range(c0, min(c0 + chunk, L))):
            sp = states[t - c0]
            rt, kt, vt, dyt, wt = rf[:, t], kf[:, t], vf[:, t], dyf[:, t], w[:, t]
            dyv = (dyt * vt).sum(-1, keepdim=True)             # (B, H, 1)
            ruk = (rt * uf * kt).sum(-1, keepdim=True)
            dlogw[:, t] = wt * (dS * sp).sum(-1)
            dk[:, t] = torch.einsum("bhij,bhj->bhi", dS, vt) + uf * rt * dyv
            dv[:, t] = torch.einsum("bhij,bhi->bhj", dS, kt) + ruk * dyt
            dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, dyt) + uf * kt * dyv
            du += (rt * kt * dyv).sum(0)
            dS = wt[..., None] * dS + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dlogw, du, dS


def wkv6_chunked_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                         dy: torch.Tensor, dsT: torch.Tensor | None = None, *,
                         chunk: int = 32):
    """The gradients of ``wkv6_ref``'s (y, sT) by the chunk-parallel
    decomposition the backward kernel runs: the CPU mirror of its
    arithmetic.  Shapes and results as ``wkv6_bwd_ref``.

    (a) the state S_c before each chunk, walked forward over the chunks;
    (b) dS_c, the gradient into the state after each chunk, walked
    backward: dS_in = exp(d_last) o dS_out + sum_t (r_t o exp(p_t)) (x) dy_t;
    (c) each chunk's gradients from (S_in, dS_out) alone.  Per key channel
    i, with p_t = sum_{m<t} logw_m and q_s = sum_{m>s} logw_m (direct
    sums, both <= 0), Pi[t,s] = prod_{s<m<t} w_m (a product of decays
    <= 1), dA[t,s] = dy_t . v_s and A[t,s] = sum_i r_t k_s Pi[t,s]:

        dr_t = exp(p_t) S_in dy_t + sum_{s<t} dA[t,s] k_s Pi + u k_t dA[t,t]
        dk_s = exp(q_s) dS_out v_s + sum_{t>s} dA[t,s] r_t Pi + u r_s dA[s,s]
        dv_s = sum_{t>s} A[t,s] dy_t + <r_s, u o k_s> dy_s + (k_s o exp(q_s)) dS_out
        du = sum_t r_t o k_t dA[t,t]
        dlogw_tau = sum_{t > tau > s} r_t k_s Pi[t,s] dA[t,s]
                    + sum_{t > tau} r_t exp(p_t) (S_in dy_t)
                    + exp(d_last) <S_in, dS_out>_j
                    + sum_{s < tau} k_s exp(q_s) (dS_out v_s)

    dlogw is a sum of terms over the strict rectangle and the strict
    prefixes and suffixes, never a difference of reverse cumulative sums
    (of r o dr and k o dk) that cancel; no exponent is positive.  The
    kernel further factors the pairs with t >= 16 > s as Pi = P_t Q_s (P_t
    = prod_{16<=m<t} w_m, Q_s = prod_{s<m<16} w_m) to run them on the
    tensor cores: the same sums, rounded otherwise."""
    B, L, H, D = r.shape
    T = chunk
    pad = (-L) % T
    rf, kf, vf, wf, dyf = (t.float() for t in (r, k, v, logw, dy))
    if pad:
        # zero k, v, dy and log decay on padded steps: no state change, no gradient
        rf, kf, vf, wf, dyf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (rf, kf, vf, wf, dyf))
    nc = (L + pad) // T
    rc, kc, vc, wc, dyc = (t.reshape(B, nc, T, H, D).permute(0, 3, 1, 2, 4)
                           for t in (rf, kf, vf, wf, dyf))          # (B, H, nc, T, D)
    uf = u.float()[None, :, None, None, :]
    incl = torch.cumsum(wc, dim=3)
    p = incl - wc                                   # sum_{m<t}: exclusive prefix
    q = torch.flip(torch.cumsum(torch.flip(wc, (3,)), 3), (3,)) - wc
    dlast = wc.sum(3)                               # (B, H, nc, D)
    # Pi[t,s] = exp(sum_{s<m<t} logw_m), each sum taken directly
    idx = torch.arange(T, device=r.device)
    between = ((idx[None, None, :] > idx[None, :, None])
               & (idx[None, None, :] < idx[:, None, None]))         # [t, s, m]: s < m < t
    pi = torch.exp(torch.einsum("tsm,zhcmd->zhctsd", between.to(wc.dtype), wc))
    lower = (idx[:, None] > idx[None, :])                          # s < t
    pi = pi * lower[:, :, None]

    # (a) chunk-start states; (b) the gradient after each chunk
    kdec = kc * torch.exp(q)
    rdec = rc * torch.exp(p)
    s_in, s = [], s0.float()
    for c in range(nc):
        s_in.append(s)
        s = (torch.exp(dlast[:, :, c])[..., None] * s
             + torch.einsum("zhsi,zhsj->zhij", kdec[:, :, c], vc[:, :, c]))
    s_in = torch.stack(s_in, dim=2)                                # (B, H, nc, D, D)
    ds_out = [None] * nc
    g = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if dsT is None else dsT.float())
    for c in reversed(range(nc)):
        ds_out[c] = g
        g = (torch.exp(dlast[:, :, c])[..., None] * g
             + torch.einsum("zhti,zhtj->zhij", rdec[:, :, c], dyc[:, :, c]))
    ds_out = torch.stack(ds_out, dim=2)

    # (c) every chunk's gradients at once
    dA = torch.einsum("zhctj,zhcsj->zhcts", dyc, vc)
    diag = torch.diagonal(dA, dim1=-2, dim2=-1)                   # dy_t . v_t
    Wt = rc[:, :, :, :, None] * kc[:, :, :, None] * pi            # r_t k_s Pi: (.., t, s, D)
    A = Wt.sum(-1)
    Sdy = torch.einsum("zhcij,zhctj->zhcti", s_in, dyc)           # S_in dy_t
    Gv = torch.einsum("zhcij,zhcsj->zhcsi", ds_out, vc)           # dS_out v_s
    dr = (torch.exp(p) * Sdy + torch.einsum("zhcts,zhcsd,zhctsd->zhctd", dA, kc, pi)
          + uf * kc * diag[..., None])
    dk = (torch.exp(q) * Gv + torch.einsum("zhcts,zhctd,zhctsd->zhcsd", dA, rc, pi)
          + uf * rc * diag[..., None])
    ruk = (rc * uf * kc).sum(-1)
    dv = (torch.einsum("zhcts,zhctj->zhcsj", A, dyc) + ruk[..., None] * dyc
          + torch.einsum("zhcsi,zhcij->zhcsj", kdec, ds_out))
    du = (rc * kc * diag[..., None]).sum((0, 2, 3))
    W = Wt * dA[..., None]
    rect = torch.stack([W[:, :, :, tau + 1:, :tau].sum((3, 4)) for tau in range(T)], dim=3)
    P_t = rdec * Sdy                                               # r_t exp(p_t) (S_in dy_t)
    Q_s = kdec * Gv                                                # k_s exp(q_s) (dS_out v_s)
    psuf = torch.flip(torch.cumsum(torch.flip(P_t, (3,)), 3), (3,))  # sum_{t >= tau}
    psuf = torch.cat([psuf[:, :, :, 1:], torch.zeros_like(psuf[:, :, :, :1])], dim=3)
    qpre = torch.cat([torch.zeros_like(Q_s[:, :, :, :1]), torch.cumsum(Q_s, 3)[:, :, :, :-1]], 3)
    c0 = torch.exp(dlast) * (s_in * ds_out).sum(-1)                # (B, H, nc, D)
    dlogw = rect + psuf + c0[:, :, :, None] + qpre

    def steps(t):                                                  # (B, H, nc, T, D) -> (B, L, H, D)
        return t.permute(0, 2, 3, 1, 4).reshape(B, nc * T, H, D)[:, :L]
    return steps(dr), steps(dk), steps(dv), steps(dlogw), du, g
