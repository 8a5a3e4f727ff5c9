"""Mamba2 (SSD) block: the chunked parallel form for forward and prefill,
the same scan with one step for decode.

The JAX package's ``repro.models.mamba2``, in PyTorch: projections split
into z/x/B/C/dt weights, a depthwise causal conv over x only, and the SSD
scan.  On a CUDA tensor the scan runs the hand-written kernel
(``kernels.mamba2_scan``), and under autograd its backward kernel; on a
CPU tensor, and with ``plain=True``, it runs the kernel's plain version,
the same chunked form, which autograd differentiates.  A state (``ssm``
and ``conv``) is updated in place, where the JAX package returns a new
one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.mamba2_scan import ssd_scan, ssd_scan_ref
from ..nn import layers as nn
from ..nn.spec import tensor


def dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state


def mamba2_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_inner, H, N = dims(cfg)
    return {
        "wz": tensor(d, d_inner, axes=("embed", "mlp"), init="trunc_fan_in"),
        "wx": tensor(d, d_inner, axes=("embed", "mlp"), init="trunc_fan_in"),
        "wB": tensor(d, N, axes=("embed", "state"), init="trunc_fan_in"),
        "wC": tensor(d, N, axes=("embed", "state"), init="trunc_fan_in"),
        "wdt": tensor(d, H, axes=("embed", "heads"), init="trunc_fan_in"),
        "dt_bias": tensor(H, axes=("heads",), dtype="float32", init="zeros"),
        "A_log": tensor(H, axes=("heads",), dtype="float32", init="zeros"),
        "D": tensor(H, axes=("heads",), dtype="float32", init="ones"),
        "conv_w": tensor(cfg.conv_kernel, d_inner, axes=(None, "mlp"),
                         init="trunc_fan_in"),
        "conv_b": tensor(d_inner, axes=("mlp",), dtype="float32", init="zeros"),
        "norm": nn.rmsnorm_spec(d_inner),
        "wo": tensor(d_inner, d, axes=("mlp", "embed"), init="trunc_fan_in"),
    }


def mamba2_state_spec(cfg: ModelConfig, batch: int) -> dict:
    d_inner, H, N = dims(cfg)
    return {
        "ssm": tensor(batch, H, N, cfg.ssm_head_dim,
                      axes=("batch", "heads", "state", None),
                      dtype="float32", init="zeros"),
        "conv": tensor(batch, cfg.conv_kernel - 1, d_inner,
                       axes=("batch", None, "mlp"), dtype="bfloat16",
                       init="zeros"),
    }


def _proj(p, x):
    z = torch.einsum("bld,de->ble", x, p["wz"])
    xi = torch.einsum("bld,de->ble", x, p["wx"])
    Bm = torch.einsum("bld,dn->bln", x, p["wB"]).float()
    Cm = torch.einsum("bld,dn->bln", x, p["wC"]).float()
    dt = F.softplus(torch.einsum("bld,dh->blh", x, p["wdt"]).float() + p["dt_bias"])
    return z, xi, Bm, Cm, dt


def _conv(p, xi, conv_state=None):
    """Depthwise causal conv along L. conv_state: (B, K-1, d_inner).
    Returns the output and the new state (the last K-1 inputs)."""
    K = p["conv_w"].shape[0]
    if conv_state is None:
        pad = torch.zeros((xi.shape[0], K - 1, xi.shape[2]), dtype=xi.dtype,
                          device=xi.device)
    else:
        pad = conv_state.to(xi.dtype)
    xp = torch.cat([pad, xi], dim=1)
    L = xi.shape[1]
    out = sum(xp[:, i:i + L, :] * p["conv_w"][i] for i in range(K))
    out = F.silu(out.float() + p["conv_b"]).to(xi.dtype)
    return out, xp[:, -(K - 1):, :]


def ssd_chunked(xh, dt, A, Bm, Cm, D, h0, chunk: int = 128, *, plain: bool = False):
    """Chunked SSD scan.

    xh: (B, L, H, P) inputs per head; dt: (B, L, H); A: (H,) (negative);
    Bm, Cm: (B, L, N); h0: (B, H, N, P) initial state.
    Returns y: (B, L, H, P) float32 (with the D residual), hT float32.
    """
    scan = ssd_scan_ref if plain else ssd_scan
    y, hT = scan(xh, dt, A, Bm, Cm, h0, chunk=chunk)
    return y + xh.float() * D[None, None, :, None], hT


def apply_mamba2(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 state: dict | None = None, *, plain: bool = False):
    """x: (B, L, d).  Returns (y, state): the state dict given, updated in
    place, or None without one."""
    Bsz, L, _ = x.shape
    d_inner, H, N = dims(cfg)
    P = cfg.ssm_head_dim
    z, xi, Bm, Cm, dt = _proj(p, x)
    conv_state = None if state is None else state["conv"]
    xi, new_conv = _conv(p, xi, conv_state)
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(Bsz, L, H, P)
    h0 = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
          if state is None else state["ssm"])
    y, hT = ssd_chunked(xh, dt, A, Bm, Cm, p["D"], h0,
                        chunk=min(128, max(8, L)), plain=plain)
    y = y.reshape(Bsz, L, d_inner).to(x.dtype)
    y = nn.apply_rmsnorm(p["norm"], y * F.silu(z.float()).to(x.dtype), plain=plain)
    out = torch.einsum("ble,ed->bld", y, p["wo"])
    if state is not None:
        state["ssm"].copy_(hT)
        state["conv"].copy_(new_conv)
    return out, state


def mamba2_step(p: dict, x: torch.Tensor, cfg: ModelConfig, state: dict, *,
                plain: bool = False):
    """Single-token decode step. x: (B, 1, d)."""
    return apply_mamba2(p, x, cfg, state, plain=plain)
