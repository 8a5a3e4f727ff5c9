"""Public wrapper of the WKV6 kernels (csrc/rwkv6_scan.cu).

Takes the model's layout, not the JAX kernel's flattened one: r, k, v and
logw (B, L, H, D) are read through their strides (the JAX wrapper
transposes them and tiles u per batch).  Returns y and the final state in
float32, as the model's path needs.  A CPU tensor runs the plain version
in ``ref`` (which autograd differentiates); a CUDA tensor launches the
kernel or raises.  Where grad is enabled and an input requires it, the
kernel runs inside a ``torch.autograd.Function`` whose backward is the
hand-written ``wkv6_scan_bwd``; otherwise the forward runs alone, as
serving and decode call it.
"""
from __future__ import annotations

import torch

from ..build import aligned16, check, count_launch, library
from .ref import wkv6_ref

HEAD_DIMS = (16, 32, 64)               # the D the kernel is built for
_RKV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD_CHUNK = 32                         # kBT in csrc/rwkv6_scan.cu: steps a chunk of the backward


def _check_kernel_inputs(name: str, r, k, v, logw, u, s0) -> None:
    tensors = (r, k, v, logw, u, s0)
    devs = {t.device for t in tensors}
    if len(devs) != 1 or r.device.type != "cuda":
        raise ValueError(f"{name}: tensors must share one CUDA device, got {devs}")
    if (r.dtype not in _RKV_DTYPES or k.dtype != r.dtype or v.dtype != r.dtype
            or any(t.dtype != torch.float32 for t in (logw, u, s0))):
        raise TypeError(f"{name}: kernel takes r/k/v float32 or bfloat16 (one dtype) "
                        f"and float32 logw/u/s0; got {[t.dtype for t in tensors]}")
    D = r.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not supported by the kernel "
                         f"(built for {HEAD_DIMS})")
    if (any(t.stride(3) != 1 for t in (r, k, v, logw))
            or not (u.is_contiguous() and s0.is_contiguous())):
        raise ValueError(f"{name}: r/k/v/logw's head dim and u/s0 must be contiguous")
    if not all(aligned16(t) for t in (r, k, v, logw)):
        raise ValueError(f"{name}: r/k/v/logw rows must be 16-byte aligned "
                         "(the kernel copies 16-byte pieces)")


def _strides(r, k, v, logw) -> list[int]:
    return [s for t in (r, k, v, logw) for s in t.stride()[:3]]


def _forward(r, k, v, logw, u, s0):
    """Launch the forward kernel: (y, sT)."""
    B, L, H, D = r.shape
    y = torch.empty((B, L, H, D), dtype=torch.float32, device=r.device)
    sT = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    if L == 0 or B == 0 or H == 0:
        return y, sT.copy_(s0)
    with torch.cuda.device(r.device):
        rc = library("rwkv6_scan").wkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            s0.data_ptr(), y.data_ptr(), sT.data_ptr(), B, L, H, D,
            *_strides(r, k, v, logw), _RKV_DTYPES[r.dtype],
            torch.cuda.current_stream().cuda_stream)
    check(rc, "wkv6_scan")
    count_launch("wkv6_scan")
    return y, sT


def wkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                  dy: torch.Tensor, dsT: torch.Tensor | None = None):
    """The backward kernel: (dr, dk, dv, dlogw, du, ds0) of ``wkv6``'s (y,
    sT), given y's gradient ``dy`` (B, L, H, D) and sT's ``dsT`` (B, H, D,
    D; None: zeros), both float32.  dr, dk and dv come in r's dtype, the
    rest in float32.  Chunk-parallel: the states before and the gradients
    after each chunk of 32 steps by two walks over the chunks on the tensor
    cores, then every chunk's gradients at once; du is summed over b and
    the chunks in a fixed order without atomics, so two calls give the same
    bytes.  CUDA tensors only: the plain version is ``ref.wkv6_bwd_ref``
    (``ref.wkv6_chunked_bwd_ref`` mirrors the kernel's decomposition)."""
    _check_kernel_inputs("wkv6_scan_bwd", r, k, v, logw, u, s0)
    B, L, H, D = r.shape
    dy = dy.float().contiguous()
    if dy.shape != r.shape or dy.device != r.device:
        raise ValueError(f"wkv6_scan_bwd: dy {tuple(dy.shape)} on {dy.device} does not "
                         f"fit r {tuple(r.shape)}")
    if dsT is not None:
        dsT = dsT.float().contiguous()
        if dsT.shape != s0.shape or dsT.device != r.device:
            raise ValueError(f"wkv6_scan_bwd: dsT {tuple(dsT.shape)} does not fit s0 "
                             f"{tuple(s0.shape)}")
    if any(t.data_ptr() % 16 for t in (s0, dy) + ((dsT,) if dsT is not None else ())):
        raise ValueError("wkv6_scan_bwd: s0, dy and dsT must be 16-byte aligned")
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv = (torch.empty((B, L, H, D), dtype=r.dtype, device=r.device)
                  for _ in range(3))
    dlogw = torch.empty((B, L, H, D), **f32)
    du = torch.empty((H, D), **f32)
    ds0 = torch.empty((B, H, D, D), **f32)
    if L == 0 or B == 0 or H == 0:
        return dr, dk, dv, dlogw, du.zero_(), (ds0.zero_() if dsT is None else ds0.copy_(dsT))
    n_chunks = -(-L // BWD_CHUNK)
    du_part = torch.empty((B, n_chunks, H, D), **f32)
    sc = torch.empty((B * H, n_chunks, D, D), **f32)       # the state before each chunk
    dsc = torch.empty((B * H, n_chunks, D, D), **f32)      # the gradient after it
    with torch.cuda.device(r.device):
        rc = library("rwkv6_scan").wkv6_scan_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            s0.data_ptr(), dy.data_ptr(), None if dsT is None else dsT.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(), du.data_ptr(),
            ds0.data_ptr(), du_part.data_ptr(), sc.data_ptr(), dsc.data_ptr(),
            B, L, H, D, *_strides(r, k, v, logw), _RKV_DTYPES[r.dtype],
            torch.cuda.current_stream().cuda_stream)
    check(rc, "wkv6_scan_bwd")
    count_launch("wkv6_scan_bwd")
    return dr, dk, dv, dlogw, du, ds0


class _WKV6Scan(torch.autograd.Function):
    """The forward kernel, saving its inputs; the backward kernel as its
    backward.  An output whose gradient never came (sT, where the loss
    ignores it) reaches the backward as None, which it takes as zeros."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, logw, u, s0)
        return _forward(r, k, v, logw, u, s0)

    @staticmethod
    def backward(ctx, dy, dsT):
        r, k, v, logw, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        grads = wkv6_scan_bwd(r, k, v, logw, u, s0, dy, dsT)
        return tuple(g.to(t.dtype) if need else None for g, t, need in
                     zip(grads, (r, k, v, logw, u, s0), ctx.needs_input_grad))


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor, *, chunk: int = 32):
    """r, k, v: (B, L, H, D) float32 or bfloat16 (one dtype); logw: (B, L,
    H, D) log decay (< 0); u: (H, D); s0: (B, H, D, D), all float32.
    Returns (y (B, L, H, D), sT (B, H, D, D)), float32.  ``chunk`` is the
    plain version's chunk length; the kernel scans chunks of its own (16
    steps, or one step when L = 1), so its result does not depend on it
    but for rounding.  The kernel takes D in ``HEAD_DIMS`` and every row
    of r, k, v and logw 16-byte aligned (it copies 16-byte pieces)."""
    if any(t.dim() != 4 for t in (r, k, v, logw, s0)) or u.dim() != 2:
        raise ValueError("wkv6: want r/k/v/logw (B,L,H,D), u (H,D), s0 (B,H,D,D)")
    B, L, H, D = r.shape
    if (any(t.shape != r.shape for t in (k, v, logw)) or tuple(u.shape) != (H, D)
            or tuple(s0.shape) != (B, H, D, D)):
        raise ValueError(f"wkv6: shapes do not fit: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)}, u {tuple(u.shape)}, s0 {tuple(s0.shape)}")
    if chunk < 1:
        raise ValueError(f"wkv6: chunk {chunk} < 1")
    tensors = (r, k, v, logw, u, s0)
    if {t.device for t in tensors} == {torch.device("cpu")}:
        return wkv6_ref(r, k, v, logw, u, s0, chunk=chunk)
    _check_kernel_inputs("wkv6", *tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _WKV6Scan.apply(*tensors)
    return _forward(*tensors)
