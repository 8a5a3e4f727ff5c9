"""Public wrapper of the WKV6 kernel (csrc/rwkv6_scan.cu).

Takes the model's layout, not the JAX kernel's flattened one: r, k, v and
logw (B, L, H, D) are read through their strides (the JAX wrapper
transposes them and tiles u per batch).  Returns y and the final state in
float32, as the model's path needs.  A CPU tensor runs the plain version
in ``ref``; a CUDA tensor launches the kernel or raises, and so does one
that requires grad while grad is enabled: the kernel's backward is ROADMAP
A9.1, and until then rwkv6 trains on the CPU only.
"""
from __future__ import annotations

import torch

from ..build import aligned16, check, count_launch, library, refuse_grad
from .ref import wkv6_ref

HEAD_DIMS = (16, 32, 64)               # the D the kernel is built for
_RKV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return wkv6_ref(r, k, v, logw, u, s0, chunk=chunk)
    if len(devs) != 1 or r.device.type != "cuda":
        raise ValueError(f"wkv6: tensors must share one CUDA device, got {devs}")
    refuse_grad("wkv6_scan", *tensors)
    if (r.dtype not in _RKV_DTYPES or k.dtype != r.dtype or v.dtype != r.dtype
            or any(t.dtype != torch.float32 for t in (logw, u, s0))):
        raise TypeError(f"wkv6: kernel takes r/k/v float32 or bfloat16 (one dtype) "
                        f"and float32 logw/u/s0; got {[t.dtype for t in tensors]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim {D} not supported by the kernel "
                         f"(built for {HEAD_DIMS})")
    if (any(t.stride(3) != 1 for t in (r, k, v, logw))
            or not (u.is_contiguous() and s0.is_contiguous())):
        raise ValueError("wkv6: r/k/v/logw's head dim and u/s0 must be contiguous")
    if not all(aligned16(t) for t in (r, k, v, logw)):
        raise ValueError("wkv6: r/k/v/logw rows must be 16-byte aligned "
                         "(the kernel copies 16-byte pieces)")
    y = torch.empty((B, L, H, D), dtype=torch.float32, device=r.device)
    sT = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    if L == 0 or B == 0 or H == 0:
        return y, sT.copy_(s0)
    strides = [s for t in (r, k, v, logw) for s in t.stride()[:3]]
    with torch.cuda.device(r.device):
        rc = library("rwkv6_scan").wkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            s0.data_ptr(), y.data_ptr(), sT.data_ptr(), B, L, H, D, *strides,
            _RKV_DTYPES[r.dtype], torch.cuda.current_stream().cuda_stream)
    check(rc, "wkv6_scan")
    count_launch("wkv6_scan")
    return y, sT
