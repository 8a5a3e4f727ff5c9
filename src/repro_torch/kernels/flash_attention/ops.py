"""Public wrapper of the flash-attention kernel (csrc/flash_attention.cu).

Takes the (B, S, H, D) layout of the JAX wrapper ``ops.mha``.  A CPU tensor
runs the plain version in ``ref``; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import math

import torch

from ..build import check, count_launch, library
from .ref import mha_ref

HEAD_DIMS = (32, 64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, KV, D), H % KV == 0 -> (B, S, H, D).

    Self-attention: queries and keys share the sequence (Sq == Skv).  The
    kernel takes float32 (on the CUDA cores) or bfloat16 (on the tensor
    cores, with P split into three bfloat16 parts) with D in ``HEAD_DIMS``.
    """
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"mha: want q (B,S,H,D), k/v (B,S,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D or H % KV:
        raise ValueError(f"mha: q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         "do not fit (Sq == Skv, H % KV == 0)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"mha: mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    devs = {q.device, k.device, v.device}
    if devs == {torch.device("cpu")}:
        return mha_ref(q, k, v, causal=causal)
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"mha: tensors must share one CUDA device, got {devs}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"mha: kernel takes float32 or bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"mha: kernel takes head dims {HEAD_DIMS}, got {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("mha: tensors must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("mha: bfloat16 tensors must be 16-byte aligned "
                         "(the kernel copies 16-byte vectors)")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        rc = library("flash_attention").flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, KV, D, _DTYPES[q.dtype], 1.0 / math.sqrt(D), int(causal),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "flash_attention")
    count_launch("flash_attention")
    return out
