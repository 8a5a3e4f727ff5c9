"""Public wrapper of the flash-attention kernel (csrc/flash_attention.cu).

Takes the (B, S, H, D) layout of the JAX wrapper ``ops.mha``.  A CPU tensor
runs the plain version in ``ref`` (which autograd differentiates); a CUDA
tensor launches the kernel or raises.  Where grad is enabled and an input
requires it, the kernel runs inside a ``torch.autograd.Function``: its
forward also writes each row's log-sum-exp, and its backward is the
hand-written ``flash_attention_bwd``.  Otherwise the forward runs alone, as
serving calls it.
"""
from __future__ import annotations

import math

import torch

from ..build import check, count_launch, library
from .ref import mha_ref

HEAD_DIMS = (32, 64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_kernel_inputs(name: str, *ts: torch.Tensor) -> None:
    q = ts[0]
    if len({t.device for t in ts}) != 1 or q.device.type != "cuda":
        raise ValueError(f"{name}: tensors must share one CUDA device, got "
                         f"{ {t.device for t in ts} }")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{name}: kernel takes float32 or bfloat16 (one dtype), got "
                        f"{[t.dtype for t in ts]}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: kernel takes head dims {HEAD_DIMS}, got {q.shape[-1]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: tensors must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: bfloat16 tensors must be 16-byte aligned "
                         "(the kernel copies 16-byte vectors)")


def _forward(q, k, v, causal: bool, want_lse: bool):
    """Launch the forward kernel: (out, lse or None)."""
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if q.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        rc = library("flash_attention").flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, S, H, k.shape[2], D, _DTYPES[q.dtype], 1.0 / math.sqrt(D),
            int(causal), torch.cuda.current_stream().cuda_stream)
    check(rc, "flash_attention")
    count_launch("flash_attention")
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True):
    """The backward kernel: dq, dk, dv (the shapes and dtype of q, k, v) of
    ``mha``'s output ``o`` with row log-sum-exps ``lse`` (B, H, S) float32,
    given the output's gradient ``do``.  bfloat16 runs on the tensor cores
    (P and dS as three bfloat16 parts), float32 on the CUDA cores; neither
    uses atomics, so two calls give the same bytes.  CUDA tensors only: the
    plain version is ``ref.flash_attention_bwd_ref``."""
    _check_kernel_inputs("flash_attention_bwd", q, k, v, o, do)
    B, S, H, D = q.shape
    if (o.shape != q.shape or do.shape != q.shape or k.shape != v.shape
            or tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}, o {tuple(o.shape)}, do {tuple(do.shape)}, "
                         f"lse {lse.dtype} {tuple(lse.shape)} do not fit")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = library("flash_attention").flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, S, H, k.shape[2], D, _DTYPES[q.dtype],
            1.0 / math.sqrt(D), int(causal), torch.cuda.current_stream().cuda_stream)
    check(rc, "flash_attention_bwd")
    count_launch("flash_attention_bwd")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, saving q, k, v, its output and the LSE; the
    backward kernel as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None


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
    if {q.device, k.device, v.device} == {torch.device("cpu")}:
        return mha_ref(q, k, v, causal=causal)
    _check_kernel_inputs("mha", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, want_lse=False)[0]
