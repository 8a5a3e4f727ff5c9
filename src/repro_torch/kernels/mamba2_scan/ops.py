"""Public wrapper of the SSD-scan kernels (csrc/mamba2_scan.cu).

Takes the model's layout, not the JAX kernel's flattened one: x (Bz, L, H,
P) is read through its strides (the JAX wrapper transposes it), and B and
C (Bz, L, N) are indexed by batch (the JAX wrapper copies them once per
head).  Returns y and the final state in float32 without the D residual,
as the model's path needs.  A CPU tensor runs the plain version in
``ref`` (which autograd differentiates); a CUDA tensor launches the kernel
or raises.  Where grad is enabled and an input requires it, the kernel
runs inside a ``torch.autograd.Function`` whose backward is the
hand-written ``ssd_scan_bwd``; otherwise the forward runs alone, as
serving and decode call it.
"""
from __future__ import annotations

import torch

from ..build import aligned16, check, count_launch, library
from .ref import ssd_scan_ref

HEAD_DIMS = (32, 64, 128)             # the P the chunk kernel is built for
STATE_DIMS = (16, 32, 64)             # and the N
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_CHUNK = 32                     # kLc in csrc/mamba2_scan.cu: steps a chunk


def _check_kernel_inputs(name: str, x, dt, A, B, C, h0) -> None:
    tensors = (x, dt, A, B, C, h0)
    devs = {t.device for t in tensors}
    if len(devs) != 1 or x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must share one CUDA device, got {devs}")
    if x.dtype not in _X_DTYPES or any(t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError(f"{name}: kernel takes x float32/bfloat16 and float32 "
                        f"dt/A/B/C/h0; got {[t.dtype for t in tensors]}")
    if x.stride(3) != 1 or not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError(f"{name}: x's head dim and dt/A/B/C/h0 must be contiguous")
    P, N = x.shape[-1], B.shape[-1]
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"{name}: kernel takes P in {HEAD_DIMS} and N in "
                         f"{STATE_DIMS}, got P={P}, N={N}")
    if not all(aligned16(t) for t in (x, B, C)):
        raise ValueError(f"{name}: x's rows and B, C must be 16-byte aligned "
                         "(the kernel copies 16-byte pieces)")


def _forward(x, dt, A, B, C, h0):
    """Launch the forward kernel: (y, hT)."""
    Bz, L, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty((Bz, L, H, P), dtype=torch.float32, device=x.device)
    hT = torch.empty((Bz, H, N, P), dtype=torch.float32, device=x.device)
    if L == 0:
        return y, hT.copy_(h0)
    with torch.cuda.device(x.device):
        rc = library("mamba2_scan").ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            h0.data_ptr(), y.data_ptr(), hT.data_ptr(), Bz, L, H, P, N,
            x.stride(0), x.stride(1), x.stride(2), _X_DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    check(rc, "ssd_scan")
    count_launch("ssd_scan")
    return y, hT


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, h0: torch.Tensor,
                 dy: torch.Tensor, dhT: torch.Tensor | None = None):
    """The backward kernel: (dx, ddt, dA, dB, dC, dh0) of ``ssd_scan``'s
    (y, hT), given y's gradient ``dy`` (Bz, L, H, P) and hT's ``dhT``
    (Bz, H, N, P; None: zeros), both float32.  dx comes in x's dtype, the
    rest in float32.  Chunk-parallel on the tensor cores: the states before
    and the gradients after each chunk of 32 steps by two walks over the
    chunks, then every chunk's gradients at once; dA, dB and dC are summed
    over b, the chunks and the heads in a fixed order without atomics, so
    two calls give the same bytes.  CUDA tensors only: the plain version
    is ``ref.ssd_scan_bwd_ref`` (``ref.ssd_chunked_bwd_ref`` mirrors the
    kernel's decomposition)."""
    _check_kernel_inputs("ssd_scan_bwd", x, dt, A, B, C, h0)
    Bz, L, H, P = x.shape
    N = B.shape[-1]
    dy = dy.float().contiguous()
    if tuple(dy.shape) != (Bz, L, H, P) or dy.device != x.device:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} on {dy.device} does not "
                         f"fit x {tuple(x.shape)}")
    if dhT is not None:
        dhT = dhT.float().contiguous()
        if dhT.shape != h0.shape or dhT.device != x.device:
            raise ValueError(f"ssd_scan_bwd: dhT {tuple(dhT.shape)} does not fit h0 "
                             f"{tuple(h0.shape)}")
    if any(t.data_ptr() % 16 for t in (h0, dy) + ((dhT,) if dhT is not None else ())):
        raise ValueError("ssd_scan_bwd: h0, dy and dhT must be 16-byte aligned")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bz, L, H, P), dtype=x.dtype, device=x.device)
    ddt = torch.empty((Bz, L, H), **f32)
    dA = torch.empty((H,), **f32)
    dB = torch.empty((Bz, L, N), **f32)
    dC = torch.empty((Bz, L, N), **f32)
    dh0 = torch.empty((Bz, H, N, P), **f32)
    if L == 0 or Bz == 0 or H == 0:
        return dx, ddt, dA.zero_(), dB.zero_(), dC.zero_(), (
            dh0.zero_() if dhT is None else dh0.copy_(dhT))
    n_chunks = -(-L // KERNEL_CHUNK)
    dA_part = torch.empty((H, Bz, n_chunks), **f32)
    dB_part = torch.empty((Bz, H, L, N), **f32)
    dC_part = torch.empty((Bz, H, L, N), **f32)
    hc = torch.empty((Bz * H, n_chunks, N, P), **f32)      # the state before each chunk
    dhc = torch.empty((Bz * H, n_chunks, N, P), **f32)     # the gradient after it
    with torch.cuda.device(x.device):
        rc = library("mamba2_scan").ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            h0.data_ptr(), dy.data_ptr(), None if dhT is None else dhT.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dh0.data_ptr(), dA_part.data_ptr(), dB_part.data_ptr(), dC_part.data_ptr(),
            hc.data_ptr(), dhc.data_ptr(), Bz, L, H, P, N,
            x.stride(0), x.stride(1), x.stride(2), _X_DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    check(rc, "ssd_scan_bwd")
    count_launch("ssd_scan_bwd")
    return dx, ddt, dA, dB, dC, dh0


class _SSDScan(torch.autograd.Function):
    """The forward kernel, saving its inputs; the backward kernel as its
    backward.  An output whose gradient never came (hT, where the loss
    ignores it) reaches the backward as None, which it takes as zeros."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, h0)
        return _forward(x, dt, A, B, C, h0)

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, A, B, C, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        grads = ssd_scan_bwd(x, dt, A, B, C, h0, dy, dhT)
        return tuple(g.to(t.dtype) if need else None for g, t, need in
                     zip(grads, (x, dt, A, B, C, h0), ctx.needs_input_grad))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, h0: torch.Tensor, *,
             chunk: int = 128):
    """x: (Bz, L, H, P) float32 or bfloat16; dt: (Bz, L, H); A: (H,); B, C:
    (Bz, L, N); h0: (Bz, H, N, P), all float32.  Returns (y (Bz, L, H, P),
    hT (Bz, H, N, P)), float32.  ``chunk`` is the plain version's chunk
    length; the kernel scans chunks of its own (32 steps), so its result
    does not depend on it but for rounding.  The kernel takes P in
    ``HEAD_DIMS`` and N in ``STATE_DIMS``, x's rows and B, C 16-byte
    aligned (it copies 16-byte pieces)."""
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 3 or h0.dim() != 4:
        raise ValueError("ssd_scan: want x (Bz,L,H,P), dt (Bz,L,H), B/C (Bz,L,N), "
                         "h0 (Bz,H,N,P)")
    Bz, L, H, P = x.shape
    N = B.shape[-1]
    if (tuple(dt.shape) != (Bz, L, H) or tuple(A.shape) != (H,)
            or tuple(B.shape) != (Bz, L, N) or B.shape != C.shape
            or tuple(h0.shape) != (Bz, H, N, P)):
        raise ValueError(f"ssd_scan: shapes do not fit: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}, h0 {tuple(h0.shape)}")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk {chunk} < 1")
    tensors = (x, dt, A, B, C, h0)
    if {t.device for t in tensors} == {torch.device("cpu")}:
        return ssd_scan_ref(x, dt, A, B, C, h0, chunk=chunk)
    _check_kernel_inputs("ssd_scan", *tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _SSDScan.apply(*tensors)
    return _forward(*tensors)
