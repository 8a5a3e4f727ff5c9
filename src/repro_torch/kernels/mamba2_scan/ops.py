"""Public wrapper of the SSD-scan kernel (csrc/mamba2_scan.cu).

Takes the model's layout, not the JAX kernel's flattened one: x (Bz, L, H,
P) is read through its strides (the JAX wrapper transposes it), and B and
C (Bz, L, N) are indexed by batch (the JAX wrapper copies them once per
head).  Returns y and the final state in float32 without the D residual,
as the model's path needs.  A CPU tensor runs the plain version in
``ref``; a CUDA tensor launches the kernel or raises, and so does one
that requires grad while grad is enabled: the kernel's backward is ROADMAP
A9.1, and until then zamba2 trains on the CPU only.
"""
from __future__ import annotations

import torch

from ..build import aligned16, check, count_launch, library, refuse_grad
from .ref import ssd_scan_ref

HEAD_DIMS = (32, 64, 128)             # the P the chunk kernel is built for
STATE_DIMS = (16, 32, 64)             # and the N
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    tensors = (x, dt, A, B, C, h0)
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return ssd_scan_ref(x, dt, A, B, C, h0, chunk=chunk)
    if len(devs) != 1 or x.device.type != "cuda":
        raise ValueError(f"ssd_scan: tensors must share one CUDA device, got {devs}")
    refuse_grad("ssd_scan", *tensors)
    if x.dtype not in _X_DTYPES or any(t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError(f"ssd_scan: kernel takes x float32/bfloat16 and float32 "
                        f"dt/A/B/C/h0; got {[t.dtype for t in tensors]}")
    if x.stride(3) != 1 or not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("ssd_scan: x's head dim and dt/A/B/C/h0 must be contiguous")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk {chunk} < 1")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"ssd_scan: kernel takes P in {HEAD_DIMS} and N in "
                         f"{STATE_DIMS}, got P={P}, N={N}")
    if not all(aligned16(t) for t in (x, B, C)):
        raise ValueError("ssd_scan: x's rows and B, C must be 16-byte aligned "
                         "(the kernel copies 16-byte pieces)")
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
