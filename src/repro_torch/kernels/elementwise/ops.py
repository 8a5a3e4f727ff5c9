"""Public wrappers of the one-pass elementwise kernels (csrc/elementwise.cu).

``nonparam_ln`` and ``rmsnorm`` (one kernel, counted as ``norm``),
``rope_qk`` (q and k in one launch) and ``swiglu`` (the MLP's gate) each
read their inputs once, keep every float32 intermediate in registers and
write one output, where the plain versions in ``ref`` run a float32 copy
of the activations through one PyTorch op after another.  They take
float32 or bfloat16 CUDA tensors whose rows (the last dim; for ``rope_qk``
each half of a head row) start on 16-byte boundaries and hold whole
16-byte vectors, read through their strides, and return new contiguous
tensors; anything else raises.  ``nn.layers`` decides which version runs;
the wrappers never fall back.  The kernels have no backward: an input that
requires grad while grad is enabled raises.
"""
from __future__ import annotations

import torch

from ..build import aligned16, check, count_launch, library, refuse_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest norm row: 256 threads of 8 16-byte vectors (csrc: kThreads, kMaxNV)
MAX_NORM_BYTES = 256 * 8 * 16


def _code(name: str, *tensors: torch.Tensor) -> int:
    """The kernels' dtype code of ``tensors``: all of one dtype the kernels
    take."""
    first = tensors[0]
    if any(t.dtype != first.dtype for t in tensors):
        raise TypeError(f"{name}: mixed dtypes {[t.dtype for t in tensors]}")
    code = _DTYPES.get(first.dtype)
    if code is None:
        raise TypeError(f"{name}: the kernel takes {list(_DTYPES)}, got {first.dtype}")
    return code


def _on_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless ``tensors`` all lie on one CUDA device and none requires
    grad while grad is enabled."""
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name}: CUDA tensors only (the plain version in "
                         f"kernels.elementwise.ref runs on the CPU); got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: tensors on several devices")
    refuse_grad(name, *tensors)


def _rows(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` as rows of its last dim: a (rows, width) view where its strides
    allow (a copy otherwise), each row on a 16-byte boundary."""
    if t.dim() == 0 or t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dim must be contiguous, got strides "
                         f"{t.stride()}")
    rows = t.reshape(-1, t.shape[-1])
    if not aligned16(rows):
        raise ValueError(f"{name}: each row must start on a 16-byte boundary and "
                         f"hold whole 16-byte vectors ({t.dtype}, width "
                         f"{t.shape[-1]}, strides {t.stride()})")
    return rows


def _launch(fn: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        rc = getattr(library("elementwise"), fn)(
            *args, torch.cuda.current_stream().cuda_stream)
    check(rc, fn)


def _norm(kind: int, x: torch.Tensor, scale: torch.Tensor | None,
          eps: float) -> torch.Tensor:
    code = _code("norm", x)
    rows = _rows("norm", x)
    d = x.shape[-1]
    if d * x.element_size() > MAX_NORM_BYTES:
        raise ValueError(f"norm: rows of at most {MAX_NORM_BYTES} bytes, got {d} "
                         f"x {x.dtype}")
    if scale is not None:
        if (scale.dtype != torch.float32 or tuple(scale.shape) != (d,)
                or not scale.is_contiguous() or scale.data_ptr() % 16):
            raise ValueError(f"norm: scale must be a contiguous, 16-byte aligned "
                             f"float32 ({d},); got {scale.dtype} {tuple(scale.shape)}")
    _on_cuda("norm", x, *(() if scale is None else (scale,)))
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows.numel() == 0:
        return y
    _launch("norm_rows", x.device, rows.data_ptr(),
            None if scale is None else scale.data_ptr(), y.data_ptr(), rows.shape[0],
            d, rows.stride(0), kind, code, eps)
    count_launch("norm")
    return y


def nonparam_ln(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm over the last dim (``nonparam_ln_ref``)."""
    return _norm(0, x, None, eps)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor | None = None,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, times the float32 ``scale`` where given
    (``rmsnorm_ref``)."""
    return _norm(1, x, scale, eps)


def rope_qk(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``rope_ref`` of q (B, S, H, D) and of k (B, S, KV, D) in one launch.
    cos/sin: the float32 table of ``nn.layers.rope_table``, (S, D/2) or
    (B, S, D/2)."""
    code = _code("rope", q, k)
    if (q.dim() != 4 or k.dim() != 4 or k.shape[:2] != q.shape[:2]
            or k.shape[3] != q.shape[3]):
        raise ValueError(f"rope: want q (B, S, H, D) and k (B, S, KV, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, D = q.shape
    KV = k.shape[2]
    half = D // 2
    if D % 2 or half * q.element_size() % 16:
        raise ValueError(f"rope: head_dim {D} of {q.dtype}: each half of a head row "
                         "must hold whole 16-byte vectors")
    for t in (q, k):
        if t.stride(-1) != 1 or not aligned16(t):
            raise ValueError(f"rope: head rows must be contiguous and start on "
                             f"16-byte boundaries (strides {t.stride()})")
    want = [(S, half), (B, S, half)]
    if (cos.dtype != torch.float32 or sin.dtype != torch.float32
            or tuple(cos.shape) not in want or cos.shape != sin.shape
            or not (cos.is_contiguous() and sin.is_contiguous())
            or cos.data_ptr() % 16 or sin.data_ptr() % 16):
        raise ValueError(f"rope: cos/sin must be contiguous float32 {want}; got "
                         f"{cos.dtype} {tuple(cos.shape)}, {sin.dtype} "
                         f"{tuple(sin.shape)}")
    _on_cuda("rope", q, k, cos, sin)
    qo = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    ko = torch.empty((B, S, KV, D), dtype=q.dtype, device=q.device)
    if qo.numel() == 0:
        return qo, ko
    _launch("rope_qk", q.device, q.data_ptr(), k.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), qo.data_ptr(), ko.data_ptr(), B, S, H, KV, D, code,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
            k.stride(2), S * half if cos.dim() == 3 else 0)
    count_launch("rope")
    return qo, ko


def swiglu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``swiglu_ref(g, u)``: silu of g in float32, rounded to g's dtype, times
    u; g and u of one shape and dtype."""
    code = _code("swiglu", g, u)
    if g.shape != u.shape:
        raise ValueError(f"swiglu: g {tuple(g.shape)} and u {tuple(u.shape)} differ")
    gr, ur = _rows("swiglu", g), _rows("swiglu", u)
    _on_cuda("swiglu", g, u)
    h = torch.empty(g.shape, dtype=g.dtype, device=g.device)
    if h.numel() == 0:
        return h
    _launch("swiglu", g.device, gr.data_ptr(), ur.data_ptr(), h.data_ptr(),
            gr.shape[0], gr.shape[1], gr.stride(0), ur.stride(0), code)
    count_launch("swiglu")
    return h
