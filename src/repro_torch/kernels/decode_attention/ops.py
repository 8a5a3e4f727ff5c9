"""Public wrapper of the decode-attention kernel (csrc/decode_attention.cu).

Takes the model's layout, as the JAX wrapper ``ops.gqa_decode`` does: one
query token (B, 1, H, D) over a cache (B, S, KV, D).  The kernel reads the
cache through its strides, so no transposed copy is made (the JAX wrapper
moves the cache's axes on every call); a bfloat16 cache's rows must start
on 16-byte boundaries.  A CPU tensor runs the plain version in ``ref``; a
CUDA tensor launches the kernel or raises, and so does one that requires
grad while grad is enabled (the kernel has no backward: decode runs under
no grad).
"""
from __future__ import annotations

import math

import torch

from ..build import aligned16, check, count_launch, library, refuse_grad
from .ref import gqa_decode_ref

HEAD_DIMS = (32, 64, 80, 128)
MAX_GROUP = 8                         # query heads per KV head the kernel takes
#: (q dtype, cache dtype) the kernel takes -> its code
_DTYPES = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
           (torch.float32, torch.bfloat16): 2}
KEYS_PER_TILE = 64                    # kTile in csrc/decode_attention.cu
MAX_SPLITS = 128                      # kMaxSplits there
# At most two CTAs an SM, all in one wave: the bf16 route's registers (177
# a thread at D = 128) keep two CTAs of 128 threads an SM on the H100's 132
# SMs, and a call with a few CTAs past a whole count an SM waits on the SMs
# that hold them (PERF.md: the split sweep).
_RESIDENT_CTAS = 264
_MIN_TILES = 2                        # whole tiles a range at least
#: per (device index, CUDA stream): the kernel's int32 counters, one per
#: (b, KV head), zero between calls (the kernel's last CTA of a pair resets
#: its own); calls on one stream run one after another, so never share one
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def n_splits(B: int, KV: int, S: int) -> int:
    """Key ranges per (b, KV head) (flash decoding): as many as keep the
    B * KV * n_split CTAs within two an SM, with ranges of at least
    ``_MIN_TILES`` whole tiles of ``KEYS_PER_TILE`` keys (more, shorter
    ranges cost the merge more than they save); one where B * KV fills
    the card alone or the cache is short."""
    tiles = -(-S // KEYS_PER_TILE)
    return max(1, min(_RESIDENT_CTAS // max(B * KV, 1), tiles // _MIN_TILES, MAX_SPLITS))


def split_ranges(kv_len: int, n_split: int) -> list[tuple[int, int]]:
    """Keys ``[lo, hi)`` of each range, as the kernel's ``split_range``
    deals them: the valid prefix's whole tiles in ``n_split`` consecutive
    runs that differ by at most one tile."""
    tiles = -(-kv_len // KEYS_PER_TILE)
    return [(min(kv_len, i * tiles // n_split * KEYS_PER_TILE),
             min(kv_len, (i + 1) * tiles // n_split * KEYS_PER_TILE))
            for i in range(n_split)]


def _counters(device: torch.device, n: int) -> torch.Tensor:
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


def gqa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, D); k, v: (B, S, KV, D); kv_len: (B,) int -> (B, 1, H, D).

    Sequence b attends over cache positions ``[0, kv_len[b])``; the rest of
    the cache is excluded from the softmax.  The kernel takes q and cache
    both float32 or both bfloat16, or a float32 q over a bfloat16 cache,
    with D in ``HEAD_DIMS`` and at most ``MAX_GROUP`` query heads per KV
    head; the output has q's dtype.
    """
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"gqa_decode: want q (B,1,H,D), k/v (B,S,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KV or tuple(kv_len.shape) != (B,):
        raise ValueError(f"gqa_decode: q {tuple(q.shape)}, k/v {tuple(k.shape)} and "
                         f"kv_len {tuple(kv_len.shape)} do not fit")
    if k.dtype != v.dtype:
        raise TypeError(f"gqa_decode: k is {k.dtype}, v is {v.dtype}")
    G = H // KV
    devs = {q.device, k.device, v.device, kv_len.device}
    if devs == {torch.device("cpu")}:
        return gqa_decode_ref(q, k, v, kv_len)
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"gqa_decode: tensors must share one CUDA device, got {devs}")
    refuse_grad("decode_attention", q, k, v)
    code = _DTYPES.get((q.dtype, k.dtype))
    if code is None:
        raise TypeError(f"gqa_decode: kernel takes (q, cache) dtypes "
                        f"{list(_DTYPES)}, got ({q.dtype}, {k.dtype})")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"gqa_decode: kv_len must be int32, got {kv_len.dtype}")
    if D not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"gqa_decode: kernel takes head dims {HEAD_DIMS} and at "
                         f"most {MAX_GROUP} query heads per KV head; got D={D}, G={G}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("gqa_decode: the head dim must be contiguous")
    if code == 1 and not (aligned16(k) and aligned16(v)):
        raise ValueError("gqa_decode: a bfloat16 cache's rows must be 16-byte "
                         "aligned (the kernel copies 16-byte vectors)")
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or S == 0:
        return out.zero_()
    kv_len = kv_len.contiguous()
    splits = n_splits(B, KV, S)
    part_acc = torch.empty((B, KV, splits, G, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, KV, splits, G, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = library("decode_attention").decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            _counters(q.device, B * KV).data_ptr(),
            B, S, H, KV, D, splits, code, 1.0 / math.sqrt(D),
            q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "decode_attention")
    count_launch("decode_attention")
    return out
