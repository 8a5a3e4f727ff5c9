"""Gradient compression with error feedback.  The JAX package's
``repro.distributed.compress``, on tensors and ``torch.distributed``.

An int8 error-feedback compressor (EF-SGD): the residual of each
quantization is carried in a float32 buffer and added to the next
gradient before quantizing, so the long-run update is unbiased.
``ef_psum`` sums the int8 payloads over a process group (as int32 on the
wire) and keeps each rank's residual.

The arithmetic is the JAX package's in its order (the max of ``|x|``, the
1e-12 floor, ``/ 127.0``; ``torch.round`` rounds half to even as
``jnp.round`` does), so float32 inputs give the same bits.  ``ef_psum``
also keeps its scaling: the summed payload times the largest scale over
the ranks, over the rank count, which weighs each rank's share by
``smax / s_i`` where the ranks' scales differ (ROADMAP C5).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..training.optimizer import tree_map


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(torch.amax(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(g: torch.Tensor, err: torch.Tensor):
    """Returns (q, scale, new_err). g, err float32."""
    c = g + err
    q, scale = quantize_int8(c)
    return q, scale, c - dequantize_int8(q, scale)


def _unzip(tree, n: int) -> tuple:
    """A tree of n-tuples as n trees."""
    return tuple(tree_map(lambda t: t[i], tree) for i in range(n))


def ef_compress_tree(grads, errors):
    """(qs, scales, new_errors), trees of ``grads``' structure."""
    return _unzip(tree_map(lambda g, e: ef_compress(g.to(torch.float32), e),
                           grads, errors), 3)


def decompress_tree(qs, scales):
    return tree_map(dequantize_int8, qs, scales)


def ef_psum(grads, errors, group=None):
    """The int8-on-the-wire gradient mean over ``group``'s ranks.

    Each rank quantizes (grad + error), all-reduces the int8 payload as
    int32 (``SUM``) and its scale (``MAX``), dequantizes the sum with the
    largest scale over the rank count, and keeps its local residual.
    Returns (mean_grads, new_errors).  With no initialised process group
    it computes the one-rank result here; an initialised group of any
    size goes through the collectives."""
    collective = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size(group) if collective else 1

    def local(g, e):
        q, s, ne = ef_compress(g.to(torch.float32), e)
        acc = q.to(torch.int32).contiguous()   # a gradient may be strided
        smax = s.clone()
        if collective:
            dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
            dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
        return acc.to(torch.float32) * smax / n, ne

    return _unzip(tree_map(local, grads, errors), 2)
