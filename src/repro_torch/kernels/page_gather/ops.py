"""Public wrappers of the page gather/scatter kernels (csrc/page_gather.cu).

Rows may be of any dtype and width: the kernel moves ``row_bytes`` bytes
per row, 16 at a time when the width and pointers allow.  A CPU tensor runs
the plain version in ``ref``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..build import check, count_launch, library
from .ref import page_gather_ref, page_scatter_ref


def _check_rows(name: str, rows: torch.Tensor, idx: torch.Tensor,
                n_rows: int) -> bool:
    """Validate a (rows, idx) pair; True when it lies on the CPU."""
    if rows.dim() != 2:
        raise ValueError(f"{name}: rows must be 2-D, got {tuple(rows.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int64:
        raise TypeError(f"{name}: idx must be 1-D int64, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n_rows):
        raise IndexError(f"{name}: idx out of range [0, {n_rows})")
    if rows.device.type == "cpu" and idx.device.type == "cpu":
        return True
    if rows.device.type != "cuda" or idx.device != rows.device:
        raise ValueError(f"{name}: tensors must all lie on one CUDA device "
                         f"or all on the CPU ({rows.device}, {idx.device})")
    if not (rows.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    return False


def gather_pages(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, :] = table[idx[i], :]: the trace-ordered working set of a page
    table (or, with a sorting permutation, the WS in ascending page order).

    table: (n_pages, row) any dtype; idx: (n,) int64.
    """
    if _check_rows("gather_pages", table, idx, table.shape[0]):
        return page_gather_ref(table, idx)
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if idx.numel() == 0:
        return out
    with torch.cuda.device(table.device):
        rc = library("page_gather").gather_pages(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            table.shape[1] * table.element_size(),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "gather_pages")
    count_launch("gather_pages")
    return out


def scatter_pages(ws: torch.Tensor, idx: torch.Tensor,
                  dest: torch.Tensor) -> torch.Tensor:
    """dest[idx[i], :] = ws[i, :], written into ``dest`` in place (the
    donated-buffer semantics of the JAX wrapper); other rows keep their
    contents.  Returns ``dest``.  With a repeated index, which row wins is
    unspecified, as for the plain version.

    ws: (n, row); idx: (n,) int64; dest: (n_pages, row) of ws's dtype.
    """
    if ws.dtype != dest.dtype or dest.dim() != 2 or ws.shape[1:] != dest.shape[1:]:
        raise ValueError(f"scatter_pages: ws {ws.dtype} {tuple(ws.shape)} does "
                         f"not match dest {dest.dtype} {tuple(dest.shape)}")
    if idx.shape[0] != ws.shape[0]:
        raise ValueError("scatter_pages: idx and ws differ in length")
    cpu = _check_rows("scatter_pages", ws, idx, dest.shape[0])
    if cpu and dest.device.type == "cpu":
        return page_scatter_ref(ws, idx, dest)
    if dest.device != ws.device or not dest.is_contiguous():
        raise ValueError("scatter_pages: dest must be contiguous on ws's device")
    if idx.numel() == 0:
        return dest
    with torch.cuda.device(dest.device):
        rc = library("page_gather").scatter_pages(
            ws.data_ptr(), idx.data_ptr(), dest.data_ptr(), idx.shape[0],
            ws.shape[1] * ws.element_size(),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "scatter_pages")
    count_launch("scatter_pages")
    return dest
