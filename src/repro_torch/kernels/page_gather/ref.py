"""Plain PyTorch versions of the page gather/scatter kernels.

The CPU path of ``ops`` and the oracle the kernels are held to on the card.
"""
from __future__ import annotations

import torch


def page_gather_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, :] = table[idx[i], :]."""
    return table[idx]


def page_scatter_ref(ws: torch.Tensor, idx: torch.Tensor,
                     dest: torch.Tensor) -> torch.Tensor:
    """dest[idx[i], :] = ws[i, :] in place; other rows keep their contents.
    Returns ``dest``."""
    dest[idx] = ws
    return dest
