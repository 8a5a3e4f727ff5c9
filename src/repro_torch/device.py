"""The device an entry point runs on: the card unless the caller asks for
the CPU, and never a silent fallback."""
from __future__ import annotations

from typing import Any

import torch


def device_of(device: Any) -> torch.device:
    """``device`` as a torch device; a CUDA device this host cannot use
    raises (no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no usable CUDA device on this host "
                           "(pass device='cpu' to run on the CPU)")
    return dev
