"""Carry parameters from the JAX package into the port, bit for bit.

The JAX side gives NumPy arrays: ``repro.nn.spec.host_initialize`` output
(a flat ``{"embed/table": array, ...}`` dict) or ``np.asarray`` of the
leaves of ``LazyParams.tree()`` (a nested dict).  bfloat16 arrives as an
``ml_dtypes`` array; it is reinterpreted through its 16-bit pattern, so
neither side rounds.  Nothing here imports JAX or ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import device_of


def _leaf(arr, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device, copy=True)


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """The port's nested param tree, on ``device``, from a JAX-side tree of
    NumPy arrays (flat ``"a/b"`` keys are nested).  Like
    ``launch.steps.init_params`` it goes to the card unless the caller asks
    for the CPU, and raises where the host has no card."""
    device = device_of(device)
    if any("/" in k for k in tree):
        nested: dict = {}
        for path, arr in tree.items():
            *parents, name = path.split("/")
            node = nested
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = arr
        tree = nested
    return {k: params_from_numpy(v, device) if isinstance(v, dict)
            else _leaf(v, device) for k, v in tree.items()}
