"""Parameter specification trees and host-side initialisation.

Models describe their parameters as a nested-dict tree of
:class:`TensorSpec` leaves (shape, dtype name, logical axis names, init
law).  The tree drives the snapshot layout (``core.snapshot``), the fault
order (``core.executor``) and :func:`host_initialize`, which writes the
snapshot's bytes.  The layout, the order and the bytes are the JAX
package's, so a snapshot built by either package is the same file.

Dtypes are names (``"bfloat16"``, ``"float32"``, ...).  NumPy has no
bfloat16 here, so host arrays hold bfloat16 as its ``uint16`` bit pattern
(:func:`storage_dtype`); :func:`to_torch` reinterprets such an array as a
``torch.bfloat16`` tensor without copying.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Callable, Iterator

import numpy as np
import torch

__all__ = [
    "TensorSpec",
    "tensor",
    "tree_paths",
    "map_leaves",
    "host_initialize",
    "itemsize",
    "storage_dtype",
    "torch_dtype",
    "to_torch",
    "bf16_bits",
    "bf16_bits_to_f32",
]

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8,
             "int8": 1, "uint8": 1, "int16": 2, "uint16": 2, "int32": 4,
             "uint32": 4, "int64": 8, "bool": 1}

_TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32, "float64": torch.float64,
          "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
          "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}


def itemsize(dtype: str) -> int:
    """Bytes per element of dtype name ``dtype``."""
    return _ITEMSIZE[dtype]


def storage_dtype(dtype: str) -> np.dtype:
    """The NumPy dtype that holds ``dtype``'s bytes on the host."""
    return np.dtype(np.uint16) if dtype == "bfloat16" else np.dtype(dtype)


def torch_dtype(dtype: str) -> torch.dtype:
    return _TORCH[dtype]


def to_torch(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """Zero-copy CPU tensor of dtype name ``dtype`` over host storage
    ``arr`` (for bfloat16, ``uint16`` bits viewed as ``torch.bfloat16``)."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (``uint16``), rounding to nearest
    even like ``ml_dtypes`` does for every finite value."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns -> float32 (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A single parameter/buffer declaration."""

    shape: tuple[int, ...]
    dtype: str = "bfloat16"
    axes: tuple[str | None, ...] = ()
    init: str = "normal"  # normal | zeros | ones | embed | trunc_fan_in
    scale: float | None = None

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} does not match shape {self.shape}"
            )

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return self.size * itemsize(self.dtype)


def tensor(*shape: int, axes: tuple[str | None, ...] = (), dtype: str = "bfloat16",
           init: str = "normal", scale: float | None = None) -> TensorSpec:
    if not axes:
        axes = (None,) * len(shape)
    return TensorSpec(tuple(shape), dtype, tuple(axes), init, scale)


def _is_leaf(x) -> bool:
    return isinstance(x, TensorSpec)


def tree_paths(tree, prefix: str = "") -> Iterator[tuple[str, TensorSpec]]:
    """Deterministic depth-first (path, leaf) iteration, sorted by key.
    This order is the arena layout and the fault order."""
    if _is_leaf(tree):
        yield prefix.rstrip("/"), tree
        return
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            yield from tree_paths(tree[k], prefix + str(k) + "/")
        return
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + str(i) + "/")
        return
    raise TypeError(f"unsupported spec-tree node: {type(tree)}")


def map_leaves(fn: Callable[[str, TensorSpec], Any], tree, prefix: str = ""):
    """Structure-preserving map with path argument."""
    if _is_leaf(tree):
        return fn(prefix.rstrip("/"), tree)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, prefix + str(k) + "/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [map_leaves(fn, v, prefix + str(i) + "/") for i, v in enumerate(tree)]
        return type(tree)(seq)
    raise TypeError(f"unsupported spec-tree node: {type(tree)}")


def host_initialize(tree, seed: int = 0) -> dict[str, np.ndarray]:
    """NumPy-side initialisation for the snapshot substrate, deterministic
    per path: ``default_rng(md5(f"{seed}:{path}"))``, ``standard_normal``
    in float32 times the scale (0.02 unless given) for every law but
    zeros/ones -- ``trunc_fan_in`` included -- then a cast to the leaf
    dtype.  This is the JAX package's law, so the bytes are identical.
    Returns path -> host storage array (see :func:`storage_dtype`)."""
    out = {}
    for path, s in tree_paths(tree):
        rng = np.random.default_rng(
            int.from_bytes(hashlib.md5(f"{seed}:{path}".encode()).digest()[:8], "little")
        )
        if s.init in ("zeros", "ones"):
            x = (np.zeros if s.init == "zeros" else np.ones)(s.shape, np.float32)
        else:
            scale = s.scale if s.scale is not None else 0.02
            x = rng.standard_normal(s.shape, dtype=np.float32) * scale
        out[path] = bf16_bits(x) if s.dtype == "bfloat16" else x.astype(s.dtype)
    return out
