"""Parameter specification trees and host-side initialisation.

Models describe their parameters as a nested-dict tree of
:class:`TensorSpec` leaves (shape, dtype name, logical axis names, init
law).  The tree drives the snapshot layout (``core.snapshot``), the fault
order (``core.executor``), :func:`host_initialize`, which writes the
snapshot's bytes, and the partition rules (:func:`partition_specs`,
:func:`shardings`, :func:`shard_shape`) that the dry run and the elastic
restore read.  The layout, the order and the bytes are the JAX
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
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator

import numpy as np
import torch

__all__ = [
    "TensorSpec",
    "tensor",
    "tree_paths",
    "map_leaves",
    "host_initialize",
    "stream_initialize",
    "itemsize",
    "storage_dtype",
    "torch_dtype",
    "to_torch",
    "bf16_bits",
    "bf16_bits_to_f32",
    "PartitionSpec",
    "Sharding",
    "partition_specs",
    "shardings",
    "shard_shape",
    "shard_bytes",
]

#: leaves drawn at once by :func:`host_initialize`; the largest leaf of
#: rwkv6-7b takes 7.5 GB of float32 while it is drawn
_INIT_THREADS = 4

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


def _leaf_rng(path: str, seed: int) -> np.random.Generator:
    return np.random.default_rng(
        int.from_bytes(hashlib.md5(f"{seed}:{path}".encode()).digest()[:8], "little")
    )


def _draw(rng: np.random.Generator, shape, s: TensorSpec) -> np.ndarray:
    """The next ``shape`` values of a random leaf's stream, in its host
    storage dtype."""
    x = rng.standard_normal(shape, dtype=np.float32)
    x *= s.scale if s.scale is not None else 0.02     # float32, in place
    return bf16_bits(x) if s.dtype == "bfloat16" else x.astype(s.dtype)


def _init_leaf(path: str, s: TensorSpec, seed: int) -> np.ndarray:
    if s.init in ("zeros", "ones"):
        x = (np.zeros if s.init == "zeros" else np.ones)(s.shape, np.float32)
        return bf16_bits(x) if s.dtype == "bfloat16" else x.astype(s.dtype)
    return _draw(_leaf_rng(path, seed), s.shape, s)


def host_initialize(tree, seed: int = 0) -> dict[str, np.ndarray]:
    """NumPy-side initialisation for the snapshot substrate, deterministic
    per path: ``default_rng(md5(f"{seed}:{path}"))``, ``standard_normal``
    in float32 times the scale (0.02 unless given) for every law but
    zeros/ones -- ``trunc_fan_in`` included -- then a cast to the leaf
    dtype.  This is the JAX package's law, so the bytes are identical.
    Returns path -> host storage array (see :func:`storage_dtype`), in
    ``tree_paths`` order.  Leaves draw in a few threads at once, largest
    first (NumPy's generators release the GIL while they fill): each has
    its own generator, so the bytes do not depend on the order."""
    leaves = list(tree_paths(tree))
    with ThreadPoolExecutor(max_workers=min(_INIT_THREADS, os.cpu_count() or 1)) as pool:
        futures = {path: pool.submit(_init_leaf, path, s, seed)
                   for path, s in sorted(leaves, key=lambda ps: -ps[1].size)}
        return {path: futures[path].result() for path, _ in leaves}


#: values of one leaf drawn at once by :func:`stream_initialize` (256 MB
#: of float32)
STREAM_SLICE = 1 << 26


def stream_initialize(tree, seed: int = 0, device: Any = "cpu",
                      slice_elems: int = STREAM_SLICE) -> dict:
    """:func:`host_initialize`'s values, bit for bit, as a tree of tensors
    on ``device``, without holding whole leaves on the host.  Each leaf's
    stream is drawn in slices of at most ``slice_elems`` values (NumPy's
    ``standard_normal`` continues a stream across calls exactly as one call
    would draw it), cast and copied into the leaf's tensor one slice at a
    time; leaves draw in a few threads at once, largest first.  The host
    then holds at most one slice per thread."""
    dev = torch.device(device)
    leaves = list(tree_paths(tree))
    out = {path: torch.empty(s.shape, dtype=torch_dtype(s.dtype), device=dev)
           for path, s in leaves}

    def fill(path: str, s: TensorSpec) -> None:
        flat = out[path].view(-1)
        if s.init in ("zeros", "ones"):
            flat.fill_(0 if s.init == "zeros" else 1)
            return
        rng = _leaf_rng(path, seed)
        for lo in range(0, s.size, slice_elems):
            n = min(slice_elems, s.size - lo)
            flat[lo:lo + n].copy_(to_torch(_draw(rng, n, s), s.dtype))

    workers = min(os.cpu_count() or 1, 8)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for f in [pool.submit(fill, path, s)
                  for path, s in sorted(leaves, key=lambda ps: -ps[1].size)]:
            f.result()
    return map_leaves(lambda p, _: out[p], tree)


# ---------------------------------------------------------------------------
# Partition rules
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """One entry per leading dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of them (``_partition_spec`` drops trailing ``None``s).
    A tuple, as
    ``jax.sharding.PartitionSpec`` is, so ``p[0] == ("pod", "data")``
    reads the same."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's layout over a mesh: the record that stands where the JAX
    package has ``NamedSharding`` (one process places nothing)."""
    mesh: Any
    spec: PartitionSpec


def _partition_spec(s: TensorSpec, rules: dict[str, Any],
                    mesh=None) -> PartitionSpec:
    """Logical axes -> PartitionSpec under ``rules``.

    Never reuses a mesh axis within one tensor, and (when ``mesh`` is given)
    only assigns the longest prefix of mesh axes whose product divides the
    dimension (kv_heads=8 cannot shard a 16-way model axis and falls back
    to replication)."""
    used: set[str] = set()
    entries = []
    for dim, name in zip(s.shape, s.axes):
        mesh_axes = rules.get(name) if name is not None else None
        if mesh_axes is None:
            entries.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        picked = [a for a in mesh_axes if a not in used]
        if mesh is not None:
            while picked:
                if dim % math.prod(mesh.shape[a] for a in picked) == 0:
                    break
                picked = picked[:-1]
        if not picked:
            entries.append(None)
            continue
        used.update(picked)
        entries.append(tuple(picked) if len(picked) > 1 else picked[0])
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def partition_specs(tree, rules: dict[str, Any], mesh=None):
    return map_leaves(lambda _, s: _partition_spec(s, rules, mesh), tree)


def shardings(tree, mesh, rules: dict[str, Any]):
    return map_leaves(
        lambda _, s: Sharding(mesh, _partition_spec(s, rules, mesh)), tree)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(s: TensorSpec, spec: PartitionSpec, mesh) -> tuple[int, ...]:
    """The shape of one device's shard of ``s`` laid out by ``spec``: each
    dimension divided by the product of its mesh axes."""
    shape = list(s.shape)
    for i, entry in enumerate(spec):
        shape[i] //= math.prod(mesh.shape[a] for a in _entry_axes(entry))
    return tuple(shape)


def shard_bytes(s: TensorSpec, spec: PartitionSpec, mesh) -> int:
    """Bytes of one device's shard of ``s`` under ``spec``."""
    return math.prod(shard_shape(s, spec, mesh)) * itemsize(s.dtype)
