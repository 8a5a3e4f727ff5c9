"""Logical meshes: axis names and sizes, which the partition rules, the
dry run and the elastic restore read.  The port runs one process, so a
mesh here never touches a device.

The production shapes are the JAX package's (16 x 16 ``("data",
"model")`` and 2 x 16 x 16 ``("pod", "data", "model")``), so rules and
per-device bytes compare one to one with it.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` maps each axis name to its size, in axis order."""
    shape: dict[str, int]

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(sizes: tuple[int, ...], names: tuple[str, ...]) -> Mesh:
    if len(sizes) != len(names):
        raise ValueError(f"mesh sizes {sizes} do not match axis names {names}")
    return Mesh(dict(zip(names, sizes)))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_smoke_mesh() -> Mesh:
    """The 1 x 1 mesh of one device."""
    return make_mesh((1, 1), ("data", "model"))
