"""Weights and the snapshot image, made by the benchmark from the seed.

Every leaf of the function's image (the port's layout without the boot
region) is drawn on the device by a generator of its own, seeded from the
seed and the leaf's path, in one call a leaf, in the dtype it is served
in: ``zeros`` and ``ones`` leaves are constant, every other leaf normal
times its scale (0.02 unless given), the port's own law; the infra tables
are uniform bytes. The image is then written through the port's
``GuestMemoryFile.create``. Drawing a leaf again gives the same bits, so
the reference re-draws the weights after the window instead of keeping a
copy.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.core.arena import ArenaLayout, GuestMemoryFile
from repro_torch.core.snapshot import instance_tensor_list
from repro_torch.models import get_family
from repro_torch.nn import spec as nnspec


def leaf_generator(seed: int, path: str, device) -> torch.Generator:
    digest = hashlib.blake2b(f"{seed}:{path}".encode(), digest_size=8).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest, "little") >> 1)
    return g


def _laws(cfg) -> dict:
    """path in the image -> (init law, scale) of each parameter leaf."""
    specs = get_family(cfg).param_specs(cfg)
    return {f"params/{p}": (s.init, s.scale) for p, s in nnspec.tree_paths(specs)}


def draw(path: str, shape: tuple, dtype: str, law: tuple | None, seed: int,
         device) -> torch.Tensor:
    """One leaf on ``device`` in its own dtype."""
    tdt = nnspec.torch_dtype(dtype)
    if law is None:                                   # infra table: bytes
        return torch.randint(0, 256, shape, generator=leaf_generator(seed, path, device),
                             device=device, dtype=torch.uint8)
    init, scale = law
    if init in ("zeros", "ones"):
        return (torch.zeros if init == "zeros" else torch.ones)(shape, dtype=tdt,
                                                                device=device)
    x = torch.randn(shape, generator=leaf_generator(seed, path, device), device=device,
                    dtype=torch.float32)
    return x.mul_(0.02 if scale is None else scale).to(tdt)


def image_tensors(cfg) -> list:
    """(path, shape, dtype, region) of the image: the port's layout
    without the boot region (a REAP cold start never reads it)."""
    return instance_tensor_list(cfg, include_boot=False)


def write_image(cfg, base: str, seed: int, device) -> int:
    """Draw every leaf on ``device``, copy it to the host and write
    ``<base>.mem`` and its manifest; returns the image's bytes."""
    laws = _laws(cfg)
    tensors = image_tensors(cfg)
    arrays = {}
    for path, shape, dtype, _region in tensors:
        t = draw(path, tuple(shape), dtype, laws.get(path), seed, device).cpu()
        if dtype == "bfloat16":
            arrays[path] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[path] = t.numpy()
    layout = ArenaLayout.build(tensors)
    GuestMemoryFile.create(base, layout, arrays)
    return layout.total_bytes


def params_f32(cfg, seed: int, device) -> dict:
    """The parameters as served, widened to float32 on ``device``, keyed by
    their path in the image without ``params/`` (the reference's input)."""
    laws = _laws(cfg)
    out = {}
    for path, shape, dtype, _region in image_tensors(cfg):
        if path.startswith("params/"):
            out[path[len("params/"):]] = draw(path, tuple(shape), dtype, laws[path], seed,
                                              device).float()
    return out
