"""Building guest-memory files for function instances.

Arena regions (DESIGN.md §3):
  * ``infra/...``  -- runtime tables every invocation touches (tokenizer,
    dispatch tables, executable-cache metadata): the analogue of the ~8 MB
    of guest-kernel/gRPC pages the paper measures as stable across
    invocations (§4.4).
  * ``params/...`` -- the serving weights (bf16): the function working set.
  * ``vision/...`` / ``audio/...`` -- modality-frontend banks, touched only
    when the invocation carries that modality.
  * ``boot/...``   -- boot-only state (fp32 master weights + optimizer
    moments for instances deployed from training checkpoints): present in
    the booted image, never touched while serving -- this is what makes the
    snapshot working set a small fraction of the booted footprint (Fig. 4).

The layout, fillers and bytes are the JAX package's: a snapshot built here
is byte-identical to ``repro.core.build_instance_snapshot``'s.
"""
from __future__ import annotations

import numpy as np

from ..configs.base import ModelConfig
from ..models import get_family
from ..nn import spec as nnspec
from .arena import ArenaLayout, GuestMemoryFile

INFRA_TENSORS = (
    ("infra/tokenizer_table", (1 << 20,), "uint8"),     # 1 MB
    ("infra/runtime_config", (256 << 10,), "uint8"),    # 256 KB
    ("infra/grpc_channel_state", (2 << 20,), "uint8"),  # 2 MB
    ("infra/executable_cache_index", (1 << 20,), "uint8"),
    ("infra/kernel_pages", (4 << 20,), "uint8"),        # guest-kernel analogue
)


def _frontend_tensors(cfg: ModelConfig) -> list[tuple[str, tuple, str, str]]:
    """Modality frontend stub weight banks (sized like a small ViT/w2v)."""
    out = []
    if cfg.family == "vlm":
        out.append(("vision/vit_stub", (24, cfg.d_model, 1024), "bfloat16", "serve"))
    if cfg.family == "encdec":
        out.append(("audio/frontend_stub", (12, cfg.d_model, 512), "bfloat16", "serve"))
    return out


def instance_tensor_list(cfg: ModelConfig, *, include_boot: bool = True):
    """(path, shape, dtype, region) list in arena layout order."""
    specs = get_family(cfg).param_specs(cfg)
    tensors: list[tuple[str, tuple, str, str]] = [
        (p, s, d, "infra") for (p, s, d) in INFRA_TENSORS]
    tensors += _frontend_tensors(cfg)
    for path, s in nnspec.tree_paths(specs):
        tensors.append((f"params/{path}", s.shape, s.dtype, "serve"))
    if include_boot:
        for path, s in nnspec.tree_paths(specs):
            tensors.append((f"boot/master/{path}", s.shape, "float32", "boot"))
            tensors.append((f"boot/adam_mu/{path}", s.shape, "float32", "boot"))
            tensors.append((f"boot/adam_nu/{path}", s.shape, "float32", "boot"))
    return tensors


def _as_f32(arr: np.ndarray, dtype: str) -> np.ndarray:
    return nnspec.bf16_bits_to_f32(arr) if dtype == "bfloat16" else arr.astype(np.float32)


def build_instance_snapshot(cfg: ModelConfig, base: str, *, seed: int = 0,
                            include_boot: bool = True) -> GuestMemoryFile:
    """Create <base>.mem/.manifest.json for a booted instance of ``cfg``."""
    specs = get_family(cfg).param_specs(cfg)
    leaf_dtype = {p: s.dtype for p, s in nnspec.tree_paths(specs)}
    tensors = instance_tensor_list(cfg, include_boot=include_boot)
    layout = ArenaLayout.build(tensors)

    host = nnspec.host_initialize(specs, seed=seed)
    arrays: dict[str, np.ndarray] = {}
    rng = np.random.default_rng(seed)
    for path, shape, dtype, _region in tensors:
        if path.startswith("params/"):
            arrays[path] = host[path[len("params/"):]]
        elif path.startswith("boot/master/"):
            sub = path[len("boot/master/"):]
            arrays[path] = _as_f32(host[sub], leaf_dtype[sub])
        elif path.startswith("boot/"):
            sub = path.split("/", 2)[2]
            arrays[path] = np.zeros(host[sub].shape, np.float32)
        else:  # infra / frontend banks: deterministic filler
            if dtype == "uint8":
                arrays[path] = rng.integers(0, 255, shape, dtype=np.uint8)
            else:
                x = rng.standard_normal(shape).astype(np.float32) * 0.02
                arrays[path] = nnspec.bf16_bits(x)
    return GuestMemoryFile.create(base, layout, arrays)


def booted_footprint_bytes(cfg: ModelConfig, include_boot: bool = True) -> int:
    """Footprint of a freshly-booted instance (everything in the image)."""
    layout = ArenaLayout.build(instance_tensor_list(cfg, include_boot=include_boot))
    return layout.total_bytes
