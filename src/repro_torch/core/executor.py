"""Demand-paged invocation executor.

Runs one function invocation against an :class:`InstanceArena`, faulting
guest pages in execution order -- the framework-level userfaultfd analogue
(DESIGN.md §3).  The fault schedule is the JAX package's, so the recorded
trace and working set are the same page for page:

  * infra pages first, in ascending page order (every invocation),
  * modality frontend banks, only when the invocation carries that modality,
  * params in ``tree_paths`` order, the embedding table only at the rows of
    the request's tokens.

The embedding rows no request touched stay zero in the instance's arena.
With tied embeddings (olmo) the LM head reads the whole table, so a cold
invocation's logits differ from a warm instance's, exactly as in the JAX
package (``repro.core.executor``), whose fault trace the port reproduces.

Compute then runs on the instance's device with the params copied out of
the arena.  The MoE branch (route, then fault only the routed experts) is
not ported: ``get_family`` raises for MoE configs (ROADMAP A7).
"""
from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import get_family
from ..nn import spec as nnspec
from .arena import InstanceArena


def sync(device: torch.device) -> None:
    """Wait for the device (the invocation's result is then complete)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_executables(cfg: ModelConfig, example_batch: dict,
                     device: torch.device) -> None:
    """Deploy-time preparation of everything an invocation runs on
    ``device``: build or load the CUDA kernels and run one forward on
    zero-filled params of the right shapes (the analogue of the JAX
    package's compile at deploy)."""
    if device.type == "cuda":
        from ..kernels import build_all
        build_all()
    specs = get_family(cfg).param_specs(cfg)
    zeros = nnspec.map_leaves(
        lambda _, s: torch.zeros(s.shape, dtype=nnspec.torch_dtype(s.dtype),
                                 device=device), specs)
    get_family(cfg).forward(cfg, zeros, example_batch)
    sync(device)


class LazyParams:
    """Materializes the (stacked) param tree from the arena, page-faulting
    tensors on first access.  ``fault_all`` runs the fault schedule;
    :meth:`tree` copies the params to ``device``."""

    def __init__(self, cfg: ModelConfig, arena: InstanceArena, *,
                 device: torch.device, parallel: int = 0):
        self.cfg = cfg
        self.arena = arena
        self.device = torch.device(device)
        self.parallel = parallel
        self.specs = get_family(cfg).param_specs(cfg)
        self.paths = [p for p, _ in nnspec.tree_paths(self.specs)]

    def fault_all(self, embed_rows: np.ndarray | None = None) -> None:
        for p in self.paths:
            full = f"params/{p}"
            if embed_rows is not None and p == "embed/table":
                self.arena.tensor_rows(full, embed_rows.tolist(),
                                       parallel=self.parallel)
            else:
                self.arena.touch_pages(
                    self.arena.layout.pages_of(full), parallel=self.parallel)

    def tree(self) -> Any:
        """Full param tree as tensors on ``device`` (zero-filled where never
        faulted).  Always a copy: the arena's mmap may close under a view."""
        return nnspec.map_leaves(
            lambda p, s: self.arena.tensor(f"params/{p}", fault=False).to(
                self.device, copy=True),
            self.specs)


def _touch_infra(arena: InstanceArena) -> None:
    arena.touch_pages(sorted(arena.layout.region_pages("infra")))


def run_invocation(cfg: ModelConfig, arena: InstanceArena, batch: dict, *,
                   device: torch.device, parallel: int = 0
                   ) -> tuple[torch.Tensor, float]:
    """Execute one inference invocation against the demand-paged arena.

    Returns (logits on ``device``, seconds).  Every page the computation
    needs is faulted through the arena (so ``arena.stats`` is the paper's
    fault trace).
    """
    t0 = time.perf_counter()
    _touch_infra(arena)
    lp = LazyParams(cfg, arena, device=device, parallel=parallel)
    tokens = np.asarray(batch["tokens"])
    embed_rows = np.unique(tokens)

    if "patch_embeds" in batch and "vision/vit_stub" in arena.layout.entries:
        arena.touch_pages(arena.layout.pages_of("vision/vit_stub"),
                          parallel=parallel)
    if "frames" in batch and "audio/frontend_stub" in arena.layout.entries:
        arena.touch_pages(arena.layout.pages_of("audio/frontend_stub"),
                          parallel=parallel)

    lp.fault_all(embed_rows=embed_rows)
    logits = get_family(cfg).forward(cfg, lp.tree(), batch)
    return logits, time.perf_counter() - t0
