"""Checkpointing through the snapshot substrate.  The JAX package's
``repro.training.checkpoint``, in PyTorch, on the port's own arena.

A training checkpoint is a guest-memory file whose tensors are
``params/...`` (their own dtype), ``opt/...`` (float32 moments, the int32
count) and ``meta/step``.  Tensors reach numpy through their bit patterns
(bfloat16 as its 16-bit pattern, named ``"bfloat16"`` in the manifest), so
a checkpoint's ``.mem`` and ``.manifest.json`` are the JAX package's byte
for byte for the same values.  Restore paths:

  * ``lazy`` -- page-by-page serial faults in tree order: the vanilla-
    snapshot baseline applied to training restart;
  * ``reap`` -- one large read and an eager install (the whole file is
    the stable working set of a restart: REAP's ideal case).  The install
    is ``InstanceArena.install_block``'s one vectorised scatter, where the
    JAX package loops ``install_span`` page by page: the same bytes land.

Restored tensors go to the template's device and dtype.  An elastic
restore (:func:`restore_for_mesh`) assembles each parameter from the row
ranges that the data-parallel hosts of another mesh would each read
(:func:`read_shard`).
"""
from __future__ import annotations

import dataclasses
import math
import os
import threading
import time
from typing import Any

import numpy as np
import torch

from ..core.arena import PAGE, ArenaLayout, GuestMemoryFile, InstanceArena, PageSource
from ..device import device_of
from ..nn import spec as nnspec
from ..nn.spec import storage_dtype, to_torch
from .optimizer import tree_leaves

_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
          torch.float32: "float32", torch.float64: "float64", torch.int8: "int8",
          torch.uint8: "uint8", torch.int16: "int16", torch.int32: "int32",
          torch.int64: "int64", torch.bool: "bool"}


@dataclasses.dataclass(frozen=True)
class HostLeaf:
    """A tensor staged on the host: its storage array and dtype name."""
    array: np.ndarray
    dtype: str


def to_host(t) -> HostLeaf:
    """A tensor (or array) as host storage and its dtype name: bfloat16 as
    its ``uint16`` bit pattern."""
    if isinstance(t, HostLeaf):
        return t
    if not torch.is_tensor(t):
        a = np.asarray(t)
        return HostLeaf(a, a.dtype.name)
    name = _NAMES[t.dtype]
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return HostLeaf(t.view(torch.int16).numpy().view(np.uint16), name)
    return HostLeaf(t.numpy(), name)


def _tree_arrays(prefix: str, tree) -> dict[str, HostLeaf]:
    """``prefix/path`` -> host leaf, in sorted-key order (the JAX
    package's ``jax.tree`` order, which fixes the layout)."""
    return {f"{prefix}/{path}": to_host(leaf) for path, leaf in tree_leaves(tree)}


def save_checkpoint(base: str, params, opt_state, step: int) -> str:
    """Write <base>.mem/.manifest.json atomically; returns base.  Leaves are
    tensors on any device, or ``HostLeaf``s already staged on the host
    (``AsyncCheckpointer``)."""
    arrays = _tree_arrays("params", params)
    arrays.update(_tree_arrays("opt", opt_state))
    arrays["meta/step"] = HostLeaf(np.asarray([step], np.int64), "int64")
    tensors = [(p, h.array.shape, h.dtype, "serve" if p.startswith("params") else "boot")
               for p, h in arrays.items()]
    layout = ArenaLayout.build(tensors)
    tmp = base + ".tmp"
    GuestMemoryFile.create(tmp, layout, {p: h.array for p, h in arrays.items()})
    os.replace(tmp + ".mem", base + ".mem")
    os.replace(tmp + ".manifest.json", base + ".manifest.json")
    return base


class AsyncCheckpointer:
    """Double-buffered async save (the fault-tolerance substrate): the
    tensors are staged to the host, then written by a background thread,
    so the train loop blocks only for the copy to the host.  Keeps the
    newest ``keep`` checkpoints."""

    def __init__(self, dir_: str, keep: int = 2):
        self.dir = dir_
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        #: seconds of the last save's host staging and background write
        self.last_stage_s: float | None = None
        self.last_write_s: float | None = None
        os.makedirs(dir_, exist_ok=True)

    def save(self, params, opt_state, step: int) -> None:
        self.wait()
        t0 = time.perf_counter()
        host_p = _stage(params)
        host_o = _stage(opt_state)
        self.last_stage_s = time.perf_counter() - t0

        def work():
            t1 = time.perf_counter()
            try:
                base = os.path.join(self.dir, f"ckpt_{step:08d}")
                save_checkpoint(base, host_p, host_o, step)
                self._gc()
            except BaseException as e:          # re-raised by wait()
                self._error = e
            self.last_write_s = time.perf_counter() - t1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the background write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _bases(self) -> list[str]:
        return sorted(b[:-4] for b in os.listdir(self.dir) if b.endswith(".mem"))

    def _gc(self) -> None:
        for b in self._bases()[:-self.keep]:
            for suf in (".mem", ".manifest.json"):
                p = os.path.join(self.dir, b + suf)
                if os.path.exists(p):
                    os.remove(p)

    def latest(self) -> str | None:
        bases = self._bases()
        return os.path.join(self.dir, bases[-1]) if bases else None


def _stage(tree):
    """``tree`` with each tensor copied to the host."""
    if isinstance(tree, dict):
        return {k: _stage(v) for k, v in tree.items()}
    return to_host(tree)


def restore_checkpoint(base: str, params_like, opt_like, *,
                       mode: str = "reap") -> tuple[Any, Any, int, dict]:
    """Restore (params, opt_state, step).  ``mode``: lazy | reap.

    Returns (params, opt_state, step, stats), with stats reporting the
    restore's I/O seconds, bytes and page faults; each tensor goes to its
    template's device and dtype."""
    if mode not in ("lazy", "reap"):
        raise ValueError(f"restore mode {mode!r}: lazy | reap")
    gm = GuestMemoryFile.open(base)
    arena = InstanceArena(gm, o_direct=True)
    try:
        t0 = time.perf_counter()
        if mode == "reap":
            src = PageSource(gm.mem_path, o_direct=True)
            try:
                data = src.read_span(0, gm.layout.total_bytes)
            finally:
                src.close()
            block = np.frombuffer(data, dtype=np.uint8).reshape(-1, PAGE)
            arena.install_block(np.arange(gm.layout.n_pages), block)
            del block, data
        else:
            for e in gm.layout.entries.values():
                arena.touch_pages(e.pages())
        io_s = time.perf_counter() - t0

        def fill(template, prefix):
            def one(path, leaf):
                t = arena.tensor(f"{prefix}/{path}", fault=(mode == "lazy"))
                if torch.is_tensor(leaf):
                    return t.to(device=leaf.device, dtype=leaf.dtype, copy=True)
                return t.clone()
            return _map_with_paths(one, template)

        params = fill(params_like, "params")
        opt_state = fill(opt_like, "opt")
        step = int(arena.tensor("meta/step", fault=(mode == "lazy"))[0])
        stats = {"io_s": io_s, "bytes": gm.layout.total_bytes,
                 "n_faults": arena.stats.n_faults,
                 "fault_s": arena.stats.fault_seconds}
    finally:
        arena.close()
    return params, opt_state, step, stats


def _map_with_paths(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix.rstrip("/"), tree)


def read_shard(base: str, path: str, lo: int, hi: int) -> torch.Tensor:
    """Elastic restore: read only rows [lo, hi) of one tensor -- a host
    restoring onto a different mesh reads exactly its shard's byte range.
    A CPU tensor (bfloat16 from its bit pattern)."""
    gm = GuestMemoryFile.open(base)
    e = gm.layout.entries[path]
    row_bytes = e.nbytes // e.shape[0]
    src = PageSource(gm.mem_path, o_direct=False)
    try:
        raw = src.read_span(e.offset + lo * row_bytes, (hi - lo) * row_bytes)
    finally:
        src.close()
    arr = np.frombuffer(raw, dtype=storage_dtype(e.dtype)).reshape((hi - lo,) + e.shape[1:])
    return to_torch(arr.copy(), e.dtype)


def _read_whole(gm: GuestMemoryFile, path: str) -> torch.Tensor:
    e = gm.layout.entries[path]
    src = PageSource(gm.mem_path, o_direct=False)
    try:
        raw = src.read_span(e.offset, e.nbytes)
    finally:
        src.close()
    arr = np.frombuffer(raw, dtype=storage_dtype(e.dtype)).reshape(e.shape)
    return to_torch(arr.copy(), e.dtype)


def restore_for_mesh(base: str, spec_tree, mesh, rules, device: Any = "cuda",
                     stats: dict | None = None) -> Any:
    """Elastic re-shard restore: assemble each parameter from per-shard row
    reads for the (possibly different) target mesh -- one shard per
    data-parallel position (``sharding.data_axes``), the last taking the
    remainder rows; a scalar, or a tensor of fewer rows than shards, is
    read whole.  One process holds every shard, so the parts are joined
    and the tree of tensors goes to ``device`` (the card unless the caller
    asks for the CPU).  ``rules`` is unused, as in the JAX package: the
    rows follow the mesh's data axes.  ``stats``, if given, gets
    ``bytes`` (read) and ``reads`` (row ranges and whole reads)."""
    from ..distributed.sharding import data_axes
    dev = device_of(device)
    n_shards = max(1, math.prod(mesh.shape[a] for a in data_axes(mesh)))
    gm = GuestMemoryFile.open(base)
    counts = {"bytes": 0, "reads": 0}

    def one(path, s: nnspec.TensorSpec):
        full = f"params/{path}"
        rows = s.shape[0] if s.shape else 1
        if not s.shape or rows < n_shards:
            t = _read_whole(gm, full)
            counts["reads"] += 1
        else:
            per = rows // n_shards
            parts = [read_shard(base, full, i * per,
                                rows if i == n_shards - 1 else (i + 1) * per)
                     for i in range(n_shards)]
            counts["reads"] += n_shards
            t = torch.cat(parts, dim=0)
        counts["bytes"] += t.numel() * t.element_size()
        return t.to(dev)

    out = nnspec.map_leaves(one, spec_tree)
    if stats is not None:
        stats.update(counts)
    return out
