"""ServeConfig: the one composed entrypoint for the serving stack.

The JAX package's ServeConfig, field for field, plus the ``device`` every
instance computes on: the REAP and overlapped-restore knobs, the instance
pools, the router's config, the optional control and cluster planes
(prewarm policy, fleet demand, shard network model), telemetry, and the
page transport of a fleet.  It is consumed by
:class:`~repro_torch.serving.Orchestrator`,
:class:`~repro_torch.cluster.WorkerNode` and
:func:`~repro_torch.cluster.build_fleet`.  The overlap knobs
(``overlap_install``, ``hot_prefix_frac``, ``tail_workers``,
``tail_deadline_s``) are folded into the effective
:class:`~repro_torch.core.ReapConfig` by :meth:`ServeConfig.resolved_reap`;
with ``overlap_install`` on, a MATERIALIZED instance is not necessarily
fully resident -- the arena's pending-fault path covers the gap.

``device`` is the one place the device is chosen.  It defaults to
``"cuda"``, and a CUDA device that this host cannot use raises here: the
serving stack never falls back to the CPU.  Tests pass ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..core import ReapConfig


@dataclasses.dataclass
class ServeConfig:
    # -- restore / REAP -------------------------------------------------
    reap: ReapConfig = dataclasses.field(default_factory=ReapConfig)
    mode: str = "reap"               # 'reap' | 'vanilla'
    # -- overlapped restore (authoritative here; folded into ``reap``) --
    overlap_install: bool = True
    hot_prefix_frac: float = 0.125
    tail_workers: int = 2
    tail_deadline_s: float = 5.0
    # -- instance pools -------------------------------------------------
    keepalive_s: float = 60.0
    warm_limit: int = 8
    prewarm_concurrency: int = 4
    # -- data plane (None => RouterConfig()'s defaults) ----------------
    # typed Any to keep this module import-cycle-free (router.py imports
    # orchestrator.py which imports this module)
    router: Optional[Any] = None     # serving.RouterConfig
    # -- optional control/cluster planes -------------------------------
    policy: Optional[Any] = None     # serving.PolicyConfig (prewarm loop)
    demand: Optional[Any] = None     # cluster.DemandConfig (fleet forecasts)
    transfer: Optional[Any] = None   # cluster.TransferModel (shard network)
    # -- observability ---------------------------------------------------
    # telemetry.TelemetryConfig: enables the periodic StatsSnapshotter
    # (fleet-wide via build_fleet; per-node too with ``per_node=True``)
    telemetry: Optional[Any] = None
    # -- page transport (cluster fleets; repro_torch.transport) ---------
    # "inproc": threads in one heap, TransferModel-modeled copies.
    # "socket": process-per-node fleet moving chunks over Unix-domain
    # sockets / shared memory (build_fleet dispatches).
    transport: str = "inproc"
    transport_compress: bool = False   # per-chunk wire compression (codec)
    transport_shm: bool = True         # shm data plane when available
    transport_inline_max: int = 64 << 10  # <= this many bytes ride inline
    # -- compute ---------------------------------------------------------
    device: str = "cuda"

    def __post_init__(self):
        dev = torch.device(self.device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"ServeConfig(device={self.device!r}): no usable CUDA "
                    "device on this host (pass device='cpu' to serve on the CPU)")
            if dev.index is not None and dev.index >= torch.cuda.device_count():
                raise RuntimeError(f"ServeConfig(device={self.device!r}): only "
                                   f"{torch.cuda.device_count()} CUDA devices")
        elif dev.type != "cpu":
            raise ValueError(f"ServeConfig(device={self.device!r}): want 'cuda' "
                             "or 'cpu'")

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device)

    def resolved_reap(self) -> ReapConfig:
        """The effective ReapConfig: ``reap`` with the overlap knobs
        (authoritative on this config) folded in."""
        return dataclasses.replace(
            self.reap,
            overlap_install=self.overlap_install,
            hot_prefix_frac=self.hot_prefix_frac,
            tail_workers=self.tail_workers,
            tail_deadline_s=self.tail_deadline_s)

    def router_config(self):
        from .router import RouterConfig
        return self.router if self.router is not None else RouterConfig()
