"""WorkerNode: one host of the simulated fleet.

A node bundles the single-host serving stack — an
:class:`~repro_torch.serving.Orchestrator` (instance pool + keepalive), a
:class:`~repro_torch.serving.Router` (queues + worker pool + admission), and
optionally a per-node :class:`~repro_torch.serving.PrewarmPolicy` control loop —
behind one id, one capacity figure, and one liveness flag, plus the
node-local L1 WS cache the sharded store attached (snapstore.py).

The cluster scheduler reads three signals off a node when scoring a
placement: ``warm_count(name)`` (an idle instance => zero-restore serve),
``ws_resident(name)`` (L1 WS hit => cheap cold start), and ``load()``
(queued + in-flight vs capacity).  ``kill()`` simulates host failure:
queued invocations fail fast (RouterClosedError) so the cluster layer can
reroute them — they are never left hanging — while invocations already
executing run to completion (their results are kept; the "connection"
outlives the control plane in this simulation).
"""
from __future__ import annotations

import dataclasses
import os
import threading

from ..configs.base import ModelConfig
from ..core.reap import WSCache
from ..serving import (Orchestrator, PrewarmPolicy, Router, RouterConfig,
                       ServeConfig)
from ..telemetry import StatsSnapshotter

#: Node-flavoured data-plane defaults (smaller than the single-host
#: RouterConfig: a fleet host shares the machine with its peers).
NODE_ROUTER = RouterConfig(max_concurrency=4, max_instances_per_function=4,
                           queue_depth=256, batch_restore_limit=8)


class NodeDownError(RuntimeError):
    """The target node was killed (or closed) before accepting the work."""


class WorkerNode:
    def __init__(self, node_id: str, store_dir: str,
                 config: ServeConfig | None = None, *,
                 ws_cache: WSCache | None = None):
        """``config`` (a :class:`~repro_torch.serving.ServeConfig`) carries
        every knob, the device included; its ``router`` field defaults to
        :data:`NODE_ROUTER` and its ``policy`` field enables the per-node
        adaptive prewarming loop.  ``ws_cache``: this node's L1 (usually
        ``store.attach(node_id)``).  The JAX package's pre-ServeConfig
        loose keyword knobs are not ported.
        """
        if config is None:
            config = ServeConfig(overlap_install=False, router=NODE_ROUTER)
        if config.router is None:
            config = dataclasses.replace(config, router=NODE_ROUTER)
        self.node_id = node_id
        self.config = config
        self.ws_cache = ws_cache
        self.capacity = config.router.max_concurrency
        self.orch = Orchestrator(store_dir, config, ws_cache=ws_cache)
        self.router = Router(self.orch, config.router)
        self.policy = (PrewarmPolicy(self.orch, self.router,
                                     config.policy).start()
                       if config.policy is not None else None)
        # optional per-node time series (the fleet-level snapshotter in
        # build_fleet already nests every node's stats; this one is for
        # standalone nodes or per-node files)
        tcfg = config.telemetry
        self.snapshotter = None
        if tcfg is not None and getattr(tcfg, "per_node", False):
            path = (os.path.join(tcfg.out_dir, f"{node_id}.jsonl")
                    if tcfg.out_dir else None)
            self.snapshotter = StatsSnapshotter(
                interval_s=tcfg.interval_s, path=path, ring=tcfg.ring)
            self.snapshotter.add_source("node", self.stats)
            self.snapshotter.start()
        self._mu = threading.Lock()
        self.alive = True

    # -- control plane --------------------------------------------------

    def register(self, name: str, cfg: ModelConfig, *, seed: int = 0,
                 warmup_batch: dict | None = None):
        """Register a function on this node.  All nodes share one origin
        store_dir, so the snapshot is built by whichever node registers
        first and reused read-only by the rest."""
        return self.orch.register(name, cfg, seed=seed,
                                  warmup_batch=warmup_batch)

    def kill(self) -> None:
        """Simulated host failure.  Fails every queued invocation fast
        (their waiters see RouterClosedError and the cluster reroutes);
        in-flight invocations finish and keep their results.  The router
        dies *first* — stopping the policy loop first would join a thread
        mid-sleep and hand the workers tens of milliseconds to drain the
        queue a crash should have stranded."""
        with self._mu:
            if not self.alive:
                return
            self.alive = False
        if self.snapshotter is not None:
            self.snapshotter.stop()   # crash: no final sample, no drain
        self.router.close(drain=False)
        if self.policy is not None:
            self.policy.stop()
        self.orch.close()

    def close(self) -> None:
        """Graceful shutdown: drain accepted work, then tear down."""
        with self._mu:
            if not self.alive:
                return
            self.alive = False
        if self.policy is not None:
            self.policy.stop()
        self.router.close(drain=True)
        if self.snapshotter is not None:
            self.snapshotter.close()  # final sample while stats still live
        self.orch.close()

    # -- fleet demand plane ----------------------------------------------

    def push_forecast(self, name: str, rate_rps: float,
                      expires_at: float) -> None:
        """Accept a fleet-wide forecast rate share for ``name`` (pushed by
        the cluster DemandAggregator to owner-shard nodes).  A node built
        without a policy loop has no prewarming actuator — the hint is
        dropped, matching its purely reactive behaviour."""
        if self.policy is not None:
            self.policy.push_forecast(name, rate_rps, expires_at)

    def clear_forecast(self, name: str) -> None:
        if self.policy is not None:
            self.policy.clear_forecast(name)

    # -- data plane ------------------------------------------------------

    def submit(self, name: str, batch: dict, *, force_cold: bool = False):
        """Enqueue one invocation; raises :class:`NodeDownError` if the
        node is dead (the scheduler treats it like any placement failure
        and tries the next candidate)."""
        if not self.alive:
            raise NodeDownError(f"node {self.node_id} is down")
        return self.router.submit(name, batch, force_cold=force_cold)

    # -- scheduler signals -----------------------------------------------

    def load(self) -> int:
        """Queued + in-flight invocations on this node."""
        s = self.router.stats()
        return sum(s["queued"].values()) + sum(s["inflight"].values())

    def warm_count(self, name: str) -> int:
        """Idle warm instances of ``name`` parked on this node."""
        return self.orch.idle_count(name)

    def ws_resident(self, name: str) -> bool:
        """Is ``name``'s working set resident in this node's L1 cache?"""
        if self.ws_cache is None:
            return False
        return self.ws_cache.contains(os.path.join(self.orch.store_dir, name))

    def stats(self) -> dict:
        out = {
            "node": self.node_id,
            "alive": self.alive,
            "capacity": self.capacity,
            "load": self.load() if self.alive else 0,
            "warm_instances": self.orch.warm_counts(),
            "router": self.router.stats(),
        }
        out["stage_seconds"] = self.orch.stage_seconds()
        out["tails"] = self.orch.tail_stats()
        if self.ws_cache is not None:
            out["ws_cache"] = self.ws_cache.stats()
        if self.policy is not None:
            out["policy"] = self.policy.stats()
        return out

    def __repr__(self) -> str:
        return (f"WorkerNode({self.node_id!r}, alive={self.alive}, "
                f"load={self.load() if self.alive else '-'}/{self.capacity})")
