"""ClusterRouter: fleet-wide admission + locality-aware placement.

The single-host :class:`~repro_torch.serving.Router` dispatches onto a worker
pool; this layer sits above a fleet of :class:`~repro_torch.cluster.WorkerNode`s
and decides *which host* serves each invocation.  Placement scores
locality against load:

  * ``w_warm``  — an idle warm instance of the function (zero restore cost)
  * ``w_ws``    — the function's working set resident in the node's L1
    cache (cold start avoids both the origin read and the shard transfer)
  * ``w_owner`` — the node is an owner shard for the function (its origin
    reads double as shard-tier population, and it likely keeps the WS hot)
  * ``w_load``  — penalty proportional to (queued + in-flight) / capacity

``placement="random"`` is the ablation arm benchmarks compare against.

Failure handling: every accepted invocation is a :class:`ClusterInvocation`
future that outlives its placement.  When a node is killed its queued
invocations fail fast with ``RouterClosedError``; the cluster reroutes them
to surviving nodes — proactively at :meth:`ClusterRouter.kill_node` time
and again lazily in ``result()`` for any raced stragglers — so no waiter
ever hangs on a dead host.  Admission is fleet-wide: a node whose queue is
full simply loses the placement to the next-ranked node, and
``AdmissionError`` surfaces only when *every* alive node refuses.

When ring membership changes (join/leave/kill), :meth:`rebalance` pulls
each function's WS into its (possibly new) owner shards' caches, so the
shard tier is warm before traffic hits the new mapping.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time

from ..configs.base import ModelConfig
from ..serving import AdmissionError, RouterClosedError
from ..telemetry import TELEMETRY, StatsSnapshotter
from .demand import DemandAggregator, DemandConfig
from .node import NodeDownError, WorkerNode
from .snapstore import ShardedSnapshotStore


class NoAliveNodeError(RuntimeError):
    """Every node in the fleet is dead; nothing can place the invocation."""


@dataclasses.dataclass
class ScheduleConfig:
    placement: str = "locality"      # "locality" | "random"
    w_warm: float = 4.0              # idle warm instance available
    w_ws: float = 2.0                # WS resident in node L1 cache
    w_owner: float = 1.0             # node is an owner shard
    w_load: float = 3.0              # x utilization (load / capacity)
    max_reroutes: int = 3            # per-invocation node-failure retries
    seed: int = 0                    # random-placement RNG seed


class ClusterInvocation:
    """Future for one fleet-admitted invocation; survives node failure by
    rebinding to a replacement placement (`node_ids` records the path)."""

    def __init__(self, cluster: "ClusterRouter", name: str, batch: dict,
                 force_cold: bool):
        self._cluster = cluster
        self.name = name
        self.batch = batch
        self.force_cold = force_cold
        self._mu = threading.Lock()
        self._inv = None                   # current serving.Invocation
        self._terminal: BaseException | None = None
        self.node_ids: list[str] = []      # placement history
        self.reroutes = 0

    def _bind_locked(self, node_id: str, inv) -> None:
        self._inv = inv
        self.node_ids.append(node_id)

    @property
    def node_id(self) -> str | None:
        with self._mu:
            return self.node_ids[-1] if self.node_ids else None

    def done(self) -> bool:
        """True once the invocation has truly finished.  A placement that
        failed with a *rerouteable* error (its node died) is not done —
        ``result()`` will rebind and re-execute it on a survivor."""
        with self._mu:
            if self._terminal is not None:
                return True
            inv = self._inv
        if inv is None or not inv.done():
            return False
        return not isinstance(inv._error, (RouterClosedError, NodeDownError))

    def result(self, timeout: float | None = None):
        """Block for (output, report).  A placement that died reroutes
        transparently; raises only terminal errors (admission exhaustion,
        reroute budget, a real invocation failure, or timeout)."""
        clock = self._cluster.clock
        deadline = None if timeout is None else clock() + timeout
        while True:
            with self._mu:
                if self._terminal is not None:
                    err = self._terminal
                else:
                    err = None
                inv = self._inv
            if err is not None:
                self._cluster._forget(self)
                raise err
            left = (None if deadline is None
                    else max(deadline - clock(), 0.0))
            try:
                out = inv.result(left)
            except (RouterClosedError, NodeDownError):
                # the placement died under us; rebind (idempotent vs the
                # proactive reroute in kill_node) and wait again
                self._cluster._reroute(self, inv)
                continue
            except TimeoutError:
                raise                      # still pending: stay registered
            except BaseException:
                self._cluster._forget(self)
                raise                      # terminal: unregister, propagate
            self._cluster._forget(self)
            return out

    @property
    def report(self):
        return self.result()[1]


class ClusterRouter:
    """Admits invocations fleet-wide and places them on worker nodes."""

    def __init__(self, nodes: list[WorkerNode] | tuple[WorkerNode, ...] = (),
                 *, store: ShardedSnapshotStore | None = None,
                 cfg: ScheduleConfig | None = None,
                 demand: DemandConfig | None = None,
                 clock=time.perf_counter):
        """``demand``: when given, a fleet-wide :class:`DemandAggregator`
        runs (demand.py) — every node's arrivals merge into per-function
        forecasts pushed to the owner-shard nodes' prewarm policies.
        ``clock`` times result/drain deadlines (injectable for tests)."""
        self.cfg = cfg or ScheduleConfig()
        self.clock = clock
        if self.cfg.placement not in ("locality", "random"):
            raise ValueError(f"unknown placement {self.cfg.placement!r}")
        self.store = store
        self.nodes: dict[str, WorkerNode] = {}
        self._functions: dict[str, tuple[ModelConfig, int]] = {}
        self._pending: dict[str, set[ClusterInvocation]] = {}
        self._mu = threading.Lock()
        self._rng = random.Random(self.cfg.seed)
        self.n_placed = 0
        self.n_rerouted = 0
        self.n_rejected = 0
        self.placements: dict[str, int] = {}
        self.demand_plane = (DemandAggregator(self, demand)
                             if demand is not None else None)
        #: fleet-level StatsSnapshotter (wired by build_fleet when the
        #: ServeConfig carries a TelemetryConfig); closed first in close()
        self.telemetry = None
        for n in nodes:
            self.add_node(n, rebalance=False)
        if self.demand_plane is not None:
            self.demand_plane.start()

    # -- membership -----------------------------------------------------

    def add_node(self, node: WorkerNode, *, rebalance: bool = True) -> None:
        """Join a node: attach its L1 cache to the store (wiring it into
        the node if it was built without one — a joined-but-unattached
        owner would silently degrade the shard tier), register the known
        function set on it, and optionally warm the new ring mapping."""
        if self.store is not None:
            cache = self.store.attach(node.node_id)  # alive + on the ring
            if node.ws_cache is None:
                node.ws_cache = cache
                node.orch.ws_cache = cache
            elif node.ws_cache is not cache:
                raise ValueError(
                    f"{node.node_id}: node was built with a ws_cache that "
                    f"is not the store's attached cache for it")
        with self._mu:
            self.nodes[node.node_id] = node
            self._pending.setdefault(node.node_id, set())
            self.placements.setdefault(node.node_id, 0)
            functions = list(self._functions.items())
        if self.demand_plane is not None:
            self.demand_plane.attach_node(node)
        for name, (cfg, seed) in functions:
            node.register(name, cfg, seed=seed)
        if rebalance:
            self.rebalance()

    def kill_node(self, node_id: str) -> int:
        """Simulated host failure: drop the node from the ring, fail its
        queue, and proactively reroute every queued invocation onto
        survivors.  Returns the number rerouted here (stragglers that race
        this pass reroute lazily in ``result()``)."""
        node = self.nodes[node_id]
        if self.store is not None:
            self.store.set_alive(node_id, False)
        node.kill()                        # queued invocations now failed
        if self.demand_plane is not None:
            # ownership moved: drop stale hints so the victim's replicas
            # start prewarming on the next aggregator step
            self.demand_plane.retarget()
        with self._mu:
            pending = list(self._pending.pop(node_id, ()))
            self._pending[node_id] = set()
        rerouted = 0
        for cinv in pending:
            with cinv._mu:
                inv = cinv._inv
            if inv is None or not inv.done():
                continue                   # in-flight: will finish normally
            try:
                inv.result(0)
            except (RouterClosedError, NodeDownError):
                if self._reroute(cinv, inv):
                    rerouted += 1
            except BaseException:
                pass                       # real failure/timeout: the waiter's
        return rerouted

    def alive_nodes(self) -> list[WorkerNode]:
        with self._mu:
            return [n for n in self.nodes.values() if n.alive]

    # -- control plane ---------------------------------------------------

    def register(self, name: str, cfg: ModelConfig, *, seed: int = 0,
                 warmup_batch: dict | None = None,
                 replication: int | None = None) -> None:
        """Register a function fleet-wide.  The snapshot builds once in the
        shared origin store (first node wins); the deploy-time executable
        warm-up runs once (one process builds and loads the kernels).  ``replication``
        raises the function's owner-shard count (hot functions)."""
        with self._mu:
            self._functions[name] = (cfg, seed)
            nodes = list(self.nodes.values())
        if replication is not None and self.store is not None:
            self.store.set_replication(name, replication)
        for i, node in enumerate(nodes):
            node.register(name, cfg, seed=seed,
                          warmup_batch=warmup_batch if i == 0 else None)

    def rebalance(self) -> dict[str, int]:
        """Warm each function's WS into its current owner shards' caches —
        run after ring membership changes so the shard tier serves the new
        mapping immediately.  Returns per-function owner caches warmed."""
        if self.demand_plane is not None:
            self.demand_plane.retarget()   # hints follow the new ring
        if self.store is None:
            return {}
        with self._mu:
            names = list(self._functions)
            store_dirs = {n.orch.store_dir for n in self.nodes.values()}
        warmed = {}
        for name in names:
            warmed[name] = sum(
                self.store.warm_owners(os.path.join(d, name))
                for d in store_dirs)
        return warmed

    def drain(self, timeout: float | None = None) -> None:
        deadline = None if timeout is None else self.clock() + timeout
        for node in self.alive_nodes():
            left = (None if deadline is None
                    else max(deadline - self.clock(), 0.001))
            node.router.drain(left)

    def close(self) -> None:
        if self.telemetry is not None:
            self.telemetry.close()       # final sample while nodes are live
        self._save_forecasts()           # persist before the plane stops
        if self.demand_plane is not None:
            self.demand_plane.stop()
        for node in self.alive_nodes():
            node.close()
        if self.store is not None:
            self.store.close()           # detach the invalidation broadcast

    FORECAST_STATE = "forecast_profiles.json"

    def _save_forecasts(self) -> None:
        """Serialize every confident periodicity profile alongside the
        snapshot store so the next fleet build prewarms day-one ramps
        (:func:`build_fleet` reloads the file into its demand plane)."""
        if self.demand_plane is None:
            return
        profiles = self.demand_plane.export_profiles()
        if not profiles:
            return
        dirs = {n.orch.store_dir for n in self.nodes.values()}
        payload = json.dumps({"version": 1, "profiles": profiles},
                             sort_keys=True)
        for d in sorted(dirs):
            try:
                with open(os.path.join(d, self.FORECAST_STATE), "w",
                          encoding="utf-8") as fh:
                    fh.write(payload)
            except OSError:
                continue                 # store dir gone: nothing to persist

    def __enter__(self) -> "ClusterRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- placement -------------------------------------------------------

    def score(self, node: WorkerNode, name: str, load: int | None = None,
              owners: set[str] | None = None) -> float:
        """Placement score; ``load``/``owners`` accept precomputed values
        so the submit hot path pays one router-stats pass per node and one
        ring lookup per placement instead of per (node, placement)."""
        c = self.cfg
        load = node.load() if load is None else load
        if owners is None:
            owners = (set(self.store.owners(name))
                      if self.store is not None else set())
        s = 0.0
        if node.warm_count(name) > 0:
            s += c.w_warm
        if node.ws_resident(name):
            s += c.w_ws
        if node.node_id in owners:
            s += c.w_owner
        return s - c.w_load * load / max(node.capacity, 1)

    def rank(self, name: str) -> list[WorkerNode]:
        """Alive nodes in placement-preference order."""
        alive = self.alive_nodes()
        if not alive:
            return []
        if self.cfg.placement == "random":
            with self._mu:
                return self._rng.sample(alive, len(alive))
        # deterministic locality order: score desc, then least loaded,
        # then node id (stable across equal-score fresh fleets)
        owners = (set(self.store.owners(name))
                  if self.store is not None else set())
        scored = []
        for n in alive:
            load = n.load()
            scored.append((-self.score(n, name, load, owners), load,
                           n.node_id, n))
        scored.sort(key=lambda t: (t[0], t[1], t[2]))
        return [t[3] for t in scored]

    def _submit_once(self, name: str, batch: dict, force_cold: bool):
        """Place on the best node that accepts; falls through ranked
        candidates on full queues and dead nodes.

        Exhaustion surfaces as exactly two errors: AdmissionError when at
        least one alive node refused on a full queue (a throttle, which
        load generators record as a rejection), else NoAliveNodeError
        (every candidate was dead or died racing us) — a raced node's
        NodeDownError/RouterClosedError never leaks to the caller as if
        it were this submit's failure.
        """
        admission: AdmissionError | None = None
        for node in self.rank(name):
            try:
                inv = node.submit(name, batch, force_cold=force_cold)
            except AdmissionError as e:
                admission = e
                continue
            except (NodeDownError, RouterClosedError):
                continue                   # died racing us: next candidate
            with self._mu:
                self.n_placed += 1
                self.placements[node.node_id] = (
                    self.placements.get(node.node_id, 0) + 1)
            return node, inv
        if admission is not None:
            with self._mu:
                self.n_rejected += 1
            raise admission
        raise NoAliveNodeError("no alive nodes in the fleet")

    # -- client API -------------------------------------------------------

    def submit(self, name: str, batch: dict, *,
               force_cold: bool = False) -> ClusterInvocation:
        """Admit one invocation fleet-wide; returns its future.  Raises
        AdmissionError only when every alive node's queue is full."""
        cinv = ClusterInvocation(self, name, batch, force_cold)
        node, inv = self._submit_once(name, batch, force_cold)
        with cinv._mu:
            cinv._bind_locked(node.node_id, inv)
        with self._mu:
            self._pending.setdefault(node.node_id, set()).add(cinv)
        return cinv

    def invoke(self, name: str, batch: dict, *, force_cold: bool = False,
               timeout: float | None = None):
        return self.submit(name, batch, force_cold=force_cold).result(timeout)

    def map(self, items: list[tuple[str, dict]], *,
            force_cold: bool = False) -> list:
        invs = [self.submit(n, b, force_cold=force_cold) for n, b in items]
        return [inv.result() for inv in invs]

    # -- failure handling -------------------------------------------------

    def _reroute(self, cinv: ClusterInvocation, failed_inv) -> bool:
        """Rebind ``cinv`` after its placement died; True when this call
        actually rebound it.  Idempotent: the kill-time proactive pass and
        a concurrent ``result()`` waiter may both observe the same failed
        placement; only one rebinds."""
        with cinv._mu:
            if cinv._terminal is not None or cinv._inv is not failed_inv:
                return False               # someone else already rebound it
            cinv.reroutes += 1
            if cinv.reroutes > self.cfg.max_reroutes:
                cinv._terminal = NoAliveNodeError(
                    f"{cinv.name}: reroute budget exhausted "
                    f"(tried {cinv.node_ids})")
                return False
            old = cinv.node_ids[-1] if cinv.node_ids else None
            try:
                node, inv = self._submit_once(cinv.name, cinv.batch,
                                              cinv.force_cold)
            except BaseException as e:
                cinv._terminal = e
                return False
            cinv._bind_locked(node.node_id, inv)
        with self._mu:
            self.n_rerouted += 1
            if old is not None:
                self._pending.get(old, set()).discard(cinv)
            self._pending.setdefault(node.node_id, set()).add(cinv)
        return True

    def _forget(self, cinv: ClusterInvocation) -> None:
        """Drop a resolved invocation from the pending registry."""
        node_id = cinv.node_id
        if node_id is None:
            return
        with self._mu:
            self._pending.get(node_id, set()).discard(cinv)

    # -- observability ----------------------------------------------------

    def reset_stats(self) -> None:
        """Zero placement/reroute counters (and the store's, if any) —
        benchmark arms reset between replays without touching state."""
        with self._mu:
            self.n_placed = self.n_rerouted = self.n_rejected = 0
            self.placements = {n: 0 for n in self.nodes}
        if self.store is not None:
            self.store.reset_stats()

    def stats(self) -> dict:
        with self._mu:
            out = {
                "placement": self.cfg.placement,
                "placed": self.n_placed,
                "rerouted": self.n_rerouted,
                "rejected": self.n_rejected,
                "placements": dict(self.placements),
                "pending": {n: len(s) for n, s in self._pending.items() if s},
            }
            nodes = list(self.nodes.values())
        out["nodes"] = {n.node_id: n.stats() for n in nodes}
        if self.store is not None:
            out["store"] = self.store.stats()
        if self.demand_plane is not None:
            out["demand"] = self.demand_plane.stats()
        return out


def build_fleet(n_nodes: int, store_dir: str, *,
                config=None,
                cfg: ScheduleConfig | None = None,
                demand: DemandConfig | None = None,
                replication: int = 1, vnodes: int = 64,
                transfer=None, cache_capacity_bytes: int = 256 << 20,
                transport: str | None = None):
    """Assemble ring + sharded store + N worker nodes into a ClusterRouter.

    ``config`` (a :class:`~repro_torch.serving.ServeConfig`) configures
    every node's serving stack, the device included, and its
    ``demand``/``transfer`` fields supply the fleet demand plane and shard
    network model unless overridden by the explicit kwargs.  Nodes share
    ``store_dir`` as the origin snapshot store.

    ``transport`` (defaults to ``config.transport``, else ``"inproc"``):
    ``"inproc"`` builds this thread-fleet ClusterRouter with the modeled
    :class:`~repro_torch.cluster.snapstore.TransferModel` network;
    ``"socket"`` builds a :class:`~repro_torch.transport.procnode.ProcessFleet`
    — one child process per node, WS chunks moving over Unix-domain
    sockets / shared memory (repro_torch.transport) — speaking the same
    scheduling interface, so the two fleets A/B on identical traces.
    """
    if transport is None:
        transport = getattr(config, "transport", None) or "inproc"
    if transport == "socket":
        from ..transport.procnode import build_process_fleet
        return build_process_fleet(
            n_nodes, store_dir, config=config, cfg=cfg,
            replication=replication, vnodes=vnodes,
            cache_capacity_bytes=cache_capacity_bytes)
    if transport != "inproc":
        raise ValueError(f"unknown transport {transport!r}")
    from .shardmap import ConsistentHashRing
    ring = ConsistentHashRing(vnodes=vnodes)
    reap = None
    if config is not None:
        demand = demand if demand is not None else config.demand
        transfer = transfer if transfer is not None else config.transfer
        reap = config.resolved_reap()
    store = ShardedSnapshotStore(ring, transfer=transfer,
                                 replication=replication,
                                 cache_capacity_bytes=cache_capacity_bytes,
                                 reap=reap)
    nodes = [WorkerNode(f"node-{i}", store_dir, config,
                        ws_cache=store.attach(f"node-{i}"))
             for i in range(n_nodes)]
    cluster = ClusterRouter(nodes, store=store, cfg=cfg, demand=demand)
    # restart path: reload persisted periodicity profiles so the demand
    # plane prewarms known ramps before re-learning them from arrivals
    if cluster.demand_plane is not None:
        state = os.path.join(store_dir, ClusterRouter.FORECAST_STATE)
        try:
            with open(state, encoding="utf-8") as fh:
                payload = json.load(fh)
            cluster.demand_plane.seed_profiles(payload.get("profiles", {}))
        except (OSError, ValueError):
            pass                         # no prior state (or unreadable)
    # fleet-level time series: one snapshotter over the nested cluster
    # stats (per-node warm counts / cache tiers / stage breakdowns / demand
    # forecasts) plus the process registry's counters and histograms
    tcfg = config.telemetry if config is not None else None
    if tcfg is not None:
        path = (os.path.join(tcfg.out_dir, "fleet.jsonl")
                if tcfg.out_dir else None)
        snap = StatsSnapshotter(interval_s=tcfg.interval_s, path=path,
                                ring=tcfg.ring)
        snap.add_source("cluster", cluster.stats)
        snap.add_source("registry", TELEMETRY.collect)
        cluster.telemetry = snap.start()
    return cluster
