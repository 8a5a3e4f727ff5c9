"""Sharded snapshot store: fleet-wide two-tier WS record serving.

Within one host, :data:`repro_torch.core.reap.WS_CACHE` already collapses N
concurrent cold-starts into one WS-file read.  Across a fleet the same
redundancy reappears one level up: every host that cold-starts function
*f* re-reads *f*'s working set from the origin (shared) disk.  "How Low
Can You Go?" (Tan et al., 2021) measures exactly this — cold-start floors
dominated by state-loading I/O that a shared tier can amortize.

This module shards that tier by the consistent-hash ring (shardmap.py):

  * every node gets its own bounded :class:`~repro_torch.core.reap.WSCache`
    (**L1**, attached via :meth:`ShardedSnapshotStore.attach`);
  * each function name hashes to 1..R **owner** shards; a node's L1 miss
    **peeks** the alive peer replicas' caches (an owner consults its
    co-owners too before paying the origin read): a resident WS is
    transferred over a modeled network (:class:`TransferModel`, latency +
    bandwidth cost paid as real sleep time so benchmarks observe it) and
    installed locally — restores resolve **local hit -> remote fetch ->
    origin disk**;
  * the wire ships only the chunks the requester's L1 doesn't already
    hold *from any function* (the caches' content-hash index,
    pagestore.py): ``transfer_bytes`` charges actual-missing bytes and
    ``dedup_bytes_saved`` the cross-function overlap;
  * a *cold* owner does not serve (counted ``remote_misses``) — the
    requester reads origin itself.  Owner caches are populated by their
    own cold starts and by :meth:`warm_owners` (the scheduler's
    ``rebalance()`` runs it after every ring change);
  * when no owner that was ever alive remains alive (node failure), the
    non-owner falls back to the origin disk and the event is counted
    (``dead_owner_fallbacks``); ring entries that never came up are
    ordinary ``remote_misses`` — nothing "died".

Deadlock-freedom by construction: the remote tier uses
:meth:`~repro_torch.core.reap.WSCache.peek`, which serves only *completed*
entries and never joins another cache's in-flight single-flight read — so
no thread ever blocks on another cache's event, and ring changes mid-fetch
(which can flip ownership between two nodes that are simultaneously
fetching) cannot create a cross-cache wait cycle.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time

from ..core.reap import (PAGE, ReapConfig, WSCache, _read_ws, has_record,
                         register_invalidation_listener,
                         unregister_invalidation_listener)
from .shardmap import ConsistentHashRing


@dataclasses.dataclass
class TransferModel:
    """Cost model for moving WS pages between hosts.

    ``cost_s = latency_s + n_bytes / bytes_per_s`` — a one-way RPC plus a
    bandwidth term per page.  Defaults model a ~10 GbE fabric with sub-ms
    RPC latency; benchmarks lower ``gbps`` to make tier placement visible
    at smoke-config WS sizes.

    This modeled sleep is the *inproc* fleet's stand-in for a copy that
    never happens (every node shares one heap).  The ``transport="socket"``
    fleet (:mod:`repro_torch.transport`) moves chunks between real
    processes and pays real wire/shm time; it does not consult this model.
    Kept as the ``inproc`` seam for A/B baselines.
    """
    latency_s: float = 5e-4
    gbps: float = 10.0

    def cost_s(self, n_bytes: int) -> float:
        return self.latency_s + n_bytes * 8.0 / (self.gbps * 1e9)

    def cost_pages(self, n_pages: int) -> float:
        return self.cost_s(n_pages * PAGE)


class ShardedSnapshotStore:
    """Fleet-wide WS-record store sharded over a consistent-hash ring.

    One instance spans the whole (simulated) fleet.  Per-node caches are
    created by :meth:`attach`; ownership queries and node liveness live
    here so a node's miss path can route around dead owners.
    """

    def __init__(self, ring: ConsistentHashRing, *,
                 transfer: TransferModel | None = None,
                 replication: int = 1,
                 cache_capacity_bytes: int = 256 << 20,
                 reap: ReapConfig | None = None,
                 sleep=time.sleep):
        if replication < 1:
            raise ValueError("replication must be >= 1")
        self.ring = ring
        self.transfer = transfer or TransferModel()
        self.replication = replication
        self.reap = reap or ReapConfig()     # read config for warm passes
        self.cache_capacity_bytes = cache_capacity_bytes
        self.caches: dict[str, WSCache] = {}
        self._alive: dict[str, bool] = {}
        self._ever_alive: set[str] = set()   # dead vs never-up accounting
        self._hot: dict[str, int] = {}       # per-function replication override
        self._mu = threading.Lock()
        self._sleep = sleep                  # injectable for tests
        self.remote_fetches = 0
        self.remote_misses = 0               # owner alive but cache cold
        self.origin_reads = 0
        self.dead_owner_fallbacks = 0
        self.transfer_bytes = 0              # actual-missing chunk bytes shipped
        self.dedup_bytes_saved = 0           # WS bytes the requester already held
        self.transfer_s = 0.0
        self.group_fetches = 0               # shard fetches serving a batch
        self.group_instances = 0             # instances amortized over those
        self.pushed_invalidations = 0        # stale peer-L1 entries dropped
        # Push invalidation (the eager path): a re-record or record drop
        # broadcasts through core.reap's listener hook; every attached L1
        # drops its stale entry *now* instead of on its next mtime-checked
        # fetch.  The listener holds only a weakref so a store that is
        # never close()d (and its caches) can still be collected; close()
        # and GC both unregister it.
        import weakref
        self_ref = weakref.ref(self)

        def _listener(base):
            store = self_ref()
            if store is not None:
                store._push_invalidation(base)

        self._listener = _listener
        register_invalidation_listener(_listener)
        weakref.finalize(self, unregister_invalidation_listener, _listener)

    # -- membership -----------------------------------------------------

    def attach(self, node_id: str, *,
               capacity_bytes: int | None = None) -> WSCache:
        """Create (or return) ``node_id``'s L1 cache, wired so its misses
        resolve through the shard tier.  Also joins the node to the ring
        if absent."""
        with self._mu:
            cache = self.caches.get(node_id)
            if cache is None:
                cap = (self.cache_capacity_bytes if capacity_bytes is None
                       else capacity_bytes)
                cache = WSCache(
                    cap,
                    source=lambda base, cfg, group=1, _n=node_id:
                        self._shard_fetch(_n, base, cfg, group=group))
                self.caches[node_id] = cache
            self._alive[node_id] = True
            self._ever_alive.add(node_id)
        self.ring.add(node_id)
        return cache

    def set_alive(self, node_id: str, alive: bool) -> None:
        """Mark a node up/down for the fetch path.  A down node also leaves
        the ring, so new placements/ownership exclude it (minimal remap)."""
        with self._mu:
            self._alive[node_id] = alive
            if alive:
                self._ever_alive.add(node_id)
        if alive:
            self.ring.add(node_id)
        else:
            self.ring.remove(node_id)

    def is_alive(self, node_id: str) -> bool:
        with self._mu:
            return self._alive.get(node_id, False)

    # -- ownership ------------------------------------------------------

    def set_replication(self, name: str, n: int) -> None:
        """Raise (or lower) one function's replica count — the hot-function
        knob: a popular WS served from R shards instead of one."""
        if n < 1:
            raise ValueError("replication must be >= 1")
        with self._mu:
            self._hot[name] = n

    def replication_of(self, name: str) -> int:
        with self._mu:
            return self._hot.get(name, self.replication)

    def owners(self, name: str) -> list[str]:
        """Owner shards for ``name`` in preference order (primary first)."""
        return self.ring.lookup(name, self.replication_of(name))

    # -- fetch path (per-node WSCache source hook) ----------------------

    def _shard_fetch(self, node_id: str, base: str, cfg: ReapConfig,
                     group: int = 1):
        """L1-miss resolution for ``node_id``: peek an alive peer
        replica's cache over the modeled network, else origin disk.  An
        owner consults its co-owner replicas too — a cold owner paying an
        origin read while an alive peer holds the WS wastes exactly the
        I/O this tier exists to amortize.  Runs outside any cache lock
        (the WSCache leader pattern), so the transfer sleep never blocks
        other functions' fetches; ``peek`` never blocks at all, so no
        cross-cache wait cycle can form.

        The transfer is charged at **actual-missing bytes**: the serving
        peer's chunk hashes are diffed against the requester L1's
        cross-function chunk index, and only absent chunks ship (the rest
        is ``dedup_bytes_saved``).

        ``group`` is the restore-batch size this fetch feeds (restore.py
        threads it through the node's L1): a k-instance group restore
        reaches the shard tier at most once, so the transfer cost is paid
        once per group instead of once per instance."""
        if group > 1:
            with self._mu:
                self.group_fetches += 1
                self.group_instances += group
        name = os.path.basename(base)
        owners = self.owners(name)
        is_owner = node_id in owners
        any_alive = False
        any_ever_alive = False
        for owner in owners:
            if owner == node_id:
                continue                 # own L1 already missed
            with self._mu:
                cache = self.caches.get(owner)
                up = self._alive.get(owner, False)
                ever = owner in self._ever_alive
                requester = self.caches.get(node_id)
            any_ever_alive = any_ever_alive or ever
            if cache is None or not up:
                continue
            any_alive = True
            served = cache.peek_chunks(base)
            if served is None:
                continue                 # owner is cold: try next replica
            pages, data, hashes = served
            missing = (requester.missing_chunks(hashes)
                       if requester is not None else set(hashes))
            wire_bytes = len(missing) * PAGE
            # A fully-deduped fetch ships nothing: charging the modeled
            # per-transfer latency for zero wire bytes would bill a
            # network round-trip that never happens (the chunk diff is
            # an in-memory index lookup).
            cost = self.transfer.cost_s(wire_bytes) if wire_bytes else 0.0
            self._sleep(cost)
            with self._mu:
                self.remote_fetches += 1
                self.transfer_bytes += wire_bytes
                self.dedup_bytes_saved += max(len(data) - wire_bytes, 0)
                self.transfer_s += cost
            return pages, data
        if not is_owner and owners:
            with self._mu:
                if any_alive:
                    self.remote_misses += 1      # cold owners only
                elif any_ever_alive:
                    self.dead_owner_fallbacks += 1
                else:
                    # ring entries that never came up: nothing "died", the
                    # owner tier simply has no replica yet
                    self.remote_misses += 1
        pages, data = _read_ws(base, cfg)
        with self._mu:
            self.origin_reads += 1
        return pages, data

    # -- maintenance ----------------------------------------------------

    def _push_invalidation(self, base: str) -> None:
        """Re-record/drop broadcast: eagerly drop ``base`` from every
        attached L1 so no node can serve (or remote-peek) the stale WS
        while waiting for its next mtime check.  Counted per entry
        actually dropped (``pushed_invalidations``)."""
        with self._mu:
            caches = list(self.caches.values())
        dropped = 0
        for cache in caches:
            if cache.invalidate(base):
                dropped += 1
        if dropped:
            with self._mu:
                self.pushed_invalidations += dropped

    def close(self) -> None:
        """Detach from the record-invalidation broadcast (a store used per
        benchmark arm must not keep invalidating caches it no longer
        owns).  GC of an unclosed store detaches it too (weakref.finalize
        in ``__init__``)."""
        unregister_invalidation_listener(self._listener)

    def resident(self, node_id: str, base: str) -> bool:
        """Scheduler locality probe: does ``node_id``'s L1 hold ``base``?"""
        cache = self.caches.get(node_id)
        return cache is not None and cache.contains(base)

    def warm_owners(self, base: str) -> int:
        """Pull ``base``'s WS into every alive owner's L1 (rebalance /
        post-join warm-up).  Returns the number of owner caches now
        holding it; no-op when no record exists yet."""
        if not has_record(base):
            return 0
        name = os.path.basename(base)
        warmed = 0
        cfg = self.reap                      # the fleet's configured reads
        for owner in self.owners(name):
            with self._mu:
                cache = self.caches.get(owner)
                up = self._alive.get(owner, False)
            if cache is None or not up:
                continue
            try:
                cache.fetch(base, cfg)
                warmed += 1
            except OSError:
                continue                 # record dropped mid-warm: skip
        return warmed

    def reset_stats(self) -> None:
        """Zero the store's counters and every attached cache's (cache
        *contents* survive — use each cache's ``clear`` for that)."""
        with self._mu:
            self.remote_fetches = self.remote_misses = 0
            self.origin_reads = self.dead_owner_fallbacks = 0
            self.transfer_bytes = 0
            self.dedup_bytes_saved = 0
            self.transfer_s = 0.0
            self.group_fetches = self.group_instances = 0
            self.pushed_invalidations = 0
            caches = list(self.caches.values())
        for c in caches:
            c.reset_stats()

    def stats(self) -> dict:
        with self._mu:
            out = {
                "remote_fetches": self.remote_fetches,
                "remote_misses": self.remote_misses,
                "origin_reads": self.origin_reads,
                "dead_owner_fallbacks": self.dead_owner_fallbacks,
                "transfer_bytes": self.transfer_bytes,
                "dedup_bytes_saved": self.dedup_bytes_saved,
                "transfer_s": self.transfer_s,
                "group_fetches": self.group_fetches,
                "group_instances": self.group_instances,
                "pushed_invalidations": self.pushed_invalidations,
                "alive": sorted(n for n, up in self._alive.items() if up),
            }
            caches = dict(self.caches)
        out["nodes"] = {n: c.stats() for n, c in sorted(caches.items())}
        local = sum(c["hits"] for c in out["nodes"].values())
        lookups = local + sum(c["misses"] for c in out["nodes"].values())
        out["local_hit_rate"] = local / lookups if lookups else 0.0
        return out
