"""Consistent-hash shard map: function name -> owner host(s).

The fleet's sharded snapshot store (snapstore.py) and the locality-aware
scheduler (scheduler.py) both need a stable answer to "which node owns
function *f*'s working set?" that

  * spreads functions evenly across hosts (virtual nodes smooth out the
    variance a bare one-point-per-host ring would have),
  * moves only ~1/N of the keyspace when a host joins or leaves (minimal
    remap — a full rehash would invalidate every node's cache residency at
    once), and
  * supports a **replication factor**: hot functions list their first R
    distinct hosts clockwise from the key's hash, so a popular WS is served
    from several shards instead of hot-spotting one.

Hashing is :mod:`hashlib`-based (blake2b), never Python's randomized
``hash()``, so the mapping is stable across processes and runs — traces,
benchmarks, and a restarted fleet all agree on ownership.
"""
from __future__ import annotations

import bisect
import hashlib
import threading


def stable_hash(key: str) -> int:
    """64-bit stable hash (process-independent, unlike built-in hash())."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big")


class ConsistentHashRing:
    """Ring of ``vnodes`` virtual points per host; thread-safe.

    ``lookup(key, n)`` walks clockwise from ``hash(key)`` and returns the
    first ``n`` *distinct* hosts — position 0 is the primary owner, the
    rest are replicas in preference order.
    """

    def __init__(self, nodes: tuple[str, ...] | list[str] = (), *,
                 vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self._mu = threading.Lock()
        self._nodes: set[str] = set()
        self._points: list[int] = []     # sorted vnode hashes
        self._owners: list[str] = []     # owner of _points[i]
        for n in nodes:
            self.add(n)

    def add(self, node_id: str) -> None:
        with self._mu:
            if node_id in self._nodes:
                return
            self._nodes.add(node_id)
            for v in range(self.vnodes):
                h = stable_hash(f"{node_id}#{v}")
                i = bisect.bisect_left(self._points, h)
                # tie-break vnode-hash collisions by node id so insertion
                # order can't change the mapping
                while (i < len(self._points) and self._points[i] == h
                       and self._owners[i] < node_id):
                    i += 1
                self._points.insert(i, h)
                self._owners.insert(i, node_id)

    def remove(self, node_id: str) -> None:
        with self._mu:
            if node_id not in self._nodes:
                return
            self._nodes.discard(node_id)
            kept = [(p, o) for p, o in zip(self._points, self._owners)
                    if o != node_id]
            self._points = [p for p, _ in kept]
            self._owners = [o for _, o in kept]

    def lookup(self, key: str, n: int = 1) -> list[str]:
        """First ``n`` distinct owners clockwise from ``hash(key)``.

        Returns fewer than ``n`` when the ring has fewer hosts; empty when
        the ring is empty.
        """
        with self._mu:
            if not self._points:
                return []
            n = min(n, len(self._nodes))
            out: list[str] = []
            seen: set[str] = set()
            start = bisect.bisect_right(self._points, stable_hash(key))
            for step in range(len(self._points)):
                owner = self._owners[(start + step) % len(self._points)]
                if owner not in seen:
                    seen.add(owner)
                    out.append(owner)
                    if len(out) >= n:
                        break
            return out

    def owner(self, key: str) -> str | None:
        """Primary owner of ``key`` (None on an empty ring)."""
        owners = self.lookup(key, 1)
        return owners[0] if owners else None

    @property
    def nodes(self) -> list[str]:
        with self._mu:
            return sorted(self._nodes)

    def __len__(self) -> int:
        with self._mu:
            return len(self._nodes)

    def __contains__(self, node_id: str) -> bool:
        with self._mu:
            return node_id in self._nodes
