"""REAP: Record-and-Prefetch (the paper's §5).

* **Record phase**: the first cold invocation runs against a demand-paged
  :class:`InstanceArena`; the monitor records the ordered page-fault trace.
  Afterwards the recorded pages are copied into a *contiguous, compact
  working-set (WS) file* and the page indices into a *trace file*.

* **Prefetch phase**: every later cold invocation fetches the whole WS file
  with a single large read (``O_DIRECT``, bypassing the page cache --
  §5.2.3) and eagerly installs the pages into the instance arena before the
  function runs.  Residual faults (mispredicted pages, §7.1) are served on
  demand by the monitor.

* **Re-record policy** (§7.2): if the residual fault count exceeds
  ``rerecord_threshold`` x |WS|, the orchestrator re-records on the next
  invocation.

* **Shared WS page cache**: under concurrent load, N simultaneous
  cold-starts of the same function would each re-read the identical WS file
  from disk.  The process-wide :class:`WSCache` collapses those into a
  single O_DIRECT read (single-flight: late arrivals block on the leader's
  read), keyed by ``(base, ws-file mtime)`` so re-recording invalidates
  naturally.  ``drop_record`` / ``write_record`` also invalidate explicitly.

* **Content-addressed records** (pagestore.py): by default ``f.ws`` holds
  a *manifest* — the ordered page indices mapped to content hashes — and
  the page bytes live once, fleet-wide, in the store directory's shared
  chunk store.  A re-record writes only the chunks the store doesn't
  already hold (delta), ``drop_record`` refcounts/GCs, and legacy flat WS
  files (or ``record_format="flat"``) still read through the
  :func:`_read_ws_flat` fallback seam.

Files for function ``f`` under ``store_dir``:
  ``f.mem`` + ``f.manifest.json``   guest memory file (arena.py)
  ``f.ws``                          WS manifest (v2) or flat pages (legacy)
  ``f.trace.npy``                   int64 page indices (original offsets)
  ``.pagestore/``                   shared content-addressed chunk store
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import numpy as np

from . import pagestore
from .arena import PAGE, GuestMemoryFile, InstanceArena, PageSource
from ..telemetry import TELEMETRY


@dataclasses.dataclass
class ReapConfig:
    o_direct: bool = True            # bypass page cache for the WS read
    parallel_faults: int = 0         # >1 => "Parallel PFs" design point
    use_ws_file: bool = True         # False => prefetch via per-page reads
    rerecord_threshold: float = 0.5  # residual faults / |WS| triggering re-record
    min_ws_read: int = 8 << 20       # single-read floor noted in §5.2.3 (bytes)
    share_ws_cache: bool = True      # dedupe concurrent WS reads process-wide
    fuse_engine: str = "auto"        # group-install gather: auto|numpy|cuda
    record_format: str = "cas"       # cas => content-addressed manifest;
    #                                  flat => legacy contiguous WS file
    # -- overlapped restore (serve from a hot prefix, install the tail in
    # the background).  Off by default so raw pipelines keep the PR-5
    # fully-resident-at-materialize contract; the serving layer's
    # ServeConfig flips it on as the recommended construction path.
    overlap_install: bool = False
    hot_prefix_frac: float = 0.125   # blind fallback when no cut point exists
    tail_workers: int = 2            # background tail-install pool size
    tail_deadline_s: float = 5.0     # straggler demotion to the disk-fault path


@dataclasses.dataclass
class StageTimings:
    """Per-stage wall-clock seconds of one restore pipeline run.

    ``ws_fetch_s + install_s`` is the paper's "prefetch" segment;
    ``materialize_s`` (param residency) only runs off-path (prewarms).
    With overlapped restore, ``install_s`` covers only the eager hot
    prefix; ``materialize_to_resident_s`` is the overlap window from
    materialize until the background tail made the arena fully resident,
    and ``tail_wait_s`` is the time faults spent blocked on the pending
    tail instead of going to disk.
    """
    load_vmm_s: float = 0.0
    connection_s: float = 0.0
    ws_fetch_s: float = 0.0
    install_s: float = 0.0
    materialize_s: float = 0.0
    materialize_to_resident_s: float = 0.0
    tail_wait_s: float = 0.0

    @property
    def prefetch_s(self) -> float:
        return self.ws_fetch_s + self.install_s

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ColdStartReport:
    """Per-invocation latency report, §4.2 split.

    ``stages`` is the source of truth for the restore-stage seconds (the
    same :class:`StageTimings` the pipeline produced); the historical flat
    names (``load_vmm_s``, ``connection_s``, ``prefetch_s``, ``install_s``)
    remain available as read-only compat properties.
    """
    queue_s: float = 0.0             # router queueing delay (pre-dispatch)
    stages: StageTimings = dataclasses.field(default_factory=StageTimings)
    processing_s: float = 0.0        # function execution (incl. demand faults)
    fault_s: float = 0.0             # portion of processing spent in faults
    n_faults: int = 0
    n_prefetched_pages: int = 0
    ws_bytes: int = 0
    ws_cache_hit: bool = False       # WS served from the shared page cache
    prewarmed: bool = False          # served by a pre-spawned warm instance
    batch_size: int = 1              # instances restored in this one's group
    tail_waits: int = 0              # faults that blocked on the pending tail

    # -- read-only compat properties over ``stages`` -------------------

    @property
    def load_vmm_s(self) -> float:
        return self.stages.load_vmm_s

    @property
    def connection_s(self) -> float:
        return self.stages.connection_s

    @property
    def prefetch_s(self) -> float:
        return self.stages.prefetch_s

    @property
    def install_s(self) -> float:
        return self.stages.install_s

    @property
    def tail_wait_s(self) -> float:
        return self.stages.tail_wait_s

    @property
    def total_s(self) -> float:
        """Cold-start latency as the paper measures it (excl. queueing)."""
        return (self.load_vmm_s + self.connection_s + self.prefetch_s
                + self.processing_s)

    @property
    def e2e_s(self) -> float:
        """Client-observed latency: queueing delay + cold start + run."""
        return self.queue_s + self.total_s


# Record-invalidation broadcast: a re-record (write_record) or record drop
# invalidates the process-wide WS_CACHE directly, but other caches may hold
# the stale WS too — the cluster's per-node L1s key by (base, mtime) and
# would only notice on their next fetch.  Listeners registered here are
# called with the base on every invalidation so a shard tier can push the
# drop to peer caches eagerly (snapstore.py).  Listener errors are swallowed:
# an observability hook must never fail a record write.
_INVALIDATION_LISTENERS: list = []


def register_invalidation_listener(fn) -> None:
    """``fn(base)`` is called on every ``write_record``/``drop_record``."""
    if fn not in _INVALIDATION_LISTENERS:
        _INVALIDATION_LISTENERS.append(fn)


def unregister_invalidation_listener(fn) -> None:
    if fn in _INVALIDATION_LISTENERS:
        _INVALIDATION_LISTENERS.remove(fn)


def _broadcast_invalidation(base: str) -> None:
    for fn in list(_INVALIDATION_LISTENERS):
        try:
            fn(base)
        except Exception:
            pass


def trace_path(base: str) -> str:
    return base + ".trace.npy"


def ws_path(base: str) -> str:
    return base + ".ws"


def cut_path(base: str) -> str:
    return base + ".cut.json"


def has_record(base: str) -> bool:
    return os.path.exists(trace_path(base)) and os.path.exists(ws_path(base))


def choose_hot_prefix(times: list[float], *,
                      lo_frac: float = 0.05, hi_frac: float = 0.9,
                      min_gap_s: float = 0.005) -> int | None:
    """Pick the hot-prefix cut point from recorded fault timestamps.

    The recorded trace interleaves two phases: a dense burst of boot/setup
    faults, then the execution-driven tail.  The cut is the largest
    inter-fault time gap (the boot→execution knee) searched inside
    ``[lo_frac, hi_frac]`` of the trace; returns the number of leading
    trace pages in the hot prefix, or ``None`` when no gap stands out
    (flat timing, or too few samples).  ``None`` means the timestamps
    carry no phase signal — callers fall back to the runtime
    ``hot_prefix_frac`` knob, which deliberately is NOT frozen into the
    persisted cut file at record time.
    """
    n = len(times)
    if n < 8:
        return None
    lo = max(1, int(n * lo_frac))
    hi = max(lo + 1, int(n * hi_frac))
    gaps = [(times[i] - times[i - 1], i) for i in range(lo, hi)]
    if not gaps:
        return None
    best_gap, best_i = max(gaps)
    # the baseline is the *other* gaps' median: including the winner in
    # its own baseline inflates the 8x bar on short traces (a handful of
    # gaps shift the median toward the knee itself) and suppresses
    # legitimate cuts
    others = sorted(g for g, i in gaps if i != best_i)
    threshold = min_gap_s
    if others:
        median = others[len(others) // 2]
        # a knee must dominate the typical inter-fault spacing AND be a
        # real phase boundary in absolute terms — a scheduler hiccup in a
        # microsecond-spaced record easily clears a relative-only bar and
        # would pin a spurious cut
        threshold = max(8 * median, min_gap_s)
    if best_gap < threshold:
        return None
    return best_i


def read_hot_prefix(base: str) -> int | None:
    """Recorded hot-prefix page count for ``base``, or None (no cut file)."""
    try:
        with open(cut_path(base)) as f:
            return int(json.loads(f.read())["hot_pages"])
    except (OSError, ValueError, KeyError):
        return None


# Record mutations for one base are serialized: two concurrent write_record
# calls would otherwise each read the same prior manifest and double-release
# its chunk refs — a chunk shared with a third live manifest could hit
# refcount zero and be GC'd while still referenced.  Bounded by the number
# of distinct recorded functions.
_RECORD_LOCKS: dict[str, threading.Lock] = {}
_RECORD_LOCKS_MU = threading.Lock()


def _record_lock(base: str) -> threading.Lock:
    with _RECORD_LOCKS_MU:
        return _RECORD_LOCKS.setdefault(base, threading.Lock())


def _sweep_tmp(base: str) -> int:
    """Remove crash leftovers of an interrupted ``write_record``: a failure
    between a ``.tmp`` write and its ``os.replace`` strands the temp file
    forever (nothing else ever matches its name).  Returns files removed.
    """
    removed = 0
    for p in (ws_path(base) + ".tmp",
              trace_path(base) + ".tmp.npy",
              cut_path(base) + ".tmp"):
        try:
            os.remove(p)
            removed += 1
        except OSError:
            pass
    return removed


def _write_ws_flat(base: str, pages: list[int], src: PageSource) -> None:
    """Legacy flat WS writer: contiguous page bytes in fault order.  Kept
    for the ``record_format="flat"`` baseline arm; with the REP007 seam
    :func:`_read_ws_flat` this is the only flat-file producer."""
    with open(ws_path(base) + ".tmp", "wb") as f:
        for p in pages:
            f.write(src.read_span(p * PAGE, PAGE))
    os.replace(ws_path(base) + ".tmp", ws_path(base))


def write_record(base: str, trace: list[int],
                 times: list[float] | None = None, *,
                 fmt: str = "cas") -> tuple[int, int]:
    """Persist the traced pages as a WS record + write the trace file.

    Returns (n_pages, ws_bytes).  Duplicates are dropped, order preserved
    (the order is the fault order -- §5.2.1).  When per-fault ``times``
    accompany the trace, the hot-prefix cut point (overlapped restore) is
    derived from the boot→execution timing knee and persisted alongside.

    ``fmt="cas"`` (default) writes a content-addressed manifest: page
    bytes are chunk-hashed into the store directory's shared
    :class:`~repro_torch.core.pagestore.PageStore`, so a re-record appends only
    chunks the store doesn't hold (delta) and identical pages across
    functions are stored once.  ``fmt="flat"`` keeps the legacy
    contiguous WS file.  ``ws_bytes`` is the logical WS size either way.
    """
    seen: set[int] = set()
    pages: list[int] = []
    page_times: list[float] = []
    for i, p in enumerate(trace):
        if p not in seen:
            seen.add(p)
            pages.append(p)
            if times is not None and i < len(times):
                page_times.append(times[i])
    arr = np.asarray(pages, dtype=np.int64)
    src = PageSource(base + ".mem", o_direct=False)
    try:
        with _record_lock(base):
            _sweep_tmp(base)
            prior = pagestore.read_manifest(ws_path(base))
            if fmt == "flat":
                _write_ws_flat(base, pages, src)
                if prior is not None:
                    # format downgrade: the flat file replaced a manifest,
                    # so its chunk refs must not pin store bytes forever
                    store = pagestore.get_store(os.path.dirname(base) or ".")
                    store.release_manifest(prior["chunks"])
            else:
                blocks: dict[str, bytes] = {}
                hashes: list[str] = []
                for p in pages:
                    blk = src.read_span(p * PAGE, PAGE)
                    h = pagestore.chunk_hash(blk)
                    hashes.append(h)
                    blocks.setdefault(h, blk)
                store = pagestore.get_store(os.path.dirname(base) or ".")
                store.commit_manifest(hashes, blocks,
                                      delta=prior is not None)
                pagestore.write_manifest(ws_path(base), pages, hashes)
                if prior is not None:
                    # release the superseded manifest's refs only now that
                    # f.ws durably points at the new one: a crash anywhere
                    # above leaves a readable record (old or new) and at
                    # worst a leaked incref, never a live manifest whose
                    # unique chunks were GC'd
                    store.release_manifest(prior["chunks"])
            np.save(trace_path(base) + ".tmp.npy", arr)
            os.replace(trace_path(base) + ".tmp.npy", trace_path(base))
            if len(page_times) == len(pages) and pages:
                cut = choose_hot_prefix(page_times)
                if cut is not None:
                    with open(cut_path(base) + ".tmp", "w") as f:
                        f.write(json.dumps({"hot_pages": cut,
                                            "n_pages": len(pages)}))
                    os.replace(cut_path(base) + ".tmp", cut_path(base))
                elif os.path.exists(cut_path(base)):
                    os.remove(cut_path(base))  # stale knee, prior record
        WS_CACHE.invalidate(base)  # a fresh record obsoletes cached WS pages
        _broadcast_invalidation(base)
    finally:
        src.close()
    return len(pages), len(pages) * PAGE


def drop_record(base: str) -> None:
    WS_CACHE.invalidate(base)
    _broadcast_invalidation(base)
    with _record_lock(base):
        _sweep_tmp(base)
        man = pagestore.read_manifest(ws_path(base))
        if man is not None:
            # release this manifest's chunk references; chunks shared with
            # other functions' manifests survive, orphans are GC'd
            store = pagestore.get_store(os.path.dirname(base) or ".")
            store.release_manifest(man["chunks"])
        for p in (trace_path(base), ws_path(base), cut_path(base)):
            if os.path.exists(p):
                os.remove(p)


def _read_ws_flat(base: str, cfg: ReapConfig,
                  k: int | None = None) -> tuple[list[int], bytes]:
    """Legacy flat-WS fallback seam: one O_DIRECT span read of a
    pre-manifest (or ``record_format="flat"``) WS file.  ``k`` limits the
    read to the first ``k`` fault-order pages (the file's head IS the hot
    prefix, §5.2.1).  This function and :class:`PageStore` internals are
    the only places allowed to read WS bytes directly (lint REP007)."""
    pages = np.load(trace_path(base))
    n = len(pages) if k is None else min(k, len(pages))
    src = PageSource(ws_path(base), o_direct=cfg.o_direct)
    try:
        data = src.read_span(0, n * PAGE)
    finally:
        src.close()
    return [int(p) for p in pages], data


def _read_ws(base: str, cfg: ReapConfig) -> tuple[list[int], bytes]:
    """Resolve the full WS: reassemble a v2 manifest from the shared
    chunk store (adjacent chunks coalesce back into span reads), or fall
    back to the flat reader for legacy files."""
    man = pagestore.read_manifest(ws_path(base))
    if man is None:
        return _read_ws_flat(base, cfg)
    pages = np.load(trace_path(base))
    chunks = man["chunks"]
    if len(chunks) != len(pages):
        raise RuntimeError(
            f"WS manifest/trace length mismatch for {base}: "
            f"{len(chunks)} chunks vs {len(pages)} trace pages")
    store = pagestore.get_store(os.path.dirname(base) or ".")
    try:
        data = store.read_chunks(chunks, o_direct=cfg.o_direct)
    except KeyError as e:
        # a concurrent §7.2 drop/re-record released the chunks under us;
        # surface the same signal a vanished flat file would
        raise FileNotFoundError(f"WS chunks for {base} dropped: {e}") from e
    return [int(p) for p in pages], data


def _read_ws_prefix(base: str, cfg: ReapConfig,
                    k: int) -> tuple[list[int], bytes]:
    """Read only the first ``k`` fault-order pages of the WS.

    The WS layout IS the fault order (§5.2.1), so the hot prefix of an
    overlapped restore is the manifest's (or flat file's) head — a short
    chunk-store read instead of the full reassembly.  Returns the FULL
    page-index list (the tail indices are needed for the pending-install
    markers) with data covering only the prefix."""
    man = pagestore.read_manifest(ws_path(base))
    if man is None:
        return _read_ws_flat(base, cfg, k)
    pages = np.load(trace_path(base))
    k = min(k, len(pages))
    store = pagestore.get_store(os.path.dirname(base) or ".")
    try:
        data = store.read_chunks(man["chunks"][:k], o_direct=cfg.o_direct)
    except KeyError as e:
        raise FileNotFoundError(f"WS chunks for {base} dropped: {e}") from e
    return [int(p) for p in pages], data


class WSCache:
    """Process-wide shared working-set page cache.

    N concurrent cold-starts of the same function perform exactly one
    underlying WS-file read: the first arrival becomes the *leader* and
    reads; followers block on its completion and install from memory.
    Entries are keyed by ``(base, mtime)`` so a re-record (new WS file)
    invalidates stale data; ``invalidate`` drops an entry eagerly.

    A per-base **generation counter** closes the invalidate-during-read
    race: a leader mid-``_read_ws`` must not re-insert its (possibly stale)
    entry after ``write_record``/``drop_record`` invalidated the base —
    that would resurrect dropped WS data under the old mtime.  The leader
    snapshots the generation before reading and discards its insert if an
    invalidation bumped it meanwhile (the caller still installs from the
    data it read; only the *cache entry* is suppressed).

    **Tiering hook**: ``source`` replaces the default origin-disk read
    (:func:`_read_ws`) with an arbitrary ``(base, cfg) -> (pages, data)``
    callable.  The cluster layer uses this to make a per-node cache
    *two-tier*: on a local miss, the node's source fetches the WS from its
    owner shard's cache over a modeled network instead of re-reading the
    origin disk (snapstore.py).  Single-flight still applies — concurrent
    local misses trigger exactly one source call.

    The cache is **bounded**: inserts beyond ``capacity_bytes`` evict LRU
    entries (``evicted`` stat), so a long fleet run over many functions
    cannot grow the cache without bound.

    **Chunk index**: every entry also carries its per-page content hashes
    (pagestore.py), maintained in a cross-entry refcount index so the
    shard tier can ask what this cache already holds *from any function*
    (:meth:`missing_chunks`) and ship only the missing chunks over the
    wire (:meth:`peek_chunks` on the serving side).
    """

    def __init__(self, capacity_bytes: int = 512 << 20, *,
                 source=None):
        self.capacity_bytes = capacity_bytes
        self.source = source             # None => origin-disk _read_ws
        self._lock = threading.Lock()
        # base -> (mtime, pages, data, per-page chunk hashes)
        self._entries: dict[str, tuple[float, list[int], bytes, list[str]]] = {}
        self._chunks: dict[str, int] = {}  # chunk hash -> #entries holding it
        self._inflight: dict[str, threading.Event] = {}
        self._gens: dict[str, int] = {}  # bumped by every invalidation
        self._order: list[str] = []      # LRU order, oldest first
        self._bytes = 0                  # running total of cached WS bytes
        self.hits = 0
        self.misses = 0
        self.reads = 0                   # underlying WS-file reads performed
        self.invalidations = 0
        self.discarded = 0               # inserts dropped: raced an invalidate
        self.evicted = 0                 # LRU entries dropped at capacity
        self.peek_hits = 0               # remote-peer serves via peek()
        self.group_fetches = 0           # fetches serving a restore group
        self.group_instances = 0         # instances amortized over those

    def _lru_touch(self, base: str) -> None:
        if base in self._order:
            self._order.remove(base)
        self._order.append(base)

    def _chunks_add(self, hashes: list[str]) -> None:
        for h in set(hashes):
            self._chunks[h] = self._chunks.get(h, 0) + 1

    def _chunks_sub(self, hashes: list[str]) -> None:
        for h in set(hashes):
            n = self._chunks.get(h, 0) - 1
            if n <= 0:
                self._chunks.pop(h, None)
            else:
                self._chunks[h] = n

    def _evict(self) -> None:
        # Never evict the newest entry: an entry larger than the whole
        # capacity must survive its own insert so concurrent followers can
        # still hit it (it becomes LRU-oldest and goes on the next insert).
        while self._bytes > self.capacity_bytes and len(self._order) > 1:
            victim = self._order.pop(0)
            _, _, data, hashes = self._entries.pop(victim)
            self._bytes -= len(data)
            self._chunks_sub(hashes)
            self.evicted += 1
            TELEMETRY.inc("ws_cache.evicted")

    def _call_source(self, base: str, cfg: ReapConfig, group: int):
        """Invoke the miss resolver, passing ``group`` through when the
        source accepts it (the shard tier counts once-per-group remote
        fetches); plain ``(base, cfg)`` sources keep working."""
        import inspect
        try:
            params = inspect.signature(self.source).parameters
            accepts = ("group" in params
                       or any(p.kind is p.VAR_KEYWORD
                              for p in params.values()))
        except (TypeError, ValueError):
            accepts = False
        if accepts:
            return self.source(base, cfg, group=group)
        return self.source(base, cfg)

    def fetch(self, base: str, cfg: ReapConfig,
              group: int = 1) -> tuple[list[int], bytes, bool]:
        """Return (pages, data, cache_hit) for ``base``'s WS file.

        ``group`` declares how many instance restores this one fetch will
        feed (a :class:`~repro_torch.core.restore.RestoreBatch` fetches once per
        group instead of once per instance) — it only affects accounting
        and is forwarded to a group-aware ``source``.
        """
        mtime = os.path.getmtime(ws_path(base))
        if group > 1:
            with self._lock:
                self.group_fetches += 1
                self.group_instances += group
        while True:
            with self._lock:
                ent = self._entries.get(base)
                if ent is not None and ent[0] == mtime:
                    self.hits += 1
                    self._lru_touch(base)
                    TELEMETRY.inc("ws_cache.hits")
                    return ent[1], ent[2], True
                ev = self._inflight.get(base)
                if ev is None:
                    # become the leader for this (base, mtime)
                    ev = threading.Event()
                    self._inflight[base] = ev
                    self.misses += 1
                    TELEMETRY.inc("ws_cache.misses")
                    gen = self._gens.get(base, 0)
                    break
            # follower: wait for the leader's read, then re-check the entry
            ev.wait()
        try:
            pages, data = (_read_ws(base, cfg) if self.source is None
                           else self._call_source(base, cfg, group))
            hashes = pagestore.page_hashes(data)  # outside the lock
            with self._lock:
                self.reads += 1
                if self._gens.get(base, 0) == gen:
                    old = self._entries.get(base)
                    if old is not None:
                        self._bytes -= len(old[2])
                        self._chunks_sub(old[3])
                    self._entries[base] = (mtime, pages, data, hashes)
                    self._bytes += len(data)
                    self._chunks_add(hashes)
                    self._lru_touch(base)
                    self._evict()
                else:
                    self.discarded += 1  # invalidated mid-read: don't resurrect
            return pages, data, False
        finally:
            with self._lock:
                self._inflight.pop(base, None)
                self._gens.pop(base, None)  # no leader left holding a snapshot
            ev.set()

    def contains(self, base: str) -> bool:
        """Residency probe (no disk I/O, no LRU touch): is a WS entry for
        ``base`` cached?  The cluster scheduler scores placement locality
        with this; a stale-mtime entry answering True merely costs one
        fresh read on the placed node, so staleness is acceptable here."""
        with self._lock:
            return base in self._entries

    def peek(self, base: str, *,
             count: bool = True) -> tuple[list[int], bytes] | None:
        """Serve ``base`` from a *completed* entry or return None — never
        joins an in-flight read and never triggers one.  This is the
        cluster shard tier's remote-serve primitive: a peer peeking an
        owner's cache can't block on the owner's single-flight event, so
        cross-node cache waits (and therefore cross-cache deadlock) are
        impossible by construction.  Freshness is still mtime-checked.

        ``count=False`` makes the probe stat-silent — the overlapped
        restore path peeks to decide whether to split its fetch and then
        fetches anyway on a hit, which would otherwise double-count."""
        served = self.peek_chunks(base, count=count)
        if served is None:
            return None
        pages, data, _hashes = served
        return pages, data

    def peek_chunks(self, base: str, *, count: bool = True
                    ) -> tuple[list[int], bytes, list[str]] | None:
        """:meth:`peek` plus the entry's per-page chunk hashes — the shard
        tier serves a peer from this and charges the transfer only for
        the chunks the *requester's* cache is missing."""
        try:
            mtime = os.path.getmtime(ws_path(base))
        except OSError:
            return None                  # record dropped: nothing to serve
        with self._lock:
            ent = self._entries.get(base)
            if ent is None or ent[0] != mtime:
                return None
            if count:
                # counted apart from hits/misses: a peek serves a *peer*,
                # and folding it into hits would inflate this node's local
                # hit rate
                self.peek_hits += 1
                TELEMETRY.inc("ws_cache.peek_hits")
            self._lru_touch(base)
            return ent[1], ent[2], ent[3]

    def missing_chunks(self, hashes) -> set[str]:
        """Subset of ``hashes`` held by NO cached entry — of *any*
        function (cross-function wire dedup: a chunk cached here under
        one function's WS need not be shipped again for another's)."""
        with self._lock:
            return {h for h in set(hashes) if h not in self._chunks}

    def chunk_index(self) -> set[str]:
        """Every chunk hash any cached entry holds — the L1 index digest
        a transport requester sends so the responder ships only what is
        actually missing here (wire.py negotiation)."""
        with self._lock:
            return set(self._chunks)

    def chunk_payloads(self, hashes) -> dict[str, bytes]:
        """Resolve held chunk hashes to their page bytes (best effort:
        hashes evicted since :meth:`chunk_index` are simply absent).
        The transport client reassembles a negotiated fetch from this —
        chunks the responder skipped because our digest covered them."""
        want = set(hashes)
        out: dict[str, bytes] = {}
        with self._lock:
            for _mtime, _pages, data, entry_hashes in self._entries.values():
                if not want:
                    break
                for i, h in enumerate(entry_hashes):
                    if h in want:
                        out[h] = data[i * pagestore.PAGE:
                                      (i + 1) * pagestore.PAGE]
                        want.discard(h)
        return out

    def invalidate(self, base: str) -> bool:
        """Drop ``base``'s entry; True when an entry was actually held (the
        shard tier counts eager peer drops with this)."""
        with self._lock:
            if base in self._inflight:
                # only an in-flight leader holds a generation snapshot, so
                # only then does a bump matter — this keeps _gens bounded by
                # the number of concurrent reads instead of growing with
                # every base ever invalidated
                self._gens[base] = self._gens.get(base, 0) + 1
            dropped = self._entries.pop(base, None)
            if dropped is not None:
                self._bytes -= len(dropped[2])
                self._chunks_sub(dropped[3])
                self.invalidations += 1
                TELEMETRY.inc("ws_cache.invalidations")
            if base in self._order:
                self._order.remove(base)
            return dropped is not None

    def clear(self) -> None:
        with self._lock:
            for base in self._inflight:
                self._gens[base] = self._gens.get(base, 0) + 1
            self._entries.clear()
            self._chunks.clear()
            self._order.clear()
            self._bytes = 0

    def reset_stats(self) -> None:
        with self._lock:
            self.hits = self.misses = self.reads = 0
            self.invalidations = self.discarded = self.evicted = 0
            self.peek_hits = 0
            self.group_fetches = self.group_instances = 0

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "reads": self.reads, "invalidations": self.invalidations,
                    "discarded": self.discarded, "evicted": self.evicted,
                    "peek_hits": self.peek_hits,
                    "group_fetches": self.group_fetches,
                    "group_instances": self.group_instances,
                    "entries": len(self._entries), "bytes": self._bytes,
                    "chunks": len(self._chunks)}


#: Process-wide singleton (the orchestrator's host-level page cache analogue).
WS_CACHE = WSCache()


def prefetch(arena: InstanceArena, base: str, cfg: ReapConfig) -> tuple[int, float]:
    """REAP prefetch phase: fetch WS with one read, eagerly install.

    Always performs the underlying read (no sharing) — this is the raw
    phase primitive the step benchmarks time.  Returns (n_pages, seconds).
    """
    t0 = time.perf_counter()
    if cfg.use_ws_file:
        pages, data = _read_ws(base, cfg)
        arena.install_span(pages, data)
    else:
        # "Parallel PFs" design point: trace known, but pages still read from
        # the (scattered) guest memory file
        pages = [int(p) for p in np.load(trace_path(base))]
        arena.touch_pages(pages, parallel=max(cfg.parallel_faults, 1))
    return len(pages), time.perf_counter() - t0


def prefetch_shared(arena: InstanceArena, base: str, cfg: ReapConfig,
                    cache: WSCache | None = None) -> tuple[int, float, bool]:
    """Cache-aware prefetch used by the serving data plane.

    Concurrent cold-starts of the same function share one WS read through
    ``cache`` (default: the process-wide :data:`WS_CACHE`; the cluster
    layer passes each node's own two-tier cache).  Returns
    (n_pages, seconds, ws_cache_hit).
    """
    if not (cfg.use_ws_file and cfg.share_ws_cache):
        n, secs = prefetch(arena, base, cfg)
        return n, secs, False
    t0 = time.perf_counter()
    pages, data, hit = (cache or WS_CACHE).fetch(base, cfg)
    arena.install_span(pages, data)
    return len(pages), time.perf_counter() - t0, hit


class Monitor:
    """Per-instance monitor thread analogue (§5.2): owns the arena, records
    or prefetches, and serves residual faults.  In-process (goroutine ->
    Python object whose fault service runs on the caller thread; I/O releases
    the GIL so concurrent instances overlap, cf. Fig. 9)."""

    def __init__(self, gm: GuestMemoryFile, base: str, cfg: ReapConfig,
                 *, mode: str | None = None, cache: WSCache | None = None):
        """``mode``: None => auto (prefetch if a record exists, else record);
        'vanilla' => ignore records, serve every page as a demand fault.
        ``cache``: WS page cache for the prefetch (None => process-wide
        :data:`WS_CACHE`; cluster nodes pass their own tiered cache)."""
        self.gm = gm
        self.base = base
        self.cfg = cfg
        self.cache = cache
        self.arena = InstanceArena(gm, o_direct=cfg.o_direct)
        self.mode = mode or ("prefetch" if has_record(base) else "record")
        if self.mode == "record":
            # record-open hygiene: a crash between a prior recorder's
            # .tmp write and its os.replace strands temp files next to
            # the record; sweep them before producing fresh ones
            _sweep_tmp(base)
        self.prefetched = 0
        self.prefetch_s = 0.0
        self.ws_cache_hit = False

    @property
    def mode(self) -> str:
        return self._mode

    @mode.setter
    def mode(self, m: str) -> None:
        # the §6 recorder is the only consumer of the full fault trace —
        # outside record mode the arena stops accumulating it, so a
        # long-serving prefetch/vanilla instance can't grow it unboundedly
        self._mode = m
        self.arena.record_trace = (m == "record")

    def start(self) -> None:
        if self.mode == "prefetch":
            try:
                self.prefetched, self.prefetch_s, self.ws_cache_hit = (
                    prefetch_shared(self.arena, self.base, self.cfg,
                                    self.cache))
            except FileNotFoundError:
                # a concurrent §7.2 re-record dropped the WS/trace files
                # between mode selection and this prefetch: record afresh
                # instead of failing the invocation
                self.mode = "record"

    def finish(self) -> dict:
        """Called when the orchestrator receives the function response."""
        stats = self.arena.stats
        out = {
            "mode": self.mode,
            "n_faults": stats.n_faults,
            "fault_s": stats.fault_seconds,
            "prefetched_pages": self.prefetched,
            "prefetch_s": self.prefetch_s,
            "resident_bytes": self.arena.resident_bytes,
        }
        if self.mode == "record":
            n, nbytes = write_record(self.base, stats.trace, stats.trace_t,
                                     fmt=self.cfg.record_format)
            out["ws_pages"] = n
            out["ws_bytes"] = nbytes
        elif self.prefetched:
            # disk faults caused by a demoted (straggling) tail install are
            # prefetch pages the record *did* predict — counting them as
            # residual mispredictions would trigger §7.2 re-record storms
            residual = (max(stats.n_faults - stats.tail_demoted, 0)
                        / max(self.prefetched, 1))
            out["residual_ratio"] = residual
            if residual > self.cfg.rerecord_threshold:
                drop_record(self.base)  # §7.2 fallback: re-record next time
                out["rerecord"] = True
        return out
