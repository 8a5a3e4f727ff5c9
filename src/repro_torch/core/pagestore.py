"""Content-addressed page store: fleet-wide WS chunk dedup (ROADMAP item 2).

The 12 model configs share one runtime, so their recorded working sets
share pages — yet the flat REAP layout stores and ships every function's
full WS file.  This module turns the WS record into a *manifest* (ordered
page indices -> content hashes) over a **content-addressed chunk store**:

* **Chunking**: 1 chunk == 1 arena page (``PAGE`` bytes).  The WS file's
  natural granularity *is* the page — the fault trace, the install path
  and the shard transfer all already move page multiples, so page-sized
  chunks dedup exactly the unit everything else reasons about.
* **Hashing**: ``blake2b(digest_size=16)`` over the raw page bytes.
  128-bit digests make accidental collisions negligible at fleet scale
  (birthday bound ~2^64 chunks) while keeping manifests compact.
* **Store layout** (one per snapshot-store directory, shared by every
  function recorded under it)::

      <store_dir>/.pagestore/chunks.data   packed unique chunks, appended
      <store_dir>/.pagestore/index.json    hash -> [offset, refcount]

* **Delta re-records**: a §7.2 re-record only appends chunks absent from
  the store; unchanged pages are pure refcount traffic (``dedup_hits``).
* **GC**: manifests refcount their unique chunks.  ``release_manifest``
  (``drop_record``) decrefs; a chunk hitting zero is dropped from the
  index and its bytes become dead.  Compaction rewrites ``chunks.data``
  with live chunks only once dead bytes dominate.

Concurrency contract (keeps the static lock analyzer clean):

* ``_mu`` guards the in-memory index/cache/stat maps and is never held
  across file I/O.
* ``_write_mu`` serializes mutators (append, refcount commit, index
  persist, compaction swap); reads never take it.
* Reads are single-flight per chunk (WSCache's leader/follower pattern):
  concurrent cold-starts of two functions sharing chunks perform one
  underlying read per unique chunk, and adjacent chunks coalesce into
  span reads (a fresh record's chunks are contiguous, so its first cold
  read stays one large ``preadv``).
* Compaction is optimistic: it snapshots, rewrites outside the locks and
  commits only if no writer raced it (generation check), so it never
  holds a lock across the bulk copy.
"""
from __future__ import annotations

import hashlib
import json
import mmap
import os
import threading
import weakref

from .arena import PAGE
from ..telemetry import TELEMETRY

#: Magic prefix distinguishing a v2 manifest from a legacy flat WS file.
#: A flat file holds raw page bytes; the probability of page 0 starting
#: with this exact string is negligible, and the legacy reader is still
#: reachable for any non-matching file.
WS_MAGIC = b"REAPWS2\n"

WS_FORMAT_VERSION = 2


def chunk_hash(block: bytes) -> str:
    """Content hash of one page-sized chunk (blake2b-128 hex)."""
    return hashlib.blake2b(block, digest_size=16).hexdigest()


def page_hashes(data: bytes) -> list[str]:
    """Hash ``data`` page by page (``len(data)`` must be a PAGE multiple;
    a trailing partial page — never produced by the record path — is
    hashed as its own short chunk rather than silently dropped)."""
    return [chunk_hash(data[off:off + PAGE])
            for off in range(0, len(data), PAGE)]


# -- manifest file format ------------------------------------------------

def read_manifest(path: str) -> dict | None:
    """Parse a v2 WS manifest at ``path``.

    Returns ``None`` for a legacy flat WS file, a missing file, or
    unparseable contents — callers fall back to the flat reader (which
    surfaces the usual ``FileNotFoundError`` for missing records).
    """
    try:
        with open(path, "rb") as f:
            head = f.read(len(WS_MAGIC))
            if head != WS_MAGIC:
                return None
            doc = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError):
        return None
    if doc.get("version") != WS_FORMAT_VERSION:
        return None
    return doc


def write_manifest(path: str, pages: list[int], chunks: list[str],
                   *, page_size: int = PAGE) -> int:
    """Atomically write a v2 manifest (tmp + ``os.replace``); returns the
    manifest byte size.  The ordered ``pages``/``chunks`` pair IS the WS:
    reassembly concatenates the chunks in this order."""
    doc = {"version": WS_FORMAT_VERSION, "page": page_size,
           "n_pages": len(pages), "pages": [int(p) for p in pages],
           "chunks": list(chunks)}
    blob = WS_MAGIC + json.dumps(doc).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return len(blob)


def _close_fds(fds: list[int]) -> None:
    while fds:
        try:
            os.close(fds.pop())
        except OSError:
            pass


class PageStore:
    """One content-addressed chunk store (use :func:`get_store`)."""

    def __init__(self, store_dir: str, *,
                 cache_bytes: int = 64 << 20,
                 compact_min_bytes: int = 4 << 20):
        self.root = os.path.join(store_dir, ".pagestore")
        os.makedirs(self.root, exist_ok=True)
        self.data_path = os.path.join(self.root, "chunks.data")
        self.index_path = os.path.join(self.root, "index.json")
        self.cache_capacity = cache_bytes
        self.compact_min_bytes = compact_min_bytes
        self._mu = threading.Lock()        # index/cache/stats; no I/O under it
        self._write_mu = threading.Lock()  # serializes mutators; outer lock
        self._fds: list[int] = []          # open data fds (close()/finalize)
        self._fd = os.open(self.data_path, os.O_RDWR | os.O_CREAT, 0o644)
        self._fds.append(self._fd)
        self._fd_gen = 0                   # bumped when compaction swaps fds
        self._gen_readers: dict[int, int] = {}   # fd gen -> active readers
        self._retired_fds: dict[int, list[int]] = {}  # fd gen -> close pending
        # a SEPARATE O_DIRECT read fd: setting the flag on a dup of the
        # write fd would poison it too (dup'd fds share the open file
        # description), making every later unaligned pwrite fail EINVAL
        self._dfd = self._open_direct()
        weakref.finalize(self, _close_fds, self._fds)
        self._index: dict[str, list[int]] = {}   # hash -> [offset, refcount]
        self._data_end = 0
        self._dead_bytes = 0
        self._logical_bytes = 0            # sum of manifest WS sizes (flat-equiv)
        self._manifests = 0
        self._gen = 0                      # bumped by every mutator (compaction)
        self._cache: dict[str, bytes] = {}  # chunk LRU (insertion-ordered)
        self._cache_bytes = 0
        self._inflight: dict[str, threading.Event] = {}
        self.chunk_writes = 0              # unique chunks appended
        self.dedup_hits = 0                # chunks already present at write
        self.delta_chunks = 0              # new chunks written by re-records
        self.chunk_reads = 0               # chunks read from the data file
        self.span_reads = 0                # coalesced preadv calls issued
        self.cache_hits = 0
        self.cache_evicted = 0
        self.gc_freed = 0                  # chunks dropped at refcount zero
        self.compactions = 0
        self._load_index()

    def _open_direct(self) -> int | None:
        """O_DIRECT read fd on the current data file, or ``None`` when the
        flag or filesystem refuses (reads fall back to the buffered fd).
        Tracked in ``_fds`` so close()/finalize reap it."""
        if not hasattr(os, "O_DIRECT"):    # pragma: no cover - non-Linux
            return None
        try:
            dfd = os.open(self.data_path, os.O_RDONLY | os.O_DIRECT)
        except OSError:
            return None
        self._fds.append(dfd)
        return dfd

    # -- persistence ----------------------------------------------------

    def _load_index(self) -> None:
        try:
            with open(self.index_path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return
        self._index = {h: [int(off), int(refs)]
                       for h, (off, refs) in doc.get("chunks", {}).items()}
        self._data_end = int(doc.get("data_end", 0))
        self._dead_bytes = int(doc.get("dead_bytes", 0))
        self._logical_bytes = int(doc.get("logical_bytes", 0))
        self._manifests = int(doc.get("manifests", 0))

    def _persist_index(self) -> None:
        """Atomic index snapshot (caller holds ``_write_mu``)."""
        with self._mu:
            doc = {"chunks": {h: [off, refs]
                              for h, (off, refs) in self._index.items()},
                   "data_end": self._data_end,
                   "dead_bytes": self._dead_bytes,
                   "logical_bytes": self._logical_bytes,
                   "manifests": self._manifests}
        blob = json.dumps(doc).encode("utf-8")
        tmp = self.index_path + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.write(fd, blob)
        finally:
            os.close(fd)
        os.replace(tmp, self.index_path)

    # -- write path -----------------------------------------------------

    def commit_manifest(self, hashes: list[str],
                        blocks: dict[str, bytes],
                        *, delta: bool = False) -> tuple[int, int]:
        """Atomically publish one manifest's chunks: append the chunks the
        store doesn't hold and incref every unique chunk, write + incref
        in one mutator step so a concurrent ``release_manifest`` of a
        sharing function can never GC a chunk between the two.  A delta
        re-record (``delta=True``, counted as ``delta_chunks``) must
        release the superseded manifest's refs via ``release_manifest``
        only AFTER its own manifest pointer is durable on disk — a crash
        in between then leaves a readable record and at worst a leaked
        incref, never a live manifest whose chunks were GC'd.

        Returns ``(n_new, n_dedup)``: chunks appended vs already present.
        """
        uniq = list(dict.fromkeys(hashes))
        with self._write_mu:
            with self._mu:
                new = [h for h in uniq if h not in self._index]
                off = self._data_end
                offsets = {}
                for h in new:
                    offsets[h] = off
                    off += PAGE
                fd = self._fd
            for h in new:
                blk = blocks[h]
                if len(blk) != PAGE:
                    raise ValueError(
                        f"chunk {h} is {len(blk)} bytes, want {PAGE}")
                os.pwrite(fd, blk, offsets[h])
            with self._mu:
                for h in new:
                    self._index[h] = [offsets[h], 0]
                self._data_end = off
                for h in uniq:
                    self._index[h][1] += 1
                self._logical_bytes += len(hashes) * PAGE
                self._manifests += 1
                self._gen += 1
                self.chunk_writes += len(new)
                self.dedup_hits += len(uniq) - len(new)
                if delta:
                    self.delta_chunks += len(new)
            TELEMETRY.inc("pagestore.chunk_writes", len(new))
            TELEMETRY.inc("pagestore.dedup_hits", len(uniq) - len(new))
            self._persist_index()
        return len(new), len(uniq) - len(new)

    def _release_locked(self, hashes: list[str]) -> int:
        """Decref one manifest's unique chunks (caller holds ``_mu``)."""
        freed = 0
        for h in dict.fromkeys(hashes):
            ent = self._index.get(h)
            if ent is None:
                continue                 # already freed (double release)
            ent[1] -= 1
            if ent[1] <= 0:
                del self._index[h]
                self._dead_bytes += PAGE
                blk = self._cache.pop(h, None)
                if blk is not None:
                    self._cache_bytes -= len(blk)
                freed += 1
        self._logical_bytes = max(self._logical_bytes - len(hashes) * PAGE, 0)
        self._manifests = max(self._manifests - 1, 0)
        self.gc_freed += freed
        return freed

    def release_manifest(self, hashes: list[str]) -> int:
        """Drop one manifest's references (``drop_record``).  Chunks still
        referenced by any other manifest survive; orphans are GC'd.
        Returns the number of chunks freed."""
        with self._write_mu:
            with self._mu:
                freed = self._release_locked(hashes)
                if freed:
                    self._gen += 1
            self._persist_index()
        if freed:
            TELEMETRY.inc("pagestore.gc_freed", freed)
            self._maybe_compact()
        return freed

    # -- read path ------------------------------------------------------

    def contains(self, h: str) -> bool:
        with self._mu:
            return h in self._index

    def missing(self, hashes) -> set[str]:
        """Subset of ``hashes`` the store does not hold."""
        with self._mu:
            return {h for h in set(hashes) if h not in self._index}

    def read_chunks(self, hashes: list[str], *,
                    o_direct: bool = False) -> bytes:
        """Reassemble ``b"".join(chunk bytes in hash order)``.

        Single-flight per chunk: concurrent readers sharing chunks elect
        one leader per missing chunk; followers block on its completion
        and serve from the chunk cache.  Adjacent store offsets coalesce
        into one span read, so a fresh (contiguous) record costs one
        large read just like the flat WS file did.
        """
        out: dict[str, bytes] = {}
        pending = list(dict.fromkeys(hashes))
        while pending:
            waits: list[threading.Event] = []
            rest: list[str] = []
            claimed: list[tuple[str, int]] = []
            missing: str | None = None
            with self._mu:
                for h in pending:
                    blk = self._cache.get(h)
                    if blk is not None:
                        del self._cache[h]       # LRU touch: reinsert last
                        self._cache[h] = blk
                        self.cache_hits += 1
                        out[h] = blk
                        continue
                    ev = self._inflight.get(h)
                    if ev is not None:
                        waits.append(ev)
                        rest.append(h)
                        continue
                    ent = self._index.get(h)
                    if ent is None:
                        missing = h
                        break
                    self._inflight[h] = threading.Event()
                    claimed.append((h, ent[0]))
                if missing is not None:
                    # the raise must not strand this pass's claims: no
                    # waiter can have seen them yet (registered under this
                    # same lock hold), so pop + set before surfacing
                    for ch, _ in claimed:
                        ev = self._inflight.pop(ch, None)
                        if ev is not None:
                            ev.set()
                    raise KeyError(f"chunk {missing} not in page store")
                if claimed:
                    fd, dfd, fgen = self._acquire_read_locked()
            if claimed:
                try:
                    offs = [off for _, off in claimed]
                    blks = self._read_offsets(fd, offs, o_direct, dfd=dfd)
                    with self._mu:
                        for (h, _), blk in zip(claimed, blks):
                            out[h] = blk
                            self._cache_put(h, blk)
                        self.chunk_reads += len(claimed)
                finally:
                    self._release_read(fgen)
                    with self._mu:
                        events = [self._inflight.pop(h, None)
                                  for h, _ in claimed]
                    for ev in events:
                        if ev is not None:
                            ev.set()
            for ev in waits:
                ev.wait()
            pending = rest
        return b"".join(out[h] for h in hashes)

    def _acquire_read_locked(self) -> tuple[int, int | None, int]:
        """Snapshot ``(fd, dfd, fd-generation)`` for a read and pin the
        generation: a concurrent compaction swap defers closing the
        retired fds until the last pinned reader releases (caller holds
        ``_mu``)."""
        g = self._fd_gen
        self._gen_readers[g] = self._gen_readers.get(g, 0) + 1
        return self._fd, self._dfd, g

    def _release_read(self, gen: int) -> None:
        """Unpin one read of fd generation ``gen``; the last reader of a
        retired generation closes its fds (bounding open fds at two per
        *live* generation instead of two per compaction ever run)."""
        close: list[int] = []
        with self._mu:
            n = self._gen_readers.get(gen, 0) - 1
            if n > 0:
                self._gen_readers[gen] = n
            else:
                self._gen_readers.pop(gen, None)
                close = self._retired_fds.pop(gen, [])
                for fd in close:
                    try:
                        self._fds.remove(fd)
                    except ValueError:
                        pass
        for fd in close:
            try:
                os.close(fd)
            except OSError:
                pass

    def _cache_put(self, h: str, blk: bytes) -> None:
        # caller holds _mu; never evict the entry just inserted
        if h in self._cache:
            return
        self._cache[h] = blk
        self._cache_bytes += len(blk)
        while self._cache_bytes > self.cache_capacity and len(self._cache) > 1:
            victim = next(iter(self._cache))
            self._cache_bytes -= len(self._cache.pop(victim))
            self.cache_evicted += 1

    def _read_offsets(self, fd: int, offsets: list[int],
                      o_direct: bool, dfd: int | None = None) -> list[bytes]:
        """Read one PAGE chunk per offset, coalescing adjacent offsets
        into span reads.  Runs outside every store lock.  ``dfd`` is the
        dedicated O_DIRECT fd snapshotted with ``fd`` (same data-file
        generation): offsets, lengths and the anonymous-mmap buffer are
        all PAGE-aligned, and a refusal mid-read falls back to the
        buffered fd for that span."""
        order = sorted(set(offsets))
        runs: list[list[int]] = []       # [start, n_pages]
        for off in order:
            if runs and off == runs[-1][0] + runs[-1][1] * PAGE:
                runs[-1][1] += 1
            else:
                runs.append([off, 1])
        rfd = dfd if (o_direct and dfd is not None) else fd
        blocks: dict[int, bytes] = {}
        for start, n in runs:
            n_bytes = n * PAGE
            buf = mmap.mmap(-1, n_bytes)
            mv = memoryview(buf)
            got = 0
            while got < n_bytes:
                try:
                    r = os.preadv(rfd, [mv[got:]], start + got)
                except OSError:
                    if rfd == fd:
                        mv.release()
                        buf.close()
                        raise
                    rfd = fd             # O_DIRECT refused: go buffered
                    continue
                if r <= 0:
                    # EOF mid-span == truncated/corrupt data file; silently
                    # serving the rest of the anonymous mmap would restore
                    # zero-filled guest memory
                    mv.release()
                    buf.close()
                    raise IOError(
                        f"short read in {self.data_path}: wanted "
                        f"{n_bytes} bytes at offset {start}, got {got}")
                got += r
            for i in range(n):
                blocks[start + i * PAGE] = bytes(
                    mv[i * PAGE:(i + 1) * PAGE])
            mv.release()
            buf.close()
        with self._mu:
            self.span_reads += len(runs)
        return [blocks[off] for off in offsets]

    # -- compaction -----------------------------------------------------

    def _should_compact(self) -> bool:
        with self._mu:
            live = len(self._index) * PAGE
            return (self._dead_bytes >= self.compact_min_bytes
                    and self._dead_bytes > live)

    def _maybe_compact(self) -> None:
        if self._should_compact():
            self.compact()

    def compact(self) -> bool:
        """Rewrite ``chunks.data`` with live chunks only.  Optimistic: the
        bulk copy runs outside the locks; the swap commits only when no
        writer raced it (generation check), else it retries.  Readers
        mid-flight keep their pinned snapshot fds; the retired generation
        is closed as soon as its last reader releases."""
        for _ in range(4):
            with self._mu:
                snap = sorted((off, h)
                              for h, (off, _refs) in self._index.items())
                gen = self._gen
                fd, _dfd, fgen = self._acquire_read_locked()
            try:
                blks = (self._read_offsets(fd, [off for off, _ in snap],
                                           False)
                        if snap else [])
            finally:
                self._release_read(fgen)
            tmp = self.data_path + ".tmp"
            tfd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            new_off: dict[str, int] = {}
            pos = 0
            try:
                for (_, h), blk in zip(snap, blks):
                    os.pwrite(tfd, blk, pos)
                    new_off[h] = pos
                    pos += PAGE
            finally:
                os.close(tfd)
            with self._write_mu:
                to_close: list[int] = []
                with self._mu:
                    if self._gen != gen:
                        raced = True
                    else:
                        raced = False
                        os.replace(tmp, self.data_path)
                        old_fds = [f for f in (self._fd, self._dfd)
                                   if f is not None]
                        nfd = os.open(self.data_path, os.O_RDWR)
                        self._fds.append(nfd)
                        self._fd = nfd
                        self._dfd = self._open_direct()
                        # retire the old generation: readers mid-flight
                        # pinned it and the last _release_read closes it;
                        # with no pinned reader it closes right here
                        old_gen = self._fd_gen
                        self._fd_gen += 1
                        if self._gen_readers.get(old_gen):
                            self._retired_fds[old_gen] = old_fds
                        else:
                            to_close = old_fds
                            for f in to_close:
                                try:
                                    self._fds.remove(f)
                                except ValueError:
                                    pass
                        for h, noff in new_off.items():
                            self._index[h][0] = noff
                        self._data_end = pos
                        self._dead_bytes = 0
                        self.compactions += 1
                for f in to_close:
                    try:
                        os.close(f)
                    except OSError:
                        pass
                if not raced:
                    self._persist_index()
                    TELEMETRY.inc("pagestore.compactions")
                    return True
            try:
                os.remove(tmp)           # raced a writer: retry fresh
            except OSError:
                pass
        return False

    # -- stats / lifecycle ----------------------------------------------

    def reset_stats(self) -> None:
        with self._mu:
            self.chunk_writes = self.dedup_hits = self.delta_chunks = 0
            self.chunk_reads = self.span_reads = 0
            self.cache_hits = self.cache_evicted = 0
            self.gc_freed = self.compactions = 0

    def stats(self) -> dict:
        with self._mu:
            store_bytes = len(self._index) * PAGE
            logical = self._logical_bytes
            return {
                "chunks": len(self._index),
                "manifests": self._manifests,
                "store_bytes": store_bytes,          # live chunk bytes
                "data_bytes": self._data_end,        # file incl. dead bytes
                "dead_bytes": self._dead_bytes,
                "logical_bytes": logical,            # flat-file equivalent
                "dedup_ratio": (logical / store_bytes if store_bytes
                                else 1.0),
                "chunk_writes": self.chunk_writes,
                "dedup_hits": self.dedup_hits,
                "delta_chunks": self.delta_chunks,
                "chunk_reads": self.chunk_reads,
                "span_reads": self.span_reads,
                "cache_hits": self.cache_hits,
                "cache_evicted": self.cache_evicted,
                "cache_bytes": self._cache_bytes,
                "gc_freed": self.gc_freed,
                "compactions": self.compactions,
            }

    def close(self) -> None:
        with self._mu:
            self._cache.clear()
            self._cache_bytes = 0
            # _close_fds owns every remaining fd now; a straggling
            # _release_read must not close (possibly reused) fd numbers
            self._retired_fds.clear()
            self._gen_readers.clear()
        _close_fds(self._fds)


# -- process-wide registry ----------------------------------------------

_STORES: dict[str, PageStore] = {}
_STORES_MU = threading.Lock()


def get_store(store_dir: str) -> PageStore:
    """The (process-wide) PageStore for a snapshot-store directory.  All
    functions recorded under one directory share one chunk store — that
    sharing IS the cross-function dedup."""
    key = os.path.realpath(store_dir)
    with _STORES_MU:
        store = _STORES.get(key)
    if store is not None:
        return store
    # construct outside the registry lock (init reads the persisted
    # index); a racing constructor loses setdefault and is discarded
    store = PageStore(key)
    with _STORES_MU:
        winner = _STORES.setdefault(key, store)
    if winner is not store:
        store.close()
    return winner


def reset_stores() -> None:
    """Close and forget every registered store (test isolation; persisted
    index/data files survive, so a later get_store() reloads them)."""
    with _STORES_MU:
        stores = list(_STORES.values())
        _STORES.clear()
    for s in stores:
        s.close()
