"""Guest-memory-file analogue: a flat, page-aligned snapshot arena.

The paper's Firecracker snapshot maps a *guest memory file* and lazily
faults 4 KB pages from disk.  Here the "guest memory" of an ML function
instance is the flat byte arena holding every tensor of the booted instance
(serving weights, embedding tables, expert banks, runtime/infra tables, and
-- for instances deployed from training checkpoints -- master weights and
optimizer moments, which are *boot-only* state never touched at serve time).

Tensors are laid out back-to-back at PAGE-aligned offsets; a JSON manifest
maps tensor path -> (offset, shape, dtype).  The :class:`InstanceArena` is
the demand-paged in-memory image: first touch of a page triggers a "fault"
serviced by a monitor (serial 4 KB O_DIRECT reads -- the vanilla-snapshot
baseline), mirroring userfaultfd semantics at framework level
(DESIGN.md §3).

This is the JAX package's arena, byte for byte: the layout sizes dtypes
from the port's own itemsize table (no ``ml_dtypes`` here), and
:meth:`InstanceArena.tensor` returns a zero-copy CPU ``torch`` tensor over
the arena bytes (bfloat16 viewed through its ``uint16`` storage).
"""
from __future__ import annotations

import dataclasses
import json
import mmap
import os
import threading
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from ..nn.spec import itemsize, storage_dtype, to_torch

PAGE = 4096


def _align(n: int, a: int = PAGE) -> int:
    return (n + a - 1) // a * a


@dataclasses.dataclass(frozen=True)
class Entry:
    path: str
    offset: int          # byte offset in the arena (PAGE aligned)
    shape: tuple[int, ...]
    dtype: str
    nbytes: int
    region: str = "serve"  # serve | boot | infra

    @property
    def first_page(self) -> int:
        return self.offset // PAGE

    @property
    def n_pages(self) -> int:
        return _align(self.nbytes) // PAGE

    def pages(self) -> range:
        return range(self.first_page, self.first_page + self.n_pages)

    def row_pages(self, rows: Iterable[int]) -> set[int]:
        """Pages covering specific leading-axis rows (embedding/expert access)."""
        if not self.shape:
            return set(self.pages())
        row_bytes = self.nbytes // self.shape[0]
        out: set[int] = set()
        for r in rows:
            lo = self.offset + r * row_bytes
            hi = lo + row_bytes
            out.update(range(lo // PAGE, (hi - 1) // PAGE + 1))
        return out


class ArenaLayout:
    """Deterministic page-aligned layout of named tensors."""

    def __init__(self, entries: dict[str, Entry], total_bytes: int):
        self.entries = entries
        self.total_bytes = total_bytes
        self.n_pages = total_bytes // PAGE
        self._by_page: np.ndarray | None = None

    @classmethod
    def build(cls, tensors: Sequence[tuple[str, tuple[int, ...], str, str]]):
        """tensors: (path, shape, dtype_str, region) in layout order."""
        entries: dict[str, Entry] = {}
        off = 0
        for path, shape, dtype, region in tensors:
            nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize(dtype)
            entries[path] = Entry(path, off, tuple(shape), dtype, int(nbytes), region)
            off += _align(int(nbytes))
        return cls(entries, off)

    def to_json(self) -> str:
        return json.dumps({
            "page": PAGE,
            "total_bytes": self.total_bytes,
            "entries": [dataclasses.asdict(e) for e in self.entries.values()],
        })

    @classmethod
    def from_json(cls, text: str) -> "ArenaLayout":
        d = json.loads(text)
        entries = {}
        for e in d["entries"]:
            e["shape"] = tuple(e["shape"])
            entries[e["path"]] = Entry(**e)
        return cls(entries, d["total_bytes"])

    def pages_of(self, path: str) -> range:
        return self.entries[path].pages()

    def region_pages(self, region: str) -> set[int]:
        out: set[int] = set()
        for e in self.entries.values():
            if e.region == region:
                out.update(e.pages())
        return out


class GuestMemoryFile:
    """The on-disk snapshot: ``<base>.mem`` (raw arena) + ``<base>.manifest.json``."""

    def __init__(self, base: str, layout: ArenaLayout):
        self.base = base
        self.layout = layout
        self.mem_path = base + ".mem"
        self.manifest_path = base + ".manifest.json"

    @classmethod
    def create(cls, base: str, layout: ArenaLayout,
               arrays: dict[str, np.ndarray]) -> "GuestMemoryFile":
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        gm = cls(base, layout)
        with open(gm.mem_path, "wb") as f:
            f.truncate(layout.total_bytes)
            for path, e in layout.entries.items():
                a = arrays[path]
                assert a.nbytes == e.nbytes, (path, a.nbytes, e.nbytes)
                f.seek(e.offset)
                f.write(memoryview(np.ascontiguousarray(a)).cast("B"))
        with open(gm.manifest_path, "w") as f:
            f.write(layout.to_json())
        return gm

    @classmethod
    def open(cls, base: str) -> "GuestMemoryFile":
        with open(base + ".manifest.json") as f:
            layout = ArenaLayout.from_json(f.read())
        return cls(base, layout)


@dataclasses.dataclass
class FaultStats:
    n_faults: int = 0
    n_pages_installed: int = 0
    fault_seconds: float = 0.0
    trace: list[int] = dataclasses.field(default_factory=list)  # page order
    trace_t: list[float] = dataclasses.field(default_factory=list)  # per-fault time
    # overlapped-restore accounting: faults that blocked on an in-flight
    # background (tail) install instead of reading disk, the time they
    # spent waiting, and tail pages demoted to the disk-fault path by the
    # straggler deadline
    tail_waits: int = 0
    tail_wait_seconds: float = 0.0
    tail_demoted: int = 0


class PageSource:
    """Serves page reads from the guest memory file.

    ``o_direct`` bypasses the host page cache (the paper's cold-disk model),
    so every serial 4 KB fault pays true device latency.
    """

    def __init__(self, mem_path: str, o_direct: bool = True):
        flags = os.O_RDONLY
        self._direct = False
        if o_direct and hasattr(os, "O_DIRECT"):
            try:
                self.fd = os.open(mem_path, flags | os.O_DIRECT)
                self._direct = True
            except OSError:
                self.fd = os.open(mem_path, flags)
        else:
            self.fd = os.open(mem_path, flags)
        self.size = os.fstat(self.fd).st_size
        # O_DIRECT needs an aligned buffer: one page, reused per fault
        self._buf = mmap.mmap(-1, PAGE)
        self._mv = memoryview(self._buf)

    def read_page(self, page: int, out: memoryview) -> None:
        os.preadv(self.fd, [self._mv], page * PAGE)
        out[:] = self._mv

    def read_span(self, offset: int, nbytes: int) -> bytes:
        """One large aligned read (REAP prefetch path)."""
        n = _align(nbytes)
        buf = mmap.mmap(-1, n)
        mv = memoryview(buf)
        got = 0
        while got < n:
            r = os.preadv(self.fd, [mv[got:]], offset + got)
            if r <= 0:
                break
            got += r
        return bytes(mv[:nbytes])

    def close(self):
        os.close(self.fd)
        self._mv.release()
        self._buf.close()


class InstanceArena:
    """Demand-paged in-memory image of one function instance.

    Fault service is *serial by default* (the paper's baseline: the faulting
    vCPU is halted while the host reads one page), with a parallel mode used
    by the "Parallel PFs" design point of Fig. 7.
    """

    def __init__(self, gm: GuestMemoryFile, *, o_direct: bool = True):
        self.gm = gm
        self.layout = gm.layout
        self.buf = mmap.mmap(-1, max(self.layout.total_bytes, PAGE))
        self.view = memoryview(self.buf)
        self.resident = np.zeros(self.layout.n_pages, dtype=bool)
        self.stats = FaultStats()
        self.source = PageSource(gm.mem_path, o_direct=o_direct)
        self._lock = threading.RLock()
        # fault-vs-background-install rendezvous: pages in ``_pending`` have
        # an in-flight tail install; a fault on one waits on ``_cv`` for the
        # installer's notify instead of reading disk
        self._cv = threading.Condition(self._lock)
        self._pending: set[int] = set()
        #: liveness backstop for waiters — a tail stuck past this falls
        #: through to the disk-fault path regardless of the pending marker
        self.pending_wait_s = 30.0
        #: §6 recorder gate: only a monitor in record mode keeps the full
        #: fault trace (bugfix: the trace grew without bound on long
        #: serving runs).  Raw arenas default to recording.
        self.record_trace = True
        self._closed = False

    # -- fault paths --------------------------------------------------------

    def touch_pages(self, pages: Iterable[int], *, parallel: int = 0) -> int:
        """Ensure pages are resident; returns number of faults served.

        Thread-safe: the residence check, page install, and stats update are
        one atomic step, so concurrent fault paths (e.g. ``make_warm`` racing
        a monitor) never double-install or corrupt the trace.  A fault on a
        page with an in-flight background install blocks on the installer's
        completion (counted in ``tail_waits``/``tail_wait_seconds``, not as
        a disk fault) instead of falling through to disk.
        """
        with self._cv:
            missing = [p for p in pages if not self.resident[p]]
            if not missing:
                return 0
            if self._pending:
                waited = self._wait_pending_locked(
                    [p for p in missing if p in self._pending])
                if waited:
                    missing = [p for p in pages if not self.resident[p]]
                    if not missing:
                        return 0
            t0 = time.perf_counter()
            if parallel > 1:
                self._fault_parallel(missing, parallel)
            else:
                for p in missing:
                    self.source.read_page(
                        p, self.view[p * PAGE:(p + 1) * PAGE])
                    self.resident[p] = True
            self.stats.fault_seconds += time.perf_counter() - t0
            self.stats.n_faults += len(missing)
            self.stats.n_pages_installed += len(missing)
            if self.record_trace:
                t_now = time.perf_counter()
                self.stats.trace.extend(missing)
                self.stats.trace_t.extend([t_now] * len(missing))
            # pages this fault installed from disk can have no useful
            # pending marker left (e.g. after a timed-out wait)
            if self._pending:
                self._pending.difference_update(missing)
                self._cv.notify_all()
            return len(missing)

    def _wait_pending_locked(self, pend: list[int]) -> bool:
        """Wait (``_cv`` held) for in-flight installs covering ``pend``;
        returns True when any wait actually happened."""
        if not pend:
            return False
        t0 = time.perf_counter()
        deadline = t0 + self.pending_wait_s
        while (not self._closed
               and any(p in self._pending for p in pend)):
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            self._cv.wait(timeout=left)
        self.stats.tail_waits += 1
        self.stats.tail_wait_seconds += time.perf_counter() - t0
        return True

    # -- background (tail) install rendezvous -------------------------------

    def begin_pending(self, pages: Iterable[int]) -> None:
        """Mark ``pages`` as having an in-flight background install: a
        fault on any of them blocks on that install instead of reading
        disk.  Already-resident pages are skipped."""
        with self._cv:
            self._pending.update(
                int(p) for p in pages if not self.resident[p])

    def install_pending(self, page_indices, block) -> int:
        """Install one chunk of pending pages (vectorized scatter) and wake
        fault waiters.  Returns pages actually installed."""
        with self._cv:
            n = self.install_block(page_indices, block)
            self._pending.difference_update(int(p) for p in page_indices)
            self._cv.notify_all()
            return n

    def cancel_pending(self, pages: Iterable[int] | None = None, *,
                       demote: bool = True) -> int:
        """Drop pending markers (all of them when ``pages`` is None) so
        waiters fall through to the normal disk-fault path.  ``demote``
        counts the drop as a straggler demotion (``tail_demoted``) —
        teardown cancels pass False."""
        with self._cv:
            if pages is None:
                dropped = len(self._pending)
                self._pending.clear()
            else:
                dropped = 0
                for p in pages:
                    p = int(p)
                    if p in self._pending:
                        self._pending.discard(p)
                        dropped += 1
            if dropped and demote:
                self.stats.tail_demoted += dropped
            self._cv.notify_all()
            return dropped

    @property
    def pending_count(self) -> int:
        with self._cv:
            return len(self._pending)

    def _fault_parallel(self, pages: list[int], workers: int) -> None:
        import concurrent.futures as cf

        def job(chunk):
            src = PageSource(self.gm.mem_path, o_direct=True)
            try:
                for p in chunk:
                    src.read_page(p, self.view[p * PAGE:(p + 1) * PAGE])
            finally:
                src.close()

        chunks = [pages[i::workers] for i in range(workers)]
        with cf.ThreadPoolExecutor(workers) as ex:
            list(ex.map(job, [c for c in chunks if c]))
        for p in pages:
            self.resident[p] = True

    def install_span(self, page_indices: Sequence[int], data: bytes) -> None:
        """Eagerly install prefetched page contents (REAP prefetch phase)."""
        with self._lock:
            mv = memoryview(data)
            for i, p in enumerate(page_indices):
                if not self.resident[p]:
                    self.view[p * PAGE:(p + 1) * PAGE] = mv[i * PAGE:(i + 1) * PAGE]
                    self.resident[p] = True
            self.stats.n_pages_installed += len(page_indices)

    def install_block(self, page_indices, block) -> int:
        """Fused eager install: one vectorized scatter of a prefetched page
        block (``block[i]`` -> page ``page_indices[i]``), instead of
        ``install_span``'s per-page loop.  ``block`` is a ``(n, PAGE)``
        uint8 array (the output of a fused gather pass — restore.py); pages
        already resident are skipped, byte-identically to ``install_span``.
        Returns the number of pages actually installed."""
        with self._lock:
            idx = np.asarray(page_indices, dtype=np.int64)
            missing = ~self.resident[idx]
            tgt = idx[missing]
            if len(tgt):
                arr = np.frombuffer(
                    self.buf, dtype=np.uint8,
                    count=self.layout.n_pages * PAGE).reshape(-1, PAGE)
                arr[tgt] = block[missing]
                self.resident[tgt] = True
            self.stats.n_pages_installed += len(idx)
            return int(len(tgt))

    # -- tensor access ------------------------------------------------------

    def tensor(self, path: str, *, fault: bool = True,
               parallel: int = 0) -> torch.Tensor:
        """Zero-copy CPU tensor over the arena bytes of ``path`` (pages never
        faulted read as zeros)."""
        e = self.layout.entries[path]
        if fault:
            self.touch_pages(e.pages(), parallel=parallel)
        st = storage_dtype(e.dtype)
        arr = np.frombuffer(self.view, dtype=st, count=e.nbytes // st.itemsize,
                            offset=e.offset)
        return to_torch(arr.reshape(e.shape), e.dtype)

    def tensor_rows(self, path: str, rows: Iterable[int],
                    parallel: int = 0) -> torch.Tensor:
        """Fault only the pages covering ``rows`` (embedding/expert access)."""
        e = self.layout.entries[path]
        self.touch_pages(sorted(e.row_pages(rows)), parallel=parallel)
        return self.tensor(path, fault=False)

    @property
    def resident_bytes(self) -> int:
        return int(self.resident.sum()) * PAGE

    def close(self):
        with self._cv:
            if self._closed:
                return
            self._closed = True
            # no waiter may hang on a pending marker past close
            self._pending.clear()
            self._cv.notify_all()
            self.source.close()
            self.view.release()
            try:
                self.buf.close()
            except BufferError:
                # zero-copy tensor/np views may still alias the mmap; the OS
                # frees it when the last reference dies.
                pass
