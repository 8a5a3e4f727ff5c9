"""Staged cold-start restore pipeline + batched group restores.

The paper's §4.2 latency split (load VMM / connection restore / prefetch /
processing) used to be produced implicitly by ``FunctionInstance.__init__``
doing blocking I/O in a constructor.  This module makes the restore path an
explicit, separately-timed pipeline:

    load_vmm -> connect -> ws_fetch -> install -> materialize

and adds the group form the single-instance path cannot express: under
concurrent load, N queued cold starts of one function used to run N full
pipelines — N manifest parses, N WS-cache waits (single-flight followers
blocking on the leader's read), and N serial per-page ``install_span``
loops.  :class:`RestoreBatch` restores all N as **one** staged operation:

  * one manifest parse (the layout is shared across the group's arenas),
  * one WS fetch (a single cache transaction instead of leader+followers),
  * one fused page-gather pass producing an ascending-page install block,
  * N vectorized block installs (one scatter per arena, no per-page loop).

The fuse step is the ``page_gather`` kernel's job description: reorder the
trace-order WS into the contiguous block the installs want.  A pipeline on
a CUDA device runs it through the CUDA gather kernel (``kernels/page_gather``);
one on the CPU runs the same permutation as a single numpy fancy-index.
``fuse_engine="auto"`` picks by the pipeline's device, never by what
happens to be installed, and both engines are parity-tested byte-for-byte.
The arena stays host-side, so the CUDA engine pays a copy of the WS to the
card and a copy of the block back.

The ``ws_fetch`` stage is format-agnostic: ``_read_ws``/``_read_ws_prefix``
reassemble a content-addressed manifest from the store directory's shared
chunk store (core/pagestore.py) — adjacent chunks coalesce back into span
reads — or fall back to the legacy flat-file seam, so the pipeline and the
group restore never see which format recorded the WS.
"""
from __future__ import annotations

import threading
import socket
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..kernels.page_gather import gather_pages
from .arena import PAGE, GuestMemoryFile, InstanceArena
from .reap import (WS_CACHE, Monitor, ReapConfig, StageTimings, _read_ws,
                   _read_ws_prefix, read_hot_prefix, trace_path)
from ..telemetry import TELEMETRY

__all__ = [
    "STAGES", "StageTimings", "TailInstall", "RestorePipeline",
    "RestoreBatch", "connect_handshake", "default_fuse_engine",
    "fuse_ws_block", "shutdown_tail_pool",
]

#: Stage names in execution order (benchmarks iterate this).
STAGES = ("load_vmm", "connect", "ws_fetch", "install", "materialize")


# Shared background pool for tail installs: tails are short memcpy bursts,
# so one small process-wide pool beats a thread per restore.  Sized by the
# first ``tail_workers`` seen (later configs reuse the pool).
_TAIL_POOL: ThreadPoolExecutor | None = None
_TAIL_POOL_LOCK = threading.Lock()


def _tail_pool(workers: int) -> ThreadPoolExecutor:
    global _TAIL_POOL
    with _TAIL_POOL_LOCK:
        if _TAIL_POOL is None:
            _TAIL_POOL = ThreadPoolExecutor(
                max_workers=max(1, workers),
                thread_name_prefix="tail-install")
        return _TAIL_POOL


def shutdown_tail_pool(wait: bool = True) -> None:
    """Join the shared tail-install pool's threads (idempotent).

    Tails themselves are cancel/join-able per instance
    (:meth:`TailInstall.cancel`); this releases the *pool* — process
    teardown, or tests asserting no thread leaks.  The next TailInstall
    lazily rebuilds it.
    """
    global _TAIL_POOL
    with _TAIL_POOL_LOCK:
        pool, _TAIL_POOL = _TAIL_POOL, None
    if pool is not None:
        pool.shutdown(wait=wait)


class TailInstall:
    """Background fetch+install of the working-set tail after materialize.

    The arena's pending markers are set *before* the task is scheduled, so
    a fault racing the installer always either waits on the pending page or
    finds it resident — never reads disk for a page the tail holds.  Pages
    are installed in chunks (each chunk notifies waiters) and a straggler
    deadline demotes the remaining tail to the normal disk-fault path.

    ``block`` of None defers even the tail's *bytes* to the background:
    ``fetch()`` (run first, on the worker) returns the tail's page rows —
    the overlapped pipeline uses this on a WS-cache miss so the eager path
    reads only the hot-prefix span of the WS file.
    """

    CHUNK_PAGES = 256
    #: test seam: ``throttle(tail, chunk_start)`` runs before each chunk.
    throttle = None

    def __init__(self, arena: InstanceArena, pages, block=None, *,
                 fetch=None, deadline_s: float = 5.0, workers: int = 2,
                 clock=time.perf_counter, registry=None):
        if block is None and fetch is None:
            raise ValueError("TailInstall needs a block or a fetch")
        self.arena = arena
        self.pages = np.asarray(pages, dtype=np.int64)
        self.block = block
        self.fetch = fetch
        self.fetch_s = 0.0
        self.deadline_s = deadline_s
        self.demoted = False
        self.clock = clock
        self.registry = TELEMETRY if registry is None else registry
        self.done_at: float | None = None   # clock() at full residency
        self.t0 = clock()
        self._cancel = threading.Event()
        self.registry.inc("tail.started")
        arena.begin_pending(self.pages)
        self._future = _tail_pool(workers).submit(self._run)

    def _run(self) -> None:
        try:
            if self.block is None:
                if self._cancel.is_set():
                    self.arena.cancel_pending(self.pages, demote=False)
                    self.registry.inc("tail.cancelled")
                    return
                if self.clock() - self.t0 > self.deadline_s:
                    self.arena.cancel_pending(self.pages, demote=True)
                    self.demoted = True
                    self.registry.inc("tail.demoted")
                    return
                t0 = self.clock()
                self.block = self.fetch()
                self.fetch_s = self.clock() - t0
                self.registry.observe("tail.fetch_s", self.fetch_s)
            n = len(self.pages)
            for i in range(0, n, self.CHUNK_PAGES):
                if self._cancel.is_set():
                    self.arena.cancel_pending(self.pages[i:], demote=False)
                    self.registry.inc("tail.cancelled")
                    return
                if self.clock() - self.t0 > self.deadline_s:
                    # straggler: demote the rest to the disk-fault path
                    self.arena.cancel_pending(self.pages[i:], demote=True)
                    self.demoted = True
                    self.registry.inc("tail.demoted")
                    return
                if TailInstall.throttle is not None:
                    TailInstall.throttle(self, i)
                j = i + self.CHUNK_PAGES
                self.arena.install_pending(self.pages[i:j], self.block[i:j])
            self.done_at = self.clock()
            self.registry.inc("tail.completed")
            self.registry.observe("tail.resident_s", self.done_at - self.t0)
        except BaseException:
            # never leave waiters parked on pages nobody will install
            self.arena.cancel_pending(self.pages)
            raise

    def done(self) -> bool:
        return self._future.done()

    def wait(self, timeout: float | None = None) -> None:
        self._future.result(timeout)

    def cancel(self, join: bool = True) -> None:
        """Stop installing (remaining pending markers are dropped without
        counting as demotions); ``join`` waits for the worker to leave the
        arena so a subsequent ``arena.close()`` is safe."""
        self._cancel.set()
        if join:
            try:
                self._future.result(timeout=30.0)
            except BaseException:
                pass


def connect_handshake() -> None:
    """Real loopback handshake standing in for gRPC connection restore."""
    a, b = socket.socketpair()
    try:
        a.sendall(b"PING")
        assert b.recv(4) == b"PING"
        b.sendall(b"PONG")
        assert a.recv(4) == b"PONG"
    finally:
        a.close()
        b.close()


def default_fuse_engine(device) -> str:
    """'cuda' for a pipeline on a CUDA device, 'numpy' for one on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "numpy"


def fuse_ws_block(pages, data: bytes, *, engine: str = "auto",
                  device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """One fused gather pass over the trace-order WS bytes.

    Returns ``(sorted_pages, block)`` where ``block[i]`` is the content of
    arena page ``sorted_pages[i]`` — the WS permuted into ascending-page
    order so each instance's install is a single monotonic scatter.

    ``engine='cuda'`` copies the WS to ``device``, runs the permutation
    through the :func:`~repro_torch.kernels.gather_pages` kernel and copies
    the block back; ``engine='numpy'`` is the vectorized host path.  Both
    produce identical bytes (tested).  ``'auto'`` is
    :func:`default_fuse_engine` of ``device``.
    """
    idx = np.asarray(pages, dtype=np.int64)
    ws = np.frombuffer(data, dtype=np.uint8,
                       count=len(idx) * PAGE).reshape(len(idx), PAGE)
    order = np.argsort(idx, kind="stable")
    if engine == "auto":
        engine = default_fuse_engine(device)
    if engine == "cuda":
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"fuse engine 'cuda' needs a CUDA device, got {dev}")
        with warnings.catch_warnings():
            # the WS bytes are read-only, and only the copy to the card reads
            # them: a writable host copy would cost a second pass over them
            warnings.simplefilter("ignore", UserWarning)
            table = torch.from_numpy(ws)
        block = gather_pages(table.to(dev), torch.from_numpy(order).to(dev)
                             ).cpu().numpy()
    elif engine == "numpy":
        block = np.ascontiguousarray(ws[order])
    else:
        raise ValueError(f"unknown fuse engine {engine!r}")
    return idx[order], block


class RestorePipeline:
    """Explicit staged restore of one function instance's state.

    Stages are separate methods so a group restore (:class:`RestoreBatch`)
    can interleave them across instances — e.g. run every ``load_vmm``
    against one parsed manifest, then one shared ``ws_fetch`` for the whole
    group.  ``run()`` is the single-instance convenience that executes them
    in order.

    ``clock`` injects the timer (tests pass a fake clock so stage
    attribution is deterministic); ``exec_restore`` is the jit-cache lookup
    (Firecracker's device-state restore analogue) supplied by the serving
    layer; ``connector`` stands in for the gRPC connection restore.
    ``device`` is where the instance computes: it picks the group fuse
    engine (``ReapConfig.fuse_engine="auto"``).
    """

    def __init__(self, base: str, reap: ReapConfig | None = None, *,
                 mode: str | None = None, cache=None, exec_restore=None,
                 connector=connect_handshake, clock=time.perf_counter,
                 registry=None, device="cuda"):
        self.base = base
        self.device = torch.device(device)
        self.reap = reap or ReapConfig()
        self.mode = mode                 # None => auto; 'vanilla' => no REAP
        self.cache = cache
        self.exec_restore = exec_restore
        self.connector = connector
        self.clock = clock
        self.registry = TELEMETRY if registry is None else registry
        self.timings = StageTimings()
        self.gm: GuestMemoryFile | None = None
        self.monitor: Monitor | None = None
        #: live background tail install (overlapped restore), else None.
        self.tail: TailInstall | None = None
        #: hot-prefix size when ws_fetch split (read only the prefix span);
        #: the tail's bytes then come from ``_tail_fetch`` in the background.
        self._split_k: int | None = None
        self._tail_fetch = None          # () -> (pages, data) full WS

    def _span(self, stage: str, t0: float, dur_s: float, **attrs) -> None:
        """Record one stage span in the calling thread's current trace (an
        invocation's ``acquire``, or a prewarm), if any.  ``dur_s`` is
        always the value just written to ``self.timings`` — StageTimings
        stays the single stage-seconds sink (REP005); the trace only
        mirrors it for per-invocation attribution."""
        self.registry.record(stage, t0, t0 + dur_s, **attrs)
        self.registry.observe(f"restore.{stage}_s", dur_s)

    # -- stages ---------------------------------------------------------

    def load_vmm(self, layout=None) -> None:
        """Manifest parse + arena map + executable-handle restore.

        ``layout`` short-circuits the manifest parse with an
        already-parsed :class:`~repro_torch.core.arena.ArenaLayout` — a group
        restore parses the manifest once and shares it.
        """
        t0 = self.clock()
        self.gm = (GuestMemoryFile(self.base, layout) if layout is not None
                   else GuestMemoryFile.open(self.base))
        self.monitor = Monitor(self.gm, self.base, self.reap,
                               mode=self.mode, cache=self.cache)
        if self.exec_restore is not None:
            self.exec_restore()
        self.timings.load_vmm_s = self.clock() - t0
        self._span("load_vmm", t0, self.timings.load_vmm_s)

    def connect(self) -> None:
        t0 = self.clock()
        self.connector()
        self.timings.connection_s = self.clock() - t0
        self._span("connect", t0, self.timings.connection_s)

    def ws_fetch(self, group: int = 1):
        """Fetch the working set (REAP prefetch phase, read half).

        Returns ``(pages, data, cache_hit)`` — ``data`` is None on the
        "Parallel PFs" design point (``use_ws_file=False``), where the
        install stage demand-reads the traced pages instead — or None when
        this monitor is not in prefetch mode.

        A concurrent §7.2 re-record may ``drop_record`` the WS file between
        the monitor's mode selection and this fetch; the resulting
        ``FileNotFoundError`` falls back to record mode (the §7.2 path)
        instead of failing the invocation.
        """
        mon = self.monitor
        if mon.mode != "prefetch":
            return None
        cfg = self.reap
        t0 = self.clock()
        try:
            if not cfg.use_ws_file:
                pages = [int(p) for p in np.load(trace_path(self.base))]
                data, hit = None, False
            else:
                split = (self._split_fetch(group)
                         if cfg.overlap_install else None)
                if split is not None:
                    pages, data, hit = split
                elif cfg.share_ws_cache:
                    pages, data, hit = (self.cache or WS_CACHE).fetch(
                        self.base, cfg, group=group)
                else:
                    pages, data = _read_ws(self.base, cfg)
                    hit = False
        except FileNotFoundError:
            mon.mode = "record"          # record dropped under us: re-record
            return None
        self.timings.ws_fetch_s = self.clock() - t0
        self._span("ws_fetch", t0, self.timings.ws_fetch_s, cache_hit=hit)
        return pages, data, hit

    def _split_fetch(self, group: int):
        """Overlapped fetch: eagerly read only the hot-prefix span of the
        fault-order WS file; the background tail fetches the full WS (via
        the single-flight cache when shared, so a group and later restores
        all ride one read) before installing.  Returns ``(pages,
        prefix_data, False)`` or None when splitting doesn't apply — a
        cache hit already holds the full bytes (only the install then
        overlaps) or the WS is too small to cut."""
        cfg = self.reap
        cache = (self.cache or WS_CACHE) if cfg.share_ws_cache else None
        if cache is not None and cache.peek(self.base, count=False) is not None:
            return None
        n = len(np.load(trace_path(self.base)))
        k = self.hot_count(n)
        if k >= n:
            return None
        pages, data = _read_ws_prefix(self.base, cfg, k)
        self._split_k = k
        if cache is not None:
            self._tail_fetch = lambda: cache.fetch(
                self.base, cfg, group=group)[:2]
        else:
            self._tail_fetch = lambda: _read_ws(self.base, cfg)
        return pages, data, False

    def _tail_rows(self, k: int, want_pages):
        """Closure for :class:`TailInstall`: resolve the full WS in the
        background and slice out the tail's page rows.  A §7.2 re-record
        can swap the WS under the in-flight fetch — the guard raises and
        the tail's pending markers drop to the disk-fault path instead of
        installing rows against the wrong page indices."""
        fetch = self._tail_fetch
        want = [int(p) for p in want_pages]
        base = self.base

        def rows():
            pages_all, data = fetch()
            if [int(p) for p in pages_all[k:]] != want:
                raise RuntimeError(
                    f"WS for {base} re-recorded during tail fetch")
            return np.frombuffer(
                data, dtype=np.uint8,
                count=len(pages_all) * PAGE).reshape(-1, PAGE)[k:]
        return rows

    def hot_count(self, n_pages: int) -> int:
        """Size of the eager hot prefix for an ``n_pages`` working set.

        Without ``overlap_install`` (or for trivially small sets) the whole
        WS is installed eagerly.  With it, the recorded cut point (the
        boot→execution timing knee — reap.py) wins over the blind
        ``hot_prefix_frac`` fallback.
        """
        if not self.reap.overlap_install or n_pages <= 8:
            return n_pages
        k = read_hot_prefix(self.base)
        if k is None:
            k = int(round(n_pages * self.reap.hot_prefix_frac))
        return max(1, min(k, n_pages))

    def _start_tail(self, pages, block=None, *, fetch=None) -> None:
        self.tail = TailInstall(
            self.monitor.arena, pages, block, fetch=fetch,
            deadline_s=self.reap.tail_deadline_s,
            workers=self.reap.tail_workers, clock=self.clock,
            registry=self.registry)

    def install(self, fetched) -> None:
        """Single-instance eager install (per-page ``install_span`` path).

        With ``overlap_install`` only the hot prefix (fault-order head of
        the WS) installs eagerly; the tail is handed to a background
        :class:`TailInstall` and this pipeline MATERIALIZES before the
        arena is fully resident — the arena's pending-fault path covers
        the gap.
        """
        if fetched is None:
            return
        pages, data, hit = fetched
        t0 = self.clock()
        if data is None:
            self.monitor.arena.touch_pages(
                pages, parallel=max(self.reap.parallel_faults, 1))
        else:
            k = (self._split_k if self._split_k is not None
                 else self.hot_count(len(pages)))
            self.monitor.arena.install_span(
                pages[:k], memoryview(data)[:k * PAGE])
            if k < len(pages):
                self.timings.install_s = self.clock() - t0
                self._span("install", t0, self.timings.install_s,
                           hot_pages=k, total_pages=len(pages))
                self._mark_prefetched(len(pages), hit)
                if self._tail_fetch is not None:
                    # split fetch: the tail's bytes arrive in the background
                    self._start_tail(pages[k:],
                                     fetch=self._tail_rows(k, pages[k:]))
                else:
                    tail_block = np.frombuffer(
                        data, dtype=np.uint8,
                        count=len(pages) * PAGE).reshape(-1, PAGE)[k:]
                    self._start_tail(pages[k:], tail_block)
                return
        self.timings.install_s = self.clock() - t0
        self._span("install", t0, self.timings.install_s,
                   total_pages=len(pages))
        self._mark_prefetched(len(pages), hit)

    def install_block(self, sorted_pages: np.ndarray, block: np.ndarray,
                      hit: bool, *, ws_fetch_s: float = 0.0,
                      tail: tuple[np.ndarray, np.ndarray | None] | None = None,
                      tail_fetch=None) -> None:
        """Fused group install: one vectorized scatter of the shared block.

        ``ws_fetch_s`` charges this instance its share of the group's
        single fetch (every member waited on it, like followers used to
        wait on the single-flight leader).  ``tail`` — the (pages, block)
        remainder of an overlapped restore — starts a background
        :class:`TailInstall` after the eager prefix lands; a tail block of
        None defers the tail's bytes to ``tail_fetch`` (split fetch).
        """
        t0 = self.clock()
        self.monitor.arena.install_block(sorted_pages, block)
        self.timings.install_s = self.clock() - t0
        self.timings.ws_fetch_s = ws_fetch_s
        self._span("ws_fetch", t0, self.timings.ws_fetch_s,
                   cache_hit=hit, group_share=True)
        self._span("install", t0, self.timings.install_s,
                   batched=True, total_pages=len(sorted_pages))
        n_total = len(sorted_pages)
        if tail is not None and len(tail[0]):
            n_total += len(tail[0])
            self._start_tail(tail[0], tail[1], fetch=tail_fetch)
        self._mark_prefetched(n_total, hit)

    def materialize(self, fn) -> None:
        """Timed post-install residency work (e.g. param materialization);
        its span is open while ``fn`` runs, so ``fn``'s own spans nest in
        it."""
        t0 = self.clock()
        with self.registry.span("materialize", start_s=t0) as span:
            fn()
            self.timings.materialize_s = self.clock() - t0
            span.stop(t0 + self.timings.materialize_s)
        self.registry.observe("restore.materialize_s", self.timings.materialize_s)

    def _mark_prefetched(self, n_pages: int, hit: bool) -> None:
        # keep the monitor's view consistent so finish() computes the
        # residual-fault ratio (§7.2 re-record policy) exactly as before
        mon = self.monitor
        mon.prefetched = n_pages
        mon.prefetch_s = self.timings.prefetch_s
        mon.ws_cache_hit = hit

    # -- convenience ----------------------------------------------------

    def run(self) -> "RestorePipeline":
        """Execute load_vmm → connect → ws_fetch → install in order."""
        self.load_vmm()
        self.connect()
        self.install(self.ws_fetch())
        return self

    def close(self) -> None:
        """Tear down a partially-restored pipeline (error paths)."""
        if self.tail is not None:
            # the tail worker writes into the arena mmap; join it before
            # the close releases the buffer under it
            self.tail.cancel(join=True)
            self.tail = None
        if self.monitor is not None:
            self.monitor.arena.close()


class RestoreBatch:
    """Restore N pipelines of ONE function as a single staged group.

    All pipelines must target the same ``base``.  The group performs one
    manifest parse, one WS fetch, and one fused gather pass; every member
    then installs the shared block with one vectorized scatter.  With
    ``len(pipes) == 1`` the batch degrades to the plain per-page pipeline
    (identical semantics to an unbatched restore).

    A mode fallback on the group's fetch (record dropped mid-restore)
    propagates to every member: the whole group re-records, exactly as N
    independent restores would have.
    """

    def __init__(self, pipes: list[RestorePipeline]):
        if not pipes:
            raise ValueError("empty restore batch")
        bases = {p.base for p in pipes}
        if len(bases) > 1:
            raise ValueError(f"restore batch spans bases {sorted(bases)}")
        self.pipes = pipes
        self.fuse_s = 0.0                # the shared gather pass, once

    def run(self) -> "RestoreBatch":
        pipes = self.pipes
        try:
            layout = None
            for p in pipes:
                p.load_vmm(layout=layout)
                layout = p.gm.layout     # manifest parsed once per group
            for p in pipes:
                p.connect()
            leader = pipes[0]
            fetched = leader.ws_fetch(group=len(pipes))
            if fetched is None:
                # record/vanilla mode — or the §7.2 fallback; every member
                # must agree (followers may have resolved 'prefetch' from a
                # record that a concurrent re-record has since dropped)
                if leader.monitor.mode == "record":
                    for p in pipes[1:]:
                        p.monitor.mode = "record"
                return self
            pages, data, hit = fetched
            if len(pipes) == 1 or data is None:
                # single restore, or the "Parallel PFs" design point where
                # every arena demand-reads its own pages (nothing to fuse)
                for p in pipes:
                    p.install(fetched)
                return self
            t0 = leader.clock()
            if leader._split_k is not None:
                # the leader's fetch split: ``data`` holds only the hot
                # prefix span.  Fuse just the prefix; every member's tail
                # resolves the full WS in the background (the per-pipe
                # fetch closures collapse to one read via the single-flight
                # cache, the rest hit the fresh entry)
                k = leader._split_k
                sorted_hot, hot_block = fuse_ws_block(
                    pages[:k], data, engine=leader.reap.fuse_engine,
                    device=leader.device)
                self.fuse_s = leader.clock() - t0
                fetch_s = leader.timings.ws_fetch_s + self.fuse_s
                tail_pages = np.asarray(pages[k:], dtype=np.int64)
                for p in pipes:
                    p.install_block(
                        sorted_hot, hot_block, hit, ws_fetch_s=fetch_s,
                        tail=(tail_pages, None),
                        tail_fetch=leader._tail_rows(k, tail_pages))
                return self
            sorted_pages, block = fuse_ws_block(
                pages, data, engine=leader.reap.fuse_engine,
                device=leader.device)
            self.fuse_s = leader.clock() - t0
            # the fuse pass and the fetch sit on every member's critical
            # path — charge them to each report like follower waits were
            fetch_s = leader.timings.ws_fetch_s + self.fuse_s
            k_hot = leader.hot_count(len(pages))
            if k_hot < len(pages):
                # overlapped group restore: the hot set is the fault-order
                # head of the trace; split the ascending fused block by
                # membership so each member eagerly scatters only the
                # prefix and backgrounds the rest
                hot = set(int(p) for p in pages[:k_hot])
                mask = np.fromiter((int(p) in hot for p in sorted_pages),
                                   dtype=bool, count=len(sorted_pages))
                hot_pages, hot_block = sorted_pages[mask], block[mask]
                tail_pages, tail_block = sorted_pages[~mask], block[~mask]
                for p in pipes:
                    p.install_block(hot_pages, hot_block, hit,
                                    ws_fetch_s=fetch_s,
                                    tail=(tail_pages, tail_block))
            else:
                for p in pipes:
                    p.install_block(sorted_pages, block, hit,
                                    ws_fetch_s=fetch_s)
            return self
        except BaseException:
            for p in pipes:
                p.close()                # never leak half-restored arenas
            raise

    def stage_seconds(self) -> dict:
        """Aggregate per-stage seconds across the group (+ the fuse pass)."""
        out = {k: 0.0 for k in StageTimings().as_dict()}
        for p in self.pipes:
            for k, v in p.timings.as_dict().items():
                out[k] += v
        out["fuse_s"] = self.fuse_s
        return out
