"""Function-instance lifecycle: the MicroVM analogue.

Cold-start latency is split exactly as the paper measures it (§4.2):

  * **Load VMM**            -- open the guest memory file (manifest parse),
                               map the arena, restore the executable handle
                               (executable-cache lookup = Firecracker's device state
                               restore analogue).
  * **Connection restore**  -- re-bind the instance to the orchestrator's
                               data plane over a real socketpair handshake
                               (the persistent-gRPC analogue).
  * **(REAP) prefetch**     -- single large O_DIRECT read of the WS file +
                               eager install (only in prefetch mode); split
                               into ``ws_fetch`` and ``install`` stages, the
                               install fused across a restore group.
  * **Function processing** -- actual invocation, demand-faulting any page
                               not yet resident.

The restore itself lives in :mod:`repro_torch.core.restore`: a
:class:`FunctionInstance` is a thin shell — its constructor does **no I/O**
— that adopts the result of a :class:`~repro_torch.core.restore.RestorePipeline`.
:func:`restore_group` restores N instances of one function as a single
staged batch (one manifest parse, one WS fetch, one fused gather pass, N
vectorized installs).
"""
from __future__ import annotations

import dataclasses
import enum
import functools
import itertools
import threading
import time

import torch

from ..configs.base import ModelConfig
from ..core import ReapConfig, run_invocation
from ..core.executor import sync, warm_executables
from ..core.reap import ColdStartReport, StageTimings
from ..core.restore import RestoreBatch, RestorePipeline
from ..models import get_family
from ..nn import spec as nnspec


class State(enum.Enum):
    LOADING = "loading"
    IDLE = "idle"
    BUSY = "busy"
    RECLAIMED = "reclaimed"


class ExecutableCache:
    """The forward an instance runs (the snapshot's 'emulated devices'
    restore is a lookup here, not a rebuild).  The CUDA kernels are built
    or loaded, and the forward run once on the device, at function *deploy*
    time via :func:`warm`."""

    @classmethod
    def get(cls, cfg: ModelConfig):
        return functools.partial(get_family(cfg).forward, cfg)

    @classmethod
    def warm(cls, cfg: ModelConfig, example_batch: dict,
             device: torch.device) -> None:
        warm_executables(cfg, example_batch, device)


class FunctionInstance:
    """One sandboxed instance of a function (cfg), restored from snapshot.

    The constructor only records identity — all restore I/O (manifest,
    handshake, WS fetch, install) runs in :meth:`restore` /
    :func:`restore_group` through the staged pipeline, so instances can be
    built in bulk and restored as one batch.

    State transitions are lock-guarded so the router's worker pool, the
    keepalive reaper, and scale-to-zero can race safely: an instance is
    dispatched only via :meth:`try_acquire` (IDLE -> BUSY) and reclaimed
    only via :meth:`try_reclaim`, which refuses BUSY instances.
    """

    _ids = itertools.count()
    # class-level defaults so state-machine methods work on instances built
    # without __init__ (tests construct bare instances via __new__)
    clock = staticmethod(time.monotonic)
    perf_clock = staticmethod(time.perf_counter)

    def __init__(self, name: str, cfg: ModelConfig, base: str,
                 reap: ReapConfig, *, device: torch.device,
                 mode: str = "auto", prewarmed: bool = False, ws_cache=None,
                 clock=time.monotonic, perf_clock=time.perf_counter):
        """``prewarmed=True`` marks an instance spawned by the control plane
        *off* the invocation path: its load/connect/prefetch costs were paid
        by a pool thread, so no invocation report ever charges them.
        ``ws_cache`` selects the WS page cache for the REAP prefetch (None
        => the process-wide default; cluster nodes pass their own).
        ``clock`` stamps ``last_used`` (compared against the reaper's
        monotonic clock); ``perf_clock`` times invocation processing.
        ``device`` is where the invocation computes and warm params live."""
        self.name = name
        self.device = torch.device(device)
        self.cfg = cfg
        self.base = base
        self.reap = reap
        self.mode = mode
        self.prewarmed = prewarmed
        self.ws_cache = ws_cache
        self.clock = clock
        self.perf_clock = perf_clock
        self.instance_id = next(FunctionInstance._ids)
        self._state_lock = threading.Lock()
        self.state = State.LOADING
        self.report = ColdStartReport()
        self.last_used = clock()
        self.gm = None
        self.monitor = None
        self._warm_params = None
        self._n_invocations = 0
        #: live background tail install (overlapped restore), else None —
        #: a MATERIALIZED instance with a live tail is NOT fully resident;
        #: faults on tail pages wait on the install (arena.py)
        self._tail = None

    # -- restore (thin shell over core/restore.py) ---------------------

    def _pipeline(self) -> RestorePipeline:
        mode = "vanilla" if self.mode == "vanilla" else None
        return RestorePipeline(
            self.base, self.reap, mode=mode, cache=self.ws_cache,
            exec_restore=lambda: ExecutableCache.get(self.cfg),
            device=self.device)

    def _adopt(self, pipe: RestorePipeline, batch_size: int = 1) -> None:
        """Take ownership of a completed pipeline's state and map its stage
        timings onto the §4.2 report split."""
        self.gm = pipe.gm
        self.monitor = pipe.monitor
        self._tail = pipe.tail
        self.report = dataclasses.replace(
            self.report,
            stages=dataclasses.replace(pipe.timings),
            n_prefetched_pages=pipe.monitor.prefetched,
            ws_cache_hit=pipe.monitor.ws_cache_hit,
            prewarmed=self.prewarmed,
            batch_size=batch_size)
        self.last_used = self.clock()
        self.state = State.IDLE

    def restore(self) -> "FunctionInstance":
        """Run the full staged restore for this instance alone."""
        restore_group([self])
        return self

    # -- state machine -------------------------------------------------

    def try_acquire(self) -> bool:
        """IDLE -> BUSY; False if the instance is not dispatchable."""
        with self._state_lock:
            if self.state is not State.IDLE:
                return False
            self.state = State.BUSY
            return True

    def release(self) -> None:
        """BUSY -> IDLE (after an invocation completes)."""
        with self._state_lock:
            if self.state is State.BUSY:
                self.state = State.IDLE
            self.last_used = self.clock()

    def try_reclaim(self) -> bool:
        """IDLE -> RECLAIMED; never tears down a BUSY instance, and never
        one whose background tail is still installing (the tail worker
        writes into the arena mmap — a keepalive sweep must not close it
        under the worker; forced paths use :meth:`cancel_tail` first)."""
        with self._state_lock:
            if self.state is not State.IDLE:
                return False
            if self._tail is not None and not self._tail.done():
                return False
            self.state = State.RECLAIMED
        self.monitor.arena.close()
        self._warm_params = None
        return True

    def cancel_tail(self, join: bool = True) -> None:
        """Stop a live background tail install (no-op without one)."""
        if self._tail is not None:
            self._tail.cancel(join=join)

    # ------------------------------------------------------------------

    def invoke(self, batch: dict, *, parallel_faults: int = 0):
        """Process one invocation; first call is cold, later calls warm."""
        stats = self.monitor.arena.stats
        f0, fs0 = stats.n_faults, stats.fault_seconds
        tw0, tws0 = stats.tail_waits, stats.tail_wait_seconds
        t0 = self.perf_clock()
        if self._warm_params is not None:
            logits = ExecutableCache.get(self.cfg)(self._warm_params, batch)
        else:
            logits, _ = run_invocation(self.cfg, self.monitor.arena, batch,
                                       device=self.device,
                                       parallel=parallel_faults)
        sync(self.device)
        dt = self.perf_clock() - t0
        first = self._n_invocations == 0
        self._n_invocations += 1
        # fresh per-invocation report; load/connect/prefetch costs belong to
        # the first (cold) invocation only — and never to an invocation on a
        # prewarmed instance, whose restore ran off the critical path
        on_path = first and not self.prewarmed
        prev = self.report.stages
        tail = self._tail
        stages = StageTimings(
            load_vmm_s=prev.load_vmm_s if on_path else 0.0,
            connection_s=prev.connection_s if on_path else 0.0,
            ws_fetch_s=prev.ws_fetch_s if on_path else 0.0,
            install_s=prev.install_s if on_path else 0.0,
            materialize_s=prev.materialize_s if on_path else 0.0,
            # overlap window: restore-return → fully resident (known only
            # once the background tail finished; 0.0 while still live)
            materialize_to_resident_s=(
                tail.done_at - tail.t0
                if on_path and tail is not None and tail.done_at is not None
                else 0.0),
            # tail-wait time is attributed to whichever invocation's faults
            # actually blocked on the pending install — including warm
            # invocations racing a still-live tail
            tail_wait_s=stats.tail_wait_seconds - tws0,
        )
        self.report = dataclasses.replace(
            self.report,
            stages=stages,
            n_prefetched_pages=self.report.n_prefetched_pages if on_path else 0,
            ws_cache_hit=self.report.ws_cache_hit if on_path else False,
            prewarmed=self.prewarmed,
            processing_s=dt,
            fault_s=stats.fault_seconds - fs0,
            n_faults=stats.n_faults - f0,
            tail_waits=stats.tail_waits - tw0,
        )
        self.last_used = self.clock()
        return logits, dt

    def make_warm(self):
        """Promote to a memory-resident (warm) instance: materialize params
        as tensors on the instance's device so later invocations skip the
        arena entirely."""
        fam = get_family(self.cfg)
        specs = fam.param_specs(self.cfg)
        self.monitor.arena.touch_pages(
            sorted(set().union(*[set(self.monitor.arena.layout.pages_of(f"params/{p}"))
                                 for p, _ in nnspec.tree_paths(specs)])))
        self._warm_params = nnspec.map_leaves(
            lambda p, s: self.monitor.arena.tensor(
                f"params/{p}", fault=False).to(self.device, copy=True), specs)

    def finish_cold(self) -> dict:
        if self.monitor.mode == "vanilla":
            stats = self.monitor.arena.stats
            return {"mode": "vanilla", "n_faults": stats.n_faults,
                    "fault_s": stats.fault_seconds,
                    "resident_bytes": self.monitor.arena.resident_bytes}
        return self.monitor.finish()

    def reclaim(self):
        """Unconditional teardown (caller must know the instance is not
        mid-invocation); prefer :meth:`try_reclaim` on shared paths.  A
        live background tail is cancelled and joined first so the arena
        never closes under the tail worker's writes."""
        with self._state_lock:
            self.state = State.RECLAIMED
        self.cancel_tail(join=True)
        if self.monitor is not None:
            self.monitor.arena.close()
        self._warm_params = None


def restore_group(instances: list[FunctionInstance], *,
                  materialize: bool = False) -> list[FunctionInstance]:
    """Restore N instances of ONE function as a single staged batch.

    The batch performs one manifest parse, one WS fetch and one fused
    page-gather pass for the whole group, then one vectorized install per
    arena — instead of N full pipelines with N single-flight cache waits
    and N per-page install loops.  ``materialize=True`` additionally makes
    every instance warm (param residency) inside the timed ``materialize``
    stage (the prewarm path).
    """
    pipes = [inst._pipeline() for inst in instances]
    RestoreBatch(pipes).run()
    k = len(instances)
    for inst, pipe in zip(instances, pipes):
        inst._adopt(pipe, batch_size=k)
    if materialize:
        try:
            for inst, pipe in zip(instances, pipes):
                pipe.materialize(inst.make_warm)
        except BaseException:
            # a failed materialization (e.g. records dropped mid-spawn)
            # must not leak the group's already-adopted arenas
            for inst in instances:
                inst.reclaim()
            raise
    return instances
