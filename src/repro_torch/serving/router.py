"""Concurrent serving data plane: per-function queues + a worker pool.

The paper's scalability experiment (Fig. 9) drives many *concurrent*
cold-starts; this router is the data plane that makes such load runnable
in-process.  Architecture:

  * **Per-function FIFO queues** — invocations of one function are ordered;
    functions are dispatched round-robin for fairness.
  * **Worker pool** — ``max_concurrency`` threads execute invocations
    against the orchestrator.  Page-fault and WS-read I/O release the GIL,
    so cold-start I/O genuinely overlaps across workers.
  * **Admission control** — the AWS-Lambda one-invocation-per-instance
    model (orchestrator.py): a function with fewer than
    ``max_instances_per_function`` in-flight invocations may *spawn* (or
    reuse) an instance; beyond that, arrivals *queue*.  A queue longer than
    ``queue_depth`` rejects the submit (the 429/throttle analogue).

Every accepted invocation resolves to an :class:`Invocation` future whose
report carries the queueing delay (``report.queue_s``) as a first-class
timing segment next to the paper's load/connect/prefetch/processing split.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any

from ..core.reap import ColdStartReport
from ..telemetry import TELEMETRY
from .orchestrator import Orchestrator


class AdmissionError(RuntimeError):
    """Submit rejected: the per-function queue is at ``queue_depth``."""


class RouterClosedError(RuntimeError):
    """The router was closed while this invocation was still queued."""


@dataclasses.dataclass
class RouterConfig:
    max_concurrency: int = 8            # worker-pool size (global)
    max_instances_per_function: int = 8  # queue-or-spawn threshold
    queue_depth: int = 1024             # per-function backlog bound
    # Group-restore ceiling: a worker dispatching a cold invocation counts
    # the same-function waiters still queued behind it and the orchestrator
    # restores the whole group as ONE batch (one WS fetch, one fused
    # install pass — core/restore.py).  1 disables batching (every cold
    # start runs its own pipeline, pre-PR-5 behaviour).
    batch_restore_limit: int = 8


class Invocation:
    """Future for one accepted invocation."""

    def __init__(self, name: str, batch: dict, force_cold: bool,
                 *, clock=time.perf_counter):
        self.name = name
        self.batch = batch
        self.force_cold = force_cold
        self.t_submit = clock()
        self.queue_s = 0.0
        self.group_hint = 1              # set at dispatch: cold-group size
        self._done = threading.Event()
        self._output: Any = None
        self._report: ColdStartReport | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> tuple[Any, ColdStartReport]:
        if not self._done.wait(timeout):
            raise TimeoutError(f"invocation of {self.name!r} still pending")
        if self._error is not None:
            raise self._error
        return self._output, self._report

    @property
    def report(self) -> ColdStartReport:
        return self.result()[1]

    def _resolve(self, output: Any, report: ColdStartReport) -> None:
        self._output, self._report = output, report
        self._done.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._done.set()


class Router:
    """Dispatches queued invocations onto a bounded worker pool.

    ``start=False`` builds the router paused (submits enqueue only) — used
    by tests and by the load generator to stage a burst, then ``start()``.
    """

    def __init__(self, orch: Orchestrator, cfg: RouterConfig | None = None,
                 *, start: bool = True, clock=time.perf_counter,
                 arrival_clock=time.monotonic, registry=None):
        self.orch = orch
        self.cfg = cfg or RouterConfig()
        self.registry = TELEMETRY if registry is None else registry
        # queue/drain deltas use ``clock``; arrival taps use
        # ``arrival_clock`` because the policy/demand consumers compare
        # those stamps against their own monotonic clocks
        self.clock = clock
        self.arrival_clock = arrival_clock
        self._cv = threading.Condition()
        self._queues: dict[str, deque[Invocation]] = {}
        self._rr: deque[str] = deque()     # round-robin function order
        self._inflight: dict[str, int] = {}
        # per-function arrival timestamps (time.monotonic) fanned out to
        # one deque per *tap*: the default tap feeds the node's prewarming
        # policy loop; the cluster demand plane opens its own tap so both
        # consumers see every arrival (a single queue would let whichever
        # drains first starve the other).  Bounded so an idle consumer
        # can't leak memory.
        self._taps: dict[str, dict[str, deque[float]]] = {
            self.DEFAULT_TAP: {}}
        self.max_arrival_history = 4096
        self._closed = False
        self._started = False
        self._workers: list[threading.Thread] = []
        self.completed = 0
        self.rejected = 0
        if start:
            self.start()

    # -- client API ----------------------------------------------------

    def submit(self, name: str, batch: dict, *,
               force_cold: bool = False) -> Invocation:
        """Enqueue one invocation; returns its future.

        Raises :class:`AdmissionError` when the function's backlog is full.
        """
        inv = Invocation(name, batch, force_cold, clock=self.clock)
        with self._cv:
            if self._closed:
                raise RouterClosedError("router is closed")
            q = self._queues.get(name)
            if q is None:
                q = self._queues[name] = deque()
                self._rr.append(name)
                self._inflight.setdefault(name, 0)
            # demand signal for the policy loop(s): every arrival counts,
            # including ones the admission controller is about to throttle
            t_arr = self.arrival_clock()
            for tap in self._taps.values():
                arr = tap.get(name)
                if arr is None:
                    arr = tap[name] = deque(
                        maxlen=self.max_arrival_history)
                arr.append(t_arr)
            if len(q) >= self.cfg.queue_depth:
                self.rejected += 1
                self.registry.inc("router.rejected")
                raise AdmissionError(
                    f"{name}: queue depth {self.cfg.queue_depth} exceeded")
            q.append(inv)
            self._cv.notify()
        self.registry.inc("router.submitted")
        return inv

    def invoke(self, name: str, batch: dict, *, force_cold: bool = False,
               timeout: float | None = None) -> tuple[Any, ColdStartReport]:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(name, batch, force_cold=force_cold).result(timeout)

    def map(self, items: list[tuple[str, dict]],
            *, force_cold: bool = False) -> list[tuple[Any, ColdStartReport]]:
        """Submit a batch of (function, request) pairs; wait for all."""
        invs = [self.submit(n, b, force_cold=force_cold) for n, b in items]
        return [inv.result() for inv in invs]

    def start(self) -> None:
        with self._cv:
            if self._started or self._closed:
                return
            self._started = True
            for i in range(self.cfg.max_concurrency):
                t = threading.Thread(target=self._worker_loop,
                                     name=f"router-worker-{i}", daemon=True)
                self._workers.append(t)
                t.start()

    def drain(self, timeout: float | None = None) -> None:
        """Block until every accepted invocation has resolved."""
        deadline = None if timeout is None else self.clock() + timeout
        with self._cv:
            while (any(self._queues.values())
                   or any(self._inflight.values())):
                left = None if deadline is None else deadline - self.clock()
                if left is not None and left <= 0:
                    raise TimeoutError("router drain timed out")
                self._cv.wait(timeout=left)

    def close(self, *, drain: bool = True) -> None:
        """Shut the router down.

        ``drain=True`` waits for every accepted invocation first.  With
        ``drain=False`` (or on a never-started router) still-queued
        invocations are failed with :class:`RouterClosedError` — a waiter
        blocked in ``result()`` must never hang forever on a closed router.
        """
        if drain and self._started:
            self.drain()
        with self._cv:
            self._closed = True
            abandoned = [inv for q in self._queues.values() for inv in q]
            for q in self._queues.values():
                q.clear()
            self._cv.notify_all()
        for inv in abandoned:
            inv._fail(RouterClosedError(
                f"router closed with {inv.name!r} still queued"))
        for t in self._workers:
            t.join(timeout=5.0)

    DEFAULT_TAP = "policy"

    def open_tap(self, tap: str) -> str:
        """Create an independent arrival stream named ``tap`` (idempotent).
        Every subsequent submit is recorded into it; drain it with
        ``drain_arrivals(tap=...)``."""
        with self._cv:
            self._taps.setdefault(tap, {})
        return tap

    def drain_arrivals(self, tap: str = DEFAULT_TAP) -> dict[str, list[float]]:
        """Pop and return per-function arrival timestamps accumulated in
        ``tap`` since its previous drain (``time.monotonic`` values, submit
        order).  Draining one tap never disturbs another's backlog."""
        with self._cv:
            arrivals = self._taps.get(tap, {})
            out = {n: list(d) for n, d in arrivals.items() if d}
            for d in arrivals.values():
                d.clear()
        return out

    def stats(self) -> dict:
        with self._cv:
            return {
                "queued": {n: len(q) for n, q in self._queues.items() if q},
                "inflight": {n: c for n, c in self._inflight.items() if c},
                "completed": self.completed,
                "rejected": self.rejected,
            }

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    # -- worker pool ---------------------------------------------------

    def _next_locked(self) -> Invocation | None:
        """Pick the next dispatchable invocation (round-robin across
        functions); called with ``_cv`` held."""
        for _ in range(len(self._rr)):
            name = self._rr[0]
            self._rr.rotate(-1)
            q = self._queues[name]
            if q and self._inflight[name] < self.cfg.max_instances_per_function:
                self._inflight[name] += 1
                inv = q.popleft()
                # group-restore hint: same-function waiters still queued
                # behind this invocation that the instance budget will let
                # dispatch concurrently — if this dispatch goes cold, the
                # orchestrator restores the whole group as one batch
                budget = (self.cfg.max_instances_per_function
                          - self._inflight[name])
                inv.group_hint = 1 + min(
                    len(q), budget, max(self.cfg.batch_restore_limit - 1, 0))
                return inv
        return None

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                inv = self._next_locked()
                while inv is None and not self._closed:
                    self._cv.wait()
                    inv = self._next_locked()
                if inv is None:      # closed and nothing dispatchable
                    return
            inv.queue_s = self.clock() - inv.t_submit
            self.registry.observe("router.queue_s", inv.queue_s)
            try:
                out, rep = self.orch.invoke(inv.name, inv.batch,
                                            force_cold=inv.force_cold,
                                            group_hint=inv.group_hint)
                rep = dataclasses.replace(rep, queue_s=inv.queue_s)
                inv._resolve(out, rep)
            except BaseException as e:  # propagate to the waiter, keep serving
                inv._fail(e)
            finally:
                with self._cv:
                    self._inflight[inv.name] -= 1
                    self.completed += 1
                    self._cv.notify_all()
                self.registry.inc("router.completed")


def percentile(xs: list[float], q: float) -> float:
    """Nearest-rank percentile of ``xs`` (q in [0, 100])."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[k]


def summarize(reports: list[ColdStartReport]) -> dict:
    """Latency summary of a batch of per-invocation reports.

    ``stage_seconds`` is the canonical mean per-stage schema
    (:class:`~repro_torch.core.reap.StageTimings` keys) — the same dict shape
    ``WorkerNode.stats`` and the benchmark artifacts emit, with the
    overlapped-restore tail-wait time attributed separately.
    """
    from ..core.reap import StageTimings
    n = max(len(reports), 1)
    e2e = [r.e2e_s for r in reports]
    # an invocation is "cold" when restore cost landed on its critical path
    cold = sum(1 for r in reports if r.load_vmm_s > 0)
    stage = {k: 0.0 for k in StageTimings().as_dict()}
    for r in reports:
        for k, v in r.stages.as_dict().items():
            stage[k] += v
    return {
        "n": len(reports),
        "queue_mean_s": sum(r.queue_s for r in reports) / n,
        "queue_p95_s": percentile([r.queue_s for r in reports], 95),
        "total_mean_s": sum(r.total_s for r in reports) / n,
        "e2e_p50_s": percentile(e2e, 50),
        "e2e_p95_s": percentile(e2e, 95),
        "ws_cache_hits": sum(1 for r in reports if r.ws_cache_hit),
        "cold": cold,
        "cold_fraction": cold / n,
        "prewarmed": sum(1 for r in reports if r.prewarmed),
        # group-restore attribution (restore.py): invocations whose cold
        # instance was restored in a batch, and the install-stage cost
        "batched": sum(1 for r in reports
                       if r.load_vmm_s > 0 and r.batch_size > 1),
        "install_mean_s": sum(r.install_s for r in reports) / n,
        "stage_seconds": {k: v / n for k, v in stage.items()},
        # overlapped restore: faults that blocked on a background tail
        "tail_waits": sum(r.tail_waits for r in reports),
        "tail_wait_mean_s": stage["tail_wait_s"] / n,
    }
