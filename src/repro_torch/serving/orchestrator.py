"""vHive-CRI orchestrator analogue: function registry, instance pool,
autoscaler-lite with keepalive + scale-to-zero.

The orchestrator owns the snapshot store and the per-function REAP records.
Per the paper's AWS-Lambda model, one instance processes one invocation at
a time; concurrent invocations of the same function spawn additional
instances (Fig. 9's scalability experiment drives exactly this path).

Cold starts run through the staged restore pipeline (core/restore.py) and
are **batched**: when the router reports a queue of same-function cold
waiters (``group_hint``), :meth:`Orchestrator.invoke` restores the whole
group through :meth:`spawn_batch` — one WS fetch and one fused install pass
for N instances — parking the extras in the function's *fresh pool* for the
waiters to claim.  Prewarm bursts take the same path (one group restore per
``prewarm`` call instead of n single-instance pipelines).

With span recording on, :meth:`Orchestrator.invoke` opens ``acquire``
(the restore stages of a cold start nest in it) inside the calling
thread's current trace, or opens the invocation's root itself when called
without a router; a prewarm group is a ``prewarm`` trace of its own.

Every public method is thread-safe: the router's worker pool (router.py)
calls :meth:`invoke` from many threads while the keepalive reaper runs
concurrently.  Instances move IDLE -> BUSY only via
``FunctionInstance.try_acquire`` and are torn down only via
``try_reclaim``, which refuses BUSY instances — so a reaper racing an
invocation can never pull the arena out from under it.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

from ..configs.base import ModelConfig
from ..core import build_instance_snapshot
from ..core.reap import ColdStartReport, StageTimings, drop_record
from ..telemetry import TELEMETRY
from .config import ServeConfig
from .instance import FunctionInstance, restore_group


def request_attrs(name: str, batch: dict) -> dict:
    """An invocation trace's attributes: the function and the request's
    batch, length and token count (where it carries ``tokens``)."""
    shape = getattr(batch.get("tokens"), "shape", ())
    if len(shape) != 2:
        return {"function": name}
    return {"function": name, "batch": int(shape[0]), "length": int(shape[1]),
            "tokens": int(shape[0]) * int(shape[1])}


class FunctionRecord:
    """Per-function state: snapshot base, warm pool, invocation stats.

    ``lock`` is a condition variable guarding ``idle``, ``fresh`` and
    ``stats``; ``n_spawned`` / ``n_invocations`` / ``n_prewarmed`` are
    monotone counters updated under the same lock.  ``fresh`` holds
    batch-restored instances that have never served an invocation: a cold
    arrival that claims one still pays (reports) the group's restore split.
    ``batch_pending`` counts fresh instances an in-flight group restore
    will deliver — cold arrivals wait on it instead of spawning duplicates.

    ``warm_limit`` / ``keepalive_s`` are per-function overrides (None =>
    inherit the orchestrator-wide default); ``min_warm`` is the adaptive
    policy's floor — the keepalive reaper never shrinks the idle pool below
    it (policy.py owns all three).
    """

    def __init__(self, name: str, cfg: ModelConfig, base: str):
        self.name = name
        self.cfg = cfg
        self.base = base
        self.lock = threading.Condition()
        self.idle: list[FunctionInstance] = []
        self.fresh: list[FunctionInstance] = []
        self.batch_pending = 0
        self.stats: list[ColdStartReport] = []
        self.n_spawned = 0
        self.n_batched = 0               # instances restored in groups > 1
        self.n_invocations = 0
        self.n_prewarmed = 0
        self.n_prewarming = 0            # prewarms currently on pool threads
        self.n_prewarm_failures = 0
        self.last_prewarm_error: BaseException | None = None
        self.warm_limit: int | None = None
        self.keepalive_s: float | None = None
        self.min_warm = 0


class Orchestrator:
    def __init__(self, store_dir: str, config: ServeConfig | None = None, *,
                 ws_cache=None, clock=time.monotonic):
        """``config`` (a :class:`~repro_torch.serving.ServeConfig`, default
        ``ServeConfig()``) carries every knob, the device included; it
        enables overlapped restore by default.  ``ws_cache``: WS page cache
        every instance prefetches through (None => process-wide default).
        The JAX package's pre-ServeConfig keyword knobs are not ported."""
        if config is None:
            config = ServeConfig()
        self.config = config
        self.clock = clock   # monotonic seconds: keepalive/quiesce deadlines
        self.store_dir = store_dir
        self.reap = config.resolved_reap()
        self.mode = config.mode
        self.device = config.torch_device
        self.ws_cache = ws_cache
        self.keepalive_s = config.keepalive_s
        self.warm_limit = config.warm_limit
        self.prewarm_concurrency = config.prewarm_concurrency
        self.functions: dict[str, FunctionRecord] = {}
        self._lock = threading.Lock()
        self._prewarm_pool: ThreadPoolExecutor | None = None
        self._prewarm_futures: list[Future] = []
        # live background tail installs spawned by this orchestrator's
        # group restores (bounded; drained by tail_quiesce / tail_stats)
        self._tails: deque = deque(maxlen=512)
        self._closed = False
        os.makedirs(store_dir, exist_ok=True)

    def _effective_warm_limit(self, rec: FunctionRecord) -> int:
        return self.warm_limit if rec.warm_limit is None else rec.warm_limit

    def _effective_keepalive(self, rec: FunctionRecord) -> float:
        return self.keepalive_s if rec.keepalive_s is None else rec.keepalive_s

    # -- control plane -------------------------------------------------

    def register(self, name: str, cfg: ModelConfig, *, seed: int = 0,
                 rebuild: bool = False,
                 warmup_batch: dict | None = None) -> FunctionRecord:
        base = os.path.join(self.store_dir, name)
        if rebuild or not os.path.exists(base + ".mem"):
            build_instance_snapshot(cfg, base, seed=seed)
            drop_record(base)
        if warmup_batch is not None:
            # deploy-time compile of all invocation executables (the paper's
            # analogue: booting/initialization happens once, off the
            # invocation critical path)
            from .instance import ExecutableCache
            ExecutableCache.warm(cfg, warmup_batch, self.device)
        with self._lock:
            rec = self.functions.get(name)
            if rec is None:
                rec = FunctionRecord(name, cfg, base)
                self.functions[name] = rec
        return rec

    def reset_records(self, name: str) -> None:
        drop_record(self.functions[name].base)

    @staticmethod
    def _force_reclaim(inst: FunctionInstance) -> bool:
        """Reclaim an instance that may carry a live tail install: cancel
        the tail (join) first, then reclaim.  Returns False only when the
        instance is BUSY."""
        if inst.try_reclaim():
            return True
        inst.cancel_tail(join=True)
        return inst.try_reclaim()

    def scale_to_zero(self, name: str) -> None:
        """Reclaim every idle/fresh instance of ``name``.  Unlike the
        keepalive reaper this is a *forced* path: live background tail
        installs are cancelled (and joined) so the arenas actually close.

        The pools are snapshotted (and emptied) under ``rec.lock`` but the
        reclaims run *outside* it: cancelling a live tail joins its worker
        future (up to seconds), and holding the record condvar across that
        join would stall every invoke/release on this function — and order
        ``rec.lock`` under the tail worker's own blocking.  Instances the
        reclaim must keep (a BUSY straggler) are re-parked afterwards.
        """
        rec = self.functions[name]
        with rec.lock:
            idle, rec.idle = rec.idle, []
            fresh, rec.fresh = rec.fresh, []
        keep_idle = [i for i in idle if not self._force_reclaim(i)]
        keep_fresh = [i for i in fresh if not self._force_reclaim(i)]
        if keep_idle or keep_fresh:
            with rec.lock:
                rec.idle.extend(keep_idle)
                rec.fresh.extend(keep_fresh)

    def set_policy(self, name: str, *, warm_limit: int | None = None,
                   keepalive_s: float | None = None,
                   min_warm: int | None = None) -> None:
        """Per-function provisioning knobs (the policy loop's actuators).

        ``warm_limit``/``keepalive_s`` of None restore the orchestrator-wide
        defaults; ``min_warm`` is the reaper floor (always explicit).
        """
        rec = self.functions[name]
        with rec.lock:
            rec.warm_limit = warm_limit
            rec.keepalive_s = keepalive_s
            if min_warm is not None:
                rec.min_warm = min_warm

    def idle_count(self, name: str) -> int:
        """Warm instances currently parked for ``name`` (0 if unknown) —
        the cluster scheduler's warm-availability signal."""
        rec = self.functions.get(name)
        if rec is None:
            return 0
        with rec.lock:
            return len(rec.idle)

    def warm_counts(self) -> dict[str, int]:
        """Idle warm instances per registered function (the canonical
        ``warm_instances`` stat — telemetry/schema.py)."""
        with self._lock:
            records = dict(self.functions)
        out = {}
        for name, rec in records.items():
            with rec.lock:
                out[name] = len(rec.idle)
        return out

    def prewarm(self, name: str, n: int, *, wait: bool = False) -> int:
        """Pre-spawn up to ``n`` warm instances of ``name`` on a pool thread.

        The cold-start cost (load VMM, connection restore, WS prefetch,
        param materialization) is paid here — *off* every invocation's
        critical path — and the whole burst restores as **one** group
        (one WS fetch, one fused install pass) instead of n single-flight
        pipelines.  Spawns are capped so the idle pool never exceeds the
        function's warm limit, counting prewarms already in flight.
        Returns the number of spawns actually scheduled.
        """
        rec = self.functions[name]
        with self._lock:
            if self._closed:             # never resurrect the pool after close
                return 0
            if self._prewarm_pool is None:
                self._prewarm_pool = ThreadPoolExecutor(
                    max_workers=self.prewarm_concurrency,
                    thread_name_prefix="prewarm")
            pool = self._prewarm_pool
        with rec.lock:
            limit = self._effective_warm_limit(rec)
            allowed = min(n, limit - len(rec.idle) - rec.n_prewarming)
            if allowed <= 0:
                scheduled = 0
            else:
                rec.n_prewarming += allowed
                scheduled = allowed
        if scheduled:
            try:
                fut = pool.submit(self._prewarm_group, rec, scheduled)
            except RuntimeError:        # pool shut down by a concurrent close
                with rec.lock:
                    rec.n_prewarming -= scheduled
                return 0
            with self._lock:
                self._prewarm_futures = (
                    [f for f in self._prewarm_futures if not f.done()] + [fut])
        if wait:
            self.prewarm_quiesce()
        return scheduled

    def prewarm_quiesce(self, timeout: float | None = None) -> None:
        """Block until every scheduled prewarm has finished (test/bench aid).

        ``timeout`` bounds the *total* wait, not the wait per prewarm.
        """
        deadline = None if timeout is None else self.clock() + timeout
        with self._lock:
            futs = list(self._prewarm_futures)
        for f in futs:
            left = None if deadline is None else deadline - self.clock()
            f.result(left)

    def _prewarm_group(self, rec: FunctionRecord, n: int) -> None:
        insts: list[FunctionInstance] = []
        try:
            with TELEMETRY.root("prewarm", function=rec.name, n=n):
                insts = self.spawn_batch(rec.name, n, prewarmed=True,
                                         materialize=True)
            if insts[0].monitor.mode == "record":
                # No WS record existed yet (function was never cold-invoked):
                # persist one from the pages make_warm just faulted, so REAP
                # prefetch engages on the next true cold start instead of the
                # function staying permanently recordless behind warm pools.
                # A mispredicted record self-corrects via the §7.2 re-record
                # fallback.
                for inst in insts:
                    inst.finish_cold()
            leftover: list[FunctionInstance] = []
            with rec.lock:
                rec.n_prewarmed += len(insts)
                for inst in insts:
                    if len(rec.idle) < self._effective_warm_limit(rec):
                        rec.idle.append(inst)
                    else:
                        leftover.append(inst)  # limit shrank mid-spawn
            for inst in leftover:
                self._force_reclaim(inst)
        except BaseException as e:
            # a failed prewarm (e.g. records dropped mid-spawn) must neither
            # leak half-built instances nor detonate later out of a Future
            # in prewarm_quiesce — record it and move on
            with rec.lock:
                rec.n_prewarm_failures += 1
                rec.last_prewarm_error = e
            for inst in insts:
                inst.reclaim()
        finally:
            with rec.lock:
                rec.n_prewarming -= n

    def tail_quiesce(self, timeout: float | None = None) -> int:
        """Block until every tracked background tail install has finished
        (installed, demoted, or cancelled); returns how many were waited
        on.  ``timeout`` bounds the total wait."""
        deadline = None if timeout is None else self.clock() + timeout
        with self._lock:
            tails = list(self._tails)
        n = 0
        for t in tails:
            left = None if deadline is None else max(
                deadline - self.clock(), 0.001)
            try:
                t.wait(left)
            except BaseException:
                pass
            n += 1
        return n

    def tail_stats(self) -> dict:
        """Counters over tracked background tail installs + per-arena
        fault-wait totals (live = still installing)."""
        with self._lock:
            tails = list(self._tails)
        out = {"tracked": len(tails),
               "live": sum(1 for t in tails if not t.done()),
               "demoted": sum(1 for t in tails if t.demoted)}
        waits = wait_s = 0
        with self._lock:
            records = list(self.functions.values())
        for rec in records:
            with rec.lock:
                for r in rec.stats:
                    waits += r.tail_waits
                    wait_s += r.stages.tail_wait_s
        out["tail_waits"] = waits
        out["tail_wait_seconds"] = wait_s
        return out

    def stage_seconds(self) -> dict:
        """Mean per-stage seconds across every recorded invocation report
        (the same ``stage_seconds`` schema Router.summarize emits)."""
        totals = {k: 0.0 for k in StageTimings().as_dict()}
        n = 0
        with self._lock:
            records = list(self.functions.values())
        for rec in records:
            with rec.lock:
                reports = list(rec.stats)
            for r in reports:
                n += 1
                for k, v in r.stages.as_dict().items():
                    totals[k] += v
        return {k: v / max(n, 1) for k, v in totals.items()}

    def reap_idle(self) -> int:
        """Keepalive sweep: reclaim instances idle past the deadline.

        Safe to run concurrently with ``invoke``: an instance that a worker
        just acquired is BUSY and ``try_reclaim`` refuses it.  Never shrinks
        a function's idle pool below its policy floor (``min_warm``), so an
        adaptive target survives keepalive expiry.  Fresh (batch-restored,
        never-invoked) instances expire on the same deadline but are not
        protected by the floor — they are surplus from an over-sized group.
        """
        now = self.clock()
        n = 0
        with self._lock:
            records = list(self.functions.values())
        for rec in records:
            with rec.lock:
                keepalive = self._effective_keepalive(rec)
                # oldest-first so the floor keeps the most recently used
                candidates = sorted(rec.idle, key=lambda i: i.last_used)
                keep = []
                n_idle = len(candidates)
                for inst in candidates:
                    if (n_idle > rec.min_warm
                            and now - inst.last_used > keepalive
                            and inst.try_reclaim()):
                        n += 1
                        n_idle -= 1
                    else:
                        keep.append(inst)
                rec.idle = keep
                stale = [i for i in rec.fresh
                         if now - i.last_used > keepalive]
                if stale:
                    rec.fresh = [i for i in rec.fresh if i not in stale]
            for inst in stale:
                if inst.try_reclaim():
                    n += 1
        return n

    def close(self) -> None:
        """Tear down the prewarm pool and reclaim every idle instance.

        Permanent: later ``prewarm`` calls become no-ops (a policy loop
        still winding down must not resurrect the pool).
        """
        with self._lock:
            self._closed = True
            pool, self._prewarm_pool = self._prewarm_pool, None
            self._prewarm_futures = []
        if pool is not None:
            pool.shutdown(wait=True)
        for name in list(self.functions):
            self.scale_to_zero(name)

    # -- data plane ------------------------------------------------------

    def spawn_batch(self, name: str, n: int, *, prewarmed: bool = False,
                    materialize: bool = False) -> list[FunctionInstance]:
        """Restore ``n`` instances of ``name`` as ONE staged group.

        The group shares a single manifest parse, a single WS fetch and a
        single fused page-gather pass (core/restore.py); each instance then
        installs the shared block with one vectorized scatter.  Returns the
        instances (IDLE, not parked anywhere).
        """
        rec = self.functions[name]
        n = max(1, n)
        mode = "vanilla" if self.mode == "vanilla" else "auto"
        insts = [FunctionInstance(rec.name, rec.cfg, rec.base, self.reap,
                                  device=self.device,
                                  mode=mode, prewarmed=prewarmed,
                                  ws_cache=self.ws_cache, clock=self.clock)
                 for _ in range(n)]
        restore_group(insts, materialize=materialize)
        tails = [i._tail for i in insts if i._tail is not None]
        if tails:
            with self._lock:
                self._tails.extend(tails)
        with rec.lock:
            rec.n_spawned += n
            if n > 1:
                rec.n_batched += n
        return insts

    def _pop_fresh_locked(self, rec: FunctionRecord):
        while rec.fresh:
            inst = rec.fresh.pop()
            if inst.try_acquire():
                return inst
            # lost a race with a reaper; instance is already dead
        return None

    def _acquire_instance(self, rec: FunctionRecord, force_cold: bool,
                          group_hint: int = 1) -> tuple[FunctionInstance, bool]:
        """Pop a warm instance (atomically marking it BUSY) or cold-start.

        The cold path is group-aware: a fresh (batch-restored) instance is
        claimed first; else, while a group restore is in flight
        (``batch_pending``), the caller waits for its delivery instead of
        spawning a duplicate; else it becomes the spawner for a group of up
        to ``group_hint`` (1 + the same-function cold waiters the router
        saw queued behind this invocation).  Returns (instance, was_cold).
        """
        if not force_cold:
            with rec.lock:
                while rec.idle:
                    inst = rec.idle.pop()
                    if inst.try_acquire():
                        return inst, False
                    # lost a race with a reaper; instance is already dead
        extra = 0
        with rec.lock:
            while True:
                inst = self._pop_fresh_locked(rec)
                if inst is not None:
                    return inst, True
                if rec.batch_pending > 0:
                    # a group restore in flight will deliver fresh
                    # instances; joining it beats spawning a duplicate.
                    # The timeout is a liveness backstop (a delivery
                    # notify can never be missed under the condvar).
                    rec.lock.wait(timeout=60.0)
                    continue
                # become the spawner; cover waiters the router saw queued,
                # minus restores already in flight for them
                extra = max(0, group_hint - 1)
                rec.batch_pending += extra
                break
        try:
            insts = self.spawn_batch(rec.name, 1 + extra)
        except BaseException:
            with rec.lock:
                rec.batch_pending -= extra
                rec.lock.notify_all()    # waiters fall through to self-spawn
            raise
        insts[0].try_acquire()
        with rec.lock:
            rec.fresh.extend(insts[1:])
            rec.batch_pending -= extra
            rec.lock.notify_all()
        return insts[0], True

    def _release_instance(self, rec: FunctionRecord, inst: FunctionInstance,
                          report: ColdStartReport) -> None:
        inst.release()
        with rec.lock:
            rec.stats.append(report)
            rec.n_invocations += 1
            # never re-park after close(): the teardown sweep already ran
            # and nothing would ever reclaim a late-parked arena
            if not self._closed and len(rec.idle) < self._effective_warm_limit(rec):
                rec.idle.append(inst)
                return
        self._force_reclaim(inst)

    def invoke(self, name: str, batch: dict, *, force_cold: bool = False,
               group_hint: int = 1) -> tuple[Any, ColdStartReport]:
        """Route one invocation; cold-starts a new instance if needed.

        ``group_hint`` (from the router) is the number of same-function
        invocations — this one included — believed to need cold instances
        right now; a cold start restores that many as one batch.
        """
        with TELEMETRY.root("invocation", **request_attrs(name, batch)) as tr:
            logits, report = self._invoke(name, batch, force_cold, group_hint)
            tr.annotate(cold=report.load_vmm_s > 0)
        return logits, report

    def _invoke(self, name: str, batch: dict, force_cold: bool,
                group_hint: int) -> tuple[Any, ColdStartReport]:
        rec = self.functions[name]
        with TELEMETRY.span("acquire"):
            inst, cold = self._acquire_instance(rec, force_cold, group_hint)
        try:
            logits, _ = inst.invoke(
                batch, parallel_faults=self.reap.parallel_faults)
            if cold:
                inst.finish_cold()
                inst.make_warm()  # stays memory-resident until reclaimed
        except BaseException:
            # failed invocation: never return the instance to the warm pool,
            # and never leak its arena mmap (a live tail is cancelled first)
            inst.release()
            self._force_reclaim(inst)
            raise
        report = inst.report
        self._release_instance(rec, inst, report)
        return logits, report
