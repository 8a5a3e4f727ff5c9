"""SPES-style adaptive prewarming control plane (the provisioning policy).

The router's data plane reacts *after* an arrival: a burst pays a cold start for
every instance the warm pool is short.  This module closes the loop the way
SPES (Lee et al.) and "How Low Can You Go?" (Tan et al.) argue for — predict
arrivals from per-function history and pre-spawn instances *off* the
invocation critical path:

  * **Demand model** (:class:`FunctionDemand`) — per-function inter-arrival
    EWMA plus a sliding-window arrival rate, fed from the router's arrival
    timestamps (``Router.drain_arrivals``).  The window catches bursts; the
    EWMA smooths them into a keepalive horizon.
  * **Target sizing** — Little's-law concurrency demand: predicted rate x
    estimated (warm) service time x a headroom factor, clamped to
    ``max_warm``.  The target becomes the function's ``min_warm`` floor (the
    keepalive reaper never shrinks below it) and its per-function
    ``warm_limit`` (replacing the static global knob).
  * **Prewarming** — when the target exceeds instances that exist or are
    being spawned, :meth:`Orchestrator.prewarm` cold-starts the difference
    on pool threads; arrivals then find IDLE instances and never pay
    ``load_vmm_s``/``prefetch_s`` (their reports carry ``prewarmed=True``).
  * **Adaptive keepalive** — per-function keepalive tracks the expected
    inter-arrival gap (a few EWMA horizons), so hot functions stay resident
    and cold ones scale to zero quickly (paper §2's keepalive/memory
    tradeoff).

Two demand signals beyond the reactive model feed the same actuators:

  * **Periodicity forecasts** — ``PolicyConfig(forecast=True)`` swaps the
    demand model for :class:`~repro_torch.serving.forecast.ForecastDemand`,
    which folds arrival history into a phase-binned rate profile and
    raises targets *ahead* of a learned ramp (forecast.py).
  * **Fleet hints** — a cluster-level aggregator (cluster/demand.py) may
    :meth:`PrewarmPolicy.push_forecast` a TTL'd rate share for functions
    whose traffic lands on *other* nodes; the step actuates
    ``max(local target, fleet target)``, so owner-shard replicas are warm
    before spillover placements arrive.

The loop runs on a daemon thread (:meth:`PrewarmPolicy.start`) but every
decision is a pure function of ingested timestamps, so tests drive
:meth:`ingest` + :meth:`step` directly — with ``clock=`` injecting a fake
monotonic clock (tests/fakeclock.py) they run in milliseconds.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque

from .orchestrator import FunctionRecord, Orchestrator
from .router import Router


@dataclasses.dataclass
class PolicyConfig:
    interval_s: float = 0.1          # control-loop period
    window_s: float = 5.0            # sliding window for the arrival rate
    ewma_alpha: float = 0.3          # inter-arrival EWMA smoothing factor
    headroom: float = 2.0            # safety factor over Little's-law demand
    max_warm: int = 8                # per-function warm-target ceiling
    default_service_s: float = 0.05  # service-time prior (no samples yet)
    service_samples: int = 32        # recent invocations in the estimate
    keepalive_horizons: float = 8.0  # keepalive = this many EWMA inter-arrivals
    min_keepalive_s: float = 0.5
    max_keepalive_s: float = 60.0
    max_prewarms_per_step: int = 2   # actuation rate limit per function/step
    sweep: bool = True               # run the keepalive reaper each step
    forecast: bool = False           # periodicity-aware demand (forecast.py)
    forecast_cfg: object | None = None  # ForecastConfig when forecast=True


class FunctionDemand:
    """Arrival model for one function: windowed rate + inter-arrival EWMA.

    ``clock`` supplies "now" whenever a caller omits it (tests inject a
    fake monotonic clock so timing assertions never sleep).
    """

    def __init__(self, cfg: PolicyConfig, *, clock=time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.window: deque[float] = deque()
        self.last_arrival: float | None = None
        self.ewma_interarrival: float | None = None
        self.n_arrivals = 0

    def observe(self, timestamps: list[float]) -> None:
        for t in sorted(timestamps):
            if self.last_arrival is not None:
                gap = max(t - self.last_arrival, 1e-9)
                a = self.cfg.ewma_alpha
                self.ewma_interarrival = (
                    gap if self.ewma_interarrival is None
                    else a * gap + (1 - a) * self.ewma_interarrival)
            self.last_arrival = t
            self.window.append(t)
            self.n_arrivals += 1

    def _trim(self, now: float) -> None:
        horizon = now - self.cfg.window_s
        while self.window and self.window[0] < horizon:
            self.window.popleft()

    def rate(self, now: float | None = None) -> float:
        """Predicted arrival rate (rps): max of the windowed empirical rate
        and the EWMA rate — the window reacts to bursts, the EWMA keeps a
        just-ended burst from zeroing the forecast instantly."""
        now = self.clock() if now is None else now
        self._trim(now)
        windowed = len(self.window) / self.cfg.window_s
        ewma = (1.0 / self.ewma_interarrival
                if self.ewma_interarrival else 0.0)
        return max(windowed, ewma if self.active(now) else 0.0)

    def peak_concurrency(self, service_s: float,
                         now: float | None = None) -> int:
        """Max arrivals landing within one service time anywhere in the
        window — the instantaneous concurrency a burst demands.  Little's
        law alone misses this: an 8-wide simultaneous burst needs 8 warm
        instances no matter how low the average rate is."""
        now = self.clock() if now is None else now
        self._trim(now)
        ts = list(self.window)
        peak = 0
        lo = 0
        for hi in range(len(ts)):
            while ts[hi] - ts[lo] > max(service_s, 1e-9):
                lo += 1
            peak = max(peak, hi - lo + 1)
        return peak

    def active(self, now: float | None = None) -> bool:
        """Demand is live while the gap since the last arrival is within the
        adaptive keepalive horizon."""
        now = self.clock() if now is None else now
        return (self.last_arrival is not None
                and now - self.last_arrival <= self.keepalive(now))

    def forgettable(self, now: float | None = None) -> bool:
        """May the policy drop this demand entry once its target hits zero?
        The reactive model holds no state worth keeping past its keepalive;
        the forecasting subclass overrides this to preserve a learned
        period through traffic troughs."""
        now = self.clock() if now is None else now
        return not self.active(now)

    def gap_estimate(self, now: float | None = None) -> float | None:
        """Expected inter-arrival gap, robust to bursts: the raw EWMA is
        dominated by tiny intra-burst gaps (a burst of 8 back-to-back
        arrivals drives it to ~0), which would collapse the keepalive right
        before the *next* burst.  Taking the max with the windowed mean gap
        keeps the horizon tied to how often traffic actually recurs.

        None when there is no recurrence evidence at all (a single stray
        arrival whose window has expired): such functions must scale down
        *fast*, not be pinned at the maximum keepalive.
        """
        now = self.clock() if now is None else now
        self._trim(now)
        cands = []
        if self.ewma_interarrival is not None:
            cands.append(self.ewma_interarrival)
        if self.window:
            cands.append(self.cfg.window_s / len(self.window))
        return max(cands) if cands else None

    def keepalive(self, now: float | None = None) -> float:
        now = self.clock() if now is None else now
        gap = self.gap_estimate(now)
        if gap is None:
            return self.cfg.min_keepalive_s
        return min(self.cfg.max_keepalive_s,
                   max(self.cfg.min_keepalive_s,
                       self.cfg.keepalive_horizons * gap))


class PrewarmPolicy:
    """Background control loop: router arrivals in, provisioning out.

    Actuators per function (all on the orchestrator):

      * ``set_policy(warm_limit=, keepalive_s=, min_warm=)``
      * ``prewarm(name, n)`` for the warm-pool deficit
      * ``reap_idle()`` each step so adaptive keepalive takes effect
    """

    def __init__(self, orch: Orchestrator, router: Router | None = None,
                 cfg: PolicyConfig | None = None, *, clock=time.monotonic):
        self.orch = orch
        self.router = router
        self.cfg = cfg or PolicyConfig()
        self.clock = clock
        self.demand: dict[str, FunctionDemand] = {}
        self.targets: dict[str, int] = {}
        # fleet-pushed forecast rates: name -> (rate_rps, expires_at).  The
        # cluster demand plane (cluster/demand.py) pushes these to the
        # owner-shard nodes so replicas prewarm before spillover lands.
        self.fleet: dict[str, tuple[float, float]] = {}
        self.n_steps = 0
        self.n_prewarms = 0
        self.n_errors = 0
        self.last_error: BaseException | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # guards demand/targets against callers (ingest/stats) racing the
        # loop thread; reentrant because step() ingests internally
        self._mu = threading.RLock()

    # -- demand ingestion ----------------------------------------------

    def _new_demand(self) -> FunctionDemand:
        if self.cfg.forecast:
            from .forecast import ForecastDemand
            return ForecastDemand(self.cfg, self.cfg.forecast_cfg,
                                  clock=self.clock)
        return FunctionDemand(self.cfg, clock=self.clock)

    def ingest(self, arrivals: dict[str, list[float]]) -> None:
        """Feed per-function arrival timestamps (``time.monotonic``)."""
        with self._mu:
            for name, ts in arrivals.items():
                d = self.demand.get(name)
                if d is None:
                    d = self.demand[name] = self._new_demand()
                d.observe(ts)

    def push_forecast(self, name: str, rate_rps: float,
                      expires_at: float) -> None:
        """Accept a fleet-wide demand forecast for ``name`` (rate share
        this node should be warm for).  Hints expire at ``expires_at`` so
        a dead aggregator can never pin warm pools forever."""
        with self._mu:
            self.fleet[name] = (rate_rps, expires_at)

    def clear_forecast(self, name: str) -> None:
        with self._mu:
            self.fleet.pop(name, None)

    def _fleet_target(self, name: str, rec: FunctionRecord,
                      now: float) -> int:
        """Warm instances the fleet forecast asks this node to hold.

        The pushed rate already carries the aggregator's safety factor
        (DemandConfig.headroom) — applying ``self.cfg.headroom`` on top
        would square the margin, so Little's law runs on the rate as-is.
        """
        hint = self.fleet.get(name)
        if hint is None:
            return 0
        rate, expires = hint
        if now >= expires or rate <= 0:
            return 0
        demand = rate * self._service_estimate(rec)
        return min(self.cfg.max_warm, max(1, math.ceil(demand)))

    def _service_estimate(self, rec: FunctionRecord) -> float:
        with rec.lock:
            recent = rec.stats[-self.cfg.service_samples:]
            samples = [r.processing_s for r in recent if r.processing_s > 0]
        if not samples:
            return self.cfg.default_service_s
        return sum(samples) / len(samples)

    def _restore_estimate(self, rec: FunctionRecord) -> float:
        """Mean observed cold-restore cost (load VMM + connection + WS
        prefetch) — what an under-provisioned arrival would pay."""
        with rec.lock:
            recent = rec.stats[-self.cfg.service_samples:]
            samples = [r.load_vmm_s + r.connection_s + r.prefetch_s
                       for r in recent if r.load_vmm_s > 0]
        if not samples:
            return self.cfg.default_service_s
        return sum(samples) / len(samples)

    def target_for(self, name: str, now: float | None = None) -> int:
        """Warm-pool target: Little's-law concurrency demand with headroom,
        floored by the burst width the window has actually seen.

        The burst horizon is service + restore time: two arrivals landing
        within one cold-restore duration need two warm instances — the
        second can't wait for a reactive spawn without paying cold.
        """
        now = self.clock() if now is None else now
        d = self.demand.get(name)
        rec = self.orch.functions.get(name)
        if d is None or rec is None or not d.active(now):
            return 0
        svc = self._service_estimate(rec)
        little = d.rate(now) * svc * self.cfg.headroom
        burst = d.peak_concurrency(svc + self._restore_estimate(rec), now)
        return min(self.cfg.max_warm, max(1, math.ceil(max(little, burst))))

    # -- control loop ---------------------------------------------------

    def step(self, now: float | None = None) -> dict[str, int]:
        """One control iteration; returns the per-function targets applied."""
        with self._mu:
            return self._step_locked(now)

    def _step_locked(self, now: float | None) -> dict[str, int]:
        if self.router is not None:
            self.ingest(self.router.drain_arrivals())
        now = self.clock() if now is None else now
        inflight: dict[str, int] = {}
        if self.router is not None:
            inflight = self.router.stats()["inflight"]
        applied: dict[str, int] = {}
        stale: list[str] = []
        for name, (_, expires) in list(self.fleet.items()):
            if now >= expires:
                del self.fleet[name]
        # visit every name with live demand or a hint, plus any actuated
        # last step — an expired/withdrawn hint must still get one pass
        # through the target-0 branch to drop its min_warm floor
        names = (set(self.demand) | set(self.fleet)
                 | {n for n, t in self.targets.items() if t > 0})
        for name in names:
            d = self.demand.get(name)
            rec = self.orch.functions.get(name)
            if rec is None:
                stale.append(name)
                continue
            # the local reactive/forecast target and the fleet-pushed
            # forecast are independent demand signals; warm for the larger
            target = max(self.target_for(name, now),
                         self._fleet_target(name, rec, now))
            applied[name] = target
            if target > 0:
                # The limit is a capacity cap, the target a residency floor.
                # Only ever *raise* the cap above the orchestrator default —
                # shrinking it below would reclaim instances the reactive
                # path could have parked; memory is recovered through the
                # adaptive keepalive sweep instead.
                # a fleet-hint-only function has no local arrival history;
                # its residency is carried by the min_warm floor, so the
                # keepalive just needs to be sane, not adaptive
                keepalive = (d.keepalive(now) if d is not None
                             else self.cfg.min_keepalive_s)
                self.orch.set_policy(
                    name,
                    warm_limit=max(target, self.orch.warm_limit),
                    keepalive_s=keepalive,
                    min_warm=target)
                with rec.lock:
                    have = len(rec.idle) + rec.n_prewarming
                have += inflight.get(name, 0)  # busy instances rejoin the pool
                # rate-limit actuation so a burst can't trigger a prewarm
                # storm that steals cycles from in-flight invocations
                deficit = min(target - have, self.cfg.max_prewarms_per_step)
                if deficit > 0:
                    self.n_prewarms += self.orch.prewarm(name, deficit)
            else:
                # demand went stale: drop the floor and leave a *short*
                # keepalive so residual instances scale to zero fast (the
                # static default may be a minute).  The reactive model is
                # then forgotten — fresh traffic rebuilds its history —
                # but a forecasting model that still holds a learned
                # period (forgettable() False) is kept through the trough.
                self.orch.set_policy(name, warm_limit=None,
                                     keepalive_s=self.cfg.min_keepalive_s,
                                     min_warm=0)
                if d is None or d.forgettable(now):
                    stale.append(name)
        for name in stale:
            self.demand.pop(name, None)
            self.fleet.pop(name, None)
        self.targets = applied
        if self.cfg.sweep:
            self.orch.reap_idle()
        self.n_steps += 1
        return applied

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "PrewarmPolicy":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="prewarm-policy", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.step()
            except Exception as e:
                # a policy hiccup (e.g. a function being deregistered
                # mid-step) must never kill the control loop — but a loop
                # that errors every step must be observable via stats()
                self.n_errors += 1
                self.last_error = e
                continue

    def __enter__(self) -> "PrewarmPolicy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stats(self) -> dict:
        with self._mu:
            now = self.clock()
            return {
                "steps": self.n_steps,
                "prewarms_scheduled": self.n_prewarms,
                "errors": self.n_errors,
                "last_error": (repr(self.last_error)
                               if self.last_error else None),
                "targets": dict(self.targets),
                "fleet_hints": {n: rate for n, (rate, exp) in
                                self.fleet.items() if now < exp},
                "keepalives": {n: d.keepalive(now)
                               for n, d in self.demand.items()},
            }
