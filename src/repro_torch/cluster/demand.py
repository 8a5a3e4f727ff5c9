"""Fleet-wide demand plane: merge every node's arrivals, forecast, and
push warm targets to the *owner shards* ahead of spillover.

The :class:`~repro_torch.serving.PrewarmPolicy` is per-node: each instance of
it sees only the arrivals its own router admitted.  Under a diurnal ramp
that is exactly wrong — the warm node saturates, the scheduler spills the
overflow onto other hosts, and those hosts' policies have *no history* for
the function, so every spillover placement lands cold.  The
:class:`DemandAggregator` closes the loop at the fleet level:

  1. **Merge** — each step drains a dedicated arrival tap on every alive
     node's router (``Router.open_tap``: the node's local policy keeps its
     own tap, so neither consumer starves the other) and folds the union
     into one :class:`~repro_torch.serving.ForecastDemand` per function —
     fleet-wide rate, fleet-wide periodicity.
  2. **Forecast** — the blended model (phase-binned periodicity profile
     over EWMA, forecast.py) predicts each function's fleet arrival rate
     over the lookahead horizon, i.e. *ahead* of the ramp.
  3. **Route to owners** — the predicted rate is split across the
     function's alive owner shards (the :class:`ConsistentHashRing` lookup
     the sharded store already uses) and pushed as a hinted rate share
     (:meth:`PrewarmPolicy.push_forecast`).  Owners are where spillover
     wants to land anyway (``w_owner`` in the placement score, and their
     L1 caches hold the WS), so prewarming them turns the ramp's spillover
     placements into ``prewarmed=True`` serves.

Hints carry a TTL: a wedged aggregator can never pin warm pools.  Ring
membership changes (kill_node / rebalance / join) call :meth:`retarget`,
which drops every outstanding hint so the next step re-pushes against the
new ownership map — replicas of a dead owner start prewarming within one
control interval.
"""
from __future__ import annotations

import dataclasses
import threading
import time

from ..serving.forecast import ForecastConfig, ForecastDemand
from ..serving.policy import PolicyConfig

_NO_NODES: frozenset[str] = frozenset()

FLEET_TAP = "fleet-demand"


@dataclasses.dataclass
class DemandConfig:
    interval_s: float = 0.1          # aggregator loop period
    hint_ttl_s: float = 2.0          # pushed hints expire after this
    # The *single* safety factor on the fleet rate split (the receiving
    # policy converts the pushed rate to a warm target without adding its
    # own headroom — see PrewarmPolicy._fleet_target).
    headroom: float = 1.5
    min_push_rate: float = 0.1       # rps below which no hint is pushed
    owners_per_function: int | None = None  # None => store replication
    # demand-model knobs (window/EWMA) and the periodicity detector's
    policy: PolicyConfig | None = None
    forecast: ForecastConfig | None = None


class DemandAggregator:
    """Fleet-level control loop over a :class:`ClusterRouter`.

    Runs on a daemon thread like the per-node policy, but every decision
    is a pure function of ingested timestamps + the ring, so tests drive
    :meth:`ingest` + :meth:`step` with a fake clock.
    """

    def __init__(self, cluster, cfg: DemandConfig | None = None, *,
                 clock=time.monotonic):
        self.cluster = cluster
        self.cfg = cfg or DemandConfig()
        self.clock = clock
        pcfg = self.cfg.policy or PolicyConfig()
        self._pcfg = pcfg
        self._fcfg = self.cfg.forecast or ForecastConfig()
        self.demand: dict[str, ForecastDemand] = {}
        self.pushed: dict[str, set[str]] = {}   # function -> hinted node ids
        self.n_steps = 0
        self.n_pushes = 0
        self.n_errors = 0
        self.last_error: BaseException | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._mu = threading.RLock()

    # -- demand ingestion ----------------------------------------------

    def attach_node(self, node) -> None:
        """Open this aggregator's arrival tap on a node's router."""
        node.router.open_tap(FLEET_TAP)

    def ingest(self, arrivals: dict[str, list[float]]) -> None:
        with self._mu:
            for name, ts in arrivals.items():
                d = self.demand.get(name)
                if d is None:
                    d = self.demand[name] = ForecastDemand(
                        self._pcfg, self._fcfg, clock=self.clock)
                d.observe(ts)

    def _drain_nodes(self) -> None:
        for node in self.cluster.alive_nodes():
            self.ingest(node.router.drain_arrivals(tap=FLEET_TAP))

    # -- forecast routing ----------------------------------------------

    def _owner_nodes(self, name: str) -> list:
        """Alive owner-shard nodes for ``name`` in ring preference order
        (falls back to the whole alive fleet when the store is absent or
        every owner is dead)."""
        store = self.cluster.store
        alive = {n.node_id: n for n in self.cluster.alive_nodes()}
        if store is not None:
            n_owners = self.cfg.owners_per_function
            if n_owners is None:
                ids = store.owners(name)
            else:
                ids = store.ring.lookup(name, n_owners)
            owners = [alive[i] for i in ids if i in alive]
            if owners:
                return owners
        return list(alive.values())

    def _clear(self, name: str, keep: set[str] = _NO_NODES) -> None:
        """Withdraw ``name``'s hints from every node not in ``keep``."""
        for node_id in self.pushed.get(name, set()) - set(keep):
            node = self.cluster.nodes.get(node_id)
            if node is not None and node.alive:
                node.clear_forecast(name)
        if keep:
            self.pushed[name] = set(keep)
        else:
            self.pushed.pop(name, None)

    def step(self, now: float | None = None) -> dict[str, float]:
        """One control iteration; returns per-function fleet rates pushed."""
        with self._mu:
            return self._step_locked(now)

    def _step_locked(self, now: float | None) -> dict[str, float]:
        self._drain_nodes()
        now = self.clock() if now is None else now
        pushed_rates: dict[str, float] = {}
        forgotten: list[str] = []
        for name, d in self.demand.items():
            if d.forgettable(now):
                self._clear(name)
                forgotten.append(name)
                continue
            rate = d.rate(now) * self.cfg.headroom
            if not d.active(now) or rate < self.cfg.min_push_rate:
                self._clear(name)
                continue
            owners = self._owner_nodes(name)
            if not owners:
                self._clear(name)
                continue
            share = rate / len(owners)
            expires = now + self.cfg.hint_ttl_s
            for node in owners:
                node.push_forecast(name, share, expires)
                self.n_pushes += 1
            self._clear(name, keep={n.node_id for n in owners})
            pushed_rates[name] = rate
        for name in forgotten:
            del self.demand[name]
        self.n_steps += 1
        return pushed_rates

    def retarget(self) -> None:
        """Drop every outstanding hint (ring membership changed); the next
        step re-pushes against the current ownership map."""
        with self._mu:
            for name in list(self.pushed):
                self._clear(name)

    # -- forecast persistence -------------------------------------------

    def export_profiles(self, now: float | None = None) -> dict[str, dict]:
        """Serializable periodicity profiles for every function whose
        detector has (or inherited) a confident period — what
        ``ClusterRouter.close`` writes alongside the snapshot store."""
        with self._mu:
            now = self.clock() if now is None else now
            out = {}
            for name, d in self.demand.items():
                state = d.export_state(now)
                if state is not None:
                    out[name] = state
            return out

    def seed_profiles(self, profiles: dict[str, dict]) -> int:
        """Install persisted profiles (``build_fleet`` reload path):
        creates a pre-seeded :class:`ForecastDemand` per function so the
        next control step prewarms day-one ramps before any arrival.
        Returns how many profiles were accepted."""
        n = 0
        with self._mu:
            for name, state in profiles.items():
                d = self.demand.get(name)
                if d is None:
                    d = self.demand[name] = ForecastDemand(
                        self._pcfg, self._fcfg, clock=self.clock)
                if d.seed_state(state):
                    n += 1
        return n

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "DemandAggregator":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="demand-aggregator", daemon=True)
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
                # a racing node death mid-step must not kill the fleet's
                # control loop; persistent failure is observable via stats
                self.n_errors += 1
                self.last_error = e
                continue

    def stats(self) -> dict:
        with self._mu:
            now = self.clock()
            return {
                "steps": self.n_steps,
                "pushes": self.n_pushes,
                "errors": self.n_errors,
                "last_error": (repr(self.last_error)
                               if self.last_error else None),
                "functions": {n: {"rate": d.rate(now),
                                  "active": d.active(now),
                                  "period": (d.detector.detect(now) or
                                             (None,))[0]}
                              for n, d in self.demand.items()},
                "pushed": {n: sorted(ids) for n, ids in self.pushed.items()},
            }
