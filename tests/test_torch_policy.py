"""The port's control plane against the JAX package's: the same inputs, the
same decisions.

The scenarios of ``test_policy.py``, ``test_forecast.py``,
``test_trace_determinism.py`` and ``test_azure_trace.py`` are replayed
through both packages on the fake clock (``tests/fakeclock.py``): the
demand model's rates and keepalives, the prewarm policy's targets, knobs
and prewarm counts, the periodicity detector's periods, profiles and
forecasts, the fleet demand plane's pushed hints, the trace generators'
events and their JSON, the load generators' outcomes and the stats
snapshotter's samples must be identical.  The policy runs against a
recording orchestrator (its actuators logged, its service history fixed),
so its decisions are a pure function of the inputs; one test drives the
port's real orchestrator on the CPU.
"""
import os
import threading
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from fakeclock import FakeClock  # noqa: E402

import repro.cluster.demand as jax_demand  # noqa: E402
import repro.serving as jax_serving  # noqa: E402
import repro.telemetry as jax_telemetry  # noqa: E402
import repro_torch.cluster.demand as torch_demand  # noqa: E402
import repro_torch.serving as torch_serving  # noqa: E402
import repro_torch.telemetry as torch_telemetry  # noqa: E402

PKGS = {"jax": jax_serving, "torch": torch_serving}
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "azure_sample.csv")
NAMES = ["fn_a", "fn_b", "fn_c"]


def both(fn):
    """``fn(serving package)`` for each package; asserts equal results."""
    out = {k: fn(mod) for k, mod in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


# -- demand model ------------------------------------------------------------

DEMAND_SCENARIOS = {
    # test_policy.py::test_demand_rate_and_keepalive: 10 rps for 2 s
    "steady": ([1000.0 - 2.0 + 0.1 * i for i in range(20)], 1000.0,
               dict(window_s=5.0, keepalive_horizons=8.0, min_keepalive_s=0.5,
                    max_keepalive_s=60.0)),
    # test_demand_burst_width_and_robust_keepalive: two 4-wide bursts
    "bursts": ([50.0 - 1.5] * 4 + [50.0] * 4, 50.0,
               dict(window_s=5.0, keepalive_horizons=8.0, min_keepalive_s=0.1)),
    "seeded": (sorted(100.0 + np.random.default_rng(4).exponential(0.3, 60).cumsum()),
               120.0, {}),
}


@pytest.mark.parametrize("scenario", sorted(DEMAND_SCENARIOS))
def test_function_demand_replay(scenario):
    ts, now, kw = DEMAND_SCENARIOS[scenario]

    def run(pkg):
        d = pkg.FunctionDemand(pkg.PolicyConfig(**kw))
        d.observe([float(t) for t in ts])
        out = []
        for dt in (0.0, 0.7, 1.4, 5.0, 100.0):
            t = now + dt
            out.append((d.rate(t), d.keepalive(t), d.active(t), d.forgettable(t),
                        d.gap_estimate(t), d.peak_concurrency(0.05, t),
                        d.peak_concurrency(0.5, t)))
        return out, d.ewma_interarrival, d.n_arrivals
    both(run)


# -- prewarm policy ------------------------------------------------------------

class RecordingOrch:
    """The orchestrator surface ``PrewarmPolicy`` reads and actuates:
    ``functions`` with a fixed service history, ``set_policy``/``prewarm``/
    ``reap_idle`` logged.  ``prewarm`` schedules what it is asked and parks
    the instances at once (as ``prewarm(wait=True)`` would)."""

    warm_limit = 8

    def __init__(self, processing_s=(), restore_s=()):
        stats = [types.SimpleNamespace(processing_s=p, load_vmm_s=r, connection_s=0.0,
                                       prefetch_s=0.0)
                 for p, r in zip(processing_s, restore_s)]
        self.functions = {"fn": types.SimpleNamespace(
            lock=threading.Lock(), stats=stats, idle=[],
            n_prewarming=0, warm_limit=None, keepalive_s=None, min_warm=0)}
        self.log = []

    def set_policy(self, name, *, warm_limit=None, keepalive_s=None, min_warm=None):
        rec = self.functions[name]
        rec.warm_limit, rec.keepalive_s = warm_limit, keepalive_s
        if min_warm is not None:
            rec.min_warm = min_warm
        self.log.append(("set_policy", name, warm_limit, keepalive_s, min_warm))

    def prewarm(self, name, n, *, wait=False):
        self.functions[name].idle += [object()] * n
        self.log.append(("prewarm", name, n))
        return n

    def reap_idle(self):
        self.log.append(("reap_idle",))
        return 0


def _policy_run(pkg, script, cfg_kw, history=((), ())):
    """Drive one policy through ``script``: a list of (op, arg) where op is
    ingest / push / clear / advance / step.  Returns every step's applied
    targets, the policy's stats, and the orchestrator's actuator log."""
    clock = FakeClock(start=1000.0)
    orch = RecordingOrch(*history)
    policy = pkg.PrewarmPolicy(orch, router=None, cfg=pkg.PolicyConfig(**cfg_kw),
                               clock=clock)
    steps = []
    for op, arg in script:
        if op == "ingest":
            policy.ingest({"fn": [clock.now + t for t in arg]})
        elif op == "push":
            policy.push_forecast("fn", arg[0], expires_at=clock.now + arg[1])
        elif op == "clear":
            policy.clear_forecast("fn")
        elif op == "advance":
            clock.advance(arg)
        else:
            steps.append(policy.step())
    st = policy.stats()
    return steps, st, orch.log, policy.n_prewarms, sorted(policy.demand)


POLICY_SCENARIOS = {
    # test_policy_step_prewarms_and_sets_knobs: a steady 20 rps history
    "steady": ([("ingest", [-1.0 + 0.05 * i for i in range(20)]), ("step", None),
                ("advance", 0.5), ("step", None)],
               dict(window_s=5.0, headroom=2.0, max_warm=4, sweep=False),
               ((0.02, 0.03, 0.025), (0.01, 0.012, 0.011))),
    # test_policy_target_zero_when_demand_stops
    "demand_stops": ([("ingest", [-0.2, -0.1, 0.0]), ("step", None),
                      ("advance", 10_000.0), ("step", None)],
                     dict(sweep=False), ((), ())),
    # test_policy_fleet_hint_prewarms_without_local_arrivals
    "fleet_hint": ([("push", (40.0, 5.0)), ("step", None), ("advance", 10.0),
                    ("step", None)],
                   dict(headroom=2.0, max_warm=4, sweep=False), ((0.04,), (0.02,))),
    # test_policy_fleet_hint_withdrawn_on_clear
    "hint_cleared": ([("push", (40.0, 60.0)), ("step", None), ("clear", None),
                      ("step", None)], dict(sweep=False), ((), ())),
    # a burst that outgrows Little's law, under the keepalive sweep
    "burst_sweep": ([("ingest", [0.0] * 6), ("step", None), ("advance", 0.3),
                     ("ingest", [0.0] * 3), ("step", None), ("advance", 100.0),
                     ("step", None)],
                    dict(max_warm=8, max_prewarms_per_step=3), ((0.05,), (0.4,))),
    # the forecasting demand model behind the same actuators
    "forecast": ([("ingest", [-60.0 + 10.0 * c + 2.0 + 0.1 * i for c in range(6)
                              for i in range(12)]), ("step", None), ("advance", 1.0),
                  ("step", None), ("advance", 5.0), ("step", None)],
                 dict(window_s=5.0, forecast=True), ((0.05,), (0.1,))),
}


@pytest.mark.parametrize("scenario", sorted(POLICY_SCENARIOS))
def test_prewarm_policy_decisions_replay(scenario):
    script, cfg_kw, history = POLICY_SCENARIOS[scenario]

    def run(pkg):
        kw = dict(cfg_kw)
        if kw.get("forecast"):
            kw["forecast_cfg"] = pkg.ForecastConfig(
                bin_s=0.5, history_s=80.0, min_period_s=2.0, max_period_s=30.0,
                lookahead_s=2.0)
        return _policy_run(pkg, script, kw, history)
    steps, _stats, log, n_prewarms, _ = both(run)
    assert any(s.get("fn", 0) > 0 for s in steps)     # each scenario actuates
    if scenario in ("steady", "fleet_hint"):
        assert n_prewarms >= 1 and any(e[0] == "prewarm" for e in log)


def test_port_policy_prewarms_a_real_orchestrator(tmp_path):
    """The policy's step against the port's own orchestrator on the CPU: a
    fleet hint alone prewarms an instance, and the next arrival is served
    by it without a restore on its critical path."""
    from repro_torch.configs import SMOKES
    cfg = SMOKES["olmo-1b"]
    batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab, (2, 16),
                                                         dtype=np.int32)}
    orch = torch_serving.Orchestrator(
        str(tmp_path), torch_serving.ServeConfig(overlap_install=False, device="cpu"))
    try:
        orch.register("fn", cfg, warmup_batch=batch)
        orch.invoke("fn", batch)                      # record
        orch.scale_to_zero("fn")
        clock = FakeClock()
        policy = torch_serving.PrewarmPolicy(
            orch, router=None, cfg=torch_serving.PolicyConfig(max_warm=4, sweep=False),
            clock=clock)
        policy.push_forecast("fn", 40.0, expires_at=clock.now + 5.0)
        assert policy.step()["fn"] >= 1
        orch.prewarm_quiesce(timeout=120)
        _, rep = orch.invoke("fn", batch)
        assert rep.prewarmed and rep.load_vmm_s == 0.0 and rep.processing_s > 0
        clock.advance(10.0)
        assert policy.step().get("fn", 0) == 0 and orch.functions["fn"].min_warm == 0
    finally:
        orch.close()


# -- periodicity forecasts ---------------------------------------------------

FCFG = dict(bin_s=0.5, history_s=80.0, min_period_s=2.0, max_period_s=30.0,
            min_cycles=2.0, lookahead_s=2.0)


def periodic_stream(t0, period, cycles, *, busy_at=2.0, busy_len=1.5, n_busy=12,
                    seed=0):
    rng = np.random.default_rng(seed)
    ts = []
    for c in range(cycles):
        ts += list(t0 + c * period + busy_at + rng.uniform(0, busy_len, size=n_busy))
    return sorted(float(t) for t in ts)


DETECTOR_STREAMS = {
    "periodic": (periodic_stream(100.0, 10.0, 6), 160.0, {}),
    "phase_shifted": (periodic_stream(100.0, 10.0, 6, busy_at=6.0), 160.0, {}),
    "aperiodic": (sorted(float(t) for t in
                         100.0 + np.random.default_rng(3).exponential(0.7, 100).cumsum()),
                  160.0, {}),
    "too_little": (periodic_stream(150.0, 10.0, 1), 160.0, {}),
    "hinted": (periodic_stream(145.0, 10.0, 1) + periodic_stream(155.0, 10.0, 1), 160.0,
               {"period_hint_s": 10.0}),
    "hinted_short": (periodic_stream(145.0, 10.0, 1), 160.0, {"period_hint_s": 10.0}),
}


@pytest.mark.parametrize("stream", sorted(DETECTOR_STREAMS))
def test_periodicity_detector_replay(stream):
    ts, now, extra = DETECTOR_STREAMS[stream]

    def run(pkg):
        det = pkg.PeriodicityDetector(pkg.ForecastConfig(**FCFG, **extra),
                                      clock=FakeClock(now))
        det.observe(ts)
        found = det.detect()
        prof = det.profile()
        state = det.to_state()
        fresh = pkg.PeriodicityDetector(pkg.ForecastConfig(**FCFG, **extra),
                                        clock=FakeClock(now))
        return (found, None if prof is None else prof.tolist(), state,
                [det.forecast_rate(now + dt, 1.0) for dt in (0.5, 2.5, 6.5, 7.3)],
                fresh.seed(state), fresh.detect(), det.span())
    found, _prof, _state, _rates, _seeded, _, _ = both(run)
    if stream in ("periodic", "phase_shifted"):
        assert found is not None and found[0] == pytest.approx(10.0, abs=0.5)


@pytest.mark.parametrize("stream", ["periodic", "aperiodic"])
def test_forecast_demand_replay(stream):
    ts = (periodic_stream(100.0, 10.0, 6) if stream == "periodic" else
          sorted(float(t) for t in
                 100.0 + np.random.default_rng(9).exponential(0.25, 120).cumsum()))

    def run(pkg):
        d = pkg.ForecastDemand(pkg.PolicyConfig(window_s=5.0), pkg.ForecastConfig(**FCFG),
                               clock=FakeClock(161.0))
        d.observe(ts)
        return ([(d.rate(t), d.active(t), d.forgettable(t), d.keepalive(t))
                 for t in (130.0, 161.0, 162.5, 166.0, 166.0 + 140.0)],
                d.export_state(161.0))
    both(run)


# -- traces --------------------------------------------------------------------

TRACES = {
    "diurnal": lambda p: p.diurnal_trace(
        base_rps=1.0, peak_rps=12.0, period_s=2.0, duration_s=6.0, functions=NAMES,
        burst_rps=8.0, burst_every_s=2.0, seed=5),
    "poisson": lambda p: p.poisson_trace(
        rate_rps=5.0, duration_s=2.0, functions=NAMES, mix={"fn_a": 2.0, "fn_b": 1.0},
        modality_mix={"text": 1.0, "vision": 1.0}, seed=1),
    "uniform": lambda p: p.uniform_trace(5, 0.25, NAMES, seed=3),
    "azure": lambda p: p.azure_trace(FIXTURE, functions=NAMES, duration_s=6.0, seed=7),
    "azure_all_rows": lambda p: p.azure_trace(FIXTURE),
    "azure_top1_3min": lambda p: p.azure_trace(FIXTURE, functions=["f"], max_minutes=3),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_events_and_json_replay(name, tmp_path):
    def run(pkg):
        tr = TRACES[name](pkg)
        path = tmp_path / f"{pkg.__name__}.json"
        tr.save(str(path))
        back = pkg.Trace.load(str(path))
        assert back.events == tr.events and back.period_hint_s == tr.period_hint_s
        return ([(e.t, e.function, e.modality, e.seed) for e in tr.events],
                tr.period_hint_s, tr.duration_s, tr.functions, path.read_bytes())
    events, *_ = both(run)
    assert events


AZURE_BAD = {
    "dirty": ("HashOwner,HashApp,HashFunction,Trigger,1,2,3\n"
              "o1,a1,good,http,4,5,6\no2,a2,garbled,http,4,notanumber,6\n"
              "o3,a3,short,http\no4,a4,good2,queue,1,0,2\n", None),
    "hopeless": ("HashOwner,1,2\no1,x,y\no2,nan_ish,zz\n", "malformed"),
    "quiet": ("HashOwner,1,2\no1,0,0\n", None),
    "no_minutes": ("HashOwner,HashApp,Trigger\n", "minute"),
    "header_only": ("HashOwner,1,2,3\n", "no function rows"),
}


@pytest.mark.parametrize("case", sorted(AZURE_BAD))
def test_azure_malformed_input_replay(case, tmp_path):
    text, error = AZURE_BAD[case]
    p = tmp_path / f"{case}.csv"
    p.write_text(text)

    def run(pkg):
        if error is not None:
            with pytest.raises(ValueError, match=error) as exc:
                pkg.azure_trace(str(p))
            return str(exc.value)
        return [(e.t, e.function) for e in pkg.azure_trace(str(p)).events]
    both(run)


# -- load generators -------------------------------------------------------------

class FakeRouter:
    """Answers at once; throttles every third submit (AdmissionError of
    the package under test)."""

    def __init__(self, pkg):
        self.pkg, self.n = pkg, 0

    def submit(self, name, batch):
        self.n += 1
        if self.n % 3 == 0:
            raise self.pkg.AdmissionError("full")
        rep = types.SimpleNamespace(name=name, seed=batch["seed"])
        return types.SimpleNamespace(result=lambda timeout=None: (None, rep))

    def invoke(self, name, batch):
        return self.submit(name, batch).result()


@pytest.mark.parametrize("kind", ["open", "closed"])
def test_load_generators_replay(kind):
    def run(pkg):
        trace = pkg.uniform_trace(7, 0.0, NAMES, seed=11)
        make = lambda ev: {"seed": ev.seed}         # noqa: E731
        if kind == "open":
            gen = pkg.OpenLoopGenerator(FakeRouter(pkg), trace, make, sleep=lambda s: None)
        else:
            gen = pkg.ClosedLoopGenerator(FakeRouter(pkg), trace, make, n_clients=1)
        return [(ev.function, ev.seed, None if rep is None else (rep.name, rep.seed))
                for ev, rep in gen.run()]
    out = both(run)
    assert sum(r is None for *_, r in out) == 2          # throttles are outcomes


# -- fleet demand plane ----------------------------------------------------------

class StubNode:
    def __init__(self, node_id, arrivals):
        self.node_id, self.alive, self.hints = node_id, True, []
        self.router = types.SimpleNamespace(
            open_tap=lambda tap: None,
            drain_arrivals=lambda tap=None: arrivals.pop(node_id, {}))

    def push_forecast(self, name, rate, expires):
        self.hints.append(("push", name, rate, expires))

    def clear_forecast(self, name):
        self.hints.append(("clear", name))


def test_demand_aggregator_replay():
    """Arrivals merged from three nodes, forecast, split over the owner
    shards (the ring of each package), re-targeted after a node dies."""
    def run(pkgs):
        serving, demand, cluster = pkgs
        clock = FakeClock(1000.0)
        arrivals = {"node-0": {"fa": [999.0 + 0.05 * i for i in range(20)]},
                    "node-1": {"fa": [999.5], "fb": [999.9, 1000.0]}}
        nodes = {f"node-{i}": StubNode(f"node-{i}", arrivals) for i in range(3)}
        ring = cluster.ConsistentHashRing(sorted(nodes), vnodes=16)
        fleet = types.SimpleNamespace(
            nodes=nodes, store=types.SimpleNamespace(
                owners=lambda name: ring.lookup(name, 2), ring=ring),
            alive_nodes=lambda: [n for n in nodes.values() if n.alive])
        agg = demand.DemandAggregator(fleet, demand.DemandConfig(headroom=1.5),
                                      clock=clock)
        for n in nodes.values():
            agg.attach_node(n)
        rates = [agg.step()]
        clock.advance(0.5)
        nodes[ring.lookup("fa", 1)[0]].alive = False
        agg.retarget()
        rates.append(agg.step())
        clock.advance(600.0)
        rates.append(agg.step())
        return rates, {k: n.hints for k, n in nodes.items()}, agg.n_pushes
    import repro.cluster as jax_cluster
    import repro_torch.cluster as torch_cluster
    out = {"jax": run((jax_serving, jax_demand, jax_cluster)),
           "torch": run((torch_serving, torch_demand, torch_cluster))}
    assert out["torch"] == out["jax"]
    assert out["torch"][2] > 0


# -- stats snapshotter -----------------------------------------------------------

def test_stats_snapshotter_samples_replay(tmp_path):
    def run(tel):
        clock = FakeClock(5.0)
        path = tmp_path / f"{tel.__name__}.jsonl"
        snap = tel.StatsSnapshotter(interval_s=1.0, path=str(path), clock=clock,
                                    registry=tel.MetricsRegistry())
        n = {"calls": 0}

        def src():
            n["calls"] += 1
            if n["calls"] == 2:
                raise RuntimeError("node died")
            return {"ws_hits": n["calls"], "warm_counts": {"fn": 1}, "x": np.int64(3)}
        snap.add_source("node", src)
        taken = [snap.sample(), snap.maybe_sample()]     # the second: too soon
        for dt in (1.0, 2.5):
            clock.advance(dt)
            taken.append(snap.maybe_sample())
        snap.close()                                      # one final sample
        return ([tel.canonicalize(s) for s in taken if s is not None],
                path.read_text().splitlines(), sorted(tel.SAMPLE_KEYS),
                tel.LEGACY_ALIASES)
    out = {k: run(t) for k, t in (("jax", jax_telemetry), ("torch", torch_telemetry))}
    assert out["torch"] == out["jax"]
    samples = out["torch"][0]
    assert samples[0]["sources"]["node"]["ws_cache_hits"] == 1
    assert samples[1]["sources"]["node"] == {"error": "RuntimeError('node died')"}
