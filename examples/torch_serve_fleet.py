"""Scenario, on the PyTorch port: a multi-tenant worker serving ALL TEN
assigned architectures as serverless functions behind the concurrent data
plane: per-function queues, a bounded worker pool, admission control,
keepalive-driven scale-to-zero, REAP-accelerated cold starts, and a shared
WS page cache.

Phases:
  1. deploy + record  -- every function cold-starts once (record phase)
  2. scale to zero    -- the autoscaler reclaims all idle instances
  3. trace replay     -- a replayable open-loop Poisson trace drives the
                         router; cold starts hit the REAP prefetch path and
                         concurrent restores of one function share one WS
                         read through the process-wide cache
  4. adaptive replay  -- the same trace again, now with the SPES-style
                         prewarming control plane predicting arrivals and
                         pre-spawning instances off the critical path:
                         compare the cold-start fractions

    PYTHONPATH=src python examples/torch_serve_fleet.py            # the card
    PYTHONPATH=src python examples/torch_serve_fleet.py --device cpu

Each function's request comes from a seed fixed by its name (CRC-32), so
two runs send the same requests.  Exits non-zero when an invocation fails
with anything but the router's admission refusal, or when a served
request's logits are not finite.
"""
import argparse
import contextlib
import os
import sys
import time
import zlib

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCHS, SMOKES  # noqa: E402
from repro_torch.core import ReapConfig  # noqa: E402
from repro_torch.core.pagestore import read_manifest  # noqa: E402
from repro_torch.core.reap import WS_CACHE  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.serving import (AdmissionError, OpenLoopGenerator,  # noqa: E402
                                 Orchestrator, PolicyConfig, PrewarmPolicy,
                                 Router, RouterConfig, ServeConfig,
                                 poisson_trace, summarize)


def request_seed(name: str) -> int:
    """A seed fixed by the function's name (``hash`` of a str is salted
    per process)."""
    return zlib.crc32(name.encode())


def steady_state(results):
    """Reports excluding each function's first replay arrival: that one is
    cold under any policy (no history yet), so the provisioning comparison
    is over the remaining, predictable traffic."""
    seen, out = set(), []
    for ev, rep in results:
        if rep is None:
            continue
        if ev.function not in seen:
            seen.add(ev.function)
            continue
        out.append(rep)
    return out


class Recorder:
    """The router as the load generator sees it, keeping every accepted
    invocation, and counting the submits admission refused, so that each
    outcome (served, refused, failed) can be read after the replay."""

    def __init__(self, router: Router):
        self.router = router
        self.invocations = []
        self.refused = 0

    def submit(self, name: str, batch: dict):
        try:
            inv = self.router.submit(name, batch)
        except AdmissionError:
            self.refused += 1
            raise
        self.invocations.append(inv)
        return inv


def replay(orch: Orchestrator, trace, requests: dict, policy: PolicyConfig | None):
    """Replay ``trace`` through a fresh ``Router`` (under ``PrewarmPolicy``
    when ``policy`` is given).  Returns the generator's (event, report)
    pairs, each accepted invocation's outcome counts, and the policy's
    stats (None without one)."""
    router = Router(orch, RouterConfig(max_concurrency=8, max_instances_per_function=4))
    rec = Recorder(router)
    gen = OpenLoopGenerator(rec, trace, make_batch=lambda ev: requests[ev.function])
    results, pol, error = [], None, None
    try:
        with (PrewarmPolicy(orch, router, policy) if policy is not None
              else contextlib.nullcontext()) as pol:
            try:
                results = gen.run()
            finally:
                router.close()
    except Exception as e:           # a failed invocation aborts the generator
        error = e
    outcome = {"served": 0, "refused": rec.refused, "failed": 0, "not_finite": 0,
               "served_by_function": {}}
    for inv in rec.invocations:
        try:
            logits, _ = inv.result()
        except AdmissionError:
            outcome["refused"] += 1
            continue
        except Exception:
            outcome["failed"] += 1
            continue
        outcome["served"] += 1
        by = outcome["served_by_function"]
        by[inv.name] = by.get(inv.name, 0) + 1
        outcome["not_finite"] += not bool(torch.isfinite(logits).all())
    if error is not None and not outcome["failed"]:
        outcome["failed"] = 1
    return results, outcome, None if pol is None else pol.stats()


def orchestrator(store: str, device: str) -> Orchestrator:
    """The fleet's orchestrator: REAP, a 2 s keepalive, at most four warm
    instances a function, one prewarm at a time."""
    return Orchestrator(store, ServeConfig(mode="reap", reap=ReapConfig(),
                                           keepalive_s=2.0, warm_limit=4,
                                           prewarm_concurrency=1, device=device))


def deploy(orch: Orchestrator, names: list, log=print) -> dict:
    """Register each function's SMOKE config; returns its request."""
    requests = {}
    for name in names:
        cfg = SMOKES[name]
        requests[name] = steps.make_batch(cfg, 48, 2, "train", request_seed(name))
        orch.register(name, cfg, warmup_batch=requests[name])
        log(f"deployed {name}")
    return requests


def record_all(orch: Orchestrator, names: list, requests: dict, log=print) -> dict:
    """Phase 1: every function cold (the REAP record phase).  Returns each
    function's record faults, WS pages and whether its logits are finite."""
    log("\n-- phase 1: cold starts (record) --")
    record = {}
    for name in names:
        logits, r = orch.invoke(name, requests[name])
        ws = read_manifest(orch.functions[name].base + ".ws")
        record[name] = {"n_faults": r.n_faults, "ws_pages": len(ws["pages"]),
                        "finite": bool(torch.isfinite(logits).all())}
        log(f"  {name:28s} total={r.total_s*1e3:7.1f}ms faults={r.n_faults}")
    return record


def run(functions=None, duration_s: float = 3.0, store: str = ".fleet_store",
        device: str = "cuda", log=print) -> dict:
    """The four phases over ``functions`` (default: all ten).  Returns each
    function's record faults and WS pages, both replays' ``summarize``
    dicts (``reactive`` and ``adaptive``, with the steady-state cold
    counts and each replay's outcome counts) and the WS cache's stats
    after each replay."""
    names = list(functions or ARCHS)
    orch = orchestrator(store, device)
    try:
        requests = deploy(orch, names, log)
        record = record_all(orch, names, requests, log)

        # phase 2: idle long enough for the autoscaler to reclaim everything
        time.sleep(2.2)
        n = orch.reap_idle()
        log(f"\nautoscaler reclaimed {n} idle instances (scale-to-zero)")

        # phase 3: replayable open-loop Poisson trace through the router.
        # A skewed mix concentrates arrivals on a few functions so concurrent
        # cold-starts of one function exercise the shared WS cache.
        mix = {n: (4.0 if i < 3 else 1.0) for i, n in enumerate(names)}
        trace = poisson_trace(rate_rps=15.0, duration_s=duration_s, functions=names,
                              mix=mix, seed=7)
        trace.save(os.path.join(store, "fleet_trace.json"))
        log(f"\n-- phase 3: open-loop replay ({len(trace.events)} arrivals, "
            f"{trace.duration_s:.2f}s trace) --")
        WS_CACHE.reset_stats()
        results, outcome, _ = replay(orch, trace, requests, None)
        s = summarize([rep for _, rep in results if rep is not None])
        ss = summarize(steady_state(results))
        s.update(outcome, steady_state_cold=ss["cold"], steady_state_n=ss["n"],
                 arrivals=len(trace.events))
        ws_reactive = WS_CACHE.stats()
        log(f"  served {s['n']}/{len(results)} "
            f"queue_mean={s['queue_mean_s']*1e3:.1f}ms "
            f"queue_p95={s['queue_p95_s']*1e3:.1f}ms "
            f"e2e_p50={s['e2e_p50_s']*1e3:.1f}ms "
            f"e2e_p95={s['e2e_p95_s']*1e3:.1f}ms")
        log(f"  cold starts: {s['cold']} "
            f"({100*s['cold_fraction']:.0f}% of served, "
            f"ws_cache_hits={s['ws_cache_hits']}) ws_cache={ws_reactive}")

        # phase 4: identical trace with the adaptive prewarming control plane
        # -- arrival history sizes per-function warm pools, instances are
        # spawned on pool threads, and served invocations carry prewarmed=True
        for name in names:
            orch.scale_to_zero(name)
        time.sleep(2.2)
        log("\n-- phase 4: adaptive replay (prewarming policy) --")
        WS_CACHE.clear()              # same cold cache as phase 3, fair compare
        WS_CACHE.reset_stats()
        results, outcome, pstats = replay(orch, trace, requests,
                                          PolicyConfig(interval_s=0.05, max_warm=4))
        sa = summarize([rep for _, rep in results if rep is not None])
        ssa = summarize(steady_state(results))
        sa.update(outcome, steady_state_cold=ssa["cold"], steady_state_n=ssa["n"],
                  arrivals=len(trace.events))
        ws_adaptive = WS_CACHE.stats()
        log(f"  served {sa['n']}/{len(results)} "
            f"e2e_p50={sa['e2e_p50_s']*1e3:.1f}ms "
            f"e2e_p95={sa['e2e_p95_s']*1e3:.1f}ms")
        log(f"  cold starts: {sa['cold']} total; steady-state "
            f"(excl. each function's first arrival): "
            f"{ssa['cold']}/{ssa['n']} adaptive vs {s['steady_state_cold']}/"
            f"{s['steady_state_n']} reactive, prewarmed-served={sa['prewarmed']}")
        log(f"  policy targets={pstats['targets']}")
    finally:
        orch.close()
    return {"functions": names, "record": record, "reactive": s, "adaptive": sa,
            "ws_cache": {"reactive": ws_reactive, "adaptive": ws_adaptive}}


def failures(out: dict) -> list[str]:
    """What makes the run a failure: a record request or a replayed one
    that failed (an admission refusal is an outcome, not a failure), or
    logits that are not finite."""
    bad = [f"{n}: record logits not finite" for n, r in out["record"].items()
           if not r["finite"]]
    for phase in ("reactive", "adaptive"):
        s = out[phase]
        if s["failed"]:
            bad.append(f"{phase} replay: {s['failed']} invocations failed")
        if s["not_finite"]:
            bad.append(f"{phase} replay: {s['not_finite']} logits not finite")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--store", default=".fleet_store")
    args = ap.parse_args(argv)
    out = run(store=args.store, device=args.device)
    bad = failures(out)
    for b in bad:
        print(f"FAILED: {b}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
