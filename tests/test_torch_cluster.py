"""The port's cluster layer against the JAX package's, on the CPU.

* The consistent-hash ring gives the same owners, so placement and shard
  ownership agree between the packages.
* A two-node inproc fleet in each package (olmo-1b SMOKE, the same seed
  and the same numpy requests) records the same trace and working set,
  places the same way, resolves the same shard-tier fetches (local hit,
  remote fetch, origin read) and serves cold logits within the bf16
  tolerance of ``test_torch_serving.py``; its stats canonicalise to the
  JAX fleet's schema.
* The static analysis (lockgraph and REP001-REP008) over the port holds
  to the accepted findings listed here.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.cluster as jax_cluster  # noqa: E402
import repro_torch.cluster as torch_cluster  # noqa: E402
from repro.analysis import run_all  # noqa: E402
from repro.configs import SMOKES as JAX_SMOKES  # noqa: E402
from repro.core import pagestore as jax_pagestore  # noqa: E402
from repro.serving import RouterConfig as JaxRouterConfig  # noqa: E402
from repro.serving import ServeConfig as JaxServeConfig  # noqa: E402
from repro.telemetry import canonicalize as jax_canonicalize  # noqa: E402
from repro_torch.configs import SMOKES  # noqa: E402
from repro_torch.core import pagestore as torch_pagestore  # noqa: E402
from repro_torch.serving import RouterConfig, ServeConfig  # noqa: E402
from repro_torch.telemetry import canonicalize  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
BF16_ATOL = 3e-2        # the bf16 tolerance of tests/test_torch_serving.py
WAIT_S = 120.0


# -- the ring ---------------------------------------------------------------

FUNCTIONS = [f"fn-{i:03d}" for i in range(200)]


@pytest.mark.parametrize("n_nodes", [2, 3, 4, 5])
def test_ring_owners_match_jax(n_nodes):
    ids = [f"node-{i}" for i in range(n_nodes)]
    rings = [pkg.ConsistentHashRing(ids, vnodes=64) for pkg in (jax_cluster, torch_cluster)]
    for name in FUNCTIONS:
        assert torch_cluster.stable_hash(name) == jax_cluster.stable_hash(name)
        assert rings[1].lookup(name, n_nodes) == rings[0].lookup(name, n_nodes)
        assert rings[1].owner(name) == rings[0].owner(name)
    for ring in rings:                    # a node leaves: minimal remap, same in both
        ring.remove(ids[-1])
    assert ([rings[1].lookup(n, 2) for n in FUNCTIONS]
            == [rings[0].lookup(n, 2) for n in FUNCTIONS])


# -- inproc fleets in both packages -------------------------------------------

def _router(pkg_router_config):
    # one slot a node, so a two-wide burst spreads over both nodes
    return pkg_router_config(max_concurrency=1, max_instances_per_function=1,
                             queue_depth=16, batch_restore_limit=1)


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """The same scenario in each package: register, record, scale to zero,
    warm the owner shard, then a two-wide cold burst."""
    batch = {"tokens": np.random.default_rng(0).integers(
        0, SMOKES["olmo-1b"].vocab, (2, 32), dtype=np.int32)}
    out = {"batch": batch}
    for key, pkg, cfg, config in (
            ("jax", jax_cluster, JAX_SMOKES["olmo-1b"],
             JaxServeConfig(overlap_install=False, router=_router(JaxRouterConfig))),
            ("torch", torch_cluster, SMOKES["olmo-1b"],
             ServeConfig(overlap_install=False, device="cpu",
                         router=_router(RouterConfig)))):
        store = str(tmp_path_factory.mktemp(f"{key}_fleet"))
        fleet = pkg.build_fleet(2, store, config=config,
                                cfg=pkg.ScheduleConfig(seed=7))
        try:
            fleet.register("fn", cfg, seed=0, warmup_batch=batch)
            record = fleet.submit("fn", batch)
            _, rep = record.result(WAIT_S)
            assert rep.n_prefetched_pages == 0
            for node in fleet.nodes.values():
                node.orch.scale_to_zero("fn")
            warmed = fleet.rebalance()
            fleet.reset_stats()
            burst = [fleet.submit("fn", batch) for _ in range(2)]
            cold = [inv.result(WAIT_S) for inv in burst]
            base = os.path.join(store, "fn")
            out[key] = {
                "store": store, "warmed": warmed,
                "placements": [record.node_id] + [inv.node_id for inv in burst],
                "cold": cold, "stats": fleet.stats(),
                "l1": {n: c.peek(base, count=False)
                       for n, c in fleet.store.caches.items()},
                "owner": fleet.store.owners("fn")}
        finally:
            fleet.close()
    yield out
    for mod in (jax_pagestore, torch_pagestore):
        mod.reset_stores()


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jax.device_get(x), np.float32)


def test_fleet_record_trace_and_ws_match_jax(fleets):
    jt = np.load(fleets["jax"]["store"] + "/fn.trace.npy")
    tt = np.load(fleets["torch"]["store"] + "/fn.trace.npy")
    np.testing.assert_array_equal(tt, jt)
    jm = jax_pagestore.read_manifest(fleets["jax"]["store"] + "/fn.ws")
    tm = torch_pagestore.read_manifest(fleets["torch"]["store"] + "/fn.ws")
    assert tm["pages"] == jm["pages"] and tm["chunks"] == jm["chunks"]
    # the WS bytes every node's L1 holds after the burst
    for node, (pages, data) in fleets["torch"]["l1"].items():
        jpages, jdata = fleets["jax"]["l1"][node]
        assert list(pages) == list(jpages) and data == jdata


def test_fleet_placements_and_shard_fetches_match_jax(fleets):
    t, j = fleets["torch"], fleets["jax"]
    assert t["owner"] == j["owner"] and t["warmed"] == j["warmed"] == {"fn": 1}
    assert t["placements"] == j["placements"]
    assert sorted(t["placements"][1:]) == ["node-0", "node-1"]  # one cold start each
    keys = ("remote_fetches", "remote_misses", "origin_reads", "dead_owner_fallbacks",
            "transfer_bytes", "dedup_bytes_saved", "group_fetches")
    ts, js = t["stats"]["store"], j["stats"]["store"]
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["remote_fetches"] == 1 and ts["transfer_bytes"] > 0


def test_fleet_cold_logits_match_jax(fleets):
    for (tl, trep), (jl, jrep) in zip(fleets["torch"]["cold"], fleets["jax"]["cold"]):
        assert trep.n_prefetched_pages == jrep.n_prefetched_pages > 0
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=BF16_ATOL)
    a, b = (logits for logits, _ in fleets["torch"]["cold"])
    assert torch.equal(a, b)              # local hit and remote fetch: same bytes


def _schema(obj):
    """The key tree of a stats dict (values dropped)."""
    if isinstance(obj, dict):
        return {k: _schema(v) for k, v in obj.items()}
    return type(obj).__name__ if isinstance(obj, (dict, list)) else None


def test_fleet_stats_canonicalise_to_jax_schema(fleets):
    t = _schema(canonicalize(fleets["torch"]["stats"]))
    j = _schema(jax_canonicalize(fleets["jax"]["stats"]))
    assert t == j
    assert "ws_cache" in t["nodes"]["node-0"] and "store" in t


# -- static analysis of the port -----------------------------------------------

#: The port's accepted findings: key -> why it stays.  The first four are
#: the JAX package's own (``analysis-baseline.json``), in the modules the
#: port copied.
ACCEPTED = {
    "LOCK-BLOCKING:core/arena.py:InstanceArena.touch_pages:thread-pool join at "
    "with-exit|InstanceArena._fault_parallel|InstanceArena._lock":
        "the arena's fault model is serialized under its lock (one guest vCPU); "
        "the short-lived pool parallelizes the disk reads of one fault batch",
    "LOCK-BLOCKING:core/arena.py:InstanceArena.touch_pages:page-source "
    "I/O|InstanceArena.touch_pages|InstanceArena._lock":
        "demand-fault reads run under the arena lock against tail installs and "
        "close(): the paper's page-fault stall, per arena",
    "LOCK-BLOCKING:serving/policy.py:PrewarmPolicy.step:Future.result|"
    "Orchestrator.prewarm_quiesce|PrewarmPolicy._mu":
        "path-insensitive: step() calls prewarm(wait=False), which never quiesces",
    "REP008:core/restore.py:<module>:data-plane-import:socket":
        "connect_handshake's socketpair loopback models the guest network "
        "handshake inside one process; no page bytes cross it",
    "LOCK-BLOCKING:kernels/build.py:kernels/build.py:library:file I/O "
    "(open)|kernels/build.py:build_all|kernels/build.py:_LOCK":
        "the first kernel call of a process builds or loads the libraries under "
        "the lock, so concurrent first calls never build twice; later calls only "
        "read the loaded table",
}


def test_port_analysis_holds_to_accepted_findings():
    findings = run_all(PORT)
    keys = {f.key for f in findings}
    fresh = [f.render() for f in findings if f.key not in ACCEPTED]
    assert not fresh, "findings not accepted:\n" + "\n".join(fresh)
    assert set(ACCEPTED) <= keys, f"stale accepted findings: {set(ACCEPTED) - keys}"
