"""The port's examples (``examples/torch_*.py``) against the JAX package's,
on the CPU at SMOKE size.

* quickstart: qwen2-7b SMOKE served through the example's ``run`` and
  through the JAX ``Orchestrator`` on the same numpy request -- the same
  record trace, snapshot and WS bytes, the same prefetched pages, logits
  within the bf16 tolerance of ``test_torch_serving``;
* serve fleet: each of the ten SMOKE functions' record faults and WS pages
  equal the JAX package's on the same request; both replays on the port
  alone end every arrival served or refused by admission;
* fault-tolerant training: the restarted run's losses equal the
  uninterrupted run's;
* each example's exit code on the failures it names.

The test marked ``cuda`` runs each example's ``run`` on the card.
"""
import filecmp
import importlib.util
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import pagestore as torch_pagestore  # noqa: E402
from repro_torch.core import reap as torch_reap  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_ATOL = 3e-2        # the bf16 tolerance of tests/test_torch_model.py
STORE_FILES = ("{}.trace.npy", "{}.ws", "{}.mem", ".pagestore/index.json",
               ".pagestore/chunks.data")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


quickstart = _example("torch_quickstart")
fleet = _example("torch_serve_fleet")
training = _example("torch_train_fault_tolerant")


def _quiet(*_):
    pass


def _reset_stores(jx=None):
    torch_pagestore.reset_stores()
    torch_reap.WS_CACHE.clear()
    if jx is not None:
        jx.pagestore.reset_stores()
        jx.reap.WS_CACHE.clear()


@pytest.fixture(scope="module")
def jx():
    """The JAX package's serving entry points (imported here, so that the
    ``cuda`` test needs no JAX)."""
    pytest.importorskip("jax")
    from repro.configs import SMOKES
    from repro.core import ReapConfig, pagestore, reap
    from repro.serving import Orchestrator, ServeConfig
    return types.SimpleNamespace(smokes=SMOKES, ReapConfig=ReapConfig,
                                 pagestore=pagestore, reap=reap,
                                 Orchestrator=Orchestrator, ServeConfig=ServeConfig)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# -- quickstart ------------------------------------------------------------------


@pytest.fixture(scope="module")
def quick(jx, tmp_path_factory):
    """The example's ``run`` on the CPU, and the JAX example's three
    requests on the same request through the JAX orchestrator."""
    arch = "qwen2-7b"
    tstore = tmp_path_factory.mktemp("torch_quick")
    jstore = tmp_path_factory.mktemp("jax_quick")
    out = quickstart.run(arch, str(tstore), "cpu")
    request = out["request"]
    jorch = jx.Orchestrator(str(jstore), jx.ServeConfig(mode="reap",
                                                        reap=jx.ReapConfig()))
    try:
        jorch.register(arch, jx.smokes[arch], warmup_batch=request)
        jrecord, jr_record = jorch.invoke(arch, request, force_cold=True)
        _, jr_warm = jorch.invoke(arch, request)
        jorch.scale_to_zero(arch)
        jcold, jr_cold = jorch.invoke(arch, request, force_cold=True)
    finally:
        jorch.close()
    yield {"arch": arch, "out": out, "tstore": tstore, "jstore": jstore,
           "jax": {"record": jr_record, "warm": jr_warm, "reap_cold": jr_cold,
                   "record_logits": np.asarray(jrecord, np.float32),
                   "reap_cold_logits": np.asarray(jcold, np.float32)}}
    _reset_stores(jx)


@pytest.mark.parametrize("rel", STORE_FILES, ids=lambda r: r.format("fn"))
def test_quickstart_store_matches_jax(quick, rel):
    """Record trace, WS file, snapshot and page store, byte for byte."""
    rel = rel.format(quick["arch"])
    assert filecmp.cmp(quick["tstore"] / rel, quick["jstore"] / rel, shallow=False), rel


def test_quickstart_reports_and_logits_match_jax(quick):
    out, jx = quick["out"], quick["jax"]
    for step in ("record", "warm", "reap_cold"):
        assert out[step]["n_faults"] == jx[step].n_faults, step
        assert out[step]["n_prefetched_pages"] == jx[step].n_prefetched_pages, step
    assert out["record"]["n_prefetched_pages"] == 0
    assert out["reap_cold"]["n_prefetched_pages"] == out["ws_pages"] > 0
    assert out["warm"]["n_faults"] == 0
    assert torch.equal(out["record_logits"], out["reap_cold_logits"])
    for key in ("record_logits", "reap_cold_logits"):
        np.testing.assert_allclose(out[key].float().numpy(), jx[key], atol=BF16_ATOL)


def test_quickstart_exit_code(quick, monkeypatch):
    """0 when the gates hold; 1 when the REAP cold logits differ from the
    record's by one bit, or the warm request faulted."""
    out = quick["out"]
    monkeypatch.setattr(quickstart, "run", lambda *a: out)
    assert quickstart.main(["--device", "cpu"]) == 0
    cold = out["reap_cold_logits"].clone()
    cold.view(torch.int16).view(-1)[0] ^= 1
    monkeypatch.setattr(quickstart, "run", lambda *a: {**out, "reap_cold_logits": cold})
    assert quickstart.main(["--device", "cpu"]) == 1
    monkeypatch.setattr(quickstart, "run", lambda *a: {
        **out, "warm": {**out["warm"], "n_faults": 1}})
    assert quickstart.main(["--device", "cpu"]) == 1


# -- serve fleet -----------------------------------------------------------------


@pytest.fixture(scope="module")
def recorded(jx, tmp_path_factory):
    """Phase 1 of the fleet (deploy, one record request each) in each
    package, on the port example's requests."""
    names = list(ARCHS)
    orch = fleet.orchestrator(str(tmp_path_factory.mktemp("torch_fleet")), "cpu")
    jorch = jx.Orchestrator(str(tmp_path_factory.mktemp("jax_fleet")), jx.ServeConfig(
        mode="reap", reap=jx.ReapConfig(), keepalive_s=2.0, warm_limit=4,
        prewarm_concurrency=1))
    try:
        requests = fleet.deploy(orch, names, _quiet)
        record = fleet.record_all(orch, names, requests, _quiet)
        jrecord = {}
        for name in names:
            jorch.register(name, jx.smokes[name])
            _, rep = jorch.invoke(name, requests[name])
            ws = jx.pagestore.read_manifest(jorch.functions[name].base + ".ws")
            jrecord[name] = {"n_faults": rep.n_faults, "ws_pages": len(ws["pages"])}
    finally:
        orch.close()
        jorch.close()
    yield {"torch": record, "jax": jrecord, "requests": requests}
    _reset_stores(jx)


@pytest.mark.parametrize("name", list(ARCHS))
def test_fleet_record_matches_jax(recorded, name):
    got, want = recorded["torch"][name], recorded["jax"][name]
    assert got["n_faults"] == want["n_faults"] > 0
    assert got["ws_pages"] == want["ws_pages"]
    assert got["finite"]


def test_fleet_requests_are_stable_across_processes(recorded):
    """ROADMAP C6: a request's seed is fixed by the function's name, so a
    process whose ``hash`` of a str is salted otherwise sends the same
    requests."""
    code = ("import importlib.util, sys; s = importlib.util.spec_from_file_location("
            f"'f', {os.path.join(ROOT, 'examples', 'torch_serve_fleet.py')!r}); "
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m); "
            "print([m.request_seed(n) for n in m.ARCHS])")
    env = dict(os.environ, PYTHONHASHSEED=str(hash("qwen2-7b") % 1000 + 1))
    seeds = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                           capture_output=True, text=True).stdout.strip()
    assert seeds == str([fleet.request_seed(n) for n in ARCHS])
    for name, batch in recorded["requests"].items():
        again = fleet.steps.make_batch(fleet.SMOKES[name], 48, 2, "train",
                                       fleet.request_seed(name))
        for k, v in batch.items():
            np.testing.assert_array_equal(v, again[k])


def test_fleet_replays(tmp_path):
    """Both replays on the port alone, three functions over a 1 s trace:
    every arrival ends served or refused by admission, none fails, every
    served logit is finite."""
    names = list(ARCHS)[:3]
    try:
        out = fleet.run(names, 1.0, str(tmp_path), "cpu", _quiet)
    finally:
        _reset_stores()
    assert fleet.failures(out) == []
    for phase in ("reactive", "adaptive"):
        s = out[phase]
        assert s["arrivals"] > 0 and s["served"] > 0
        assert s["served"] + s["refused"] == s["arrivals"]
        assert s["failed"] == 0 and s["not_finite"] == 0
        assert s["n"] == s["served"]
        assert set(s["served_by_function"]) <= set(names)
        assert sum(s["served_by_function"].values()) == s["served"]
    assert out["adaptive"]["prewarmed"] >= 0
    assert set(out["ws_cache"]) == {"reactive", "adaptive"}


def test_fleet_failures_name_each_fault():
    ok = {"served": 3, "refused": 1, "failed": 0, "not_finite": 0}
    out = {"record": {"a": {"finite": True}}, "reactive": ok, "adaptive": ok}
    assert fleet.failures(out) == []
    assert len(fleet.failures({**out, "record": {"a": {"finite": False}}})) == 1
    assert len(fleet.failures({**out, "reactive": {**ok, "failed": 1}})) == 1
    assert len(fleet.failures({**out, "adaptive": {**ok, "not_finite": 2}})) == 1


# -- fault-tolerant training ---------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return training.run("olmo-1b", 50, str(tmp_path_factory.mktemp("ft") / "w"),
                        "cpu", _quiet)


def test_training_restart_equals_uninterrupted(trained):
    """The preempted run's losses are the uninterrupted run's first 25, the
    restarted run's its last 25, bit for bit on the CPU; the REAP restore
    took no fault."""
    ref = trained["uninterrupted"]
    assert len(ref) == 50 and len(trained["preempted"]) == 25
    assert trained["preempted"] == ref[:25]
    assert trained["restarted"] == ref[25:]
    assert trained["tail_rel_diff"] == 0.0
    assert trained["restore_stats"]["n_faults"] == 0
    assert all(np.isfinite(ref))


def test_training_exit_code(trained, monkeypatch):
    monkeypatch.setattr(training, "run", lambda *a: trained)
    assert training.main(["--device", "cpu"]) == 0
    monkeypatch.setattr(training, "run", lambda *a: {**trained, "tail_rel_diff": 1e-3})
    assert training.main(["--device", "cpu"]) == 1
    monkeypatch.setattr(training, "run", lambda *a: {
        **trained, "restore_stats": {**trained["restore_stats"], "n_faults": 3}})
    assert training.main(["--device", "cpu"]) == 1


# -- on the card -----------------------------------------------------------------------


@pytest.mark.cuda
def test_examples_run_on_the_card(cuda, tmp_path):
    try:
        q = quickstart.run("qwen2-7b", str(tmp_path / "quick"), "cuda")
        assert torch.equal(q["record_logits"], q["reap_cold_logits"])
        assert q["warm"]["n_faults"] == 0
        f = fleet.run(list(ARCHS)[:3], 1.0, str(tmp_path / "fleet"), "cuda", _quiet)
        assert fleet.failures(f) == []
    finally:
        _reset_stores()
    t = training.run("olmo-1b", 50, str(tmp_path / "ft"), "cuda", _quiet)
    assert t["tail_rel_diff"] <= training.RESTART_RTOL
    assert t["restore_stats"]["n_faults"] == 0
