"""The port's serving main path against the JAX package's, on the CPU.

One olmo-1b SMOKE function is registered in each package with the same
seed and served the same numpy request: record, scale to zero, cold start.
The port must record the same fault trace and working set page for page,
and its cold logits must match the JAX cold logits.  It must also keep the
JAX package's tied-embedding behaviour: a cold invocation faults only the
request's embedding rows, the tied head reads the whole table, so cold
logits differ from warm ones in both packages.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import SMOKES as JAX_SMOKES  # noqa: E402
from repro.core import pagestore as jax_pagestore  # noqa: E402
from repro.core import reap as jax_reap  # noqa: E402
from repro.serving import Orchestrator as JaxOrchestrator  # noqa: E402
from repro.serving import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs import SMOKES  # noqa: E402
from repro_torch.core import pagestore as torch_pagestore  # noqa: E402
from repro_torch.core import reap as torch_reap  # noqa: E402
from repro_torch.serving import Orchestrator, Router, ServeConfig  # noqa: E402

BF16_ATOL = 3e-2        # the bf16 tolerance of tests/test_torch_model.py


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Record + scale-to-zero + one cold start in each package."""
    batch = {"tokens": np.random.default_rng(0).integers(
        0, SMOKES["olmo-1b"].vocab, (2, 32), dtype=np.int32)}
    jstore = str(tmp_path_factory.mktemp("jax_store"))
    tstore = str(tmp_path_factory.mktemp("torch_store"))
    jorch = JaxOrchestrator(jstore, JaxServeConfig())
    jorch.register("fn", JAX_SMOKES["olmo-1b"], warmup_batch=batch)
    orch = Orchestrator(tstore, ServeConfig(device="cpu"))
    orch.register("fn", SMOKES["olmo-1b"], warmup_batch=batch)
    out = {"batch": batch, "jstore": jstore, "tstore": tstore, "orch": orch}
    for key, o in (("jax", jorch), ("torch", orch)):
        out[key + "_record"], rep = o.invoke("fn", batch)
        assert rep.n_prefetched_pages == 0
        o.scale_to_zero("fn")
        out[key + "_cold"], rep = o.invoke("fn", batch)
        assert rep.n_prefetched_pages > 0
        out[key + "_warm"], rep = o.invoke("fn", batch)
        assert rep.load_vmm_s == 0
    yield out
    jorch.close()
    orch.close()
    for mod in (jax_pagestore, torch_pagestore):
        mod.reset_stores()
    jax_reap.WS_CACHE.clear()
    torch_reap.WS_CACHE.clear()


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jax.device_get(x), np.float32)


def test_record_trace_and_ws_match_jax(served):
    jt = np.load(served["jstore"] + "/fn.trace.npy")
    tt = np.load(served["tstore"] + "/fn.trace.npy")
    np.testing.assert_array_equal(tt, jt)
    jm = jax_pagestore.read_manifest(served["jstore"] + "/fn.ws")
    tm = torch_pagestore.read_manifest(served["tstore"] + "/fn.ws")
    assert tm["pages"] == jm["pages"] and tm["chunks"] == jm["chunks"]


def test_cold_logits_match_jax(served):
    np.testing.assert_allclose(_f32(served["torch_cold"]), _f32(served["jax_cold"]),
                               atol=BF16_ATOL)
    np.testing.assert_allclose(_f32(served["torch_warm"]), _f32(served["jax_warm"]),
                               atol=BF16_ATOL)


def test_record_and_prefetch_cold_are_bitwise_equal(served):
    assert torch.equal(served["torch_record"], served["torch_cold"])


def test_tied_embedding_cold_differs_from_warm_as_in_jax(served):
    """Pinned fault of the JAX package (ROADMAP §C), reproduced on purpose:
    unfaulted embedding rows read as zeros through the tied head."""
    jdiff = np.abs(_f32(served["jax_cold"]) - _f32(served["jax_warm"])).max()
    tdiff = np.abs(_f32(served["torch_cold"]) - _f32(served["torch_warm"])).max()
    assert jdiff > 0.1 and tdiff > 0.1
    cfg = SMOKES["olmo-1b"]
    rows_per_page = 4096 // (cfg.d_model * 2)           # bf16 table rows
    page = np.arange(cfg.vocab) // rows_per_page
    unseen = ~np.isin(page, np.unique(served["batch"]["tokens"]) // rows_per_page)
    assert unseen.sum() > 0
    assert not served["torch_cold"][..., unseen].any()  # never-faulted rows -> 0
    assert served["torch_warm"][..., unseen].any()


def test_group_restore_matches_single_cold(served):
    orch, batch = served["orch"], served["batch"]
    insts = orch.spawn_batch("fn", 2)
    try:
        for inst in insts:
            assert inst.report.batch_size == 2
            assert inst.try_acquire()
            logits, _ = inst.invoke(batch)
            inst.release()
            assert torch.equal(logits, served["torch_cold"])
    finally:
        for inst in insts:
            inst.reclaim()


def test_router_answers_three_requests(served):
    orch, batch = served["orch"], served["batch"]
    with Router(orch) as router:
        invs = [router.submit("fn", batch) for _ in range(3)]
        outs = [inv.result(timeout=120) for inv in invs]
    assert len(outs) == 3
    for logits, rep in outs:
        assert tuple(logits.shape) == (2, 32, SMOKES["olmo-1b"].vocab)
        assert bool(torch.isfinite(logits).all())


def test_default_device_is_cuda_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        assert ServeConfig().device == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        Orchestrator(str(tmp_path))
    assert not any(tmp_path.iterdir())
