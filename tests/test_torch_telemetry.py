"""The port's span recorder (``repro_torch.telemetry``) and the spans of its
serving path, on the CPU.

A trace is one invocation's span tree: the router's ``queue``, the
orchestrator's ``acquire`` (a cold start's restore stages beneath it), the
instance's ``forward`` tiled by ``dispatch`` and ``sync``, and the dense
model's op spans under ``dispatch``.  A prewarm is a trace of its own.
Recording is off by default and then allocates no span at all.
"""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SMOKES  # noqa: E402
from repro_torch.core import pagestore, reap  # noqa: E402
from repro_torch.serving import Orchestrator, Router, RouterConfig, ServeConfig  # noqa: E402
from repro_torch.telemetry import TELEMETRY, MetricsRegistry, registry  # noqa: E402

CFG = SMOKES["olmo-1b"]
LAYER_OPS = ["norm", "qkv", "rope", "attention", "attn_out", "norm", "mlp_in", "act",
             "mlp_out"]


def _batch(seed, batch=2, length=32):
    return {"tokens": np.random.default_rng(seed).integers(0, CFG.vocab, (batch, length),
                                                           dtype=np.int32)}


@pytest.fixture
def tracing():
    """The process-wide registry recording spans for the test only."""
    TELEMETRY.drain_traces()
    TELEMETRY.start_tracing()
    try:
        yield TELEMETRY
    finally:
        TELEMETRY.stop_tracing()
        TELEMETRY.drain_traces()


@pytest.fixture
def store(tmp_path):
    yield str(tmp_path)
    pagestore.reset_stores()
    reap.WS_CACHE.clear()


def children(trace, idx):
    return [i for i, s in enumerate(trace.spans) if s.parent == idx]


def named(trace, idx, name):
    found = [i for i in children(trace, idx) if trace.spans[i].name == name]
    assert len(found) == 1, (name, [trace.spans[i].name for i in children(trace, idx)])
    return found[0]


# -- the recorder ---------------------------------------------------------------

def test_span_nesting_parents_ids_and_threads():
    ticks = iter(range(1, 1000))
    reg = MetricsRegistry(clock=lambda: float(next(ticks)))
    assert reg.trace("invocation") is registry._NOOP          # recording is off
    reg.start_tracing()
    assert reg.span("orphan") is registry._NOOP               # no current trace
    tr = reg.trace("invocation", function="fn")
    other = reg.trace("invocation")
    assert other.inv > tr.inv and tr.spans[0].start_s == 1.0
    with reg.current(tr):
        assert reg.active() is tr
        with reg.span("a", k=1) as a:
            with reg.span("b") as b:
                pass
            reg.record("c", 10.5, 11.5)
        with reg.span("d", start_s=0.25) as d:
            d.stop(0.75)

    def worker():
        with reg.current(tr), reg.span("e"):
            pass
    th = threading.Thread(target=worker)
    th.start()
    th.join()
    assert reg.active() is None
    tr.finish()
    names = [s.name for s in tr.spans]
    assert names == ["invocation", "a", "b", "c", "d", "e"]
    assert [s.parent for s in tr.spans] == [-1, 0, 1, 1, 0, 0]
    assert a.attrs == {"k": 1} and b.attrs is None
    assert tr.spans[3].duration_s == 1.0 and (d.start_s, d.end_s) == (0.25, 0.75)
    assert a.start_s < b.start_s < b.end_s < a.end_s
    me = threading.get_ident()
    assert [s.tid for s in tr.spans[:5]] == [me] * 5
    assert tr.spans[5].tid == th.ident != me
    assert reg.traces("invocation") == [tr]
    assert reg.drain_traces() == [tr] and reg.traces() == []
    d = tr.to_dict()
    assert d["inv"] == tr.inv and d["attrs"] == {"function": "fn"}
    assert d["spans"][1] == {"name": "a", "start_s": a.start_s, "end_s": a.end_s,
                             "parent": 0, "tid": me, "attrs": {"k": 1}}


def test_root_opens_only_where_no_trace_is_current():
    reg = MetricsRegistry()
    with reg.root("prewarm") as t:
        assert t is registry._NOOP                            # recording is off
    reg.start_tracing()
    with reg.root("prewarm", n=2) as t:
        with reg.root("invocation") as inner:
            assert inner is registry._NOOP
        with reg.span("x"):
            pass
    assert [tr.kind for tr in reg.drain_traces()] == ["prewarm"]
    assert t.attrs == {"n": 2} and [s.name for s in t.spans] == ["prewarm", "x"]
    assert t.root.end_s is not None


def test_threads_adding_spans_to_one_trace_keep_their_parents():
    reg = MetricsRegistry()
    reg.start_tracing()
    tr = reg.trace("invocation")
    n_threads, n_spans = 16, 100

    def worker():
        with reg.current(tr):
            for i in range(n_spans):
                with reg.span("outer", i=i):
                    with reg.span("inner"):
                        pass
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    spans = tr.spans
    assert len(spans) == 1 + 2 * n_threads * n_spans
    for sp in spans[1:]:
        parent = spans[sp.parent]
        if sp.name == "inner":
            assert parent.name == "outer" and parent.tid == sp.tid
            assert parent.start_s <= sp.start_s <= sp.end_s <= parent.end_s
        else:
            assert sp.parent == 0
    assert sorted(sp.attrs["i"] for sp in spans if sp.name == "outer") == sorted(
        list(range(n_spans)) * n_threads)


def test_the_buffer_holds_a_window_of_invocations():
    reg = MetricsRegistry()
    reg.start_tracing()
    for _ in range(5000):
        reg.trace("invocation").finish()
    assert len(reg.drain_traces()) == 5000


# -- the serving path -----------------------------------------------------------

def test_recording_off_allocates_no_span_and_logits_are_bitwise_equal(store, monkeypatch):
    orch = Orchestrator(store, ServeConfig(device="cpu", mode="vanilla"))
    made = []
    for cls in (registry.Span, registry.Trace):
        init = cls.__init__
        monkeypatch.setattr(cls, "__init__",
                            lambda self, *a, _init=init, **k: (made.append(self),
                                                               _init(self, *a, **k))[1])
    try:
        orch.register("fn", CFG)
        orch.prewarm("fn", 1, wait=True)
        batch = _batch(1)
        with Router(orch, RouterConfig(max_concurrency=2)) as router:
            off, rep = router.invoke("fn", batch)
            assert rep.load_vmm_s == 0
            assert made == [] and TELEMETRY.traces() == []
            TELEMETRY.start_tracing()
            try:
                on, _ = router.invoke("fn", batch)
            finally:
                TELEMETRY.stop_tracing()
        assert made and torch.equal(on, off)
        assert [t.kind for t in TELEMETRY.drain_traces()] == ["invocation"]
    finally:
        orch.close()


def test_router_traces_one_tree_per_invocation(store, tracing):
    orch = Orchestrator(store, ServeConfig(device="cpu", mode="vanilla"))
    try:
        orch.register("fn", CFG)
        orch.prewarm("fn", 4, wait=True)
        tracing.drain_traces()
        with Router(orch, RouterConfig(max_concurrency=4)) as router:
            invs = [router.submit("fn", _batch(i, length=16 * (1 + i % 2)))
                    for i in range(8)]
            reports = {inv.t_submit: inv.result(120)[1] for inv in invs}
    finally:
        orch.close()
    traces = tracing.drain_traces()
    assert sorted(t.kind for t in traces) == ["invocation"] * 8
    assert len({t.inv for t in traces}) == 8
    for t in traces:
        root = t.spans[0]
        rep = reports[root.start_s]                   # the same read as t_submit
        assert t.attrs["function"] == "fn" and t.attrs["cold"] is False
        assert t.attrs["batch"] == 2 and t.attrs["tokens"] == 2 * t.attrs["length"]
        queue = t.spans[named(t, 0, "queue")]
        assert queue.duration_s == rep.queue_s
        acquire = t.spans[named(t, 0, "acquire")]
        forward = t.spans[named(t, 0, "forward")]
        assert forward.duration_s == rep.processing_s
        assert queue.end_s <= acquire.start_s <= acquire.end_s <= forward.start_s
        assert forward.end_s <= root.end_s
        d, s = named(t, t.spans.index(forward), "dispatch"), named(
            t, t.spans.index(forward), "sync")
        dispatch, sync = t.spans[d], t.spans[s]
        assert dispatch.start_s == forward.start_s and dispatch.end_s == sync.start_s
        assert sync.end_s == forward.end_s
        ops = [t.spans[i].name for i in children(t, d)]
        assert ops == ["embed"] + ["layer"] * CFG.n_layers + ["head"]
        layers = [i for i in children(t, d) if t.spans[i].name == "layer"]
        assert [t.spans[i].attrs for i in layers] == [{"i": i} for i in range(CFG.n_layers)]
        for i in layers:
            assert [t.spans[j].name for j in children(t, i)] == LAYER_OPS
        head = named(t, d, "head")
        assert [t.spans[j].name for j in children(t, head)] == ["norm", "logits"]
        for sp in t.spans[1:]:
            parent = t.spans[sp.parent]
            assert parent.start_s <= sp.start_s <= sp.end_s <= parent.end_s, sp.name
        assert {sp.tid for sp in t.spans[1:]} == {forward.tid}


def test_cold_invocation_restore_stages_under_acquire(store, tracing):
    orch = Orchestrator(store, ServeConfig(device="cpu"))
    try:
        orch.register("fn", CFG)
        batch = _batch(2)
        orch.invoke("fn", batch)                      # records the working set
        orch.scale_to_zero("fn")
        tracing.drain_traces()
        _, rep = orch.invoke("fn", batch)             # a REAP cold start
    finally:
        orch.close()
    assert rep.n_prefetched_pages > 0
    (t,) = tracing.drain_traces()
    assert t.kind == "invocation" and t.attrs["cold"] is True
    acquire = named(t, 0, "acquire")
    stages = {t.spans[i].name: t.spans[i] for i in children(t, acquire)}
    assert set(stages) == {"load_vmm", "connect", "ws_fetch", "install"}
    for name, field in (("load_vmm", "load_vmm_s"), ("connect", "connection_s"),
                        ("ws_fetch", "ws_fetch_s"), ("install", "install_s")):
        assert stages[name].duration_s == pytest.approx(getattr(rep.stages, field),
                                                        rel=0, abs=1e-9)
    forward = t.spans[named(t, 0, "forward")]
    assert forward.duration_s == rep.processing_s
    # the cold instance is made warm after its forward: its fault and copy
    assert [t.spans[i].name for i in children(t, 0)] == [
        "acquire", "forward", "fault", "copy"]


def test_prewarm_fault_and_copy_under_materialize(store, tracing, monkeypatch):
    from repro_torch.core.restore import RestorePipeline
    materialized = []

    def spy(self, fn, _materialize=RestorePipeline.materialize):
        _materialize(self, fn)
        materialized.append(self.timings.materialize_s)
    monkeypatch.setattr(RestorePipeline, "materialize", spy)
    orch = Orchestrator(store, ServeConfig(device="cpu", mode="vanilla"))
    try:
        orch.register("fn", CFG)
        orch.prewarm("fn", 2, wait=True)
    finally:
        traces = tracing.drain_traces()
        orch.close()
    (t,) = traces
    assert t.kind == "prewarm" and t.attrs == {"function": "fn", "n": 2}
    top = [t.spans[i].name for i in children(t, 0)]
    assert top == ["load_vmm", "load_vmm", "connect", "connect", "materialize",
                   "materialize"]
    spans = [i for i in children(t, 0) if t.spans[i].name == "materialize"]
    assert [t.spans[i].duration_s for i in spans] == pytest.approx(
        materialized, rel=0, abs=1e-9)
    for i in spans:
        fault, copy = (t.spans[j] for j in children(t, i))
        assert (fault.name, copy.name) == ("fault", "copy")
        assert fault.attrs["pages"] > 0 and fault.end_s <= copy.start_s
