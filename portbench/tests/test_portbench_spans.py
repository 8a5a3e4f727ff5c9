"""The attribution of device activity to the program's spans
(``portbench/spans.py``) and the span metrics' readers, on traces made by
hand; and, on the card, that the profiler's launches land inside the spans
of the thread that made them."""
import copy
import threading
import time

import pytest
import torch

from portbench import counts, spans, spec, trace

A, B = 0x7F00_1111_06C0, 0x7F00_2222_06C0          # two threads' get_ident()


def sp(name, s, e, parent, tid, **attrs):
    d = {"name": name, "start_s": s, "end_s": e, "parent": parent, "tid": tid}
    if attrs:
        d["attrs"] = attrs
    return d


def invocation(inv, tid, t0, dispatch_end, t1, cold=False):
    """An invocation whose forward runs [t0, t1]: a layer with a norm and an
    act inside its dispatch, then its sync."""
    mid = (t0 + dispatch_end) / 2
    return {"inv": inv, "kind": "invocation", "attrs": {"function": "fn", "cold": cold},
            "spans": [sp("invocation", t0 - 0.01, t1 + 0.001, -1, 99),
                      sp("queue", t0 - 0.01, t0 - 0.005, 0, tid),
                      sp("forward", t0, t1, 0, tid),
                      sp("dispatch", t0, dispatch_end, 2, tid),
                      sp("layer", t0 + 0.001, dispatch_end - 0.001, 3, tid, i=0),
                      sp("norm", t0 + 0.002, mid, 4, tid),
                      sp("act", mid + 0.001, dispatch_end - 0.002, 4, tid),
                      sp("sync", dispatch_end, t1, 2, tid)]}


def test_attribute_threads_interleaved_and_a_launch_outside_spans():
    t_start = 100.0
    traces = [invocation(0, A, 100.0, 100.010, 100.050),
              invocation(1, B, 100.005, 100.015, 100.060)]
    index = spans.SpanIndex(traces, t_start)
    mask = spans.THREAD_MASK
    launches = {1: (0.003, A & mask, 0.0),      # A's norm
                2: (0.004, B & mask, 0.0),      # before B's forward: only its root holds it
                3: (0.008, B & mask, 0.0),      # B's norm, inside A's layer's time
                4: (0.007, A & mask, 0.0),      # A's act
                5: (0.0089, A & mask, 0.0),     # A's layer self time (its act has ended)
                6: (0.012, B & mask, 0.0),      # B's act
                7: (0.030, A & mask, 0.0),      # A's sync
                8: (0.009, 0x1234, 0.0)}        # a thread that opened no span
    kernels = [(0.01 * i, 0.01 * i + 0.001, f"k{i}", i) for i in range(1, 10)]
    got = spans.attribute(kernels, launches, index)
    names = [None if h is None else traces[h[0]]["spans"][h[1]]["name"] for h in got]
    invs = [None if h is None else h[0] for h in got]
    assert names == ["norm", "invocation", "norm", "act", "layer", "act", "sync", None, None]
    assert invs == [0, 1, 1, 0, 0, 1, 0, None, None]     # kernel 9: no launch seen
    assert index.chain(*got[0]) == ["norm", "layer", "dispatch", "forward", "invocation"]


def test_reduce_charges_ops_and_labels_gaps(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    t_start = 100.0
    traces = [invocation(0, A, 100.0, 100.010, 100.050),
              invocation(1, B, 100.005, 100.015, 100.060)]
    mask = spans.THREAD_MASK
    launches = {1: (0.003, A & mask, 1e-5), 2: (0.007, A & mask, 2e-5),
                3: (0.008, B & mask, 4e-5), 4: (0.0089, A & mask, 8e-5),
                5: (0.020, A & mask, 1.6e-4)}
    kernels = [(0.010, 0.020, "ln", 1), (0.020, 0.025, "silu", 2), (0.025, 0.035, "ln", 3),
               (0.035, 0.036, "add", 4), (0.040, 0.045, "stray", 5),
               (0.050, 0.052, "unseen", 9)]
    processing = [(100.0, 100.050), (100.005, 100.060)]
    got = spans.reduce(kernels, launches, traces, processing, t_start, 100.100)
    assert got["device_s_by_op"] == pytest.approx({"norm": 0.020, "act": 0.005,
                                                   "layer": 0.001, "sync": 0.005})
    assert got["forward_device_s"] == pytest.approx(0.031)
    assert got["eager_device_s"] == pytest.approx(0.025)
    assert got["launch_call_s"] == pytest.approx(3.1e-4)
    # busy 0.010-0.036, 0.040-0.045, 0.050-0.052: all but the unseen one charged
    assert got["attributed_share"] == pytest.approx(0.031 / 0.033)
    # the gaps keep trace.stop's seconds, order and text, and gain the phases
    fake = type("T", (), {"t_start": t_start,
                          "prof": type("P", (), {"stop": lambda self: None})(),
                          "device_spans": lambda self: [(s, e, k) for s, e, k, _ in kernels]})()
    old = trace.stop(fake, processing, t_close=t_start + 0.100)["idle_gaps"]
    assert [g[1] for g in got["idle_gaps"]] == [g[1] for g in old]
    for (new, _), (text, _) in zip(got["idle_gaps"], old):
        assert new.startswith(text)
    assert [g[0] for g in got["idle_gaps"]] == [
        "idle, host processing 0 invocations",                  # 0.052-0.100
        "idle, host processing 2 invocations: dispatch 2",      # 0.000-0.010
        "idle, host processing 2 invocations: sync 2",          # 0.045-0.050
        "idle, host processing 2 invocations: sync 2"]          # 0.036-0.040


def _record():
    """A traced run's record as ``harness.System.window`` makes it."""
    conf = spec.load_json(spec.HERE / "configs" / "olmo-1b.json")
    reqs = [{"submit": 100.0, "done": 100.07, "batch": 8, "length": 512, "tokens": 4096,
             "processing_s": 0.05, "queue_s": 0.01, "cold": False},
            # half of its processing after the close at 100.1
            {"submit": 100.0, "done": 100.12, "batch": 8, "length": 512, "tokens": 4096,
             "processing_s": 0.04, "queue_s": 0.01, "cold": False}]
    bound = counts.attention_bound_s(conf, 8, 512)
    return {"requests": reqs, "window_start": 100.0, "seconds": 0.1, "result_wait_s": 60.0,
            "config": conf, "mix": {"kind": "closed_loop"}, "setup_s": 1.0,
            "trace": {"busy_s": 0.05, "window_s": 0.1, "n_spans": 3,
                      "by_name": {"flash_fwd_bf16<128>": 6 * bound, "gemm": 0.03},
                      "device_ops": [["gemm", 0.03]],
                      "idle_gaps": [["idle, host processing 1 invocations", 0.02]]}}


EXISTING = ("latency_p95_ms.warm", "queue_ms.warm", "forward_ms.warm", "mfu.warm",
            "b3_roofline.warm", "device_idle.warm")


def _with_spans(rec):
    rec = copy.deepcopy(rec)
    rec["trace"].update(attributed_share=0.99, forward_device_s=0.045, eager_device_s=0.009,
                        device_s_by_op={"norm": 0.006}, idle_gaps_by_phase=[
                            ["idle, host processing 1 invocations: sync 1", 0.02]])
    rec["spans"] = [invocation(0, A, 100.02, 100.03, 100.07),
                    invocation(1, B, 100.08, 100.095, 100.12),
                    # a warm-up invocation before the window: not read
                    invocation(2, A, 99.0, 99.5, 99.6),
                    {"inv": 3, "kind": "prewarm", "attrs": {"function": "fn", "n": 2},
                     "spans": [sp("prewarm", 10.0, 50.0, -1, A),
                               sp("materialize", 20.0, 30.0, 0, A),
                               sp("fault", 20.0, 28.0, 1, A), sp("copy", 28.0, 30.0, 1, A),
                               sp("materialize", 30.0, 45.0, 0, A),
                               sp("fault", 30.0, 42.5, 4, A), sp("copy", 42.5, 45.0, 4, A)]}]
    return rec


def test_existing_readers_read_the_same_with_the_span_keys():
    plain = _record()
    traced = _with_spans(plain)
    for name in EXISTING + ("prompt_tokens_per_s", "setup_s"):
        assert spec.reader(name)(traced) == spec.reader(name)(plain), name
    assert [g[1] for g in traced["trace"]["idle_gaps_by_phase"]] == [
        g[1] for g in plain["trace"]["idle_gaps"]]


def test_span_readers():
    plain = _record()
    rec = _with_spans(plain)
    # both window invocations: dispatch 10 and 15 ms, sync 40 and 25 ms
    assert spec.reader("dispatch_ms.warm")(rec) == pytest.approx(12.5)
    assert spec.reader("sync_wait_ms.warm")(rec) == pytest.approx(32.5)
    # window shares 1 and 1/2: 45 ms of device time over 1.5 invocations
    assert spec.reader("forward_device_ms.warm")(rec) == pytest.approx(30.0)
    assert spec.reader("eager_ms.warm")(rec) == pytest.approx(6.0)
    assert spec.reader("prewarm_fault_s.warm")(rec) == pytest.approx(20.5)
    for name in ("dispatch_ms.warm", "sync_wait_ms.warm", "forward_device_ms.warm",
                 "eager_ms.warm", "prewarm_fault_s.warm"):
        assert spec.reader(name)(plain) is None, name
        assert spec.reader(name)(dict(plain, trace=None)) is None, name


@pytest.mark.cuda
def test_launches_land_in_their_threads_spans(cuda):
    """Two threads launch small kernels, each inside spans of its own; the
    profiler's launches, on the program's clock, fall in the right span."""
    from repro_torch.telemetry import MetricsRegistry
    reg = MetricsRegistry()
    reg.start_tracing()
    x = torch.ones(1 << 16, device=cuda)
    torch.cuda.synchronize()
    tr = trace.Tracing()

    def work(k, n):
        with reg.root("invocation", k=k):
            for i in range(n):
                with reg.span("op", i=i):
                    y = x * (i + 1)
                    y.add_(k)
                time.sleep(0.001)
            torch.cuda.synchronize()
    threads = [threading.Thread(target=work, args=(k, n)) for k, n in ((0, 30), (1, 45))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    tr.prof.stop()
    traces = [t.to_dict() for t in reg.drain_traces()]
    kernels, launches = spans.device_activity(tr)
    index = spans.SpanIndex(traces, tr.t_start)
    got = spans.attribute(kernels, launches, index)
    assert len(kernels) == 2 * (30 + 45)
    assert all(h is not None for h in got), sum(h is None for h in got)
    for h in got:
        t = traces[h[0]]
        assert t["spans"][h[1]]["name"] == "op"
    per = {traces[h[0]]["attrs"]["k"]: 0 for h in got}
    for h in got:
        per[traces[h[0]]["attrs"]["k"]] += 1
    assert per == {0: 60, 1: 90}
    # each kernel's launch is in the span of the iteration that made it
    seen = {}
    for h in got:
        seen.setdefault((h[0], h[1]), 0)
        seen[(h[0], h[1])] += 1
    assert set(seen.values()) == {2}
