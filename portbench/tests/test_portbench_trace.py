"""The reduction of a device trace and the readers that take it, on a
trace made by hand (the profiler itself runs only on the card)."""
import time

import pytest
import torch

from portbench import counts, spec, trace


class FakeTracing:
    def __init__(self, spans, t_start):
        self.spans, self.t_start = spans, t_start
        self.prof = type("P", (), {"stop": lambda self: None})()

    def device_spans(self):
        return self.spans


def test_union_busy_gaps_and_names(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    t0 = time.perf_counter()
    spans = [(0.0, 1.0, "flash_fwd_bf16<128>"), (0.5, 1.5, "gemm"), (3.0, 3.5, "gemm")]
    spans.append((4.2, 4.6, "gemm"))                  # after the close: left out
    tr = FakeTracing(spans, t0 - 4.0)                 # a window of 4 s
    rec = trace.stop(tr, processing=[(t0 - 4.0, t0 - 2.5)], t_close=t0)
    assert rec["busy_s"] == pytest.approx(2.0)
    assert rec["window_s"] == pytest.approx(4.0)
    assert rec["by_name"] == {"flash_fwd_bf16<128>": 1.0, "gemm": 1.5}
    assert rec["device_ops"][0] == ["gemm", 1.5]
    (name, longest), = rec["idle_gaps"][:1]
    assert longest == pytest.approx(1.5) and name.endswith("processing 0 invocations")


def test_trace_readers():
    conf = spec.load_json(spec.HERE / "configs" / "olmo-1b.json")
    reqs = [{"submit": 0.0, "done": 1.0, "batch": 8, "length": 512, "tokens": 4096,
             "processing_s": 0.5, "queue_s": 0.1, "cold": False},
            # half of its processing after the close at 2.0: half its work counts
            {"submit": 1.0, "done": 2.5, "batch": 8, "length": 512, "tokens": 4096,
             "processing_s": 1.0, "queue_s": 0.3, "cold": False}]
    bound = counts.attention_bound_s(conf, 8, 512)
    rec = {"requests": reqs, "window_start": 0.0, "seconds": 2.0, "result_wait_s": 60.0,
           "config": conf, "mix": {"kind": "closed_loop"}, "setup_s": 1.0,
           "trace": {"busy_s": 0.5, "window_s": 2.0,
                     "by_name": {"flash_fwd_bf16<128>": 6 * bound, "gemm": 0.3}}}
    assert spec.reader("b3_roofline.warm")(rec) == pytest.approx(25.0)
    assert spec.reader("device_idle.warm")(rec) == pytest.approx(75.0)
    flops = counts.forward_flops(conf, 8, 512)
    assert spec.reader("mfu.warm")(rec) == pytest.approx(100 * 1.5 * flops / (1.0 * 989e12))
    # all the work sent, over the time to the last answer (2.5 s)
    assert spec.reader("prompt_tokens_per_s")(rec) == pytest.approx(8192 / 2.5)
    assert spec.reader("latency_p95_ms.warm")(rec) == pytest.approx(1500.0)
    assert spec.reader("queue_ms.warm")(rec) == pytest.approx(200.0)
    assert spec.reader("forward_ms.warm")(rec) == pytest.approx(750.0)
    assert spec.reader("setup_s")(rec) == 1.0


def test_readers_of_the_trace_find_nothing_without_one():
    rec = {"requests": [], "window_start": 0.0, "seconds": 2.0, "result_wait_s": 60.0,
           "trace": None}
    assert spec.reader("b3_roofline.warm")(rec) is None
    assert spec.reader("device_idle.warm")(rec) is None
    assert spec.reader("mfu.warm")(rec) is None
    assert spec.reader("latency_p95_ms.warm")(rec) is None
