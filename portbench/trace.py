"""The device trace of a ``--trace 1`` run, reduced to what the metrics read.

``torch.profiler`` traces the device's activity (kernels, copies, sets)
over the window, and the reduction keeps what ran before its close: the
invocations in flight at the close finish after it, and that drain is
left out, as it is of the end-to-end metric. Host operations are not traced, since tracing
every CPU op of a 45-second serving window slows the host it measures.
``device_spans`` and ``busy_s`` are ``chip_smoke.py``'s rule: the union of
the device activity's intervals, a moment two streams overlap counted once.
"""
from __future__ import annotations

import time


class Tracing:
    """The profiler over one window, and the host clock at its start: the
    trace stamps events on the system clock (ns since the epoch)."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t_start = time.perf_counter()
        self.epoch_s = time.time_ns() / 1e9

    def device_spans(self) -> list:
        """(start_s, end_s, name) of the device's own activity, seconds
        from the start. Read from the profiler's raw events: building its
        Python event tree takes minutes for a serving window's kernels."""
        from torch.autograd import DeviceType
        return [(e.start_ns() / 1e9 - self.epoch_s,
                 (e.start_ns() + e.duration_ns()) / 1e9 - self.epoch_s, e.name())
                for e in self.prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]


def union(intervals) -> list:
    """Disjoint, sorted union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def stop(tr: Tracing, processing: list, t_close: float) -> dict:
    """Stop tracing and reduce what ran up to ``t_close`` (host clock):
    busy seconds, the window's length, device seconds by kernel name, the
    ten longest device operations' totals and the ten longest idle gaps,
    each named by how many invocations the host was processing then
    (``processing``: host-clock intervals)."""
    import torch
    torch.cuda.synchronize()
    window_s = t_close - tr.t_start
    tr.prof.stop()
    spans = [(max(s, 0.0), min(e, window_s), n) for s, e, n in tr.device_spans()
             if e > 0.0 and s < window_s]
    busy = union((s, e) for s, e, _ in spans)
    by_name: dict = {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    gaps = []
    ends = [0.0] + [e for _, e in busy]
    starts = [s for s, _ in busy] + [window_s]
    for g0, g1 in zip(ends, starts):
        if g1 > g0:
            mid = tr.t_start + (g0 + g1) / 2
            n = sum(1 for a, b in processing if a <= mid <= b)
            gaps.append((g1 - g0, n))
    gaps.sort(reverse=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(e - s for s, e in busy), "window_s": window_s,
            "by_name": by_name, "n_spans": len(spans),
            "device_ops": [[name, s] for name, s in top],
            "idle_gaps": [[f"idle, host processing {n} invocations", s]
                          for s, n in gaps[:10]]}
