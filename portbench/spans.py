"""The program's span traces set against the device trace of a traced run.

With span recording on (``repro_torch.telemetry.TELEMETRY.start_tracing``)
every invocation is a tree of spans on the host's ``perf_counter`` clock:
``queue``, ``acquire``, ``forward`` tiled by ``dispatch`` and ``sync``, and
the dense model's ops under ``dispatch``; each span carries its thread's
``threading.get_ident()``. The profiler's trace (``trace.Tracing``, device
activity only) also holds the CUDA API's calls (``cuda*``, ``cu*``), each with
the correlation id of the device activity it started, and stamps each with
the low 32 bits of the calling thread's ``get_ident()`` (its
``device_resource_id``).

``attribute`` charges every kernel, copy and set to its launch, and the
launch, by thread and time, to the innermost span open on that thread
then: so each device second is known by invocation and by model op.
``reduce`` adds what the span metrics read to a traced run's reduction
(``trace.stop``'s), changing nothing that was there.
"""
from __future__ import annotations

import bisect

from .readers import mean, served, window_share
from .trace import union

#: a launch's thread, as the profiler stamps it
THREAD_MASK = 0xFFFFFFFF
#: the CUDA API calls that put work on the device
LAUNCHES = ("Launch", "Memcpy", "Memset")
#: the ops whose kernels are the eager float32 chains (A2.1's target)
EAGER_OPS = ("norm", "rope", "act")
#: the host phases an idle gap is labelled with, counted over invocations
PHASES = ("acquire", "dispatch", "sync")


def device_activity(tr) -> tuple[list, dict]:
    """From a stopped ``trace.Tracing``: the device's activity as (start_s,
    end_s, name, correlation id), seconds from the trace's start, and the
    host's launches as {correlation id: (start_s, thread, call_s)}, where
    ``call_s`` is how long the call held its thread."""
    from torch.autograd import DeviceType
    kernels, launches = [], {}
    for e in tr.prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():             # trace.Tracing's rule
                kernels.append((e.start_ns() / 1e9 - tr.epoch_s,
                                (e.start_ns() + e.duration_ns()) / 1e9 - tr.epoch_s,
                                e.name(), e.correlation_id()))
        elif e.name().startswith("cu") and any(k in e.name() for k in LAUNCHES):
            launches.setdefault(e.correlation_id(), (
                e.start_ns() / 1e9 - tr.epoch_s, e.device_resource_id() & THREAD_MASK,
                e.duration_ns() / 1e9))
    return kernels, launches


class SpanIndex:
    """The spans of a run's traces by thread, each on the trace's clock
    (seconds from ``t_start``): which span was the innermost open on a
    thread at a moment."""

    def __init__(self, traces: list, t_start: float):
        self.traces = traces
        self.t_start = t_start
        by: dict = {}
        for ti, t in enumerate(traces):
            depth = []
            for si, sp in enumerate(t["spans"]):
                depth.append(0 if sp["parent"] < 0 else depth[sp["parent"]] + 1)
                if sp["end_s"] is not None:
                    by.setdefault(sp["tid"] & THREAD_MASK, []).append(
                        (sp["start_s"] - t_start, depth[si], ti, si))
        self.by = {k: sorted(v) for k, v in by.items()}
        self.starts = {k: [s for s, _, _, _ in v] for k, v in self.by.items()}

    def at(self, thread: int, t: float):
        """(trace index, span index) of the innermost span open on
        ``thread`` at ``t``, else None."""
        starts = self.starts.get(thread)
        if not starts:
            return None
        j = bisect.bisect_right(starts, t) - 1
        if j < 0:
            return None
        _, _, ti, si = self.by[thread][j]
        spans = self.traces[ti]["spans"]
        while si >= 0:                        # the latest opened, or what holds it
            sp = spans[si]
            if sp["end_s"] is not None and sp["end_s"] - self.t_start >= t:
                return ti, si
            si = sp["parent"]
        return None

    def chain(self, ti: int, si: int) -> list:
        """The names from span ``si`` up to its trace's root."""
        spans, out = self.traces[ti]["spans"], []
        while si >= 0:
            out.append(spans[si]["name"])
            si = spans[si]["parent"]
        return out


def attribute(kernels: list, launches: dict, index: SpanIndex) -> list:
    """For each device activity (``device_activity``'s tuples), the
    (trace index, span index) of the innermost span open on its launching
    thread when it was launched, or None: no launch seen, or no span."""
    out = []
    for _, _, _, corr in kernels:
        launch = launches.get(corr)
        out.append(None if launch is None else index.at(launch[1], launch[0]))
    return out


def labelled_gaps(busy: list, window_s: float, processing: list, t_start: float,
                  traces: list) -> list:
    """``trace.stop``'s ten longest idle gaps, in its order and with its
    seconds and text, each label followed by the invocations' host phases
    (``PHASES``) at the gap's midpoint."""
    gaps = []
    ends = [0.0] + [e for _, e in busy]
    starts = [s for s, _ in busy] + [window_s]
    for g0, g1 in zip(ends, starts):
        if g1 > g0:
            mid = t_start + (g0 + g1) / 2
            n = sum(1 for a, b in processing if a <= mid <= b)
            gaps.append((g1 - g0, n, mid))
    gaps.sort(key=lambda g: (g[0], g[1]), reverse=True)
    out = []
    for s, n, mid in gaps[:10]:
        count = dict.fromkeys(PHASES, 0)
        for t in traces:
            for sp in t["spans"]:
                if (sp["name"] in count and sp["end_s"] is not None
                        and sp["start_s"] <= mid <= sp["end_s"]):
                    count[sp["name"]] += 1
        phases = ", ".join(f"{p} {k}" for p, k in count.items() if k)
        out.append([f"idle, host processing {n} invocations"
                    + (f": {phases}" if phases else ""), s])
    return out


def reduce(kernels: list, launches: dict, traces: list, processing: list,
           t_start: float, t_close: float) -> dict:
    """What the span metrics read, from a traced window (``kernels`` and
    ``launches`` as ``device_activity`` gives them, seconds from the
    trace's start at host time ``t_start``; ``traces`` the drained traces
    as dicts; ``processing`` and ``t_close`` as ``trace.stop`` takes them):

    * ``attributed_share``: the device's busy seconds whose launch fell in
      a ``forward`` span, over all its busy seconds;
    * ``forward_device_s``, ``eager_device_s``: device seconds charged to
      warm invocations' ``forward`` spans, and to their ``EAGER_OPS``;
    * ``device_s_by_op``: the warm forwards' device seconds by the
      innermost span that launched them (``layer``, ``dispatch`` and the
      like: their own time);
    * ``launch_call_s``: host seconds the warm forwards' launches of those
      kernels spent inside the launch calls (a full launch queue blocks
      there);
    * ``idle_gaps``: ``labelled_gaps``.
    """
    window_s = t_close - t_start
    index = SpanIndex(traces, t_start)
    inside = [(max(s, 0.0), min(e, window_s), k, c) for s, e, k, c in kernels
              if e > 0.0 and s < window_s]
    forward, by_op, call_s = [], {}, 0.0
    for (s, e, _, corr), hit in zip(inside, attribute(inside, launches, index)):
        if hit is None:
            continue
        ti, si = hit
        names = index.chain(ti, si)
        if "forward" not in names:
            continue
        forward.append((s, e))
        if traces[ti]["attrs"].get("cold") is False:
            by_op[names[0]] = by_op.get(names[0], 0.0) + (e - s)
            call_s += launches[corr][2]
    busy = union((s, e) for s, e, _, _ in inside)
    busy_s = sum(e - s for s, e in busy)
    return {"attributed_share": (sum(e - s for s, e in union(forward)) / busy_s
                                 if busy_s > 0 else None),
            "forward_device_s": sum(by_op.values()),
            "eager_device_s": sum(by_op.get(op, 0.0) for op in EAGER_OPS),
            "device_s_by_op": by_op, "launch_call_s": call_s,
            "idle_gaps": labelled_gaps(busy, window_s, processing, t_start, traces)}


# -- what the span metrics' readers share -----------------------------------------

def window_invocations(rec: dict) -> list:
    """The traces of the window's warm invocations that completed: the set
    ``forward_ms.warm`` reads (an invocation sent in the window opens its
    trace after the window's start). None without span traces."""
    if rec.get("spans") is None:
        return None
    return [t for t in rec["spans"] if t["kind"] == "invocation"
            and t["spans"][0]["start_s"] >= rec["window_start"]
            and t["attrs"].get("cold") is False and "error" not in t["attrs"]]


def span_s(trace: dict, name: str) -> float:
    """Seconds of the trace's spans called ``name``."""
    return sum(sp["end_s"] - sp["start_s"] for sp in trace["spans"]
               if sp["name"] == name and sp["end_s"] is not None)


def mean_span_ms(rec: dict, name: str):
    """Mean seconds, in ms, of span ``name`` over the window's warm
    invocations."""
    invs = window_invocations(rec)
    m = mean([span_s(t, name) for t in invs]) if invs else None
    return None if m is None else m * 1e3


def per_invocation_ms(rec: dict, key: str):
    """Device seconds ``reduce`` charged under ``key``, over the summed
    share of the window's warm invocations' processing inside it, in ms."""
    if rec["trace"] is None or key not in rec["trace"]:
        return None
    n = sum(window_share(rec, r) for r in served(rec) if not r["cold"])
    return rec["trace"][key] / n * 1e3 if n > 0 else None
