"""Lock-light metrics registry + per-invocation span traces.

Design constraints, in order:

1. **Cheap on the hot path.**  Counters/gauges take one tiny leaf lock
   for the update only; histograms bisect fixed bucket edges under their
   own leaf lock.  No registry lock is ever held while calling out, so
   the static lock-graph analysis sees pure leaves (no ordering edges).
2. **Disable == no-op.**  :meth:`MetricsRegistry.disable` flips one
   boolean checked before any work; the scalability benchmark's
   telemetry-overhead A/B toggles it.  Span recording has a switch of its
   own, off by default (:meth:`MetricsRegistry.start_tracing`): while it
   is off ``trace()`` and ``span()`` hand back one shared no-op, so an
   invocation or a model op allocates no span.
3. **StageTimings stays the stage-seconds sink (REP005).**  Restore
   spans *read* their durations from the just-written ``StageTimings``
   fields — the registry never computes a stage duration itself.
4. **One injected clock.**  The registry reads its clock (``clock=``,
   ``time.perf_counter`` by default) only to open and close spans and
   traces; emitters that already read the time hand their reads in
   (``start_s=``, :meth:`Span.stop`), so a span's duration is exactly the
   emitter's own measurement.

A trace is one invocation's (or one prewarm's) span tree.  A thread makes
a trace current with :meth:`MetricsRegistry.current`; ``span(name)`` then
opens a child of that thread's innermost open span, and ``record`` adds an
already-timed one.  With no current trace both are no-ops.
"""
from __future__ import annotations

import bisect
import itertools
import math
import threading
import time
from collections import deque

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Span",
    "Trace",
    "MetricsRegistry",
    "TELEMETRY",
]

# Default histogram edges (seconds): 100us .. ~26s, x2 per bucket.
DEFAULT_EDGES = tuple(1e-4 * 2.0 ** i for i in range(19))


class Counter:
    """Monotonic counter."""

    __slots__ = ("_mu", "_n")

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._n = 0

    def inc(self, n: int = 1) -> None:
        with self._mu:
            self._n += n

    @property
    def value(self) -> int:
        with self._mu:
            return self._n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("_mu", "_v")

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._mu:
            self._v = float(v)

    @property
    def value(self) -> float:
        with self._mu:
            return self._v

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram; ``edges[i]`` is the inclusive upper bound
    of bucket ``i``, with one implicit overflow bucket at the end."""

    __slots__ = ("edges", "_mu", "_buckets", "_count", "_sum", "_min", "_max")

    def __init__(self, edges=DEFAULT_EDGES) -> None:
        self.edges = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(self.edges):
            raise ValueError("histogram edges must be sorted ascending")
        self._mu = threading.Lock()
        self._buckets = [0] * (len(self.edges) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.edges, v)
        with self._mu:
            self._buckets[i] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._mu:
            return self._count

    def percentile(self, q: float) -> float | None:
        """Bucket-resolution percentile (upper edge of the bucket holding
        the ``q``-th percentile, ``q`` in [0, 100]); None when empty."""
        with self._mu:
            if self._count == 0:
                return None
            rank = min(self._count,
                       max(1, math.ceil(q / 100.0 * self._count)))
            seen = 0
            for i, n in enumerate(self._buckets):
                seen += n
                if seen >= rank:
                    if i < len(self.edges):
                        return self.edges[i]
                    return self._max
            return self._max

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "buckets": list(self._buckets),
                "edges": list(self.edges),
            }


class Span:
    """One timed stage of a :class:`Trace`: ``[start_s, end_s]`` on the
    registry's clock (``end_s`` is None while open), ``parent`` its
    parent's index in the trace (-1 for the root), ``tid`` the opening
    thread's ``threading.get_ident()`` (whose low 32 bits a CUDA profiler
    stamps on the thread's kernel launches)."""

    __slots__ = ("name", "start_s", "end_s", "parent", "tid", "attrs",
                 "_frame")

    def __init__(self, name: str, start_s: float, parent: int = -1,
                 attrs: dict | None = None, end_s: float | None = None) -> None:
        self.name = name
        self.start_s = float(start_s)
        self.end_s = end_s
        self.parent = parent
        self.tid = threading.get_ident()
        self.attrs = attrs or None
        self._frame = None

    @property
    def duration_s(self) -> float | None:
        return None if self.end_s is None else self.end_s - self.start_s

    def stop(self, end_s: float) -> float:
        """Close the span at ``end_s`` (a read the caller already made);
        the block's exit then keeps it.  Returns ``end_s``."""
        self.end_s = end_s
        return end_s

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        frame, self._frame = self._frame, None
        if self.end_s is None:
            self.end_s = frame.trace._registry._clock()
        frame.stack.pop()

    def to_dict(self) -> dict:
        d = {"name": self.name, "start_s": self.start_s, "end_s": self.end_s,
             "parent": self.parent, "tid": self.tid}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


#: process-wide invocation ids: one per :class:`Trace`
_TRACE_IDS = itertools.count()


class Trace:
    """The span tree of one invocation (or one prewarm): ``spans[0]`` is
    the root, named ``kind``; ``inv`` is a process-wide id.  Any thread
    that makes the trace current (:meth:`MetricsRegistry.current`) adds
    spans to it; :meth:`finish` closes the root and hands the trace to the
    registry's buffer."""

    __slots__ = ("inv", "kind", "attrs", "spans", "_registry", "_mu")

    def __init__(self, kind: str, attrs: dict | None = None,
                 registry: "MetricsRegistry | None" = None,
                 start_s: float = 0.0) -> None:
        self.inv = next(_TRACE_IDS)
        self.kind = kind
        self.attrs = dict(attrs or {})
        self.spans: list[Span] = [Span(kind, start_s)]
        self._registry = registry
        self._mu = threading.Lock()

    @property
    def root(self) -> Span:
        return self.spans[0]

    def _add(self, span: Span) -> int:
        with self._mu:
            self.spans.append(span)
            return len(self.spans) - 1

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def finish(self, end_s: float | None = None) -> None:
        """Close the root (now, unless ``end_s`` is given) and hand the
        trace to the owning registry's buffer."""
        if self._registry is not None:
            self.root.end_s = self._registry._clock() if end_s is None else end_s
            self._registry._record_trace(self)

    def to_dict(self) -> dict:
        return {"inv": self.inv, "kind": self.kind, "attrs": dict(self.attrs),
                "spans": [s.to_dict() for s in self.spans]}


class _Noop:
    """Stand-in returned by a disabled registry (and by ``trace()`` while
    span recording is off); swallows everything, and is also the shared
    no-op span and scope: ``with`` on it does nothing."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def annotate(self, **attrs) -> None:
        pass

    def finish(self, end_s: float | None = None) -> None:
        pass

    def stop(self, end_s: float) -> float:
        return end_s

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP = _Noop()


class _Frame:
    """A thread's current trace and its stack of open span indices."""

    __slots__ = ("trace", "stack", "prev")

    def __init__(self, trace: Trace, prev: "_Frame | None") -> None:
        self.trace = trace
        self.stack = [0]
        self.prev = prev


class _Current:
    """Makes a trace current on the entering thread for the block; with
    ``finish`` the trace is finished at the block's end."""

    __slots__ = ("_local", "_trace", "_finish")

    def __init__(self, local, trace: Trace, finish: bool) -> None:
        self._local, self._trace, self._finish = local, trace, finish

    def __enter__(self) -> Trace:
        self._local.frame = _Frame(self._trace, getattr(self._local, "frame", None))
        return self._trace

    def __exit__(self, *exc) -> None:
        self._local.frame = self._local.frame.prev
        if self._finish:
            self._trace.finish()


class MetricsRegistry:
    """Process-wide named metrics + a buffer of finished traces.

    The creation lock (``_mu``) guards only the name->metric maps and the
    trace buffer; per-metric updates take the metric's own leaf lock.  All
    public methods are safe from any thread.
    """

    def __init__(self, *, trace_ring: int = 8192, enabled: bool = True,
                 clock=time.perf_counter) -> None:
        self._mu = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._traces: deque[Trace] = deque(maxlen=trace_ring)
        self._local = threading.local()
        self._clock = clock
        self.enabled = bool(enabled)
        #: span recording (``trace``/``span``/``record``), off by default
        self.tracing = False

    # -- toggles --------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def start_tracing(self) -> None:
        self.tracing = True

    def stop_tracing(self) -> None:
        self.tracing = False

    # -- metric accessors ----------------------------------------------

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NOOP  # type: ignore[return-value]
        c = self._counters.get(name)
        if c is None:
            with self._mu:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NOOP  # type: ignore[return-value]
        g = self._gauges.get(name)
        if g is None:
            with self._mu:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str, edges=DEFAULT_EDGES) -> Histogram:
        if not self.enabled:
            return _NOOP  # type: ignore[return-value]
        h = self._histograms.get(name)
        if h is None:
            with self._mu:
                h = self._histograms.setdefault(name, Histogram(edges))
        return h

    # -- convenience emitters ------------------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    # -- traces and spans -----------------------------------------------

    def trace(self, kind: str, *, start_s: float | None = None,
              **attrs) -> Trace:
        """A new trace whose root opens at ``start_s`` (now if None); the
        shared no-op while span recording is off."""
        if not self.tracing:
            return _NOOP  # type: ignore[return-value]
        return Trace(kind, attrs, registry=self,
                     start_s=self._clock() if start_s is None else start_s)

    def current(self, trace: Trace):
        """Context manager: ``trace`` is the calling thread's current
        trace for the block (the no-op trace makes nothing current)."""
        if trace is _NOOP:
            return _NOOP
        return _Current(self._local, trace, finish=False)

    def root(self, kind: str, **attrs):
        """Context manager: a new trace, current on this thread for the
        block and finished at its end — unless span recording is off or a
        trace is current here already (then the block yields the no-op)."""
        if not self.tracing or self.active() is not None:
            return _NOOP
        return _Current(self._local, self.trace(kind, **attrs), finish=True)

    def active(self) -> Trace | None:
        """The calling thread's current trace, else None."""
        frame = getattr(self._local, "frame", None)
        return None if frame is None else frame.trace

    def span(self, name: str, *, start_s: float | None = None, **attrs):
        """Context manager: a child of this thread's innermost open span in
        its current trace, open from ``start_s`` (now if None) to the
        block's end (or to :meth:`Span.stop`'s read).  The shared no-op
        when recording is off or no trace is current."""
        if not self.tracing:
            return _NOOP
        frame = getattr(self._local, "frame", None)
        if frame is None:
            return _NOOP
        span = Span(name, self._clock() if start_s is None else start_s,
                    frame.stack[-1], attrs)
        span._frame = frame
        frame.stack.append(frame.trace._add(span))
        return span

    def record(self, name: str, start_s: float, end_s: float, **attrs) -> None:
        """Add a span already timed by the caller as a child of this
        thread's innermost open span (nothing when recording is off or no
        trace is current)."""
        if not self.tracing:
            return
        frame = getattr(self._local, "frame", None)
        if frame is not None:
            frame.trace._add(Span(name, start_s, frame.stack[-1], attrs,
                                  end_s=end_s))

    def _record_trace(self, trace: Trace) -> None:
        with self._mu:
            self._traces.append(trace)

    def traces(self, kind: str | None = None) -> list[Trace]:
        with self._mu:
            ts = list(self._traces)
        if kind is None:
            return ts
        return [t for t in ts if t.kind == kind]

    def drain_traces(self) -> list[Trace]:
        """The finished traces, oldest first; empties the buffer."""
        with self._mu:
            ts = list(self._traces)
            self._traces.clear()
        return ts

    # -- export ---------------------------------------------------------

    def collect(self) -> dict:
        """Stable-keyed snapshot of every metric (no traces: those are
        drained separately, :meth:`drain_traces`)."""
        with self._mu:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "enabled": self.enabled,
            "counters": {k: counters[k].snapshot() for k in sorted(counters)},
            "gauges": {k: gauges[k].snapshot() for k in sorted(gauges)},
            "histograms": {k: hists[k].snapshot() for k in sorted(hists)},
        }

    def reset(self) -> None:
        """Drop every metric and trace (benchmark arm isolation)."""
        with self._mu:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._traces.clear()


#: Process-wide default registry.  Emitters take ``registry=None`` and
#: fall back to this, mirroring the module-level WS_CACHE convention.
TELEMETRY = MetricsRegistry()
