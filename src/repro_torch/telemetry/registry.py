"""Lock-light metrics registry + cold-start trace spans.

Design constraints, in order:

1. **Cheap on the hot path.**  Counters/gauges take one tiny leaf lock
   for the update only; histograms bisect fixed bucket edges under their
   own leaf lock.  No registry lock is ever held while calling out, so
   the static lock-graph analysis sees pure leaves (no ordering edges).
2. **Disable == no-op.**  :meth:`MetricsRegistry.disable` flips one
   boolean checked before any work; the scalability benchmark's
   telemetry-overhead A/B toggles it.
3. **StageTimings stays the stage-seconds sink (REP005).**  Restore
   spans *read* their durations from the just-written ``StageTimings``
   fields — the registry never computes a stage duration itself.
4. **No direct ``time.*`` reads.**  Emitters pass their own injected
   clock's timestamps in; the registry only stores what it is handed.
"""
from __future__ import annotations

import bisect
import math
import dataclasses
import threading
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


@dataclasses.dataclass
class Span:
    """One timed stage inside a :class:`Trace`.  ``start_s`` is in the
    emitting component's clock domain; ``duration_s`` is read from the
    component's own timing sink (StageTimings for restore stages)."""

    name: str
    start_s: float
    duration_s: float
    attrs: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {"name": self.name, "start_s": self.start_s,
             "duration_s": self.duration_s}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class Trace:
    """A per-invocation span list (e.g. one cold start).  Built by one
    thread; the registry keeps a bounded ring of finished traces."""

    __slots__ = ("kind", "attrs", "spans", "_registry")

    def __init__(self, kind: str, attrs: dict | None = None,
                 registry: "MetricsRegistry | None" = None) -> None:
        self.kind = kind
        self.attrs = dict(attrs or {})
        self.spans: list[Span] = []
        self._registry = registry

    def add(self, name: str, start_s: float, duration_s: float,
            **attrs) -> Span:
        span = Span(name, float(start_s), float(duration_s), attrs)
        self.spans.append(span)
        return span

    def finish(self) -> None:
        """Hand the completed trace to the owning registry's ring."""
        if self._registry is not None:
            self._registry._record_trace(self)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "attrs": dict(self.attrs),
                "spans": [s.to_dict() for s in self.spans]}


class _Noop:
    """Stand-in returned by a disabled registry; swallows everything."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def add(self, name, start_s, duration_s, **attrs) -> None:
        pass

    def finish(self) -> None:
        pass


_NOOP = _Noop()


class MetricsRegistry:
    """Process-wide named metrics + trace ring.

    The creation lock (``_mu``) guards only the name->metric maps and the
    trace ring; per-metric updates take the metric's own leaf lock.  All
    public methods are safe from any thread.
    """

    def __init__(self, *, trace_ring: int = 256, enabled: bool = True) -> None:
        self._mu = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._traces: deque[Trace] = deque(maxlen=trace_ring)
        self.enabled = bool(enabled)

    # -- toggles --------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

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

    # -- traces ---------------------------------------------------------

    def trace(self, kind: str, **attrs) -> Trace:
        if not self.enabled:
            return _NOOP  # type: ignore[return-value]
        return Trace(kind, attrs, registry=self)

    def _record_trace(self, trace: Trace) -> None:
        with self._mu:
            self._traces.append(trace)

    def traces(self, kind: str | None = None) -> list[Trace]:
        with self._mu:
            ts = list(self._traces)
        if kind is None:
            return ts
        return [t for t in ts if t.kind == kind]

    # -- export ---------------------------------------------------------

    def collect(self) -> dict:
        """Stable-keyed snapshot of every metric (no traces: those are
        bounded-ring debugging payloads, exported separately)."""
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
