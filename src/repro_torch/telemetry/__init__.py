"""Fleet control room: process-wide metrics registry, per-invocation span
traces, and a periodic stats snapshotter (the JAX package's telemetry,
copied; the span traces are the port's own).

  emitters -> MetricsRegistry -> StatsSnapshotter -> <out_dir>/*.jsonl

* :class:`MetricsRegistry` — lock-light counters / gauges / fixed-bucket
  histograms plus a :class:`Trace`/:class:`Span` recorder: one span tree
  per invocation (router queue, instance acquire and restore stages, the
  forward's dispatch and sync, the dense model's ops) and per prewarm.  A
  process-wide default lives at :data:`repro_torch.telemetry.TELEMETRY`;
  emitters take ``registry=None`` and fall back to it, and
  :meth:`MetricsRegistry.disable` turns every metric emission into a
  no-op.  Span recording is off until
  :meth:`MetricsRegistry.start_tracing`.
* :class:`StatsSnapshotter` — samples every registered ``stats()``
  surface on a configurable interval into a JSON-lines time series.
  The clock is injected, so tests drive :meth:`StatsSnapshotter.sample`
  sleep-free; the background thread follows the REP004 convention
  (daemon + stop event + joined in :meth:`StatsSnapshotter.stop`).
* :mod:`repro_torch.telemetry.schema` — the one documented stat-key schema
  (canonical names, legacy aliases, per-sample invariants).
"""
from .registry import (  # noqa: F401
    TELEMETRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Span,
    Trace,
)
from .schema import LEGACY_ALIASES, SAMPLE_KEYS, canonicalize  # noqa: F401
from .snapshot import StatsSnapshotter, TelemetryConfig  # noqa: F401

__all__ = [
    "TELEMETRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "Trace",
    "StatsSnapshotter",
    "TelemetryConfig",
    "LEGACY_ALIASES",
    "SAMPLE_KEYS",
    "canonicalize",
]
