"""Fleet control room: process-wide metrics registry, cold-start trace
spans, and a periodic stats snapshotter (the JAX package's telemetry,
copied).

  emitters -> MetricsRegistry -> StatsSnapshotter -> <out_dir>/*.jsonl

* :class:`MetricsRegistry` — lock-light counters / gauges / fixed-bucket
  histograms plus a :class:`Trace`/:class:`Span` API for per-invocation
  cold-start traces.  A process-wide default lives at
  :data:`repro_torch.telemetry.TELEMETRY`; emitters take ``registry=None`` and
  fall back to it, and :meth:`MetricsRegistry.disable` turns every
  emission into a no-op.
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
