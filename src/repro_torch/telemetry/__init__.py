"""Metrics registry and cold-start trace spans (a copy of
``repro.telemetry.registry``; the snapshotter and schema are not ported)."""
from .registry import (  # noqa: F401
    TELEMETRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Span,
    Trace,
)
