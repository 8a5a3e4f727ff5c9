"""Periodic stats snapshotter: every ``stats()`` surface -> JSONL time
series.

The snapshotter owns *no* statistics of its own — it polls callables
(``Router.stats``, ``Orchestrator.tail_stats``, ``PrewarmPolicy.stats``,
``ShardedSnapshotStore.stats``, ``ClusterRouter.stats``,
``DemandAggregator.stats``, ``MetricsRegistry.collect``) and appends one
JSON object per interval to a bounded in-memory ring and, optionally, a
``.jsonl`` file under ``results/telemetry/``.

Clock and pacing are injected: the background thread (REP004: daemon +
stop event + joined in :meth:`StatsSnapshotter.stop`) paces itself off a
wall ``threading.Event.wait``, but every *sample timestamp* comes from
``self.clock``, and tests bypass the thread entirely by driving
:meth:`sample` / :meth:`maybe_sample` with a fake clock — no sleeps.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from .registry import TELEMETRY, MetricsRegistry
from .schema import SAMPLE_KEYS  # noqa: F401  (re-exported contract)

__all__ = ["TelemetryConfig", "StatsSnapshotter"]


@dataclasses.dataclass
class TelemetryConfig:
    """Knob block carried on ``ServeConfig.telemetry``.

    ``out_dir=None`` keeps samples in memory only (tests); otherwise each
    snapshotter writes ``<out_dir>/<stream>.jsonl``.
    """

    interval_s: float = 0.25
    out_dir: Optional[str] = "results/telemetry"
    ring: int = 512
    per_node: bool = False     # also run one snapshotter per WorkerNode


class StatsSnapshotter:
    """Samples registered stats sources into a ring + JSONL stream."""

    def __init__(self, *, interval_s: float = 0.25,
                 path: Optional[str] = None, ring: int = 512,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[MetricsRegistry] = None) -> None:
        self.interval_s = float(interval_s)
        self.path = path
        self.clock = clock
        self.registry = TELEMETRY if registry is None else registry
        self.sources: dict[str, Callable[[], Any]] = {}
        self.n_samples = 0
        self.n_errors = 0
        self._ring: deque[dict] = deque(maxlen=int(ring))
        self._last_t: Optional[float] = None
        self._fh = None
        self._mu = threading.Lock()      # leaf: guards ring + seq only
        self._io = threading.Lock()      # leaf: guards the jsonl file
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sources --------------------------------------------------------

    def add_source(self, name: str, fn: Callable[[], Any]) -> "StatsSnapshotter":
        """Register ``fn`` to be polled as ``sources[name]`` each sample."""
        self.sources[name] = fn
        return self

    # -- sampling -------------------------------------------------------

    def sample(self, now: Optional[float] = None) -> dict:
        """Take one sample immediately.  A raising source is recorded as
        ``{"error": repr(exc)}`` under its name — one dying node must not
        take the time series down with it."""
        now = self.clock() if now is None else now
        polled: dict[str, Any] = {}
        errors = 0
        for name, fn in list(self.sources.items()):
            try:
                polled[name] = fn()
            except Exception as e:
                polled[name] = {"error": repr(e)}
                errors += 1
        with self._mu:
            self.n_errors += errors
            rec = {"t": now, "seq": self.n_samples, "sources": polled,
                   "errors": self.n_errors}
            self.n_samples += 1
            self._last_t = now
            self._ring.append(rec)
        self._write(rec)                 # file I/O outside the ring lock
        return rec

    def maybe_sample(self, now: Optional[float] = None) -> Optional[dict]:
        """Sample only if ``interval_s`` has elapsed since the last sample
        (paces a fake-clock test); returns the sample or ``None``."""
        now = self.clock() if now is None else now
        last = self._last_t
        if last is not None and now - last < self.interval_s:
            return None
        return self.sample(now)

    def samples(self) -> list[dict]:
        with self._mu:
            return list(self._ring)

    # -- persistence ----------------------------------------------------

    def _write(self, rec: dict) -> None:
        if self.path is None:
            return
        line = json.dumps(rec, default=_json_default) + "\n"
        if self._fh is None:
            # open outside the lock (never hold a lock across file open);
            # a racing opener loses and closes its handle
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            fh = open(self.path, "a", encoding="utf-8")
            keep = False
            with self._io:
                if self._fh is None:
                    self._fh = fh
                    keep = True
            if not keep:
                fh.close()
        with self._io:
            fh = self._fh
            if fh is None:
                return                   # closed concurrently: drop the line
            fh.write(line)
            fh.flush()

    # -- lifecycle (REP004) --------------------------------------------

    def start(self) -> "StatsSnapshotter":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="stats-snapshotter", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def close(self) -> None:
        """Stop the thread, take one final sample, and close the file."""
        self.stop()
        if self.sources:
            self.sample()
        with self._io:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample()


def _json_default(obj):
    """Stats dicts occasionally carry numpy scalars; degrade gracefully."""
    for attr in ("item",):
        f = getattr(obj, attr, None)
        if callable(f):
            try:
                return f()
            except Exception:
                break
    return repr(obj)
