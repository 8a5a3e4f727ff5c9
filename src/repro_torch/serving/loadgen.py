"""Trace-driven load generation for the concurrent data plane.

Workload model (SPES-style: provisioning policy must react to arrival
patterns, so arrivals must be *replayable*):

  * A :class:`Trace` is an ordered list of :class:`TraceEvent`s — arrival
    offset, function name, modality, per-event seed.  Traces serialize to
    JSON so a workload can be saved, diffed, and replayed bit-identically.
  * :func:`poisson_trace` synthesizes an **open-loop** arrival process
    (exponential inter-arrivals at ``rate_rps``) over a weighted function
    mix and modality mix, from a seed.
  * :func:`uniform_trace` synthesizes a deterministic fixed-interval trace
    (``interval_s=0`` => an N-wide concurrent burst, the Fig. 9 shape).
  * :func:`azure_trace` ingests the Azure Functions 2019
    invocations-per-minute CSV, mapping the busiest production functions
    onto registered names (real arrival shapes, compressed in time).
  * :class:`OpenLoopGenerator` replays a trace against a router at wall
    pace: submits happen at each event's offset whether or not earlier
    invocations finished (queueing delay is *measured*, not avoided).
  * :class:`ClosedLoopGenerator` runs N client loops (submit, wait, think)
    — the throughput-oriented counterpart.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Callable

import numpy as np

from ..core.reap import ColdStartReport
from .router import AdmissionError, Router

MODALITIES = ("text", "vision", "audio")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    t: float                 # arrival offset from trace start, seconds
    function: str
    modality: str = "text"
    seed: int = 0


@dataclasses.dataclass
class Trace:
    events: list[TraceEvent]
    #: Known fundamental period of the arrival process (seconds), when the
    #: generator has one (diurnal_trace's sinusoid period; azure_trace's
    #: compressed day).  A forecasting policy may take it as a hint
    #: (ForecastConfig.period_hint_s) instead of detecting the period
    #: blind.  None: no periodicity is claimed.
    period_hint_s: float | None = None

    @property
    def duration_s(self) -> float:
        return self.events[-1].t if self.events else 0.0

    @property
    def functions(self) -> list[str]:
        return sorted({e.function for e in self.events})

    def save(self, path: str) -> None:
        doc = {"version": 1,
               "events": [dataclasses.asdict(e) for e in self.events]}
        if self.period_hint_s is not None:
            doc["period_hint_s"] = self.period_hint_s
        with open(path, "w") as f:
            json.dump(doc, f, indent=None)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            d = json.load(f)
        return cls([TraceEvent(**e) for e in d["events"]],
                   period_hint_s=d.get("period_hint_s"))


def _normalize_mix(names: list[str], mix: dict[str, float] | None) -> np.ndarray:
    w = np.asarray([1.0 if mix is None else float(mix.get(n, 0.0))
                    for n in names])
    if w.sum() <= 0:
        raise ValueError("function mix has no mass")
    return w / w.sum()


def poisson_trace(rate_rps: float, duration_s: float, functions: list[str], *,
                  mix: dict[str, float] | None = None,
                  modality_mix: dict[str, float] | None = None,
                  seed: int = 0) -> Trace:
    """Open-loop Poisson arrivals over a weighted multi-function mix."""
    rng = np.random.default_rng(seed)
    probs = _normalize_mix(functions, mix)
    mod_names = list(MODALITIES)
    mod_probs = _normalize_mix(mod_names, modality_mix or {"text": 1.0})
    events: list[TraceEvent] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate_rps))
        if t > duration_s:
            break
        events.append(TraceEvent(
            t=t,
            function=functions[int(rng.choice(len(functions), p=probs))],
            modality=mod_names[int(rng.choice(len(mod_names), p=mod_probs))],
            seed=int(rng.integers(0, 2**31)),
        ))
    return Trace(events)


def uniform_trace(n: int, interval_s: float, functions: list[str], *,
                  seed: int = 0) -> Trace:
    """Deterministic arrivals every ``interval_s``; ``interval_s=0`` is an
    N-wide concurrent burst round-robined over ``functions``."""
    return Trace([TraceEvent(t=i * interval_s,
                             function=functions[i % len(functions)],
                             seed=seed + i)
                  for i in range(n)])


def diurnal_trace(base_rps: float, peak_rps: float, period_s: float,
                  duration_s: float, functions: list[str], *,
                  mix: dict[str, float] | None = None,
                  burst_rps: float = 0.0, burst_every_s: float = 0.0,
                  burst_len_s: float = 0.1, seed: int = 0) -> Trace:
    """Non-homogeneous Poisson arrivals with a diurnal (sinusoidal) rate,
    optionally overlaid with periodic bursts — the Azure-Functions-style
    shape an adaptive prewarming policy must track (troughs scale to zero,
    ramps are predicted, bursts stress the warm-pool target).

    Rate profile (requests/s at offset ``t``)::

        rate(t) = base + (peak - base) * (1 - cos(2*pi*t/period)) / 2
                  [+ burst_rps while t mod burst_every_s < burst_len_s]

    Synthesized by Lewis-Shedler thinning of a homogeneous process at the
    peak rate, so the trace is exact and replayable from ``seed``.
    """
    if peak_rps < base_rps:
        raise ValueError("peak_rps must be >= base_rps")
    rng = np.random.default_rng(seed)
    probs = _normalize_mix(functions, mix)

    def rate(t: float) -> float:
        r = base_rps + (peak_rps - base_rps) * (
            1.0 - np.cos(2.0 * np.pi * t / period_s)) / 2.0
        if burst_rps > 0 and burst_every_s > 0 \
                and (t % burst_every_s) < burst_len_s:
            r += burst_rps
        return r

    rate_max = peak_rps + (burst_rps if burst_every_s > 0 else 0.0)
    if rate_max <= 0:
        return Trace([], period_hint_s=period_s)
    events: list[TraceEvent] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate_max))
        if t > duration_s:
            break
        if rng.uniform() * rate_max > rate(t):   # thinning: reject
            continue
        events.append(TraceEvent(
            t=t,
            function=functions[int(rng.choice(len(functions), p=probs))],
            seed=int(rng.integers(0, 2**31)),
        ))
    return Trace(events, period_hint_s=period_s)


def azure_trace(path: str, functions: list[str] | None = None, *,
                duration_s: float | None = None,
                max_minutes: int | None = None,
                top_k: int | None = None, seed: int = 0) -> Trace:
    """Ingest the Azure Functions 2019 invocations-per-minute CSV format.

    Each row is one function: hash-id columns (``HashOwner``, ``HashApp``,
    ``HashFunction``, ``Trigger``, ...) followed by numeric minute columns
    ``1..1440`` holding the invocation count in that minute of the day.
    Parsing is header-driven — any non-numeric leading columns are treated
    as identity, any numeric header as a minute index — so the 2021 format
    variants parse too.  Rows with garbled count cells are skipped, not
    fatal; a file yielding *no* valid rows raises ``ValueError``.

    Synthesis: rows are ranked by total invocations and the busiest
    ``top_k`` kept (default: ``len(functions)`` when a mapping is given,
    else all rows).  With ``functions`` given, rank *i* maps onto
    ``functions[i % len(functions)]`` — the production arrival *shape*
    replayed over this repo's registered function names.  A count of *c*
    in minute *m* becomes *c* arrivals uniformly placed inside
    ``[60*m, 60*(m+1))`` by a seeded RNG, so the trace is exact and
    replayable.  ``duration_s`` rescales the whole timeline (1440 minutes
    of production traffic compressed into a benchmark window);
    ``max_minutes`` truncates to the first N minute columns first.
    """
    rows: list[tuple[str, list[int]]] = []   # (function id, per-minute counts)
    with open(path) as f:
        header = f.readline().rstrip("\n").split(",")
        minute_cols = [i for i, h in enumerate(header)
                       if h.strip().lstrip("-").isdigit()]
        if not minute_cols:
            raise ValueError(f"{path}: no numeric minute columns in header")
        if max_minutes is not None:
            minute_cols = minute_cols[:max_minutes]
        # identity = every column before the first minute column (columns
        # interleaved after that point are not supported and would parse
        # as counts)
        id_cols = list(range(minute_cols[0]))
        n_skipped = 0
        for line in f:
            cells = line.rstrip("\n").split(",")
            if len(cells) <= minute_cols[0]:
                continue                     # blank/short line
            fid = "/".join(cells[i] for i in id_cols) or f"row{len(rows)}"
            try:
                counts = [int(float(cells[i])) if i < len(cells) and cells[i]
                          else 0 for i in minute_cols]
            except ValueError:
                # a garbled count cell poisons only its own row: real trace
                # dumps carry the occasional truncated/corrupt line, and
                # one of them must not abort a whole replay
                n_skipped += 1
                continue
            rows.append((fid, counts))
    if not rows:
        raise ValueError(
            f"{path}: no function rows"
            + (f" ({n_skipped} malformed rows skipped)" if n_skipped else ""))
    rows.sort(key=lambda r: (-sum(r[1]), r[0]))  # busiest first, stable
    k = top_k if top_k is not None else (len(functions) if functions
                                         else len(rows))
    rows = rows[:max(k, 1)]

    span_s = 60.0 * max(len(c) for _, c in rows)
    scale = 1.0 if duration_s is None else duration_s / span_s
    rng = np.random.default_rng(seed)
    events: list[TraceEvent] = []
    for rank, (fid, counts) in enumerate(rows):
        name = (functions[rank % len(functions)] if functions else fid)
        for m, c in enumerate(counts):
            if c <= 0:
                continue
            for t in rng.uniform(60.0 * m, 60.0 * (m + 1), size=c):
                events.append(TraceEvent(t=float(t) * scale, function=name,
                                         seed=int(rng.integers(0, 2**31))))
    events.sort(key=lambda e: e.t)
    # production traffic's fundamental period is the day; in the compressed
    # timeline that is the full span (one cycle of history per replay)
    return Trace(events, period_hint_s=span_s * scale)


#: Maps one trace event to a request payload for its function.
BatchFactory = Callable[[TraceEvent], dict]


class OpenLoopGenerator:
    """Replay a trace against a router at wall-clock pace.

    ``speedup`` compresses the timeline (2.0 => replay twice as fast);
    submits are never delayed by completions — that is the point of
    open-loop load (queueing delay shows up in ``report.queue_s``).
    """

    def __init__(self, router: Router, trace: Trace,
                 make_batch: BatchFactory, *, speedup: float = 1.0,
                 clock=time.perf_counter, sleep=time.sleep):
        self.router = router
        self.trace = trace
        self.make_batch = make_batch
        self.speedup = speedup
        self.clock = clock
        self.sleep = sleep

    def run(self) -> list[tuple[TraceEvent, ColdStartReport | None]]:
        """Returns (event, report) per event; report None when throttled.

        A throttle is a measured outcome, never an abort — whether it
        happens at submit time or later (a cluster rerouting a failed
        node's queue may find every survivor full and fail the future
        with :class:`AdmissionError` at result time).
        """
        pending: list[tuple[TraceEvent, object]] = []
        rejected: list[TraceEvent] = []
        t0 = self.clock()
        for ev in self.trace.events:
            target = ev.t / self.speedup
            delay = target - (self.clock() - t0)
            if delay > 0:
                self.sleep(delay)
            try:
                pending.append(
                    (ev, self.router.submit(ev.function, self.make_batch(ev))))
            except AdmissionError:
                rejected.append(ev)
        out: list[tuple[TraceEvent, ColdStartReport | None]] = []
        for ev, inv in pending:
            try:
                out.append((ev, inv.result()[1]))
            except AdmissionError:
                rejected.append(ev)
        out.extend((ev, None) for ev in rejected)
        return out


class ClosedLoopGenerator:
    """N concurrent clients, each looping submit -> wait -> think."""

    def __init__(self, router: Router, trace: Trace, make_batch: BatchFactory,
                 *, n_clients: int = 4, think_time_s: float = 0.0,
                 sleep=time.sleep):
        self.router = router
        self.trace = trace
        self.make_batch = make_batch
        self.n_clients = n_clients
        self.think_time_s = think_time_s
        self.sleep = sleep

    def run(self) -> list[tuple[TraceEvent, ColdStartReport | None]]:
        """Returns (event, report) per event; report None when the submit
        was throttled (:class:`AdmissionError`) — parity with
        :class:`OpenLoopGenerator`.  Only *real* invocation failures abort
        the run; a throttle is a measured outcome, not an error.
        """
        events = list(self.trace.events)
        out: list[tuple[TraceEvent, ColdStartReport | None]] = []
        errors: list[BaseException] = []
        out_lock = threading.Lock()
        it_lock = threading.Lock()
        idx = [0]

        def client() -> None:
            while True:
                with it_lock:
                    if idx[0] >= len(events):
                        return
                    ev = events[idx[0]]
                    idx[0] += 1
                try:
                    _, rep = self.router.invoke(ev.function,
                                                self.make_batch(ev))
                except AdmissionError:
                    with out_lock:
                        out.append((ev, None))   # throttled, not failed
                    continue
                except BaseException as e:
                    with out_lock:
                        errors.append(e)
                    continue
                with out_lock:
                    out.append((ev, rep))
                if self.think_time_s:
                    self.sleep(self.think_time_s)

        threads = [threading.Thread(target=client, name=f"client-{i}",
                                    daemon=True)
                   for i in range(self.n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]  # partial results must not masquerade as a run
        return out
