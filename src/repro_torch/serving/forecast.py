"""Periodicity-aware demand forecasting (the anticipatory half of SPES).

policy.py's :class:`FunctionDemand` is reactive-statistical: an EWMA and a
sliding window both *trail* the arrival process, so a diurnal ramp is only
provisioned for after its first arrivals land cold.  SPES (Lee et al.) and
"How Low Can You Go?" (Tan et al.) both observe that production serverless
traffic is strongly periodic per function — the remaining cold-start floor
is exactly this anticipation gap.  This module closes it:

  * :class:`PeriodicityDetector` — keeps a bounded per-function arrival
    history, bins it at ``bin_s`` resolution over the ``history_s`` window,
    and scans normalized autocorrelation over candidate lags (the diurnal
    window ``[min_period_s, max_period_s]``).  A confident peak becomes the
    function's period; the history is then *folded* modulo the period into
    a phase-binned rate profile (arrivals/s per phase bin, averaged over
    the cycles each phase bin was observed).  A ``period_hint_s`` (e.g.
    from the trace generator, or an operator who knows traffic is daily)
    skips the search: the profile is trusted as soon as one full cycle of
    history exists, instead of the >= ``min_cycles`` the blind search needs.
  * :class:`ForecastDemand` — drop-in :class:`FunctionDemand` subclass that
    blends the profile with the reactive model:
    ``rate(now) = max(reactive, confidence * profile peak over
    [now, now + lookahead_s])`` — so the warm target rises *before* the
    ramp's arrivals do, and never falls below what the reactive model would
    have provisioned (the forecast can only add instances, not starve).
    During a trough the profile goes to ~0 and the function scales down as
    usual, but the demand entry is *not* forgotten (``forgettable``) while
    history remains — forgetting it would discard the learned period right
    before the next ramp needs it.

Everything is a pure function of ingested timestamps; ``clock=`` injects a
fake clock (tests/fakeclock.py) so tests run in milliseconds.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from .policy import FunctionDemand, PolicyConfig


@dataclasses.dataclass
class ForecastConfig:
    bin_s: float = 0.25            # arrival-count bin width
    history_s: float = 120.0       # how much history the detector folds
    max_arrivals: int = 16384      # bound on stored timestamps
    min_period_s: float = 1.0      # candidate-period search window
    max_period_s: float = 60.0
    min_cycles: float = 2.0        # blind search needs >= this many folds
    min_confidence: float = 0.35   # autocorrelation acceptance threshold
    lookahead_s: float = 0.5       # provision for the profile this far ahead
    period_hint_s: float | None = None  # known period (trace metadata)


class PeriodicityDetector:
    """Detects a per-function arrival period and folds history into a
    phase-binned rate profile.

    ``detect`` returns ``(period_s, confidence)`` or ``None``;
    ``forecast_rate(now, window_s)`` returns the profile's peak rate over
    ``[now, now + window_s)`` (None when no confident period exists) —
    peak, not mean, because provisioning must cover the ramp's front edge.
    """

    def __init__(self, cfg: ForecastConfig | None = None, *,
                 clock=time.monotonic):
        self.cfg = cfg or ForecastConfig()
        self.clock = clock
        self.arrivals: deque[float] = deque(maxlen=self.cfg.max_arrivals)
        self._cache_key: tuple | None = None
        self._cache: tuple[float, float] | None = None
        # persisted prior (seed): a profile exported by a previous run.
        # It answers detect()/profile() until fresh history can — a
        # restarted fleet prewarms day-one ramps instead of re-learning.
        self._seed: dict | None = None

    def observe(self, timestamps: list[float]) -> None:
        self.arrivals.extend(timestamps)

    # -- persistence (cross-restart forecast profiles) -----------------

    def to_state(self, now: float | None = None) -> dict | None:
        """Serializable profile state, or None when nothing confident is
        known.  Phase is anchored at t=0 of the detector's clock domain
        (exactly the convention ``profile``/``forecast_rate`` fold with),
        so reloading is valid whenever the restarted process shares the
        clock epoch — ``time.monotonic`` on the same boot, or a fake clock
        continuing the same timeline in tests.  Falls back to carrying an
        unreplaced seed forward, so back-to-back restarts don't lose it."""
        now = self.clock() if now is None else now
        det = self.detect(now)
        if det is not None:
            period_s, conf = det
            prof = self.profile(now, period_s)
            if prof is not None and len(prof) and float(prof.max()) > 0:
                return {"period_s": float(period_s),
                        "confidence": float(conf),
                        "bin_s": float(self.cfg.bin_s),
                        "rates": [float(r) for r in prof]}
        return dict(self._seed) if self._seed is not None else None

    def seed(self, state: dict | None) -> bool:
        """Install a persisted profile as the prior; returns False (and
        ignores it) when the state is empty or was folded at a different
        bin width than this detector's (phase indices wouldn't line up)."""
        if (not state or not state.get("rates")
                or "period_s" not in state
                or abs(float(state.get("bin_s", self.cfg.bin_s))
                       - self.cfg.bin_s) > 1e-9):
            return False
        self._seed = dict(state)
        return True

    @property
    def seeded(self) -> bool:
        return self._seed is not None

    def _seed_detect(self) -> tuple[float, float] | None:
        s = self._seed
        if s is None:
            return None
        return float(s["period_s"]), float(s["confidence"])

    def span(self) -> float:
        """Seconds of history currently held."""
        if len(self.arrivals) < 2:
            return 0.0
        return max(self.arrivals) - min(self.arrivals)

    # -- period detection ----------------------------------------------

    def _counts(self, now: float) -> tuple[np.ndarray, float]:
        """Arrival counts binned at ``bin_s`` over the history window;
        returns (counts, t0) with ``t0`` the absolute time of bin 0."""
        c = self.cfg
        t0 = now - c.history_s
        ts = np.asarray([t for t in self.arrivals if t0 <= t <= now])
        n_bins = max(int(np.ceil(c.history_s / c.bin_s)), 1)
        counts = np.zeros(n_bins)
        if ts.size:
            idx = np.clip(((ts - t0) / c.bin_s).astype(int), 0, n_bins - 1)
            np.add.at(counts, idx, 1.0)
        return counts, t0

    def _autocorr(self, x: np.ndarray, lag: int) -> float:
        """Normalized autocorrelation of ``x`` at ``lag`` (mean-removed)."""
        if lag <= 0 or lag >= len(x):
            return 0.0
        d = x - x.mean()
        var = float(np.dot(d, d))
        if var <= 0:
            return 0.0
        return float(np.dot(d[:-lag], d[lag:])) / var

    def detect(self, now: float | None = None) -> tuple[float, float] | None:
        """(period_s, confidence in [0, 1]) or None.

        With a ``period_hint_s`` the hint is trusted (confidence 1.0) once
        one full cycle of history exists — the search and its >=
        ``min_cycles`` requirement are skipped.  Without a hint, candidate
        lags are scanned and the *smallest* lag within 10% of the best
        correlation wins (a signal with period P also correlates at 2P;
        preferring the fundamental keeps the fold dense).
        """
        now = self.clock() if now is None else now
        c = self.cfg
        if c.period_hint_s is not None:
            if (len(self.arrivals) >= 4
                    and self.span() >= c.period_hint_s):
                return c.period_hint_s, 1.0
            return self._seed_detect()
        key = (len(self.arrivals), int(now / c.bin_s))
        if key != self._cache_key:
            self._cache_key = key
            self._cache = self._detect(now)
        if self._cache is not None:
            return self._cache
        # fresh history can't answer yet: fall back to the persisted prior
        return self._seed_detect()

    def _detect(self, now: float) -> tuple[float, float] | None:
        c = self.cfg
        if len(self.arrivals) < 8:
            return None
        counts, _ = self._counts(now)
        # only bins the history actually covers participate
        covered = min(int(np.ceil(self.span() / c.bin_s)) + 1, len(counts))
        x = counts[-covered:]
        lo = max(int(round(c.min_period_s / c.bin_s)), 1)
        hi = min(int(round(c.max_period_s / c.bin_s)),
                 int(len(x) / c.min_cycles))
        if hi < lo:
            return None
        corr = np.asarray([self._autocorr(x, lag)
                           for lag in range(lo, hi + 1)])
        best = float(corr.max(initial=0.0))
        if best < c.min_confidence:
            return None
        # smallest lag within 10% of the best: prefer the fundamental
        for i, r in enumerate(corr):
            if r >= 0.9 * best:
                return (lo + i) * c.bin_s, float(r)
        return None                  # unreachable; keeps type-checkers calm

    # -- phase-binned rate profile -------------------------------------

    def profile(self, now: float | None = None,
                period_s: float | None = None) -> np.ndarray | None:
        """Arrivals/s per phase bin, folded modulo the period.

        Each phase bin's count is divided by the number of times that
        phase was actually observed in the history window, so a partially
        covered final cycle does not dilute the profile.
        """
        now = self.clock() if now is None else now
        if period_s is None:
            det = self.detect(now)
            if det is None:
                return None
            period_s, _ = det
        c = self.cfg
        s = self._seed
        if (s is not None and self.span() < period_s
                and abs(float(s["period_s"]) - period_s) <= c.bin_s):
            # under one full cycle of fresh history: the persisted fold is
            # still the better estimate of the phase profile
            return np.asarray(s["rates"], dtype=float)
        n_phase = max(int(round(period_s / c.bin_s)), 1)
        counts, t0 = self._counts(now)
        n_bins = len(counts)
        phases = (np.arange(n_bins) + int(round(t0 / c.bin_s))) % n_phase
        folded = np.zeros(n_phase)
        occurrences = np.zeros(n_phase)
        # restrict the fold to covered history so empty pre-history bins
        # don't register as observed-zero phases
        covered = min(int(np.ceil(self.span() / c.bin_s)) + 1, n_bins)
        np.add.at(folded, phases[-covered:], counts[-covered:])
        np.add.at(occurrences, phases[-covered:], 1.0)
        with np.errstate(invalid="ignore"):
            rates = np.where(occurrences > 0,
                             folded / np.maximum(occurrences, 1) / c.bin_s,
                             0.0)
        return rates

    def forecast_rate(self, at: float, window_s: float = 0.0, *,
                      now: float | None = None) -> float | None:
        """Profile's peak rate over ``[at, at + window_s)``; None when no
        confident period exists."""
        now = self.clock() if now is None else now
        det = self.detect(now)
        if det is None:
            return None
        period_s, conf = det
        prof = self.profile(now, period_s)
        if prof is None or not len(prof):
            return None
        c = self.cfg
        first = int((at % period_s) / c.bin_s)
        n = max(int(np.ceil(window_s / c.bin_s)), 1)
        idx = (first + np.arange(n)) % len(prof)
        return float(prof[idx].max()) * conf


class ForecastDemand(FunctionDemand):
    """FunctionDemand + a periodicity forecast: provisions for the profile
    ``lookahead_s`` ahead, never below what the reactive model asks for."""

    def __init__(self, cfg: PolicyConfig, fcfg: ForecastConfig | None = None,
                 *, clock=time.monotonic):
        super().__init__(cfg, clock=clock)
        self.fcfg = fcfg or ForecastConfig()
        self.detector = PeriodicityDetector(self.fcfg, clock=clock)

    def observe(self, timestamps: list[float]) -> None:
        super().observe(timestamps)
        self.detector.observe(timestamps)

    def _upcoming(self, now: float) -> float | None:
        """Forecast peak rate over the lookahead horizon (None: no period)."""
        return self.detector.forecast_rate(
            now, self.fcfg.lookahead_s + self.fcfg.bin_s, now=now)

    def rate(self, now: float | None = None) -> float:
        now = self.clock() if now is None else now
        reactive = super().rate(now)
        f = self._upcoming(now)
        return reactive if f is None else max(reactive, f)

    def active(self, now: float | None = None) -> bool:
        """Live while the reactive model says so, *or* while the profile
        predicts arrivals inside the lookahead — the prewarm-ahead path."""
        now = self.clock() if now is None else now
        if super().active(now):
            return True
        f = self._upcoming(now)
        # "predicts arrivals": at least ~one arrival expected in the horizon
        horizon = self.fcfg.lookahead_s + self.fcfg.bin_s
        return f is not None and f * horizon >= 0.5

    # -- persistence ----------------------------------------------------

    def export_state(self, now: float | None = None) -> dict | None:
        """Serializable periodicity profile (detector state), or None."""
        return self.detector.to_state(now)

    def seed_state(self, state: dict | None) -> bool:
        """Install a persisted profile as this demand's prior."""
        return self.detector.seed(state)

    def forgettable(self, now: float | None = None) -> bool:
        """Keep the learned period through troughs: only forget once the
        entire history window has gone quiet.  A seeded entry that has not
        yet seen traffic is kept — forgetting it would discard the
        persisted profile before the ramp it predicts arrives."""
        now = self.clock() if now is None else now
        if self.last_arrival is None:
            return not self.detector.seeded
        return now - self.last_arrival > self.fcfg.history_s
