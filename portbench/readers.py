"""Arithmetic the metric readers share (``metrics/<metric>.py``).

A reader takes the run's record -- ``requests`` (one dict an invocation:
submit and done on the host clock, the batch's size, the report's queue
and processing seconds), ``window_start``, ``seconds``, ``result_wait_s``,
``setup_s``, ``trace`` (the reduced device trace of a ``--trace 1`` run,
else None), ``config`` and ``mix`` -- and returns a number, or None where
it finds nothing to read. ``percentile`` is
``repro_torch.serving.router.percentile``'s nearest rank.
"""
from __future__ import annotations

from .trace import union


def percentile(xs: list, q: float) -> float:
    """Nearest-rank percentile of ``xs`` (q in [0, 100])."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[k]


def latencies_s(rec: dict) -> list:
    """Send to result of every invocation sent in the window; one that
    failed or never came counts as the longest wait the run allows."""
    end = rec["window_start"] + rec["seconds"] + rec["result_wait_s"]
    return [(r["done"] if r["done"] is not None else end) - r["submit"]
            for r in rec["requests"]]


def served(rec: dict) -> list:
    """The invocations that completed, with their reports."""
    return [r for r in rec["requests"] if r["done"] is not None and "processing_s" in r]


def mean(xs: list):
    return sum(xs) / len(xs) if xs else None


def _clip(rec: dict, r: dict) -> tuple:
    """The part of ``r``'s processing inside the window (host clock)."""
    t0, t1 = rec["window_start"], rec["window_start"] + rec["seconds"]
    return max(r["done"] - r["processing_s"], t0), min(r["done"], t1)


def window_share(rec: dict, r: dict) -> float:
    """The share of invocation ``r``'s processing that fell inside the
    window: the share of its work that the window's readings hold."""
    s, e = _clip(rec, r)
    return max(e - s, 0.0) / r["processing_s"] if r["processing_s"] > 0 else 0.0


def processing_union_s(rec: dict) -> float:
    """Seconds of the window in which at least one invocation was
    processing."""
    return sum(e - s for s, e in union(iv for iv in (_clip(rec, r) for r in served(rec))
                                       if iv[1] > iv[0]))


def kernel_s(rec: dict, fragments: tuple) -> float:
    """Device seconds in the traced window of the kernels whose names
    contain a fragment."""
    return sum(s for name, s in rec["trace"]["by_name"].items()
               if any(f in name for f in fragments))
