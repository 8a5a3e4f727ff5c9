"""Prompt tokens of every invocation sent in the window, over the time from
the window's start to the last answer. The callers send nothing once the
window's time is up and wait for what they sent, so all the work counts,
over all of its time: none is cut at the close, and a stall up to the
last answer still counts as time."""


def read(rec):
    served = [r for r in rec["requests"] if r["done"] is not None]
    if not served:
        return None
    end = max(rec["window_start"] + rec["seconds"], max(r["done"] for r in served))
    return sum(r["tokens"] for r in served) / (end - rec["window_start"])
