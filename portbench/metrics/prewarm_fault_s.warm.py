"""Seconds set-up's prewarm spent faulting the instances' parameters in
(the ``fault`` spans, ``FunctionInstance.make_warm``'s ``touch_pages``,
under the ``prewarm`` traces)."""
from portbench.spans import span_s


def read(rec):
    if rec.get("spans") is None:
        return None
    pre = [t for t in rec["spans"] if t["kind"] == "prewarm"]
    return sum(span_s(t, "fault") for t in pre) if pre else None
