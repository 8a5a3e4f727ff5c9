"""Mean processing time of the warm invocations (the forward on a warm
instance, synchronised; ``ColdStartReport.processing_s``)."""
from portbench.readers import mean, served


def read(rec):
    p = mean([r["processing_s"] for r in served(rec) if not r["cold"]])
    return None if p is None else p * 1e3
