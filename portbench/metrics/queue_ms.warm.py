"""Mean queueing delay in the router (``ColdStartReport.queue_s``)."""
from portbench.readers import mean, served


def read(rec):
    q = mean([r["queue_s"] for r in served(rec)])
    return None if q is None else q * 1e3
