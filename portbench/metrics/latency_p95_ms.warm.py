"""95th percentile, nearest rank, of every invocation sent in the window,
from its send to its result; a failed or missing one counts as beyond. In
the closed loop each caller waits for its answer, so this tail follows
the throughput and is read, not judged."""
from portbench.readers import latencies_s, percentile


def read(rec):
    return percentile(latencies_s(rec), 95) * 1e3 if rec["requests"] else None
