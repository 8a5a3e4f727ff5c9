"""Model FLOPs of the window's invocations (``counts.forward_flops``, each
by the share of its processing inside the window) over the seconds of the
window in which some invocation was processing, as a share of the H100's
dense bfloat16 peak."""
from portbench import counts
from portbench.readers import processing_union_s, served, window_share


def read(rec):
    busy = processing_union_s(rec)
    if busy <= 0:
        return None
    flops = sum(counts.forward_flops(rec["config"], r["batch"], r["length"])
                * window_share(rec, r) for r in served(rec))
    return 100.0 * flops / (busy * counts.PEAK_OPS_PER_S["bfloat16"])
