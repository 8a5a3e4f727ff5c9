"""B3 (``csrc/flash_attention.cu``, forward kernels ``flash_fwd_*``): the
least time its calls in the traced window need by their shapes
(``counts.attention_bound_s``, each invocation's by the share of its
processing inside the window) over the device time its kernels took
there."""
from portbench import counts
from portbench.readers import kernel_s, served, window_share


def read(rec):
    if rec["trace"] is None:
        return None
    t = kernel_s(rec, ("flash_fwd",))
    bound = sum(counts.attention_bound_s(rec["config"], r["batch"], r["length"])
                * window_share(rec, r) for r in served(rec))
    return 100.0 * bound / t if t > 0 and bound > 0 else None
