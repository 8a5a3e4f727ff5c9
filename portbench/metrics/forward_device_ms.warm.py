"""Device ms of a warm invocation's own forward: the device seconds in the
traced window whose launch fell in a warm invocation's ``forward`` span
(``spans.reduce``), over the summed share of those invocations'
processing inside the window (``readers.window_share``)."""
from portbench.spans import per_invocation_ms


def read(rec):
    return per_invocation_ms(rec, "forward_device_s")
