"""Mean ``sync`` span of the window's warm invocations (the set
``forward_ms.warm`` reads): the wait in the device-wide synchronize after
the forward has enqueued its kernels, its own and the other instances'."""
from portbench.spans import mean_span_ms


def read(rec):
    return mean_span_ms(rec, "sync")
