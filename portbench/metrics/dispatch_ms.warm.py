"""Mean ``dispatch`` span of the window's warm invocations (the set
``forward_ms.warm`` reads): from the forward's start until the family's
forward returns, every kernel enqueued. Read from the program's span
traces of a traced run (``spans.window_invocations``)."""
from portbench.spans import mean_span_ms


def read(rec):
    return mean_span_ms(rec, "dispatch")
