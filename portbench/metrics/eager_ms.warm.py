"""Device ms a warm invocation spends in the eager float32 chains: as
``forward_device_ms.warm``, for the kernels launched inside the ``norm``,
``rope`` and ``act`` spans only (``spans.EAGER_OPS``)."""
from portbench.spans import per_invocation_ms


def read(rec):
    return per_invocation_ms(rec, "eager_device_s")
