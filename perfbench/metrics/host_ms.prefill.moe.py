"""Host milliseconds a prefill call spends inside the program's ``moe``
spans (each layer's norm, router, sort, gather, grouped expert products,
combine and shared expert), children included: the mean over the
profiled calls.  Read under the profiler, which stretches the host:
compare it with another traced run, not with the unprofiled
``dispatch_ms.prefill``."""
from perfbench import spans


def read(run):
    return spans.host_ms(run, "prefill", "moe")
