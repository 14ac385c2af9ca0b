"""Host milliseconds a prefill call spends inside the program's ``cache`` span
(the zeroed caches made and the prompt's keys and values copied in): the
mean over the profiled calls.  Read under the profiler, which stretches
the host: compare it with another traced run, not with the unprofiled
``dispatch_ms.prefill``."""
from perfbench import spans


def read(run):
    return spans.host_ms(run, "prefill", "cache")
