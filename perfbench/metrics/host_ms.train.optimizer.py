"""Host milliseconds a train step spends inside the program's ``optimizer``
span (AdamW: the clip, the moments and the update): the mean over the
profiled calls.  Read under the profiler, which stretches the host:
compare it with another traced run, not with the unprofiled
``dispatch_ms.train``."""
from perfbench import spans


def read(run):
    return spans.host_ms(run, "train", "optimizer")
