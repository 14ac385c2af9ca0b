"""Host milliseconds a prefill call spends inside the program's ``ffn`` spans
(each layer's norm and SwiGLU), children included: the mean over the
profiled calls.  Read under the profiler, which stretches the host:
compare it with another traced run, not with the unprofiled
``dispatch_ms.prefill``."""
from perfbench import spans


def read(run):
    return spans.host_ms(run, "prefill", "ffn")
