"""Host milliseconds a prefill call spends inside the program's ``mamba``
spans (each Mamba2 mixer: its norm, projections, conv, ``ssd_scan``, final
state and gated norm), children included: the mean over the profiled
calls.  Read under the profiler, which stretches the host: compare it
with another traced run, not with the unprofiled ``dispatch_ms.prefill``."""
from perfbench import spans


def read(run):
    return spans.host_ms(run, "prefill", "mamba")
