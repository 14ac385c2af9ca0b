"""Host milliseconds a train step spends inside the program's ``forward`` span
(the loss: embedding, every layer's ``attention`` and ``ffn``, the head and
the cross entropy), children included: the mean over the profiled calls.
Read under the profiler, which stretches the host: compare it with
another traced run, not with the unprofiled ``dispatch_ms.train``."""
from perfbench import spans


def read(run):
    return spans.host_ms(run, "train", "forward")
