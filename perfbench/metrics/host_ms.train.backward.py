"""Host milliseconds a train step spends inside the program's ``backward`` span
(``torch.autograd.grad`` and the zero gradients of unreached leaves): the
mean over the profiled calls.  Read under the profiler, which stretches
the host: compare it with another traced run, not with the unprofiled
``dispatch_ms.train``."""
from perfbench import spans


def read(run):
    return spans.host_ms(run, "train", "backward")
