"""Host-blocking CUDA runtime calls (``spans.SYNCS``: stream, device and event
synchronizes, copies without ``Async``) that start inside the program's
``prefill`` span: the mean over the profiled calls."""
from perfbench import spans


def read(run):
    return spans.syncs(run, "prefill")
