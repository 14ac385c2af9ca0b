"""Host-blocking CUDA runtime calls (``spans.SYNCS``: stream, device and event
synchronizes, copies without ``Async``) that start inside the program's
``train_step`` span: the mean over the profiled calls."""
from perfbench import spans


def read(run):
    return spans.syncs(run, "train")
