"""Device kernels a train call launches: every kernel in the profiler's
trace of the profiled calls (cuBLAS, elementwise and the port's own),
over the number of calls."""


def read(run):
    return run.launches("train")
