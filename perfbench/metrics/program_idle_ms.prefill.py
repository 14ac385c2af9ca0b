"""Milliseconds inside the program's ``prefill`` span in which no operation
ran on the card (the complement of the trace's busy intervals): the mean
over the profiled calls.  Read under the profiler, which stretches the
host and so the idle."""
from perfbench import spans


def read(run):
    return spans.program_idle_ms(run, "prefill")
