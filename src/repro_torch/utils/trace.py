"""Spans of the port's layers, written into ``torch.profiler``'s own trace.

``with span("attention"): ...`` marks where a layer of the program begins
and ends.  While no profiler records, ``span`` checks one flag and returns
one shared no-op context: no allocation, no clock read, no
``record_function``.  While a profiler records, the span leaves two marks
in its trace, on the trace's own clock:

    repro>NAME   on entry
    repro<NAME   on exit

each a ``record_function`` range of zero width, with nothing run inside
it.  A range that launched kernels would also enter the trace as a
device-side event of its name (a user annotation of device type CUDA),
which a reader of the device's kernels and idle time would count; a
mark launches nothing, so it is a host event alone.

Spans nest by time: each runs on the caller's thread and calls run one at
a time, so the span around a mark is its parent, and the outermost span
(``prefill``, ``train_step``) its call.  ``perfbench/spans.py`` reads
them back.
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

ENTER, EXIT = "repro>", "repro<"

_OFF = contextlib.nullcontext()


class _Marks:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        with _profiler.record_function(ENTER + self.name):
            pass

    def __exit__(self, *exc):
        with _profiler.record_function(EXIT + self.name):
            pass
        return False


def span(name: str):
    """The span ``name``: its two marks while a profiler records, else a
    shared context that does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Marks(name)
