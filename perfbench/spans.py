"""The program's spans, read back from a profiled run's trace
(``harness.Trace``), and the per-layer metrics read from them.

The port (``src/repro_torch/utils/trace.py``) marks the start of a span
NAME with a zero-width host event ``repro>NAME`` and its end with
``repro<NAME``, on the profiler's own clock.  Spans nest by time: the
marks, in time order, pair as brackets, and the outermost spans
(``prefill``, ``train_step``) are one call each.  A trace without a mark,
as of a program that writes none, reads ``None``; one whose marks do not
pair, or whose calls are not the run's profiled steps, raises.

Every host time here is read under the profiler, which stretches the
host: it compares one traced run with another, never with the unprofiled
``dispatch_ms.*``.  Each metric is a mean per call over the profiled
calls."""
from __future__ import annotations

import bisect
import itertools
from dataclasses import dataclass, field

#: the marks' format, restated rather than imported: a program that writes
#: no spans has no such module, and its traces read ``None``
ENTER, EXIT = "repro>", "repro<"
#: the spans that are one call each
ENTRIES = ("prefill", "train_step")
#: runtime calls after which the host has waited for the card to drain
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy", "cudaMemcpy2D")


@dataclass
class Span:
    name: str
    start: float                 # microseconds, the profiler's clock
    end: float
    parent: Span | None = None
    children: list = field(default_factory=list)

    @property
    def us(self) -> float:
        return self.end - self.start


def parse(trace) -> list | None:
    """The trace's spans, each before its children, or ``None`` where the
    trace holds no mark.  At one instant, spans end before others begin."""
    marks = sorted(((s, n.startswith(ENTER), n) for n, s, _ in trace.host
                    if n.startswith((ENTER, EXIT))), key=lambda m: m[:2])
    if not marks:
        return None
    out, stack = [], []
    for t, group in itertools.groupby(marks, key=lambda m: m[0]):
        group = list(group)
        ends = [n[len(EXIT):] for _, enter, n in group if not enter]
        while ends:
            if not stack or stack[-1].name not in ends:
                raise ValueError(f"marks cross or are unmatched at {t}: the end of "
                                 f"{ends} inside {[s.name for s in stack]}")
            ends.remove(stack[-1].name)
            stack.pop().end = t
        for _, _, n in (m for m in group if m[1]):
            sp = Span(n[len(ENTER):], t, t, stack[-1] if stack else None)
            if stack:
                stack[-1].children.append(sp)
            stack.append(sp)
            out.append(sp)
    if stack:
        raise ValueError(f"spans {[s.name for s in stack]} never end")
    calls = sum(s.name in ENTRIES for s in out)
    if calls != trace.steps:
        raise ValueError(f"{calls} calls ({'/'.join(ENTRIES)} spans) in a trace of "
                         f"{trace.steps} steps")
    return out


def _spans(run, phase: str):
    if run.phase != phase or run.profile is None:
        return None
    return parse(run.profile)


def _idle(busy, starts, lo: float, hi: float) -> float:
    """Length of [lo, hi] that ``busy`` (sorted, disjoint intervals, starting
    at ``starts``) leaves uncovered."""
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    out = 0.0
    for s, e in busy[i:]:
        if s >= hi:
            break
        out += max(0.0, min(e, hi) - max(s, lo))
    return hi - lo - out


def host_ms(run, phase: str, name: str):
    """Host ms a call spends inside the spans ``name``, children included."""
    spans = _spans(run, phase)
    if spans is None or not any(s.name == name for s in spans):
        return None
    return sum(s.us for s in spans if s.name == name) * 1e-3 / run.profile.steps


def syncs(run, phase: str):
    """Host-blocking runtime calls (``SYNCS``) that start inside a call."""
    spans = _spans(run, phase)
    if spans is None:
        return None
    calls = [(s.start, s.end) for s in spans if s.name in ENTRIES]
    n = sum(any(lo <= t < hi for lo, hi in calls)
            for name, t, _ in run.profile.host if name in SYNCS)
    return n / run.profile.steps


def program_idle_ms(run, phase: str):
    """Device idle (no device operation running) inside the calls, in ms."""
    spans = _spans(run, phase)
    if spans is None:
        return None
    busy = run.profile.busy_intervals()
    starts = [b[0] for b in busy]
    idle = sum(_idle(busy, starts, s.start, s.end) for s in spans if s.name in ENTRIES)
    return idle * 1e-3 / run.profile.steps

