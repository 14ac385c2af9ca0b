"""Prometheus-style telemetry primitives — ``repro_torch.gateway.telemetry``
(the reference's ``repro.gateway.telemetry``, copied: stdlib only, and
its text byte for byte the reference's for the same operations).

A dependency-free miniature of the Prometheus client: :class:`Counter`,
:class:`Gauge`, and :class:`Histogram` registered in a
:class:`MetricsRegistry` that renders the text exposition format
(``# HELP`` / ``# TYPE`` headers, ``name{label="v"} value`` samples) for
the gateway's ``GET /metrics`` endpoint.

Design points:

* every mutation is guarded by one registry-wide lock, so concurrent
  request-handler threads never tear a histogram (bucket counts, sum and
  count always move together);
* labeled children are created on first touch — scrapes only show series
  that actually happened (Prometheus convention);
* :meth:`MetricsRegistry.snapshot` returns the same data as a JSON-safe
  dict, so ``/v1/stats`` and ``/metrics`` render from one source of truth.

Label values are escaped per the exposition spec (backslash, quote,
newline).  Histogram buckets follow the cumulative ``le`` convention with
a terminal ``+Inf`` bucket.
"""
from __future__ import annotations

import math
import threading


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integers render bare, floats repr-style."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()
                              and abs(v) < 1e15):
        return str(int(v))
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _render_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


class _Metric:
    """Base: a named family of labeled children."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str, labelnames: tuple = ()):
        self.name = name
        self.help_text = help_text
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()   # replaced by the registry's lock

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def _label_dict(self, key: tuple) -> dict:
        return dict(zip(self.labelnames, key))


class Counter(_Metric):
    """Monotonically increasing count (``_total`` naming convention)."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0)

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(self._children.items())
        return [f"{self.name}{_render_labels(self._label_dict(k))} "
                f"{_fmt_value(v)}" for k, v in items]

    def snapshot(self) -> dict:
        with self._lock:
            return {",".join(k) if k else "": v
                    for k, v in sorted(self._children.items())}


class Gauge(_Metric):
    """A value that can go anywhere (queue depth, alert flag, ...)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = value

    def inc(self, amount: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0)

    render = Counter.render
    snapshot = Counter.snapshot


class Histogram(_Metric):
    """Cumulative-bucket latency histogram (Prometheus ``le`` convention).

    ``observe(v)`` increments every bucket whose upper bound is >= v, the
    ``+Inf`` bucket, ``_sum`` and ``_count`` — atomically under the lock.
    """

    kind = "histogram"

    def __init__(self, name: str, help_text: str, buckets: tuple,
                 labelnames: tuple = ()):
        super().__init__(name, help_text, labelnames)
        bs = tuple(float(b) for b in buckets)
        if list(bs) != sorted(set(bs)):
            raise ValueError(f"{name}: buckets must be strictly increasing")
        self.buckets = bs

    def _child(self, key: tuple) -> dict:
        c = self._children.get(key)
        if c is None:
            c = self._children[key] = {
                "buckets": [0] * (len(self.buckets) + 1),  # +1 = +Inf
                "sum": 0.0, "count": 0,
            }
        return c

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            c = self._child(key)
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    c["buckets"][i] += 1
            c["buckets"][-1] += 1
            c["sum"] += value
            c["count"] += 1

    def count(self, **labels) -> int:
        with self._lock:
            c = self._children.get(self._key(labels))
            return 0 if c is None else c["count"]

    def render(self) -> list[str]:
        lines: list[str] = []
        with self._lock:
            items = sorted((k, {"buckets": list(c["buckets"]),
                                "sum": c["sum"], "count": c["count"]})
                           for k, c in self._children.items())
        for key, c in items:
            base = self._label_dict(key)
            cum = 0
            for i, ub in enumerate(self.buckets):
                cum = c["buckets"][i]
                lines.append(
                    f"{self.name}_bucket"
                    f"{_render_labels({**base, 'le': _fmt_value(ub)})} {cum}")
            lines.append(
                f"{self.name}_bucket{_render_labels({**base, 'le': '+Inf'})} "
                f"{c['buckets'][-1]}")
            lines.append(f"{self.name}_sum{_render_labels(base)} "
                         f"{_fmt_value(c['sum'])}")
            lines.append(f"{self.name}_count{_render_labels(base)} "
                         f"{c['count']}")
        return lines

    def snapshot(self) -> dict:
        with self._lock:
            return {
                ",".join(k) if k else "": {
                    "count": c["count"], "sum": c["sum"],
                    "buckets": dict(zip(
                        [_fmt_value(b) for b in self.buckets] + ["+Inf"],
                        c["buckets"])),
                }
                for k, c in sorted(self._children.items())
            }


class MetricsRegistry:
    """All of a gateway's metric families, in registration order.

    One lock is shared by every registered metric: a scrape racing a
    request thread sees each family internally consistent (a histogram's
    ``_count`` never runs ahead of its ``+Inf`` bucket).
    """

    def __init__(self):
        self._metrics: list[_Metric] = []
        self._by_name: dict[str, _Metric] = {}
        self._lock = threading.RLock()

    def register(self, metric: _Metric):
        if metric.name in self._by_name:
            raise ValueError(f"metric {metric.name!r} already registered")
        metric._lock = self._lock   # one shared lock, scrape-consistent
        self._metrics.append(metric)
        self._by_name[metric.name] = metric
        return metric

    def counter(self, name: str, help_text: str, labelnames: tuple = ()) -> Counter:
        return self.register(Counter(name, help_text, labelnames))

    def gauge(self, name: str, help_text: str, labelnames: tuple = ()) -> Gauge:
        return self.register(Gauge(name, help_text, labelnames))

    def histogram(self, name: str, help_text: str, buckets: tuple,
                  labelnames: tuple = ()) -> Histogram:
        return self.register(Histogram(name, help_text, buckets, labelnames))

    def __getitem__(self, name: str) -> _Metric:
        return self._by_name[name]

    def render(self) -> str:
        """The Prometheus text exposition body (trailing newline included)."""
        lines: list[str] = []
        for m in self._metrics:
            samples = m.render()
            if not samples:
                continue
            lines.append(f"# HELP {m.name} {m.help_text}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(samples)
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-safe mirror of every family (``/v1/stats`` gateway block)."""
        return {m.name: m.snapshot() for m in self._metrics}


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
