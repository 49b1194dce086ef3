"""A process-wide registry of counters, gauges and histograms.

The part of :mod:`tpudas.obs.registry` that the fault boundary, the
quarantine ledger, the fleet and the span ring call:
``get_registry().counter(name, help, labelnames).inc(**labels)``,
``get_registry().gauge(name, help).set(value)`` and
``get_registry().histogram(name, help, labelnames).observe(v,
**labels)``, with the JAX package's metric names and bucket bounds, so
a run of either package counts the same events under the same names.
``value(name, **labels)`` reads one counter or gauge series back,
``Histogram.snapshot(**labels)`` one histogram series, and
:func:`use_registry` swaps the process registry for a scope (how a
test reads one run's numbers).  The exposition format and the
``TPUDAS_OBS=0`` kill switch are not ported yet.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from contextlib import contextmanager

__all__ = [
    "DEFAULT_BUCKETS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "use_registry",
]

# latency-oriented default buckets (seconds): sub-millisecond host hops
# through multi-minute backlog rounds (the JAX package's bounds)
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


class _Metric:
    def __init__(self, name: str, help: str, labelnames=()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got "
                f"{tuple(sorted(labels))}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)


class Counter(_Metric):
    """A monotonic count (names end in ``_total``)."""

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("a counter only goes up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(amount)


class Gauge(_Metric):
    """An instantaneous value."""

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    def __init__(self, name: str, help: str, labelnames=(), buckets=None):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            state = self._values.get(key)
            if state is None:
                # per-bucket counts, cumulated at snapshot time
                state = self._values[key] = {
                    "counts": [0] * len(self.buckets), "sum": 0.0,
                    "count": 0,
                }
            i = bisect_left(self.buckets, v)
            if i < len(self.buckets):
                state["counts"][i] += 1
            state["sum"] += v
            state["count"] += 1

    def value(self, **labels) -> float:
        """The series' observation count."""
        return float(self.snapshot(**labels)["count"])

    def snapshot(self, **labels) -> dict:
        """``{"count": n, "sum": s, "buckets": {le: cumulative}}`` for
        one label set (zeros when never observed)."""
        key = self._key(labels)
        with self._lock:
            state = self._values.get(key)
            if state is None:
                return {"count": 0, "sum": 0.0,
                        "buckets": dict.fromkeys(self.buckets, 0)}
            cum, buckets = 0, {}
            for b, c in zip(self.buckets, state["counts"]):
                cum += c
                buckets[b] = cum
            return {"count": state["count"], "sum": state["sum"],
                    "buckets": buckets}


class MetricsRegistry:
    """Get-or-create metrics by name; a name keeps its kind and label
    names from its first use."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames, **kw)
        if not isinstance(m, cls):
            raise TypeError(f"{name} is a {type(m).__name__}, not a {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets=None) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """One series' value, or ``default`` for a metric never used."""
        with self._lock:
            m = self._metrics.get(name)
        return default if m is None else m.value(**labels)


_REGISTRY = MetricsRegistry()
_SWAP_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process registry (or the one a :func:`use_registry` scope
    installed).  Instrumented code resolves it at each use site."""
    return _REGISTRY


@contextmanager
def use_registry(registry: MetricsRegistry):
    """Swap the process registry for the scope (process-global, not
    thread-scoped: worker threads, such as a fleet group's members,
    count into the same registry)."""
    global _REGISTRY
    with _SWAP_LOCK:
        prev = _REGISTRY
        _REGISTRY = registry
    try:
        yield registry
    finally:
        with _SWAP_LOCK:
            _REGISTRY = prev
