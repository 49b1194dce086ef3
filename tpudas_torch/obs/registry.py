"""A process-wide registry of counters and gauges.

The part of :mod:`tpudas.obs.registry` that the fault boundary and the
quarantine ledger call: ``get_registry().counter(name, help,
labelnames).inc(**labels)`` and ``get_registry().gauge(name,
help).set(value)``, with the JAX package's metric names, so a run of
either package counts the same events under the same names.
``value(name, **labels)`` reads one series back.  Histograms, the
exposition format, ``use_registry`` scopes and the ``TPUDAS_OBS=0``
kill switch are not ported yet.
"""

from __future__ import annotations

import threading

__all__ = ["Counter", "Gauge", "MetricsRegistry", "get_registry"]


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


class MetricsRegistry:
    """Get-or-create metrics by name; a name keeps its kind and label
    names from its first use."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, labelnames):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames)
        if not isinstance(m, cls):
            raise TypeError(f"{name} is a {type(m).__name__}, not a {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """One series' value, or ``default`` for a metric never used."""
        with self._lock:
            m = self._metrics.get(name)
        return default if m is None else m.value(**labels)


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process registry."""
    return _REGISTRY
