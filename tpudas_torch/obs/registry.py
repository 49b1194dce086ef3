"""Process-wide metrics registry: counters, gauges, histograms.

The port's counterpart of :mod:`tpudas.obs.registry`, line for line: a
zero-dependency, thread-safe registry.  Instrumented code calls
``get_registry().counter(name, help).inc()`` at the use site; the
registry get-or-creates the metric, so hot paths pay one dict lookup
under a lock per update.  The metric names, help strings, bucket bounds
and the Prometheus text exposition (:meth:`MetricsRegistry.to_prometheus`)
are the JAX package's, so the same sequence of metric operations gives
the same ``metrics.prom`` bytes in either package.

Conventions: every metric name matches ``tpudas_[a-z0-9_]+``; counters
end in ``_total`` (monotonic), gauges are instantaneous, histograms are
latency-like (seconds); label KEYS are fixed per metric at creation,
label VALUES are free.

``TPUDAS_OBS=0`` swaps in a no-op registry (and turns spans off).
``use_registry`` swaps the process registry for a scope, so a caller
reads one run's numbers from a fresh registry; an active scope
overrides the kill switch (an explicit registry is a request for
measurements).  One addition to the JAX registry: a histogram's
``value()`` is its series' observation count, and
:meth:`MetricsRegistry.value` reads it so.
"""

from __future__ import annotations

import math
import os
import re
import threading
from bisect import bisect_left as _bisect_left
from contextlib import contextmanager

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "use_registry",
    "headline",
    "DEFAULT_BUCKETS",
    "METRIC_NAME_RE",
]

METRIC_NAME_RE = re.compile(r"^tpudas_[a-z0-9_]+$")

# latency-oriented default buckets (seconds): spans sub-millisecond
# host hops through multi-minute backlog rounds
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


def _label_key(labelnames, labels: dict) -> tuple:
    # hot path: one tuple build, no set allocations
    if not labels and not labelnames:
        return ()
    if len(labels) != len(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared "
            f"labelnames {sorted(labelnames)}"
        )
    try:
        return tuple(str(labels[k]) for k in labelnames)
    except KeyError:
        raise ValueError(
            f"labels {sorted(labels)} do not match declared "
            f"labelnames {sorted(labelnames)}"
        ) from None


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple,
                 lock: threading.RLock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._values: dict = {}

    def _series(self):
        """[(labels_dict, value), ...] snapshot."""
        with self._lock:
            return [
                (dict(zip(self.labelnames, key)), value)
                for key, value in sorted(self._values.items())
            ]


class Counter(_Metric):
    """Monotonic float counter."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(amount)

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return float(self._values.get(key, 0.0))


class Gauge(_Metric):
    """Instantaneous value; set/inc/dec."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return float(self._values.get(key, 0.0))


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock, buckets=None):
        super().__init__(name, help, labelnames, lock)
        bs = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        v = float(value)
        with self._lock:
            state = self._values.get(key)
            if state is None:
                # per-bucket (non-cumulative) counts; cumulated at
                # snapshot time so observe is O(log buckets)
                state = {"counts": [0] * len(self.buckets), "sum": 0.0,
                         "count": 0}
                self._values[key] = state
            i = _bisect_left(self.buckets, v)
            if i < len(self.buckets):
                state["counts"][i] += 1
            state["sum"] += v
            state["count"] += 1

    def value(self, **labels) -> float:
        """The series' observation count."""
        return float(self.snapshot(**labels)["count"])

    def snapshot(self, **labels) -> dict:
        """{"count": n, "sum": s, "buckets": {le: cumulative}} for one
        label set (zeros when never observed)."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            state = self._values.get(key)
            if state is None:
                return {"count": 0, "sum": 0.0,
                        "buckets": {b: 0 for b in self.buckets}}
            cum, buckets = 0, {}
            for b, c in zip(self.buckets, state["counts"]):
                cum += c
                buckets[b] = cum
            return {
                "count": state["count"],
                "sum": state["sum"],
                "buckets": buckets,
            }


class MetricsRegistry:
    """Thread-safe named-metric store with Prometheus exposition."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                # name validation only on the creation path — the
                # get-or-create call sits on per-block hot paths
                if not METRIC_NAME_RE.match(name):
                    raise ValueError(
                        f"metric name {name!r} must match "
                        f"{METRIC_NAME_RE.pattern} "
                        "(OBSERVABILITY.md conventions)"
                    )
                m = cls(name, help, tuple(labelnames), self._lock, **kw)
                self._metrics[name] = m
                return m
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            if m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} labelnames {m.labelnames} != "
                    f"{tuple(labelnames)}"
                )
            return m

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets=None) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    # reading ----------------------------------------------------------
    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Scalar read of a counter/gauge series, or a histogram
        series' observation count (``default`` when the metric does not
        exist or the labels do not fit it)."""
        m = self.get(name)
        if m is None:
            return default
        try:
            return m.value(**labels)
        except ValueError:
            return default

    def snapshot(self) -> dict:
        """Plain-dict dump: {name: {"kind", "help", "series":
        [(labels, value-or-hist)]}}."""
        with self._lock:
            metrics = list(self._metrics.values())
        out = {}
        for m in metrics:
            if isinstance(m, Histogram):
                series = [
                    (labels, m.snapshot(**labels))
                    for labels, _ in m._series()
                ]
            else:
                series = m._series()
            out[m.name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4) of every metric.
        Deterministic ordering (name, then label values) so the format
        can be golden-tested."""
        lines = []
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for labels, _ in m._series():
                    snap = m.snapshot(**labels)
                    for le, c in snap["buckets"].items():
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_fmt_labels({**labels, 'le': _fmt_float(le)})}"
                            f" {c}"
                        )
                    lines.append(
                        f'{m.name}_bucket{_fmt_labels({**labels, "le": "+Inf"})}'
                        f' {snap["count"]}'
                    )
                    lines.append(
                        f"{m.name}_sum{_fmt_labels(labels)}"
                        f" {_fmt_float(snap['sum'])}"
                    )
                    lines.append(
                        f"{m.name}_count{_fmt_labels(labels)}"
                        f" {snap['count']}"
                    )
            else:
                for labels, value in m._series():
                    lines.append(
                        f"{m.name}{_fmt_labels(labels)} {_fmt_float(value)}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(s: str) -> str:
    return (
        s.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")
    )


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_float(v: float) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


# ---------------------------------------------------------------------------
# the process registry + kill-switch


class _NoopMetric:
    def inc(self, *a, **k):
        pass

    def dec(self, *a, **k):
        pass

    def set(self, *a, **k):
        pass

    def observe(self, *a, **k):
        pass

    def value(self, *a, **k):
        return 0.0


_NOOP_METRIC = _NoopMetric()


class _NoopRegistry:
    """Returned by :func:`get_registry` under ``TPUDAS_OBS=0``: every
    metric operation is a no-op (the overhead-bench baseline)."""

    def counter(self, *a, **k):
        return _NOOP_METRIC

    def gauge(self, *a, **k):
        return _NOOP_METRIC

    def histogram(self, *a, **k):
        return _NOOP_METRIC

    def get(self, name):
        return None

    def value(self, name, default=0.0, **labels):
        return default

    def snapshot(self):
        return {}

    def to_prometheus(self):
        return ""


_NOOP_REGISTRY = _NoopRegistry()
_REGISTRY = MetricsRegistry()
_SWAP_LOCK = threading.Lock()
_SCOPE_DEPTH = 0  # active use_registry scopes (overrides kill-switch)


def obs_enabled() -> bool:
    return os.environ.get("TPUDAS_OBS", "1") != "0"


def get_registry():
    """The process registry (a no-op stand-in under ``TPUDAS_OBS=0``).
    Instrumented code resolves this at each use site so
    :func:`use_registry` scopes and the kill-switch both take effect
    without re-imports.

    An active :func:`use_registry` scope WINS over the kill-switch:
    ``TPUDAS_OBS=0`` silences the default process registry, but a
    caller that explicitly installed its own registry (benches reading
    their run's headline numbers) asked for measurements — silently
    handing it zeros would corrupt the artifact."""
    if _SCOPE_DEPTH == 0 and not obs_enabled():
        return _NOOP_REGISTRY
    return _REGISTRY


@contextmanager
def use_registry(registry: MetricsRegistry):
    """Swap the process registry for the scope (process-global, not
    thread-scoped: instrumentation runs on worker threads too, e.g.
    the LFProc prefetch thread, and must land in the same registry).
    Benches use this to read one run's numbers from a fresh registry.
    While any scope is active the ``TPUDAS_OBS=0`` kill-switch is
    overridden (see :func:`get_registry`)."""
    global _REGISTRY, _SCOPE_DEPTH
    with _SWAP_LOCK:
        prev = _REGISTRY
        _REGISTRY = registry
        _SCOPE_DEPTH += 1
    try:
        yield registry
    finally:
        with _SWAP_LOCK:
            _REGISTRY = prev
            _SCOPE_DEPTH -= 1


def headline(registry=None) -> dict:
    """The headline numbers derived from the registry's
    ``tpudas_proc_*`` counters (fed by
    :class:`tpudas_torch.utils.profiling.Counters`) — the single source both
    BENCH_*.json and ``metrics.prom`` report from."""
    reg = registry if registry is not None else get_registry()
    samples = reg.value("tpudas_proc_channel_samples_total")
    data_sec = reg.value("tpudas_proc_data_seconds_total")
    wall = reg.value("tpudas_proc_wall_seconds_total")
    redundant = reg.value("tpudas_proc_samples_redundant_total")
    return {
        "channel_samples": samples,
        "data_seconds": data_sec,
        "wall_seconds": wall,
        "samples_redundant": redundant,
        "redundant_ratio": (redundant / samples) if samples else 0.0,
        "channel_samples_per_sec": (samples / wall) if wall else 0.0,
        "realtime_factor": (data_sec / wall) if wall else 0.0,
    }
