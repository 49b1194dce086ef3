"""Span tracing: nested timed spans into a bounded ring buffer.

The host half of :mod:`tpudas.obs.trace`.  ``with span("stream.round",
round=3): ...`` records a wall-clock span with attributes; spans nest
per thread (each span knows its parent and depth), land in a
process-wide ring buffer (bounded: an edge process must never grow
memory with uptime), feed the ``tpudas_span_seconds{name=...}``
histogram, are handed to every registered span sink
(:func:`add_span_sink`: the flight recorder's scoped capture,
:mod:`tpudas_torch.obs.flight`), and export one ``log_event("span",
...)`` line each when a log handler is installed.

``TPUDAS_OBS=0`` disables recording entirely (the registry's kill
switch); ``TPUDAS_SPAN_RING`` sizes the ring (default 2048 finished
spans).  Not ported yet: the device annotation around each span (the
JAX package's ``TPUDAS_TRACE_ANNOTATE``), which comes with the device
telemetry.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from tpudas_torch.obs import registry as _registry_mod
from tpudas_torch.utils import logging as _logging

__all__ = [
    "add_span_sink",
    "remove_span_sink",
    "span",
    "get_spans",
    "clear_spans",
    "span_ring_capacity",
]

_DEFAULT_RING = 2048


def span_ring_capacity() -> int:
    try:
        cap = int(os.environ.get("TPUDAS_SPAN_RING", _DEFAULT_RING))
    except ValueError:
        cap = _DEFAULT_RING
    return max(1, cap)


_lock = threading.Lock()
_ring: deque = deque(maxlen=span_ring_capacity())
_local = threading.local()
_next_id = 0
# finished-span sinks (e.g. the flight recorder's thread-scoped
# capture, tpudas_torch.obs.flight) — called with each finished span record
_sinks: list = []


def add_span_sink(fn) -> None:
    """Register ``fn(record)`` to receive every finished span (after
    the ring append).  A raising sink is counted
    (``tpudas_obs_spans_dropped_total{reason="sink_error"}``) and
    skipped — a trace consumer must never break the traced code."""
    with _lock:
        if fn not in _sinks:
            _sinks.append(fn)


def remove_span_sink(fn) -> None:
    with _lock:
        if fn in _sinks:
            _sinks.remove(fn)


def _span_stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _span_metrics(reg):
    """(histogram, eviction_counter, dropped_counter) handles, memoized
    on the registry instance — the per-span cost must not include
    get-or-create (once the ring is full, EVERY span exit counts an
    eviction)."""
    handles = getattr(reg, "_span_metric_handles", None)
    if handles is None:
        handles = (
            reg.histogram(
                "tpudas_span_seconds",
                "span wall-clock duration by span name",
                labelnames=("name",),
            ),
            reg.counter(
                "tpudas_spans_evicted_total",
                "finished spans dropped from the full ring buffer",
            ),
            reg.counter(
                "tpudas_obs_spans_dropped_total",
                "finished spans lost before reaching a consumer "
                "(ring eviction, or a raising span sink)",
                labelnames=("reason",),
            ),
        )
        try:
            reg._span_metric_handles = handles
        except AttributeError:  # pragma: no cover - exotic registry
            pass
    return handles


class _Span:
    """Hand-rolled context manager (no ``@contextmanager`` generator
    machinery) for the hot path.  Yields the mutable span record."""

    __slots__ = ("name", "attrs", "rec", "_t0", "_reg")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs
        self.rec = None

    def __enter__(self):
        # same gate as the registry: TPUDAS_OBS=0 disables spans
        # unless an explicit use_registry scope asked for measurements
        reg = _registry_mod.get_registry()
        if reg is _registry_mod._NOOP_REGISTRY:
            return None
        global _next_id
        stack = _span_stack()
        parent = stack[-1] if stack else None
        with _lock:
            _next_id += 1
            sid = _next_id
        rec = self.rec = {
            "name": str(self.name),
            "id": sid,
            "parent": None if parent is None else parent["id"],
            "depth": len(stack),
            "attrs": self.attrs,
        }
        stack.append(rec)
        self._reg = reg
        rec["start"] = time.time()
        self._t0 = time.perf_counter()
        return rec

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        if rec is None:
            return False
        dur = time.perf_counter() - self._t0
        if exc is not None:
            rec["error"] = repr(exc)[:200]
        rec["duration_s"] = dur
        _span_stack().pop()
        with _lock:
            evicted = len(_ring) == _ring.maxlen
            _ring.append(rec)
        hist, evictions, dropped = _span_metrics(self._reg)
        if evicted:
            evictions.inc()
            # the obs-wide drop count: silent trace loss must be
            # visible in metrics.prom
            dropped.inc(reason="ring_full")
        hist.observe(dur, name=rec["name"])
        for sink in tuple(_sinks):
            try:
                sink(rec)
            except Exception:
                dropped.inc(reason="sink_error")
        # JSONL export through the existing pipeline (skipped wholesale
        # when no handler is installed)
        if _logging._handler is not None:
            fields = {
                **rec["attrs"],  # attrs first: the envelope keys win
                "span": rec["name"],
                "id": rec["id"],
                "parent": rec["parent"],
                "depth": rec["depth"],
                "duration_s": round(dur, 6),
            }
            if "error" in rec:
                fields["error"] = rec["error"]
            _logging.log_event("span", **fields)
        return False  # never swallow the body's exception


def span(name: str, **attrs) -> _Span:
    """Record a named, attributed, nested timed span around the block.

    Exceptions propagate; the span is still recorded with
    ``error=<repr prefix>`` so a crashed round leaves its trace."""
    return _Span(name, attrs)


def get_spans(name: str | None = None) -> list:
    """Finished spans currently in the ring (oldest first), optionally
    filtered by name.  Returns copies — callers cannot corrupt the
    ring."""
    with _lock:
        recs = list(_ring)
    if name is not None:
        recs = [r for r in recs if r["name"] == name]
    return [dict(r) for r in recs]


def clear_spans() -> None:
    """Empty the ring and re-read ``TPUDAS_SPAN_RING`` (tests resize
    the ring this way)."""
    global _ring
    with _lock:
        _ring = deque(maxlen=span_ring_capacity())
