"""Span tracing: nested timed spans into a bounded ring buffer.

The host part of :mod:`tpudas.obs.trace`.  ``with span("fleet.step",
stream="a"): ...`` records a wall-clock span with attributes; spans
nest per thread (each knows its parent and depth), land in a
process-wide ring buffer (bounded: a months-long edge process must not
grow with uptime), feed the ``tpudas_span_seconds{name=...}``
histogram, and export one ``log_event("span", ...)`` line each when a
log handler is installed.  ``TPUDAS_SPAN_RING`` sizes the ring
(default 2048 finished spans), read when the module is imported.

Not ported yet: the device annotation around each span (the JAX
package wraps spans in ``jax.profiler.TraceAnnotation``; the port's
counterpart belongs with the profiler hooks), span sinks (the flight
recorder's capture) and the ``TPUDAS_OBS=0`` kill switch.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from tpudas_torch.obs.registry import get_registry
from tpudas_torch.utils import logging as _logging

__all__ = ["get_spans", "span", "span_ring_capacity"]

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


def _span_stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    """Hand-rolled context manager (no generator machinery on the hot
    path).  Yields the mutable span record."""

    __slots__ = ("name", "attrs", "rec", "_t0")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs
        self.rec = None

    def __enter__(self):
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
        rec["start"] = time.time()
        self._t0 = time.perf_counter()
        return rec

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        dur = time.perf_counter() - self._t0
        if exc is not None:
            rec["error"] = repr(exc)[:200]
        rec["duration_s"] = dur
        _span_stack().pop()
        with _lock:
            evicted = len(_ring) == _ring.maxlen
            _ring.append(rec)
        reg = get_registry()
        if evicted:
            reg.counter(
                "tpudas_spans_evicted_total",
                "finished spans dropped from the full ring buffer",
            ).inc()
        reg.histogram(
            "tpudas_span_seconds",
            "span wall-clock duration by span name",
            labelnames=("name",),
        ).observe(dur, name=rec["name"])
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
    Exceptions propagate; the span is still recorded, with
    ``error=<repr prefix>``."""
    return _Span(name, attrs)


def get_spans(name: str | None = None) -> list:
    """Copies of the finished spans in the ring (oldest first),
    optionally only those called ``name``."""
    with _lock:
        recs = list(_ring)
    if name is not None:
        recs = [r for r in recs if r["name"] == name]
    return [dict(r) for r in recs]
