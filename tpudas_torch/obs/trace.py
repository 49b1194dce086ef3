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

Each finished record carries ``start_ns`` / ``end_ns`` from
:func:`time.time_ns`, the clock ``torch.profiler``'s Chrome trace maps
to (``baseTimeNanoseconds`` + ``ts``), so a span lines up with the
card's kernels and copies; ``duration_s`` is derived from the two
stamps and ``start`` is ``start_ns`` in seconds.  ``thread`` is the
recording thread's ``(native id, name)`` (the profiler's ``tid``), and
``trace`` the id of the root span of the request: a span's parent is
the innermost open span of its thread, or the span passed as
``parent=`` for work handed to another thread, so one pass or one
round shares one ``trace`` across threads.
:func:`tpudas_torch.utils.profiling.device_trace` and the ``/profile``
capture append every thread's spans to the trace they write.

``TPUDAS_TRACE_ANNOTATE=1`` additionally wraps each span in
``torch.profiler.record_function`` (and, on a CUDA build of torch, an
NVTX range), so spans line up with the ``device_trace`` /
``TPUDAS_TRACE_DIR`` and ``/profile`` traces; the variable is read
once, at the first span, as the JAX package's
``jax.profiler.TraceAnnotation`` pass-through is.

``TPUDAS_OBS=0`` disables recording entirely (the registry's kill
switch); ``TPUDAS_SPAN_RING`` sizes the ring (default 2048 finished
spans).
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
    "current_span",
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


# the device annotation factory, resolved once (None = unresolved,
# False = disabled/unavailable): a span must not pay for an import on
# the hot path
_annotation = None


class _DeviceRange:
    """A span's device half: a ``record_function`` range, and an NVTX
    range when torch was built with CUDA."""

    __slots__ = ("name", "_rf", "_nvtx")

    def __init__(self, name, record_function, nvtx):
        self.name = name
        self._rf = record_function(name)
        self._nvtx = nvtx

    def __enter__(self):
        self._rf.__enter__()
        if self._nvtx is not None:
            self._nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx is not None:
            self._nvtx.range_pop()
        self._rf.__exit__(None, None, None)
        return False


def _trace_annotation():
    global _annotation
    if _annotation is None:
        if os.environ.get("TPUDAS_TRACE_ANNOTATE", "0") != "1":
            _annotation = False
        else:
            try:
                import torch
                from torch.profiler import record_function

                nvtx = torch.cuda.nvtx if torch.version.cuda else None

                def _annotation(name, _rf=record_function, _nvtx=nvtx):
                    return _DeviceRange(name, _rf, _nvtx)
            except Exception:  # pragma: no cover - build specific
                _annotation = False
    return _annotation


def _span_stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _thread():
    """This thread's ``(native id, name)``, looked up once a thread."""
    th = getattr(_local, "thread", None)
    if th is None:
        th = _local.thread = (threading.get_native_id(),
                              threading.current_thread().name)
    return th


def current_span():
    """The innermost open span record of this thread, or None: pass it
    as ``parent=`` to a span opened on another thread for this work."""
    stack = _span_stack()
    return stack[-1] if stack else None


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

    __slots__ = ("name", "attrs", "parent", "rec", "_cm", "_reg")

    def __init__(self, name, attrs, parent=None):
        self.name = name
        self.attrs = attrs
        self.parent = parent
        self.rec = None

    def __enter__(self):
        # same gate as the registry: TPUDAS_OBS=0 disables spans
        # unless an explicit use_registry scope asked for measurements
        reg = _registry_mod.get_registry()
        if reg is _registry_mod._NOOP_REGISTRY:
            return None
        global _next_id
        stack = _span_stack()
        parent = self.parent
        if parent is None and stack:
            parent = stack[-1]
        with _lock:
            _next_id += 1
            sid = _next_id
        rec = self.rec = {
            "name": str(self.name),
            "id": sid,
            "parent": None if parent is None else parent["id"],
            "trace": sid if parent is None else parent["trace"],
            "depth": 0 if parent is None else parent["depth"] + 1,
            "thread": _thread(),
            "attrs": self.attrs,
        }
        stack.append(rec)
        self._reg = reg
        ann = _trace_annotation()
        self._cm = ann(rec["name"]) if ann else None
        if self._cm is not None:
            self._cm.__enter__()
        rec["start_ns"] = time.time_ns()
        rec["start"] = rec["start_ns"] / 1e9
        return rec

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        if rec is None:
            return False
        rec["end_ns"] = time.time_ns()
        dur = (rec["end_ns"] - rec["start_ns"]) / 1e9
        if self._cm is not None:
            self._cm.__exit__(None, None, None)
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


def span(name: str, parent=None, **attrs) -> _Span:
    """Record a named, attributed, nested timed span around the block.

    ``parent`` (a span record, :func:`current_span` of the thread that
    handed the work over) parents a span opened on a thread with no
    open span of its own.  Exceptions propagate; the span is still
    recorded with ``error=<repr prefix>`` so a crashed round leaves its
    trace."""
    return _Span(name, attrs, parent)


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
