"""Bounded producer/consumer prefetch for the stateful ingest path.

The port's copy of :mod:`tpudas.proc.ingest`.  A single producer thread
reads, merges and decodes the NEXT ``process_patch_size`` slice of the
source spool while the consumer (:func:`tpudas_torch.proc.stream.
process_increment`) feeds the current one through the device, through
a bounded queue.

**Same bytes, same order.**  The slice schedule follows the carry's
ingest cursor, which only advances as slices are fed, so the producer
*speculates*: it predicts the next cursor from the slice it just loaded
(the ``last_sample + d`` arithmetic of the feed, with the gap-skip and
no-progress ``t_hi + 1`` forcings) and loads down that chain.  The
consumer uses a prefetched slice only when its ``(t_lo, t_hi)`` window
equals the window the synchronous loop would load; any mismatch is a
miss — the item is dropped, the slice is read synchronously, and the
producer restarts from the true cursor.  So the fed bytes and their
order equal the synchronous loop's (``TPUDAS_INGEST_PREFETCH=0``).

**Crash equivalence.**  The producer only reads the source spool, so a
prefetched-but-unfed slice is indistinguishable from a never-read one.

**Backpressure.**  At most ``depth`` slices (completed and in flight)
exist ahead of the consumer (``TPUDAS_INGEST_PREFETCH``, default 2).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

import numpy as np

from tpudas_torch.obs.trace import current_span, span
from tpudas_torch.resilience.faults import fault_point
from tpudas_torch.utils.logging import log_event

__all__ = ["SlicePrefetcher", "decode_payload", "ingest_depth"]


def ingest_depth() -> int:
    """``TPUDAS_INGEST_PREFETCH`` slices loaded ahead of the consumer
    (default 2; ``0`` = the synchronous slice loop; a junk value falls
    back to the default so a typo'd deployment keeps streaming)."""
    raw = os.environ.get("TPUDAS_INGEST_PREFETCH", "")
    if not raw:
        return 2
    try:
        return max(0, int(raw))
    except ValueError:
        return 2


def decode_payload(lfp, patch):
    """(host array, qscale-or-None): the stream path's payload decode,
    shared by the prefetch thread and the synchronous load so the fed
    bytes cannot depend on which side loaded the slice.  Raw int16
    payloads stay int16: they are dequantized on the device."""
    host, qs = lfp._time_major_payload(patch)
    if qs is None:
        host = np.asarray(host, np.float32)
    else:
        host = np.ascontiguousarray(host)
    return host, qs


class _Item:
    """One prefetched slice: the window key the consumer validates, the
    loaded patch (None = an unmergeable gap slice), the decoded payload
    and any exception the load raised (raised on the consumer thread
    only when the window key matches)."""

    __slots__ = ("t_lo_ns", "t_hi_ns", "patch", "payload", "error")

    def __init__(self, t_lo_ns, t_hi_ns, patch, payload, error):
        self.t_lo_ns = t_lo_ns
        self.t_hi_ns = t_hi_ns
        self.patch = patch
        self.payload = payload
        self.error = error


class SlicePrefetcher:
    """A single producer thread loading slices ahead down a speculated
    cursor chain; see the module docstring for the protocol."""

    def __init__(self, lfp, t2_ns: int, slice_ns: int, on_gap,
                 depth: int, cursor_ns: int, d_ns_hint=None):
        self._lfp = lfp
        self._t2_ns = int(t2_ns)
        self._slice_ns = int(slice_ns)
        self._on_gap = on_gap
        self.depth = max(1, int(depth))
        self._cond = threading.Condition()
        self._items: deque = deque()
        self._state = "run"  # "run" | "pause" | "stop"
        self._cursor = int(cursor_ns)  # None = chain broken (error)
        self._d_hint = None if d_ns_hint is None else int(d_ns_hint)
        self._loading = False
        self._gen = 0  # resync generation: stale loads are dropped
        # the producer's spans join the round's trace
        self._parent = current_span()
        self.stats = {
            "prefetched": 0, "hits": 0, "misses": 0,
            "stall_s": 0.0, "max_ahead": 0,
        }
        self._thread = threading.Thread(
            target=self._run, name="tpudas-torch-ingest-prefetch",
            daemon=True,
        )
        self._thread.start()

    # -- producer -------------------------------------------------------
    def _run(self):
        while True:
            with self._cond:
                while not (
                    self._state == "stop"
                    or (
                        self._state == "run"
                        and self._cursor is not None
                        and self._cursor <= self._t2_ns
                        and len(self._items) < self.depth
                    )
                ):
                    self._cond.wait(timeout=0.1)
                if self._state == "stop":
                    return
                gen = self._gen
                t_lo_ns = self._cursor
                t_hi_ns = min(self._t2_ns, t_lo_ns + self._slice_ns)
                self._loading = True
            patch = payload = error = None
            try:
                t_lo = np.datetime64(int(t_lo_ns), "ns")
                t_hi = np.datetime64(int(t_hi_ns), "ns")
                fault_point(
                    "stream.prefetch", t_lo=str(t_lo), t_hi=str(t_hi)
                )
                with span("stream.prefetch", parent=self._parent,
                          t_lo=str(t_lo)):
                    patch = self._lfp._load_window(t_lo, t_hi, self._on_gap)
                    if patch is not None:
                        payload = decode_payload(self._lfp, patch)
            except BaseException as exc:  # shipped to the consumer:
                # an interrupt must cross the thread too
                error = exc
            with self._cond:
                self._loading = False
                if gen != self._gen or self._state == "stop":
                    # resynced or stopped mid-load: the slice is no
                    # longer on the consumer's schedule
                    self._cond.notify_all()
                    continue
                self._items.append(
                    _Item(t_lo_ns, t_hi_ns, patch, payload, error)
                )
                self.stats["prefetched"] += 1
                self.stats["max_ahead"] = max(
                    self.stats["max_ahead"], len(self._items)
                )
                if error is not None:
                    # no speculation past a failing read: the consumer
                    # decides
                    self._cursor = None
                else:
                    self._cursor = self._predict(patch, t_lo_ns, t_hi_ns)
                self._cond.notify_all()

    def _predict(self, patch, t_lo_ns: int, t_hi_ns: int):
        """The cursor the feed will leave after this slice — mirrored,
        not shared; every use is validated by the window-key match in
        :meth:`get`."""
        if patch is None:
            return t_hi_ns + 1  # gap-skip forcing
        t = np.asarray(patch.coords["time"])
        if t.size == 0:
            return t_hi_ns + 1  # no-progress forcing
        last_ns = int(t[-1].astype("datetime64[ns]").astype(np.int64))
        d = self._d_hint
        if d is None:
            d = int(round(float(patch.get_sample_step("time")) * 1e9))
            self._d_hint = d
        nxt = last_ns + d
        return t_hi_ns + 1 if nxt <= t_lo_ns else nxt

    # -- consumer -------------------------------------------------------
    def get(self, t_lo_ns: int, t_hi_ns: int):
        """The prefetched item for exactly ``[t_lo, t_hi]``, or None
        after a miss: the queue is drained, the producer parks, and the
        caller loads the slice itself and then calls :meth:`resync`.
        Blocks while the matching load is in flight (the stall is
        charged to the caller's ``assemble_s``)."""
        with self._cond:
            t0 = time.perf_counter()
            while not self._items and (
                self._loading
                or (
                    self._state == "run"
                    and self._cursor is not None
                    and self._cursor <= self._t2_ns
                )
            ):
                self._cond.wait(timeout=0.1)
            stall = time.perf_counter() - t0
            if stall > 0:
                self.stats["stall_s"] += stall
                self._lfp.timings["assemble_s"] += stall
            if self._items:
                item = self._items[0]
                if item.t_lo_ns == int(t_lo_ns) and item.t_hi_ns == int(t_hi_ns):
                    self._items.popleft()
                    self._cond.notify_all()
                    if item.error is not None:
                        # a matched load failure surfaces exactly where
                        # the synchronous load would have raised
                        raise item.error
                    self.stats["hits"] += 1
                    return item
            # miss: the speculated chain diverged from the true cursor
            self.stats["misses"] += 1
            self._state = "pause"
            self._gen += 1
            self._items.clear()
            while self._loading:
                self._cond.wait(timeout=0.1)
            return None

    def resync(self, cursor_ns, d_ns_hint=None) -> None:
        """Restart the speculation chain at the true cursor."""
        with self._cond:
            self._gen += 1
            self._items.clear()
            self._cursor = None if cursor_ns is None else int(cursor_ns)
            if d_ns_hint is not None:
                self._d_hint = int(d_ns_hint)
            self._state = "run"
            self._cond.notify_all()

    def close(self) -> None:
        """Stop and join the producer; record the pipeline's counters
        and gauges (:func:`tpudas_torch.obs.phases.record_ingest_pipeline`,
        as the JAX package does) and log them."""
        with self._cond:
            self._state = "stop"
            self._gen += 1
            self._cond.notify_all()
        self._thread.join(timeout=30)
        from tpudas_torch.obs.phases import record_ingest_pipeline

        record_ingest_pipeline(self.depth, self.stats)
        log_event("ingest_pipeline", depth=self.depth, **self.stats)
