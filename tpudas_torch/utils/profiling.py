"""Wall-clock timing, throughput counters and the device trace.

The port's copy of :mod:`tpudas.utils.profiling`: :class:`Timer` (the
notebooks' tic/toc), :class:`Counters` (channel-samples/s and the
real-time factor) and :func:`device_trace`.  As in the JAX package,
every accumulation of :class:`Counters` is mirrored into the obs
registry (``tpudas_proc_channel_samples_total`` /
``_data_seconds_total`` / ``_wall_seconds_total`` /
``_samples_redundant_total``), so ``metrics.prom`` and
:func:`tpudas_torch.obs.registry.headline` report from one substrate.

:func:`device_trace` records the enclosed block with
``torch.profiler`` (CPU activity, and the card's kernels and copies
when CUDA is available) and writes a Chrome trace
(``<host>.<pid>.<ns>.pt.trace.json``) into its folder, where the JAX
package writes a TensorBoard profile.  The capture starts and stops on
the calling thread: ``torch.profiler`` records the host ranges of the
thread that started it only, while the card's activity is process
wide.  So the capture also takes every thread's finished spans
(:mod:`tpudas_torch.obs.trace`) and appends them to the written trace
as complete events of category ``tpudas_span`` (:func:`append_spans`),
each on its thread's row: the prefetch thread's reads sit under the
device timeline too.

:class:`EventTimer` times a window's or a stream block's kernels with a
CUDA event pair on the compute stream, read after the sync the caller
already makes (``LFProc.timings["device_s"]``).
"""

from __future__ import annotations

import json
import os
import socket
import time
from contextlib import contextmanager

from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import add_span_sink, remove_span_sink
from tpudas_torch.utils.logging import log_event

__all__ = ["Timer", "Counters", "device_trace"]


class Timer:
    """``with Timer() as t: ...; t.elapsed`` — tic/toc."""

    def __enter__(self):
        self.start = time.perf_counter()
        self.elapsed = None
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False


class Counters:
    """Accumulates processed channel-samples and wall time; reports the
    headline metrics."""

    def __init__(self):
        self.channel_samples = 0
        self.data_seconds = 0.0
        self.wall_seconds = 0.0
        self.last_wall = 0.0  # duration of the most recent measure()
        # full-rate channel-samples processed more than once (the
        # rewind-mode edge-buffer re-reads; 0 under stateful streaming,
        # where the carried filter state makes every sample touch the
        # filter exactly once)
        self.samples_redundant = 0

    def _mirror(self, channel_samples, data_seconds, wall_seconds):
        reg = get_registry()
        reg.counter(
            "tpudas_proc_channel_samples_total",
            "full-rate channel-samples fed through the processing engine",
        ).inc(channel_samples)
        reg.counter(
            "tpudas_proc_data_seconds_total",
            "stream-seconds of data processed",
        ).inc(data_seconds)
        reg.counter(
            "tpudas_proc_wall_seconds_total",
            "wall seconds spent inside measured processing",
        ).inc(wall_seconds)

    @contextmanager
    def measure(self, channel_samples: int, data_seconds: float):
        t0 = time.perf_counter()
        yield
        self.last_wall = time.perf_counter() - t0
        self.wall_seconds += self.last_wall
        self.channel_samples += int(channel_samples)
        self.data_seconds += float(data_seconds)
        self._mirror(int(channel_samples), float(data_seconds),
                     self.last_wall)

    def add_measured(self, channel_samples: int, data_seconds: float,
                     wall_seconds: float) -> None:
        """Absorb a measurement timed elsewhere (a kernel loop, say), so
        its headline numbers come from the registry too."""
        self.last_wall = float(wall_seconds)
        self.wall_seconds += self.last_wall
        self.channel_samples += int(channel_samples)
        self.data_seconds += float(data_seconds)
        self._mirror(int(channel_samples), float(data_seconds),
                     self.last_wall)

    def add_redundant(self, channel_samples: int) -> None:
        """Record channel-samples that were re-read only to rebuild
        filter state (rewind-mode overlap)."""
        self.samples_redundant += int(channel_samples)
        get_registry().counter(
            "tpudas_proc_samples_redundant_total",
            "channel-samples re-read solely to rebuild filter state "
            "(rewind-mode overlap)",
        ).inc(int(channel_samples))

    @property
    def redundant_ratio(self) -> float:
        """Fraction of all processed channel-samples that were redundant
        re-reads (0.0 for a stateful stream)."""
        if not self.channel_samples:
            return 0.0
        return self.samples_redundant / self.channel_samples

    @property
    def channel_samples_per_sec(self) -> float:
        return (
            self.channel_samples / self.wall_seconds if self.wall_seconds
            else 0.0
        )

    @property
    def realtime_factor(self) -> float:
        """Data-seconds processed per wall-second (> 1 is faster than
        the stream)."""
        return (
            self.data_seconds / self.wall_seconds if self.wall_seconds
            else 0.0
        )


class EventTimer:
    """Device seconds of the work enqueued between :meth:`start` and
    :meth:`stop` on ``device``'s current stream: a CUDA event pair,
    read by :meth:`seconds` once the caller has synced past the second
    event (no sync of its own).  Off the card it has no events and
    :meth:`seconds` returns the caller's host bracket."""

    __slots__ = ("_stream", "_t0", "_t1")

    def __init__(self, device):
        self._stream = self._t0 = self._t1 = None
        if device.type == "cuda":
            import torch

            self._stream = torch.cuda.current_stream(device)
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t1 = torch.cuda.Event(enable_timing=True)

    def start(self) -> "EventTimer":
        if self._t0 is not None:
            self._t0.record(self._stream)
        return self

    def stop(self) -> None:
        if self._t1 is not None:
            self._t1.record(self._stream)

    def seconds(self, host_s: float) -> float:
        if self._t0 is None:
            return host_s
        return self._t0.elapsed_time(self._t1) / 1e3


class SpanCapture:
    """A span sink that keeps every thread's finished spans while it is
    registered (``with SpanCapture() as cap: ...; cap.recs``)."""

    def __init__(self):
        self.recs = []

    def __call__(self, rec) -> None:
        self.recs.append(rec)

    def __enter__(self):
        add_span_sink(self)
        return self

    def __exit__(self, *exc):
        remove_span_sink(self)
        return False


def _arg(v):
    return v if v is None or isinstance(v, (bool, int, float, str)) \
        else str(v)


def append_spans(path, recs) -> None:
    """Append finished span records to the Chrome trace at ``path`` as
    complete (``"ph": "X"``) events of category ``tpudas_span``: ``tid``
    the recording thread's native id (the profiler's own), ``ts`` /
    ``dur`` in microseconds on the file's ``baseTimeNanoseconds``, the
    span's id, parent, trace id and depth in ``args``."""
    with open(path) as fh:
        doc = json.load(fh)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = doc.setdefault("traceEvents", [])
    pid = os.getpid()
    named = {ev.get("tid") for ev in events
             if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
    for rec in recs:
        tid, tname = rec["thread"]
        if tid not in named:
            named.add(tid)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        args = {k: _arg(v) for k, v in rec["attrs"].items()}
        args.update(id=rec["id"], parent=rec["parent"],
                    trace=rec["trace"], depth=rec["depth"])
        if "error" in rec:
            args["error"] = rec["error"]
        events.append({
            "ph": "X", "cat": "tpudas_span", "name": rec["name"],
            "pid": pid, "tid": tid,
            "ts": (rec["start_ns"] - base) / 1e3,
            "dur": (rec["end_ns"] - rec["start_ns"]) / 1e3,
            "args": args,
        })
    with open(path, "w") as fh:
        json.dump(doc, fh)


def profiler_activities(cuda: bool) -> list:
    """``torch.profiler`` activities: the host's, plus the card's when
    ``cuda``."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return acts


def trace_path(folder) -> str:
    """A fresh Chrome-trace file name in ``folder``."""
    return os.path.join(
        str(folder),
        f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}"
        ".pt.trace.json",
    )


@contextmanager
def device_trace(logdir=None):
    """Capture a profiler trace of the enclosed block with
    ``torch.profiler`` into ``logdir`` as a Chrome trace.

    ``logdir=None`` reads ``TPUDAS_TRACE_DIR`` (operators enable
    tracing by environment alone; a ``ValueError`` if neither is set).
    The card's activity is recorded when CUDA is available, and every
    thread's spans finished during the capture are appended to the
    file (:func:`append_spans`).  Robust by design: a profiler that
    fails to start logs a ``trace_failed`` event and the block still
    runs; a written trace logs ``trace_written``."""
    if logdir is None:
        logdir = os.environ.get("TPUDAS_TRACE_DIR")
        if not logdir:
            raise ValueError(
                "device_trace needs a logdir (argument or "
                "TPUDAS_TRACE_DIR)"
            )
    prof = None
    spans = SpanCapture()
    try:
        import torch
        from torch.profiler import profile

        prof = profile(
            activities=profiler_activities(torch.cuda.is_available())
        )
        prof.start()
    except Exception as exc:
        prof = None
        log_event("trace_failed", error=str(exc)[:200])
    try:
        with spans:
            yield
    finally:
        if prof is not None:
            try:
                prof.stop()
                os.makedirs(str(logdir), exist_ok=True)
                path = trace_path(logdir)
                prof.export_chrome_trace(path)
                append_spans(path, spans.recs)
                log_event("trace_written", logdir=str(logdir))
            except Exception as exc:
                log_event("trace_failed", error=str(exc)[:200])
