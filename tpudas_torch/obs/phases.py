"""Round-phase timeline: where one streaming round's wall time goes.

The port's counterpart of :mod:`tpudas.obs.phases`.  It names the phases
of one :meth:`StreamRunner.step` round and accumulates per-phase wall
seconds:

==================  =================================================
phase               what it covers (lowpass runner)
==================  =================================================
``poll``            quarantine exclusion + index update + freshness
                    check
``read_decode``     host-side prep (LFProc construction, carry
                    resolution, index metadata) plus the in-round
                    window read / int16 decode / prefetch wait
                    (``LFProc.timings["assemble_s"]``)
``place``           explicit H2D placement onto a device mesh: the
                    round's ``parallel.place`` span seconds (0.0
                    without a mesh)
``device_execute``  device seconds of the round's stream steps, from
                    the device telemetry's CUDA event pairs
                    (:func:`tpudas_torch.obs.devprof.round_collect`;
                    the host bracket on the CPU), at most the
                    processing call's residual; 0.0 under
                    ``TPUDAS_DEVPROF=0``
``host_wait``       the rest of that residual: kernel dispatch,
                    waiting on the card, host sync, engine glue
``commit``          output writes (``timings["write_s"]``) + the
                    carry save
``pyramid``         the per-round tile-pyramid append
``detect``          the per-round detection hook
``live``            the live-plane publish (``live=True``)
``health``          the health.json / metrics.prom write
==================  =================================================

Every processed round emits **all phases exactly once** (a skipped hook
contributes 0.0 but is present), into the
``tpudas_stream_round_phase_seconds{phase=...}`` histogram and into
one ``kind="round"`` record of the stream's flight recorder
(:mod:`tpudas_torch.obs.flight`), so the breakdown of the final rounds
survives a SIGKILL.
"""

from __future__ import annotations

import time

from tpudas_torch.obs.registry import get_registry

__all__ = [
    "PHASES",
    "RoundPhases",
    "ingest_pipeline_snapshot",
    "phase_seconds_snapshot",
    "record_ingest_pipeline",
]

PHASES = (
    "poll",
    "read_decode",
    "place",
    "device_execute",
    "host_wait",
    "commit",
    "pyramid",
    "detect",
    "live",
    "health",
)


class _PhaseScope:
    """Hand-rolled context manager (the span discipline: no generator
    machinery on the round hot path)."""

    __slots__ = ("rp", "phase", "_t0")

    def __init__(self, rp, phase):
        self.rp = rp
        self.phase = phase

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.rp.add(self.phase, time.perf_counter() - self._t0)
        return False


class RoundPhases:
    """One round's phase accumulator.  ``measure(phase)`` times a
    block; ``add(phase, s)`` charges derived durations (e.g. the
    assemble wait mirrored out of ``LFProc.timings``); ``finish()``
    emits the histograms and returns the completed phase dict."""

    __slots__ = ("seconds",)

    def __init__(self):
        self.seconds = dict.fromkeys(PHASES, 0.0)

    def measure(self, phase: str) -> _PhaseScope:
        return _PhaseScope(self, phase)

    def add(self, phase: str, seconds: float) -> None:
        self.seconds[phase] += max(float(seconds), 0.0)

    def total(self) -> float:
        return sum(self.seconds.values())

    def finish(self, registry=None) -> dict:
        """Observe every phase into
        ``tpudas_stream_round_phase_seconds{phase}`` (all phases, every
        round — a zero observation IS the signal that a hook was
        skipped) and return ``{phase: seconds}`` rounded for the
        flight record."""
        reg = registry if registry is not None else get_registry()
        hist = reg.histogram(
            "tpudas_stream_round_phase_seconds",
            "per-round wall seconds by round-loop phase (poll / "
            "read_decode / place / device_execute / host_wait / "
            "commit / pyramid / detect / live / health)",
            labelnames=("phase",),
        )
        out = {}
        for phase in PHASES:
            s = self.seconds[phase]
            hist.observe(s, phase=phase)
            out[phase] = round(s, 6)
        return out


def record_ingest_pipeline(depth: int, stats: dict,
                           registry=None) -> None:
    """Emit one ingest pipeline's aggregate observability (called when
    a :class:`tpudas_torch.proc.ingest.SlicePrefetcher` closes): the
    depth/stall gauges the overlap-aware phase reading needs —
    ``read_decode`` now only shows the consumer's residual STALL, so
    these are how an operator sees the producer's hidden work and
    whether the pipeline is keeping the device fed.

    ``stats`` keys: ``prefetched`` (slices loaded ahead), ``hits``
    (validated + consumed), ``misses`` (speculation diverged —
    discarded, re-read synchronously), ``stall_s`` (consumer seconds
    blocked on the queue), ``max_ahead`` (peak queue occupancy)."""
    reg = registry if registry is not None else get_registry()
    reg.gauge(
        "tpudas_stream_ingest_depth",
        "configured ingest prefetch depth (TPUDAS_INGEST_PREFETCH)",
    ).set(float(depth))
    reg.gauge(
        "tpudas_stream_ingest_queue_peak",
        "peak prefetched-slice queue occupancy of the last pipeline",
    ).set(float(stats.get("max_ahead", 0)))
    reg.counter(
        "tpudas_stream_ingest_prefetched_total",
        "slices loaded ahead by the ingest prefetch thread",
    ).inc(int(stats.get("prefetched", 0)))
    reg.counter(
        "tpudas_stream_ingest_hits_total",
        "prefetched slices validated and consumed",
    ).inc(int(stats.get("hits", 0)))
    reg.counter(
        "tpudas_stream_ingest_misses_total",
        "prefetched slices discarded after cursor-speculation "
        "mismatch (re-read synchronously; a perf signal, never a "
        "correctness one)",
    ).inc(int(stats.get("misses", 0)))
    reg.counter(
        "tpudas_stream_ingest_stall_seconds_total",
        "consumer wall seconds blocked waiting on the prefetch queue",
    ).inc(float(stats.get("stall_s", 0.0)))


def ingest_pipeline_snapshot(registry=None) -> dict:
    """The ingest pipeline counters/gauges as one dict (bench/report
    read; zeros when no pipeline ran)."""
    reg = registry if registry is not None else get_registry()
    return {
        "depth": reg.value("tpudas_stream_ingest_depth"),
        "queue_peak": reg.value("tpudas_stream_ingest_queue_peak"),
        "prefetched": reg.value("tpudas_stream_ingest_prefetched_total"),
        "hits": reg.value("tpudas_stream_ingest_hits_total"),
        "misses": reg.value("tpudas_stream_ingest_misses_total"),
        "stall_seconds": round(
            reg.value("tpudas_stream_ingest_stall_seconds_total"), 6
        ),
    }


def phase_seconds_snapshot(registry=None) -> dict:
    """``{phase: {"count", "sum", "mean"}}`` from the registry's phase
    histogram — the bench/report-side read of the timeline (empty dict
    when no round has been instrumented)."""
    reg = registry if registry is not None else get_registry()
    hist = reg.get("tpudas_stream_round_phase_seconds")
    if hist is None:
        return {}
    out = {}
    for phase in PHASES:
        snap = hist.snapshot(phase=phase)
        if not snap["count"]:
            continue
        out[phase] = {
            "count": snap["count"],
            "sum": round(snap["sum"], 6),
            "mean": round(snap["sum"] / snap["count"], 6),
        }
    return out
