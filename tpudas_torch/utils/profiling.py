"""Throughput counters for the processing drivers.

The port's copy of :class:`tpudas.utils.profiling.Counters` (the
notebooks' tic/toc harness plus the channel-samples/s and real-time
factor metrics).  As in the JAX package, every accumulation is mirrored
into the obs registry (``tpudas_proc_channel_samples_total`` /
``_data_seconds_total`` / ``_wall_seconds_total`` /
``_samples_redundant_total``), so ``metrics.prom`` and
:func:`tpudas_torch.obs.registry.headline` report from one substrate.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from tpudas_torch.obs.registry import get_registry

__all__ = ["Counters"]


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
