"""Resident-window measurement harness for the port's probes.

The counterpart of ``tools/scan_harness.py::measure``: NW distinct
resident windows (NW <= 6, at most ~9 GB in all), rotated round-robin so
that no window is warm in the card's 50 MB L2 when ``fn`` reads it
again; inputs drawn from an explicit ``torch.Generator`` outside the
timer; CUDA events around the timed loop; best of 2; seconds per window.

One difference in what is timed: the TPU harness folds
``sum(|fn(w)|)`` into its timed loop (scan_harness.py:39-40), so its
numbers include that reduce over every output.  This harness times
``fn`` alone.  The PyTorch calls are issued eagerly, so each window
costs one host dispatch; at ~1 GB windows that is microseconds against
a kernel of hundreds.

On a CPU device (rehearsals and tests only) the host clock replaces the
events; such a number is never a device measurement.
"""

from __future__ import annotations

import time

import torch

from tpudas_torch.device import resolve_device

__all__ = ["measure"]


def _resident_windows(T: int, C: int, device):
    """The NW distinct (T, C) float32 standard-normal windows of one
    measurement, made on ``device`` from a generator seeded with 0."""
    nw = max(1, min(6, int(9e9 // (T * C * 4))))
    g = torch.Generator(device=device).manual_seed(0)
    return [
        torch.randn((T, C), generator=g, device=device, dtype=torch.float32)
        for _ in range(nw)
    ]


def measure(fn, T, C, iters=96, device=None):
    """Best-of-2 seconds per (T, C) float32 window through ``fn``; the
    windows are made on ``device`` (default the CUDA card) outside the
    timer."""
    dev = resolve_device(device)
    windows = _resident_windows(T, C, dev)
    nw = len(windows)
    rep = max(1, -(-int(iters) // nw))
    cuda = dev.type == "cuda"

    def run():
        for _ in range(rep):
            for w in windows:
                fn(w)

    for w in windows:  # warm-up: builds, first launches, allocator
        fn(w)
    if cuda:
        torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(2):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
    return best / (nw * rep)
