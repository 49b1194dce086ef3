"""Synthetic DAS data for tests, examples and the on-card smoke run.

The port's counterpart of :mod:`tpudas.testing` (the data half; the
fault-injection harness belongs to a later slice): a deterministic
interrogator simulator writing contiguous dasdae or tdas files of a
(time x distance) strain-rate stream with a known low-frequency
component (recoverable after low-pass + decimate), high-frequency
interference (must be rejected), and noise.

The signal is generated in blocks of rows, so a full-width file
(1 kHz x 10,000 channels x 60 s) never holds more than a few
float64 blocks beside its float32 payload; the values equal those of
:func:`tpudas.testing.synthetic_patch`.
"""

from __future__ import annotations

import os

import numpy as np

from tpudas_torch.core.patch import Patch
from tpudas_torch.core.timeutils import to_datetime64
from tpudas_torch.io.registry import write_patch

__all__ = ["synthetic_patch", "make_synthetic_spool"]

DEFAULT_T0 = "2023-03-22T00:00:00"

_BLOCK_ELEMS = 1 << 23  # float64 elements per generated row block


def _time_axis(t0, n, fs):
    start = to_datetime64(t0).astype("datetime64[ns]")
    step = np.timedelta64(int(round(1e9 / fs)), "ns")
    return start + np.arange(n) * step


def _signal(t_sec, dists, lf_freq, hf_freq, noise, rng):
    """(T, C) float32 strain-rate: channel-ramped LF sine + HF sine +
    noise, generated a block of rows at a time."""
    amp = 1.0 + dists / (dists.max() + 1.0)
    out = np.empty((t_sec.size, dists.size), np.float32)
    rows = max(1, _BLOCK_ELEMS // max(dists.size, 1))
    for r0 in range(0, t_sec.size, rows):
        t = t_sec[r0 : r0 + rows]
        blk = np.sin(2 * np.pi * lf_freq * t)[:, None] * amp[None, :]
        blk = blk + 0.5 * np.sin(2 * np.pi * hf_freq * t)[:, None]
        if noise:
            blk = blk + noise * rng.standard_normal(blk.shape)
        out[r0 : r0 + rows] = blk
    return out


def synthetic_patch(
    t0=DEFAULT_T0,
    duration=30.0,
    fs=200.0,
    n_ch=16,
    d_ch=5.0,
    gauge_length=10.0,
    lf_freq=0.05,
    hf_freq=25.0,
    noise=0.0,
    seed=0,
    phase_origin=None,
) -> Patch:
    """One interrogator file's worth of synthetic data.

    ``phase_origin`` makes the LF/HF phases continuous across files when
    set to the stream start time.
    """
    n = int(round(duration * fs))
    times = _time_axis(t0, n, fs)
    origin = to_datetime64(phase_origin if phase_origin is not None else t0)
    t_sec = (times - origin.astype("datetime64[ns]")).astype(np.int64) / 1e9
    dists = np.arange(n_ch, dtype=np.float64) * d_ch
    rng = np.random.default_rng(seed)
    data = _signal(t_sec, dists, lf_freq, hf_freq, noise, rng)
    return Patch(
        data=data,
        coords={"time": times, "distance": dists},
        dims=("time", "distance"),
        attrs={
            "gauge_length": gauge_length,
            "d_time": 1.0 / fs,
            "d_distance": d_ch,
        },
    )


def make_synthetic_spool(
    directory,
    n_files=4,
    file_duration=30.0,
    fs=200.0,
    n_ch=16,
    start=DEFAULT_T0,
    format="dasdae",
    prefix="raw",
    write_kwargs=None,
    **kwargs,
):
    """Write ``n_files`` contiguous files into ``directory`` in the
    given IO format ("dasdae" HDF5 or "tdas").  ``write_kwargs``
    forwards to the format writer (e.g. ``{"dtype": "int16", "scale":
    1e-4}`` for a quantized tdas spool).  Returns the paths."""
    os.makedirs(directory, exist_ok=True)
    t0 = to_datetime64(start).astype("datetime64[ns]")
    step = np.timedelta64(int(round(1e9 / fs)), "ns")
    n = int(round(file_duration * fs))
    suffix = ".tdas" if format == "tdas" else ".h5"
    paths = []
    for i in range(n_files):
        file_t0 = t0 + i * n * step
        patch = synthetic_patch(
            t0=file_t0,
            duration=file_duration,
            fs=fs,
            n_ch=n_ch,
            seed=i,
            phase_origin=t0,
            **kwargs,
        )
        path = os.path.join(directory, f"{prefix}_{i:04d}{suffix}")
        write_patch(patch, path, format=format, **(write_kwargs or {}))
        paths.append(path)
    return paths
