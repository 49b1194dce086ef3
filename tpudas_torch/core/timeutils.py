"""Datetime handling at the host boundary.

All time coordinates in tpudas are numpy ``datetime64[ns]`` on the host;
device kernels never see datetimes (they see gather indices / float
weights computed here). This module reproduces the reference's time
contracts exactly:

- ``to_datetime64`` accepts float seconds since epoch (possibly
  negative — the impulse probe at reference lf_das.py:52-56 builds a
  time axis centred on 0), strings, datetimes and datetime64 values.
- the processing time grid quantizes the output interval to whole
  milliseconds: ``np.timedelta64(int(dt * 1000), "ms")``
  (reference lf_das.py:252-256); see :func:`quantize_step` /
  :func:`build_time_grid`.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

NS_PER_S = 1_000_000_000

__all__ = [
    "to_datetime64",
    "to_timedelta64",
    "to_float_seconds",
    "quantize_step",
    "build_time_grid",
    "infer_step",
    "is_datetime64",
]


def is_datetime64(x) -> bool:
    return isinstance(x, np.datetime64) or (
        isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.datetime64)
    )


def _seconds_to_ns_int(value):
    # round-to-nearest in float64, exact for ms-quantized inputs
    return np.round(np.asarray(value, dtype=np.float64) * NS_PER_S).astype(np.int64)


def to_datetime64(value):
    """Convert ``value`` to numpy datetime64[ns] (scalar or array).

    Floats/ints are interpreted as seconds relative to the unix epoch
    (negative values allowed). Strings are parsed by numpy. datetime64
    input is normalized to ns precision.
    """
    if isinstance(value, np.datetime64):
        return value.astype("datetime64[ns]")
    if isinstance(value, _dt.datetime):
        return np.datetime64(value).astype("datetime64[ns]")
    if isinstance(value, str):
        return np.datetime64(value).astype("datetime64[ns]")
    arr = np.asarray(value)
    if np.issubdtype(arr.dtype, np.datetime64):
        return arr.astype("datetime64[ns]")
    if arr.dtype == object or arr.dtype.kind == "U":
        return arr.astype("datetime64[ns]")
    ns = _seconds_to_ns_int(arr)
    out = ns.astype("datetime64[ns]") if ns.ndim else np.datetime64(int(ns), "ns")
    return out


def to_timedelta64(value):
    """Convert ``value`` to numpy timedelta64[ns] (scalar or array).

    Floats/ints are seconds. Quantities from :mod:`tpudas_torch.core.units`
    are converted via their seconds magnitude.
    """
    mag = getattr(value, "to_seconds", None)
    if mag is not None:
        value = value.to_seconds()
    if isinstance(value, np.timedelta64):
        return value.astype("timedelta64[ns]")
    if isinstance(value, _dt.timedelta):
        return np.timedelta64(value).astype("timedelta64[ns]")
    arr = np.asarray(value)
    if np.issubdtype(arr.dtype, np.timedelta64):
        return arr.astype("timedelta64[ns]")
    ns = _seconds_to_ns_int(arr)
    if ns.ndim:
        return ns.astype("timedelta64[ns]")
    return np.timedelta64(int(ns), "ns")


def to_float_seconds(times, epoch=None):
    """datetime64/timedelta64 → float64 seconds (relative to ``epoch``)."""
    arr = np.asarray(times)
    if np.issubdtype(arr.dtype, np.datetime64):
        if epoch is None:
            epoch = np.datetime64(0, "ns")
        delta = arr.astype("datetime64[ns]") - np.datetime64(epoch).astype(
            "datetime64[ns]"
        )
        return delta.astype("timedelta64[ns]").astype(np.int64) / NS_PER_S
    if np.issubdtype(arr.dtype, np.timedelta64):
        return arr.astype("timedelta64[ns]").astype(np.int64) / NS_PER_S
    return arr.astype(np.float64)


def quantize_step(dt_seconds: float) -> np.timedelta64:
    """Output-interval quantization contract: whole milliseconds.

    Matches the reference grid step ``timedelta64(int(dt*1000), "ms")``
    (lf_das.py:255) — the filename/resume contracts depend on it.
    """
    return np.timedelta64(int(dt_seconds * 1000), "ms")


def build_time_grid(bgtime, edtime, dt_seconds: float) -> np.ndarray:
    """The processing time grid: ``arange(bg, ed, ms-quantized dt)`` in ns."""
    bg = to_datetime64(bgtime).astype("datetime64[ns]")
    ed = to_datetime64(edtime).astype("datetime64[ns]")
    return np.arange(bg, ed, quantize_step(dt_seconds))


def infer_step(times) -> np.timedelta64:
    """Median sample step of a datetime64 axis."""
    arr = np.asarray(times).astype("datetime64[ns]")
    if arr.size < 2:
        return np.timedelta64(0, "ns")
    diffs = np.diff(arr.astype(np.int64))
    return np.timedelta64(int(np.median(diffs)), "ns")
