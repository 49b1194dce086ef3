"""Synthetic DAS data and the fault-injection harness for tests,
examples and the on-card smoke run.

The port's counterpart of :mod:`tpudas.testing`: a deterministic
interrogator simulator writing contiguous dasdae or tdas files of a
(time x distance) strain-rate stream with a known low-frequency
component (recoverable after low-pass + decimate, :func:`lowfreq_truth`),
high-frequency interference (must be rejected), and noise.

Fault injection is re-exported from
:mod:`tpudas_torch.resilience.faults` (the hooks live there so
production IO modules never import this module): a :class:`FaultPlan`
of :class:`FaultSpec` entries at the named :data:`FAULT_SITES`, scoped
with :func:`install_fault_plan`.  :func:`write_corrupt_file` fabricates
a file with valid HDF5 magic and garbage after it (a truncated
interrogator flush); :func:`enospc_error` is the ready-made full-disk
``OSError`` for the ``fs.write_enospc`` site.

The signal is generated in blocks of rows, so a full-width file
(1 kHz x 10,000 channels x 60 s) never holds more than a few
float64 blocks beside its float32 payload; the values equal those of
:func:`tpudas.testing.synthetic_patch`.
"""

from __future__ import annotations

import errno
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tpudas_torch.core.patch import Patch
from tpudas_torch.core.timeutils import to_datetime64
from tpudas_torch.io.registry import write_patch
from tpudas_torch.resilience.faults import (  # noqa: F401 - re-exported
    FAULT_SITES,
    FaultPlan,
    FaultSpec,
    TransientFaultError,
    install_fault_plan,
)

__all__ = [
    "synthetic_patch",
    "make_synthetic_spool",
    "lowfreq_truth",
    "write_corrupt_file",
    "enospc_error",
    "FAULT_SITES",
    "FaultPlan",
    "FaultSpec",
    "TransientFaultError",
    "install_fault_plan",
]

DEFAULT_T0 = "2023-03-22T00:00:00"

# the HDF5 signature: a half-written interrogator file usually has a
# valid header and garbage (or nothing) after it
_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"

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


def enospc_error(msg: str = "injected: no space left on device") -> OSError:
    """An ``OSError`` carrying ``errno.ENOSPC``: pass as
    ``FaultSpec("fs.write_enospc", exc=enospc_error())`` to simulate a
    full disk at any atomic state write."""
    return OSError(errno.ENOSPC, msg)


def write_corrupt_file(path, nbytes=512, seed=0) -> str:
    """A deterministic un-decodable DAS file: valid HDF5 magic (so the
    suffix and the sniffer both say "dasdae") and a seeded garbage
    payload (so the scan fails).  Returns ``path``."""
    rng = np.random.default_rng(seed)
    body = rng.integers(0, 256, size=max(int(nbytes) - 8, 0), dtype=np.uint8)
    with open(path, "wb") as fh:
        fh.write(_HDF5_MAGIC)
        fh.write(body.tobytes())
    return str(path)


def lowfreq_truth(times, dists, lf_freq=0.05):
    """The recoverable low-frequency component at the given datetimes:
    the channel-ramped LF sine the simulator writes."""
    t_sec = (
        times.astype("datetime64[ns]") - times[0].astype("datetime64[ns]")
    ).astype(np.int64) / 1e9
    amp = 1.0 + np.asarray(dists) / (np.asarray(dists).max() + 1.0)
    return np.sin(2 * np.pi * lf_freq * t_sec)[:, None] * amp[None, :]


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
    1e-4}`` for a quantized tdas spool).  Returns the paths.  The files
    are generated in threads, one a file (each file's bytes depend on
    its index alone; numpy's generators and ufuncs release the GIL, so
    a full-width spool is written in a fraction of the serial time)."""
    os.makedirs(directory, exist_ok=True)
    t0 = to_datetime64(start).astype("datetime64[ns]")
    step = np.timedelta64(int(round(1e9 / fs)), "ns")
    n = int(round(file_duration * fs))
    suffix = ".tdas" if format == "tdas" else ".h5"

    def write_file(i):
        patch = synthetic_patch(
            t0=t0 + i * n * step,
            duration=file_duration,
            fs=fs,
            n_ch=n_ch,
            seed=i,
            phase_origin=t0,
            **kwargs,
        )
        path = os.path.join(directory, f"{prefix}_{i:04d}{suffix}")
        write_patch(patch, path, format=format, **(write_kwargs or {}))
        return path

    workers = max(1, min(n_files, os.cpu_count() or 1))
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(write_file, range(n_files)))
