"""Filter-edge auto-calibration (reference lf_das.py:34-87).

The port's counterpart of :mod:`tpudas.proc.edge`.
``get_edge_effect_time`` pushes a synthetic unit impulse through the
*actual* processing pipeline — here the port's own FFT filter and
gather-lerp — and measures the support of the response above
``max * tol``, so the edge buffer self-calibrates to the filter the
port runs.  ``device`` (default the CUDA card) reaches the pipeline
through ``**kargs``.
"""

from __future__ import annotations

import numpy as np

from tpudas_torch.core.patch import Patch
from tpudas_torch.core.timeutils import to_datetime64

__all__ = ["down_sample_processing", "get_edge_effect_time"]


def down_sample_processing(patch, freq=5, nqfreq_ratio=0.8, device=None,
                           **kargs):
    """Canonical LF pipeline: low-pass at ``freq * 0.5 * nqfreq_ratio``
    then resample onto the uniform grid ``arange(t_min, t_max, 1/freq)``
    (reference lf_das.py:34-44)."""
    corner = freq * 0.5 * nqfreq_ratio
    step = np.timedelta64(int(round(1 / freq * 1e9)), "ns")
    out = patch.pass_filter(time=(None, corner), device=device)
    new_taxis = np.arange(
        np.datetime64(patch.attrs["time_min"], "ns"),
        np.datetime64(patch.attrs["time_max"], "ns"),
        step,
    )
    return out.interpolate(time=new_taxis, device=device)


def get_edge_effect_time(
    sampling_interval,
    total_T,
    fun=down_sample_processing,
    tol=1e-6,
    **kargs,
):
    """One-sided edge-effect duration (seconds) of ``fun``'s response.

    Builds an impulse Patch (N = total_T / sampling_interval samples,
    unit spike at N//2), runs it through ``fun`` via ``patch.pipe``, and
    returns the maximal one-sided support where the response exceeds
    ``max * tol``. Raises ValueError when twice the edge is at least the
    chunk length (chunk too small for the filter).

    As in the JAX package, ``freq`` defaults to 5 Hz when not passed
    (the reference crashes there, lf_das.py:63,79); every reference
    notebook passes it.
    """
    N = int(total_T / sampling_interval)
    if N < 2:
        raise ValueError("total_T too small for the sampling interval")
    taxis = (np.arange(N) - N // 2) * sampling_interval
    impulse = np.zeros((N, 1), dtype=np.float32)
    impulse[N // 2, 0] = 1.0
    probe = Patch(
        data=impulse,
        coords={"time": to_datetime64(taxis), "distance": [0.0]},
        dims=("time", "distance"),
        attrs={"d_time": sampling_interval, "d_distance": 1},
    )
    response = probe.pipe(fun, **kargs)

    freq = kargs.get("freq", 5)
    h = np.abs(response.host_data()[:, 0])
    above = h > h.max() * tol
    nz = np.nonzero(above)[0]
    first, last = nz[0], nz[-1]

    new_taxis = response.coords["time"]
    rel = (
        (new_taxis - new_taxis[0]) / np.timedelta64(1, "s")
        - (N // 2) * sampling_interval
    )
    edge_t = max(abs(rel[first]), abs(rel[last]))

    if int(np.ceil(edge_t * freq)) * 2 >= int(total_T * freq):
        raise ValueError(
            f"edge_t value ({edge_t} sec) is too close to half of the "
            f"processing chunk size ({total_T} sec). If your spool contains "
            "enough data (at least roughly more than 180 seconds) please "
            "increase memory_size or tolerance."
        )
    return float(edge_t)
