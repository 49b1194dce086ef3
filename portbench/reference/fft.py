"""Plain reference of a configuration whose engine is the FFT engine
(``edge10k-fft``): the reference's zero-phase Butterworth-squared
response applied to each window whole, then linear interpolation onto
the output grid.

A window of ``T`` rows is zero-padded to ``nfft``, the smallest 5-smooth
length at or above ``T``, and multiplied in the rfft domain by
``1 / (1 + (f / fc)^(2 * order))`` on that grid: a circular convolution
with the response's ``nfft``-point impulse response.  An output at
target time ``t`` is ``(1 - w) y[i] + w y[i + 1]`` of the filtered rows,
``i`` the last row at or before ``t`` (clamped to the window), ``w`` the
fraction of a step from it (clamped to [0, 1]).
"""

from __future__ import annotations

import numpy as np

from portbench.yardstick import plan as P


def window_rows(cfg, r0: int, r1: int, target_rows, target_ns, t0_ns,
                dt_ns) -> np.ndarray:
    """(len(target_ns), r1 - r0) float64: the outputs at ``target_ns``
    of a window that holds rows [r0, r1)."""
    T = r1 - r0
    nfft = P.next_5smooth(T)
    dt_s = float(cfg["output_sample_interval"])
    hc = P.fft_kernel(nfft, dt_ns / 1e9, P.corner_hz(dt_s),
                      int(cfg["filter_order"]))
    src = (t0_ns + (r0 + np.arange(T, dtype=np.int64)) * dt_ns)
    src_s = (src - src[0]) / 1e9
    dst_s = (np.asarray(target_ns, np.int64) - src[0]) / 1e9
    idx = np.clip(np.searchsorted(src_s, dst_s, side="right") - 1, 0, T - 2)
    w = np.clip((dst_s - src_s[idx]) / (src_s[idx + 1] - src_s[idx]), 0, 1)
    t = np.arange(T)
    out = np.empty((len(dst_s), T))
    for k, (i, wk) in enumerate(zip(idx, w)):
        out[k] = ((1.0 - wk) * hc[(i - t) % nfft]
                  + wk * hc[(i + 1 - t) % nfft])
    return out
