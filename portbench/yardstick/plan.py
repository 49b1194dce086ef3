"""What the low-pass product is, worked out afresh for the reference
and the cost counts: the output grid, the overlap-save window schedule,
the cascade's taps, the FFT engine's response, and which outputs a
stateful stream emits.

These are the semantics of the reference engine (``LFProc`` of
lf_das.py:182-295) as the program implements them: a millisecond
output grid from the job's start, windows that overlap by twice the
edge buffer and emit their interiors, a zero-phase response of
``1 / (1 + (f / fc)^(2 * order))`` at ``fc`` = 0.9 x the output
Nyquist, a multistage cascade of odd-length FIR stages designed to that
response (Kaiser guard stages, a frequency-sampled last stage), and an
FFT engine that applies the response on a 5-smooth grid and lands on
the output grid by linear interpolation.  The design code is frozen
here; a CPU test holds it to the program's own.
"""

from __future__ import annotations

import functools
import math

import numpy as np


def step_ns(dt_seconds: float) -> int:
    """The output grid step: whole milliseconds (lf_das.py:255)."""
    return int(dt_seconds * 1000) * 1_000_000


def time_grid(bg_ns: int, ed_ns: int, dt_seconds: float) -> np.ndarray:
    """``arange(bg, ed, step)`` in integer nanoseconds."""
    return np.arange(int(bg_ns), int(ed_ns), step_ns(dt_seconds),
                     dtype=np.int64)


def schedule_windows(n_grid: int, patch_size: int, buff_size: int) -> list:
    """The overlap-save schedule: (sel_lo, sel_hi, emit_lo, emit_hi)
    grid indices; a window reads [grid[sel_lo], grid[sel_hi]] and
    emits grid[emit_lo:emit_hi]."""
    windows = []
    if n_grid < 2:
        return windows
    patch_size = min(patch_size, n_grid - 1)
    if patch_size <= 2 * buff_size:
        raise ValueError("patch size must exceed twice the edge buffer")
    windows.append((0, patch_size, buff_size, patch_size - buff_size))
    end = patch_size
    nxt = end + patch_size - 2 * buff_size
    while nxt < n_grid:
        windows.append((end - 2 * buff_size, nxt, end - buff_size,
                        nxt - buff_size))
        end, nxt = nxt, nxt + patch_size - 2 * buff_size
    if n_grid - end > 1:
        nxt = n_grid - 1
        windows.append((end - 2 * buff_size, nxt, end - buff_size,
                        nxt - buff_size))
    return windows


def rows_between(t_lo_ns, t_hi_ns, t0_ns, dt_ns, n_rows) -> tuple:
    """[lo, hi) rows of a contiguous record whose times lie in the
    closed interval [t_lo, t_hi]."""
    lo = max(0, -(-(int(t_lo_ns) - t0_ns) // dt_ns))
    hi = min(n_rows, (int(t_hi_ns) - t0_ns) // dt_ns + 1)
    return int(lo), int(max(lo, hi))


def corner_hz(dt_seconds: float) -> float:
    """0.9 x the output Nyquist (lf_das.py:223)."""
    return 1.0 / float(dt_seconds) / 2.0 * 0.9


def butter2(f, corner, order):
    """The zero-phase Butterworth-squared magnitude."""
    f = np.asarray(f, np.float64)
    return 1.0 / (1.0 + (f / float(corner)) ** (2 * int(order)))


# -- the cascade --------------------------------------------------------


def factor_ratio(ratio: int) -> list:
    """Stage factors in [2, 8], largest first."""
    out, rem = [], int(ratio)
    while rem > 1:
        for f in (8, 7, 6, 5, 4, 3, 2):
            if rem % f == 0:
                out.append(f)
                rem //= f
                break
        else:
            raise ValueError(f"ratio {ratio} has a prime factor above 8")
    return sorted(out, reverse=True)


def _guard_taps(fs_in, R, f_keep):
    from scipy.signal import firwin, kaiserord

    stop = fs_in / R - f_keep
    width = max(stop - f_keep, 0.05 * fs_in / R)
    numtaps, beta = kaiserord(80.0, width / (0.5 * fs_in))
    numtaps = max(numtaps, 9)
    numtaps += 1 - numtaps % 2
    return firwin(numtaps, 0.5 * (f_keep + stop), window=("kaiser", beta),
                  fs=fs_in).astype(np.float32)


def _response(taps, fs, freqs):
    n = np.arange(len(taps), dtype=np.float64) - (len(taps) - 1) / 2.0
    ang = 2.0 * np.pi * np.asarray(freqs, np.float64)[:, None] * n / fs
    return np.cos(ang) @ np.asarray(taps, np.float64)


def _matched_taps(fs_l, corner, order, guards):
    nfft = 16384
    freqs = np.arange(nfft // 2 + 1, dtype=np.float64) * fs_l / nfft
    desired = butter2(freqs, corner, order)
    g = np.ones_like(freqs)
    for taps, fs_i in guards:
        g = g * _response(taps, fs_i, freqs)
    g = np.clip(g, 1e-3, None)
    d = np.where(desired > 1e-8, desired / g, 0.0)
    h_full = np.fft.irfft(d, n=nfft)
    h_c = np.concatenate([h_full[nfft // 2:], h_full[:nfft // 2]])
    center = nfft // 2
    mag = np.abs(h_c)
    above = np.nonzero(mag > mag.max() * 1e-6)[0]
    half = int(max(center - above[0], above[-1] - center, 4))
    taps = min(2 * half + 1, 4095)
    taps += 1 - taps % 2
    half = taps // 2
    h = h_c[center - half:center + half + 1].copy()
    s = h.sum()
    if s != 0:
        h *= d[0] / s
    return h.astype(np.float32)


@functools.lru_cache(maxsize=16)
def cascade(fs_in: float, ratio: int, corner: float, order: int) -> tuple:
    """((R, float32 taps), ...) of the decimating cascade."""
    factors = factor_ratio(ratio)
    f_keep = 0.5 * fs_in / ratio
    stages, guards, fs = [], [], float(fs_in)
    for R in factors[:-1]:
        h = _guard_taps(fs, R, f_keep)
        stages.append((R, h))
        guards.append((h, fs))
        fs /= R
    stages.append((factors[-1] if factors else 1,
                   _matched_taps(fs, corner, order, guards)))
    return tuple(stages)


def delay(stages) -> int:
    """Composite group delay in full-rate samples."""
    d, prod = 0, 1
    for R, h in stages:
        d += (len(h) // 2) * prod
        prod *= int(R)
    return d


def composite(stages) -> np.ndarray:
    """The full-rate float64 filter the cascade applies: stage taps
    upsampled by the rate they run at, convolved (length 2*delay+1)."""
    g, prod = np.ones(1), 1
    for R, h in stages:
        up = np.zeros(prod * (len(h) - 1) + 1)
        up[::prod] = np.asarray(h, np.float64)
        g = np.convolve(g, up)
        prod *= int(R)
    return g


def stream_lag_outputs(stages) -> int:
    """Outputs a zero-started carried cascade spends warming up: the
    summed carry rows (each stage keeps ``len(taps) - R`` rows), padded
    to a whole output step."""
    ratio = math.prod(int(R) for R, _ in stages)
    d, prod = 0, 1
    for R, h in stages:
        d += max(len(h) - int(R), 0) * prod
        prod *= int(R)
    return -(-d // ratio)


def stream_last_output(stages, n_rows: int) -> int:
    """Index (on the grid from the first sample) of the last output a
    stateful stream emits once ``n_rows`` samples have arrived: the
    stream feeds ``delay`` zero rows ahead of the data and emits whole
    output steps only."""
    ratio = math.prod(int(R) for R, _ in stages)
    total = (delay(stages) + int(n_rows)) // ratio
    return total - 1 - stream_lag_outputs(stages)


# -- the FFT engine ------------------------------------------------------


def next_5smooth(n: int) -> int:
    """Smallest 2^a 3^b 5^c >= n."""
    m = max(int(n), 1)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def fft_kernel(nfft: int, d_sec: float, corner: float, order: int):
    """The circular impulse response (float64, ``nfft`` points) of the
    response sampled on the rfft grid of ``nfft`` points."""
    f = np.arange(nfft // 2 + 1, dtype=np.float64) / (nfft * float(d_sec))
    return np.fft.irfft(butter2(f, corner, order), n=nfft)
