"""FFT sizing: the JAX package's 5-smooth lengths.

A verbatim copy of ``tpudas/ops/fftlen.py``.  There the 5-smooth length
was forced by the TPU (XLA's TPU FFT fell back to an O(n^2) DFT matmul
for lengths with larger prime factors).  cuFFT has no such cliff, but
the port pads to the same ``nfft`` all the same: the filter's response
is sampled on the rfft grid of that length, so the same ``nfft`` is what
makes the port's output equal the JAX package's.  Lengths friendlier to
cuFFT are later work, behind a switch.
"""

from __future__ import annotations

__all__ = ["next_tpu_fft_len"]

_cache: dict[int, int] = {}


def _is_5smooth(n: int) -> bool:
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def next_tpu_fft_len(n: int) -> int:
    """Smallest 5-smooth (2^a * 3^b * 5^c) integer >= n."""
    n = int(n)
    if n <= 1:
        return 1
    hit = _cache.get(n)
    if hit is not None:
        return hit
    # search upward from n; 5-smooth numbers are dense enough (<6% gaps)
    m = n
    while not _is_5smooth(m):
        m += 1
    _cache[n] = m
    return m
