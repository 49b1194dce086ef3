"""The least work of the kernels the benchmark holds to a roofline, and
the card's published peaks.

Each count is a property of the work, not of the code that does it:
the input read once, the output (and any carried state) written once,
and two operations per tap and output of every filter stage, or
2.5 nfft log2(nfft) per real FFT.  ``stages_step_cost``,
``stream_step_cost`` and ``fft_step_cost`` are frozen copies of the
program's ``tpudas_torch.ops.fir`` / ``tpudas_torch.ops.filter``
counts (a CPU test holds them equal); ``fft_window_cost`` counts one
window of the FFT engine.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(cost: dict) -> float:
    """The least time a card at the published peaks needs for
    ``cost``: the larger of bytes over bandwidth and operations over
    the float32 rate."""
    return max(cost["bytes"] / HBM_BYTES_PER_S,
               cost["flops"] / F32_FLOPS_PER_S)


def stages_step_cost(stages, sizes, T: int, C: int, in_bytes: int) -> dict:
    """One stateful step of ``stages`` ((R, taps) pairs with carry rows
    ``sizes``) over ``T`` rows of ``C`` channels of ``in_bytes``."""
    flops, rows = 0.0, int(T)
    for R, h in stages:
        rows //= int(R)
        flops += 2.0 * len(h) * rows * int(C)
    by = (int(T) * int(C) * int(in_bytes) + rows * int(C) * 4
          + 2 * sum(int(p) for p in sizes) * int(C) * 4)
    return {"flops": flops, "bytes": float(by)}


def carry_sizes(stages) -> tuple:
    """Per-stage carried rows of the stateful cascade, stage 0 padded so
    the summed lag is a whole output step."""
    sizes = [max(len(h) - int(R), 0) for R, h in stages]
    d, prod = 0, 1
    for p, (R, _h) in zip(sizes, stages):
        d += p * prod
        prod *= int(R)
    sizes[0] += (-d) % prod
    return tuple(sizes)


def stream_step_cost(stages, T: int, C: int, in_bytes: int) -> dict:
    """:func:`stages_step_cost` of the whole stateful cascade."""
    return stages_step_cost(stages, carry_sizes(stages), T, C, in_bytes)


def fft_step_cost(nfft: int, T: int, rows_carry: int, C: int,
                  in_bytes: int) -> dict:
    """One overlap-save FFT stream step over ``T`` new rows with a
    ``rows_carry`` float32 carry at transform length ``nfft``."""
    by = (int(T) * int(C) * (int(in_bytes) + 4)
          + 2 * int(rows_carry) * int(C) * 4)
    flops = int(C) * 2 * 2.5 * nfft * math.log2(max(nfft, 2))
    return {"flops": float(flops), "bytes": float(by)}


def fft_window_cost(nfft: int, T: int, n_out: int, C: int,
                    in_bytes: int) -> dict:
    """One window of the FFT engine: ``T`` rows of ``in_bytes`` read
    once, ``n_out`` float32 outputs written once, two real FFTs of
    ``nfft`` points a channel."""
    by = int(T) * int(C) * int(in_bytes) + int(n_out) * int(C) * 4
    flops = int(C) * 2 * 2.5 * nfft * math.log2(max(nfft, 2))
    return {"flops": float(flops), "bytes": float(by)}
