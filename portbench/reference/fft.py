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

The FFT stream (``engine="fft"`` under a real-time runner) filters
block by block, and its outputs are those of the blocks, not of one
window over the whole span: the filter's tail past the edge buffer
(~2e-5 of its peak at 10 s for the order-4 response at 0.45 Hz) is
cut at every block.  :func:`stream_segments` writes the stream's
contract down as windows that :func:`window_rows` computes:

- rounds see the pool's files as the traffic links them in
  (``initial_files``, then ``files_per_poll`` a poll); a round reads
  its new rows in slices from the next row to at most
  ``max(process_patch_size, 4)`` output steps past it, both ends
  included (tpudas_torch/proc/stream.py:477, :499);
- each slice is fed after the rows left over from the feed before; a
  feed uses a whole number of 128-row quanta (stream.py:1001, :1021)
  and keeps the rest for the next;
- the used rows are split into blocks of at most ``process_patch_size``
  output steps of rows, rounded down to the quantum (stream.py:1022),
  and then a descending power-of-two split of the remaining quanta
  (``_pow2_blocks``, stream.py:771-783);
- a block of ``B`` rows from stream row ``s`` is filtered as one window
  over rows ``[s - 2 * edge_in, s + B)``, zeros before the stream,
  padded to the 5-smooth length of ``B + 2 * edge_in``
  (tpudas_torch/ops/filter.py:105, :277-287), with ``edge_in`` the edge
  buffer in input rows, rounded up (stream.py:681); the block keeps
  rows ``[s - edge_in, s - edge_in + B)`` (filter.py:287);
- each block emits the grid points from the edge buffer on
  (stream.py:682) that its kept rows reach; a grid point that lies on
  a row is that row, the lerp's other weight being 0 (stream.py:1076-
  1098).  A grid point between two rows could fall between the seam
  row kept from the block before and a block's first row, which one
  window cannot express, so a grid off the rows is refused.
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


QUANTUM = 128  # rows: tpudas_torch/proc/stream.py:1001


def _rows(cfg):
    """(output step in rows, edge buffer in outputs, edge_in rows)."""
    dt_ns = int(round(1e9 / float(cfg["fs_hz"])))
    step = P.step_ns(float(cfg["output_sample_interval"]))
    if step % dt_ns:
        raise ValueError("the FFT stream reference needs an output grid "
                         "that lands on input rows")
    buff = int(np.ceil(float(cfg["edge_buffer"])
                       / float(cfg["output_sample_interval"])))
    return step // dt_ns, buff, -(-buff * step // dt_ns)


def _pow2_blocks(n_units: int, cap: int) -> list:
    """Whole ``cap`` blocks, then a descending power-of-two split of
    the rest (stream.py:771-783)."""
    out = [cap] * (n_units // cap)
    rem = n_units % cap
    b = 1 << max(rem.bit_length() - 1, 0)
    while rem:
        if b <= rem:
            out.append(b)
            rem -= b
        b >>= 1
    return out


def _feeds(cfg, pool, traffic):
    """The rows of each slice the stream is fed, in order."""
    ratio = _rows(cfg)[0]
    slice_rows = max(int(cfg["process_patch_size"]), 4) * ratio
    rows_file, n_files = int(pool["rows_file"]), int(pool["n_files"])
    have = min(int(traffic["initial_files"]), n_files)
    nxt = 0
    while True:
        end = have * rows_file
        while nxt < end:
            hi = min(end - 1, nxt + slice_rows)
            yield hi + 1 - nxt
            nxt = hi + 1
        if have >= n_files:
            return
        have = min(n_files, have + int(traffic["files_per_poll"]))


def stream_emits(cfg, n_rows: int) -> tuple:
    """[first, last] grid indices the FFT stream has emitted once
    ``n_rows`` samples from the grid's start arrived, however they were
    fed: every whole quantum is consumed, and the last block keeps rows
    up to ``edge_in`` before the consumed end."""
    ratio, buff, edge = _rows(cfg)
    consumed = int(n_rows) - int(n_rows) % QUANTUM
    return buff, (consumed - edge - 1) // ratio


def stream_segments(cfg, pool, traffic) -> list:
    """[(r0, r1, grid indices)]: each block's window ``[s - 2 edge_in,
    s + B)`` and the grid points the block emits (none for some short
    blocks), in the stream's order over one replay of ``traffic``."""
    ratio, buff, edge = _rows(cfg)
    cap = max(1, int(cfg["process_patch_size"]) * ratio // QUANTUM)
    out, s, left, nxt = [], 0, 0, buff
    for n in _feeds(cfg, pool, traffic):
        rows = left + n
        usable = rows - rows % QUANTUM
        for units in _pow2_blocks(usable // QUANTUM, cap):
            B = units * QUANTUM
            last = (s - edge + B - 1) // ratio
            out.append((s - 2 * edge, s + B, list(range(nxt, last + 1))))
            nxt = max(nxt, last + 1)
            s += B
        left = rows - usable
    first, last = stream_emits(cfg, int(pool["rows_file"])
                               * int(pool["n_files"]))
    if [g for *_w, idx in out for g in idx] != list(range(first, last + 1)):
        raise AssertionError("the blocks' grid points are not the "
                             "stream's emitted range")
    return out
