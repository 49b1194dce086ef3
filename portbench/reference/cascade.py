"""Plain reference of a configuration whose engine is the FIR cascade
(``edge10k``): every output sample is a fixed linear combination of the
input samples, so the reference writes that combination down.

An output at full-rate row ``c`` is ``sum_n g[n] x[c - delay + n]``,
where ``g`` is the composite full-rate filter of the cascade's stages
(:func:`portbench.yardstick.plan.composite`) and ``x`` is the samples a
window holds, zero outside it (a window filters only what it read).  A
stateful stream holds every sample since its start, with zeros before
it, and emits from the edge buffer on as far as whole output steps of
data have arrived.
"""

from __future__ import annotations

import numpy as np

from portbench.yardstick import plan as P


def _stages(cfg):
    fs = float(cfg["fs_hz"])
    dt = float(cfg["output_sample_interval"])
    ratio = int(round(dt * fs))
    return P.cascade(fs, ratio, P.corner_hz(dt), int(cfg["filter_order"]))


def window_rows(cfg, r0: int, r1: int, target_rows, target_ns, t0_ns,
                dt_ns) -> np.ndarray:
    """(len(target_rows), r1 - r0) float64: the outputs centred on full-
    rate rows ``target_rows`` of a window that holds rows [r0, r1)."""
    stages = _stages(cfg)
    g = P.composite(stages)
    d = P.delay(stages)
    out = np.zeros((len(target_rows), r1 - r0))
    for i, c in enumerate(target_rows):
        lo, hi = max(r0, c - d), min(r1, c + d + 1)
        if hi > lo:
            out[i, lo - r0:hi - r0] = g[lo - (c - d):hi - (c - d)]
    return out


def stream_emits(cfg, n_rows: int) -> tuple:
    """[first, last] grid indices a zero-started stateful stream has
    emitted once ``n_rows`` samples from the grid's start arrived."""
    buff = int(np.ceil(float(cfg["edge_buffer"])
                       / float(cfg["output_sample_interval"])))
    return buff, P.stream_last_output(_stages(cfg), n_rows)
