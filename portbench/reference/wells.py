"""Plain reference of a multi-well configuration (``multiwell50k``):
each well is its own zero-started stateful cascade stream over its own
files, so each well's outputs are the cascade reference's
(:mod:`cascade`, loaded by its file beside this one) over that
well's rows alone.

The pool's ``pool_files`` contiguous files are split in order among
``wells`` wells: well ``k`` owns files ``[k * per, (k + 1) * per)``
(``per = pool_files // wells``), starts at its first file's first
sample, and emits on its own 1 s grid, which is the pool's grid shifted
by the well's first row.  ``window_rows`` is zero outside ``[r0, r1)``,
which is exactly a stream that starts from zeros at ``r0``.
"""

from __future__ import annotations

import os

from portbench.yardstick.reference import load_engine_reference

_CASCADE = load_engine_reference(
    "cascade", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
window_rows = _CASCADE.window_rows


def stream_segments(cfg, pool, traffic) -> list:
    """[(r0, r1, grid indices)], one a well: the well's rows of the
    pool, and the pool-grid indices its stream emits (from its start
    plus the edge buffer, as far as whole output steps of its rows
    arrived)."""
    wells = int(cfg["wells"])
    n_files = int(pool["n_files"])
    if wells < 1 or n_files % wells:
        raise ValueError(f"{n_files} pool files do not split among "
                         f"{wells} wells")
    rows = n_files // wells * int(pool["rows_file"])
    step_ns = int(round(float(cfg["output_sample_interval"]) * 1e9))
    if (rows * int(pool["dt_ns"])) % step_ns:
        raise ValueError("a well's start is not on the output grid")
    grid_per_well = rows * int(pool["dt_ns"]) // step_ns
    first, last = _CASCADE.stream_emits(cfg, rows)
    return [(k * rows, (k + 1) * rows,
             list(range(k * grid_per_well + first,
                        k * grid_per_well + last + 1)))
            for k in range(wells)]
