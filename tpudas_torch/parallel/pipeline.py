"""Sharded window pipeline: filter + decimate over a (time, ch) mesh.

The port's counterpart of :mod:`tpudas.parallel.pipeline`.  A window is
laid out over a (time, ch) mesh: each shard holds a time block of a
column block, receives its neighbours' halo rows
(:func:`tpudas_torch.parallel.halo.exchange_halo_time`) and filters
locally; channels need no communication at all, time one neighbour copy
of ``halo`` rows per shard.

- :func:`sharded_cascade_decimate` is the mesh form of
  :func:`tpudas_torch.ops.fir.cascade_decimate`: every shard runs the
  strided-FIR chain (B1 on the card) on its local block plus its right
  halo.  It is bit-equal to the single-device cascade for the same
  (plan, phase, n_out): rows outside the window read as zero in both
  layouts, and each output's sums read the same rows in the same order.
- :func:`sharded_lowpass_decimate` is the FFT low-pass + stride decimate
  per shard (``torch.fft``, the port's 5-smooth lengths).

Every shard's work is launched before any result is gathered, so shards
on different cards run concurrently.

Over a mesh that spans ``torch.distributed`` ranks (built from
:func:`~tpudas_torch.parallel.distributed.global_mesh_devices`), every
rank calls the function with the same arguments, cuts its own blocks,
receives its halos across ranks and runs its own shards only (B1 on the
card), as each JAX process runs its shards of a global mesh.  The
result is then a :class:`~tpudas_torch.parallel.sharding.ShardedTensor`
of this rank's output shards with their grid coordinates;
:func:`~tpudas_torch.parallel.distributed.process_allgather` gathers it
into the single-process result.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudas_torch.parallel.halo import exchange_halo_time
from tpudas_torch.parallel.sharding import ShardedTensor, to_device, zero_block

__all__ = [
    "sharded_lowpass_decimate",
    "sharded_cascade_decimate",
    "sharded_cascade_layout",
]


def _local_blocks(x, mesh, time_axis, ch_axis, r_first, t_local):
    """This rank's ``(coords, blocks)``: the block of grid entry ``(t,
    c)`` is time shard ``t`` (input rows ``r_first + t * t_local`` on) of
    column shard ``c``, on its device (every entry of a process-local
    mesh)."""
    if mesh.devices.ndim != 2:
        raise ValueError(
            f"the sharded pipeline runs a 2-D ({time_axis}, {ch_axis}) "
            f"mesh, got {mesh}")
    it, ic = mesh.axis_names.index(time_axis), mesh.axis_names.index(ch_axis)
    w = -(-int(x.shape[1]) // int(mesh.shape[ch_axis]))
    coords = mesh.local_coords()
    blocks = []
    for coord in coords:
        r0, c = r_first + coord[it] * t_local, coord[ic]
        blocks.append(to_device(
            zero_block(x, r0, r0 + t_local, c * w, (c + 1) * w),
            mesh.devices[coord]))
    return coords, blocks


def _result(mesh, outs, coords, spec, global_shape):
    """The output shards as the caller takes them: this rank's
    :class:`~tpudas_torch.parallel.sharding.ShardedTensor` over a mesh
    that spans ranks, else the global tensor on the first shard's
    device."""
    out = ShardedTensor(outs, coords=coords, spec=spec,
                        global_shape=global_shape, mesh=mesh,
                        dtype=torch.float32)
    return out if mesh.spans_ranks else out.assemble()


def _as_2d(data):
    if isinstance(data, torch.Tensor):
        return data
    return np.asarray(data)


def sharded_lowpass_decimate(
    mesh, data, d_sec, corner, ratio, halo, order=4,
    time_axis="time", ch_axis="ch",
):
    """Run the FFT low-pass + stride decimate over a (time, ch) mesh.

    ``data``: (T, C) float32 (numpy or tensor).  Returns a (T // ratio,
    C) float32 tensor on the mesh's first device: the single-device
    result up to halo truncation (callers discard ``halo`` input samples
    at each stream end).  Over a mesh that spans ranks it returns this
    rank's output shards (see the module docstring)."""
    from tpudas_torch.ops.filter import _filter_rows

    x = _as_2d(data)
    T, C = int(x.shape[0]), int(x.shape[1])
    nt = int(mesh.shape[time_axis])
    nc = int(mesh.shape[ch_axis])
    if T % nt != 0:
        raise ValueError(f"T={T} not divisible by time shards {nt}")
    t_local = T // nt
    if t_local % ratio != 0:
        raise ValueError(
            f"local block {t_local} not divisible by decimation ratio {ratio}"
        )
    if C % nc != 0:
        raise ValueError(f"C={C} not divisible by channel shards {nc}")
    if halo >= t_local:
        raise ValueError(f"halo {halo} must be < local block {t_local}")
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32)
    else:
        x = x.astype(np.float32, copy=False)
    coords, blocks = _local_blocks(x, mesh, time_axis, ch_axis, 0, t_local)
    ext = exchange_halo_time(blocks, halo, time_axis, n_shards=nt,
                             mesh=mesh, coords=coords)
    outs = [_filter_rows(e, d_sec, None, corner, order)[
        halo : halo + t_local : ratio] for e in ext]
    return _result(mesh, outs, coords, (time_axis, ch_axis), (T // ratio, C))


def sharded_cascade_layout(mesh, plan, phase, n_out, T,
                           time_axis="time", n_ch_local=1, engine="auto"):
    """(n_loc, t_local, halo) of the time-sharded cascade for a T-row
    input, or ``None`` when it does not fit (a shard's halo would exceed
    its local block: too many time shards for this window and filter).
    ``n_ch_local``/``engine`` keep the JAX signature: every stage of the
    port consumes exactly the cascade's input need, whatever the
    engine."""
    from tpudas_torch.ops.fir import cascade_input_need

    nt = int(mesh.shape[time_axis])
    ratio = int(plan.ratio)
    n_out = int(n_out)
    if n_out < 1 or nt < 1:
        return None
    # rows of the phase-shifted window (phase < delay adds left padding)
    T_shift = int(T) - (int(phase) - plan.delay)
    # the shard grid covers ALL real input rows: the last shard has no
    # right neighbour, so data past the grid would read as zeros inside
    # the tail outputs' filter support
    n_loc = max(-(-n_out // nt), -(-T_shift // (ratio * nt)))
    t_local = n_loc * ratio
    halo = cascade_input_need(plan, n_loc) - t_local
    if halo < 0 or halo > t_local:
        return None
    return n_loc, t_local, halo


def sharded_cascade_decimate(
    mesh, x, plan, phase, n_out, engine="auto",
    time_axis="time", ch_axis="ch", qscale=None,
):
    """Mesh-parallel :func:`tpudas_torch.ops.fir.cascade_decimate`: time
    split over ``time_axis`` (a one-sided halo from the right neighbour,
    sized from the cascade's exact input need) and channels over
    ``ch_axis`` (pad-and-mask).  ``x`` is a (T, C) numpy array or tensor,
    raw int16 with ``qscale``.  Returns an (n_out, C) float32 tensor on
    the mesh's first device, bit-equal to the single-device cascade, or
    ``None`` when the layout does not fit
    (:func:`sharded_cascade_layout`); the caller then shards channels
    only.  Each shard's chain starts at its own first row: the phase
    shift is applied when the window is cut into time blocks.  Over a
    mesh that spans ranks it returns this rank's output shards, which
    :func:`~tpudas_torch.parallel.distributed.process_allgather` gathers
    bit-equal to the single-device cascade."""
    from tpudas_torch.ops.fir import _dtype_of, cascade_decimate

    x = _as_2d(x)
    nt = int(mesh.shape[time_axis])
    nc = int(mesh.shape[ch_axis])
    layout = sharded_cascade_layout(
        mesh, plan, phase, int(n_out), int(x.shape[0]), time_axis,
        n_ch_local=-(-int(x.shape[1]) // nc), engine=engine,
    )
    if layout is None:
        return None
    n_loc, t_local, halo = layout
    if qscale is not None:
        if _dtype_of(x) != torch.int16:
            raise ValueError(f"qscale given but data dtype is {x.dtype}")
    elif isinstance(x, torch.Tensor):
        x = x.to(torch.float32)
    else:
        x = x.astype(np.float32, copy=False)
    C = int(x.shape[1])
    shift = int(phase) - int(plan.delay)
    coords, blocks = _local_blocks(x, mesh, time_axis, ch_axis, shift,
                                   t_local)
    ext = exchange_halo_time(blocks, halo, time_axis, n_shards=nt,
                             left=False, mesh=mesh, coords=coords)
    outs = [cascade_decimate(e, plan, plan.delay, n_loc, engine,
                             qscale=qscale) for e in ext]
    return _result(mesh, outs, coords, (time_axis, ch_axis),
                   (int(n_out), C))
