"""Data parallelism over independent windows and patches.

The port's counterpart of :mod:`tpudas.parallel.batch`.  Windows of the
overlap-save schedule and patches of the rolling driver are independent,
so a stack of them splits over a mesh axis with no communication: each
slot of the axis takes a contiguous block of the stack, and (for the
cascade) each channel shard a column block of it.  Every slot's work is
launched before any result is gathered.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudas_torch.parallel.sharding import (
    gather_columns,
    split_columns,
    to_device,
)

__all__ = ["batched_rolling_mean", "batched_cascade_decimate"]


def _slot_devices(mesh, batch_axis, ch_axis=None) -> list:
    """``devices[b][c]``: the device of batch slot ``b`` and channel
    shard ``c`` (one shard when ``ch_axis`` is None)."""
    ib = mesh.axis_names.index(batch_axis)
    ic = None if ch_axis is None else mesh.axis_names.index(ch_axis)
    nc = 1 if ch_axis is None else int(mesh.shape[ch_axis])
    out = []
    for b in range(int(mesh.shape[batch_axis])):
        row = []
        for c in range(nc):
            index = [0] * mesh.devices.ndim
            index[ib] = b
            if ic is not None:
                index[ic] = c
            row.append(mesh.devices[tuple(index)])
        out.append(row)
    return out


def _slots(n: int, nb: int) -> list:
    """The batch slot of each of ``n`` items: contiguous blocks of
    ``ceil(n / nb)`` (the stack zero-padded to the slot multiple, as a
    sharded leading axis lies)."""
    per = -(-int(n) // int(nb))
    return [i // per for i in range(int(n))]


def batched_rolling_mean(mesh, batch, w: int, s: int, batch_axis="ch"):
    """Rolling mean over a (B, T, C) stack of windows/patches, the batch
    axis split over the mesh's ``batch_axis``.  Each patch runs the
    single-patch device reduction (the same fixed pairwise window sums
    and NaN warm-up rows), so every patch's result is byte-identical to
    its own ``rolling_reduce``.  Returns a (B, n_out, C) float32 tensor
    on the mesh's first device."""
    from tpudas_torch.ops.rolling import _reduce_window

    stack = batch if isinstance(batch, torch.Tensor) else np.asarray(batch)
    devices = _slot_devices(mesh, batch_axis)
    outs = []
    for i, b in enumerate(_slots(stack.shape[0], len(devices))):
        x = to_device(stack[i], devices[b][0])
        outs.append(_reduce_window(x.to(torch.float32), int(w), int(s),
                                   "mean"))
    dev0 = outs[0].device
    return torch.stack([o.to(dev0) for o in outs])


def batched_cascade_decimate(
    mesh, stack, plan, phase, n_out, engine="auto",
    batch_axis="time", ch_axis="ch", qscale=None,
):
    """Window-level data parallelism for the LF pipeline: a (W, T, C)
    stack of same-shape overlap-save windows, the window axis split over
    ``batch_axis`` and channels over ``ch_axis`` (pad-and-mask; a mesh
    without that axis leaves channels whole).  Every window is decimated
    with the same (plan, phase, n_out) — the steady-state schedule, where
    interior windows share one shape — by the single-device cascade on
    its slot's devices (B1 on the card), so the result equals stacking
    per-window :func:`tpudas_torch.ops.fir.cascade_decimate` outputs.
    ``qscale`` takes a raw int16 stack (one shared scale).  Returns a
    (W, n_out, C) float32 tensor on the mesh's first device."""
    from tpudas_torch.ops.fir import _dtype_of, cascade_decimate

    stack = stack if isinstance(stack, torch.Tensor) else np.asarray(stack)
    dtype = _dtype_of(stack)
    if qscale is not None:
        if dtype != torch.int16:
            raise ValueError(f"qscale given but data dtype is {stack.dtype}")
    elif dtype != torch.float32:
        stack = (stack.to(torch.float32) if isinstance(stack, torch.Tensor)
                 else stack.astype(np.float32))
    W, _T, C = (int(n) for n in stack.shape)
    if ch_axis not in mesh.shape:
        ch_axis = None
    devices = _slot_devices(mesh, batch_axis, ch_axis)
    outs = []
    for i, b in enumerate(_slots(W, len(devices))):
        outs.append([cascade_decimate(x, plan, phase, n_out, engine,
                                      qscale=qscale)
                     for x in split_columns(stack[i], devices[b])])
    dev0 = outs[0][0].device
    return torch.stack([gather_columns(p, C, device=dev0) for p in outs])
