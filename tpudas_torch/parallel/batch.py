"""Data parallelism over independent windows and patches.

The port's counterpart of :mod:`tpudas.parallel.batch`.  Windows of the
overlap-save schedule and patches of the rolling driver are independent,
so a stack of them splits over a mesh axis with no communication: each
slot of the axis takes a contiguous block of the stack, and (for the
cascade) each channel shard a column block of it.  Every slot's work is
launched before any result is put together.

Over a mesh that spans ``torch.distributed`` ranks every rank calls the
function with the same stack and runs only the slots (and channel
shards) whose entries it holds: the windows of BASELINE config 5 spread
over hosts.  The result is then a
:class:`~tpudas_torch.parallel.sharding.ShardedTensor` of this rank's
``(ceil(W / slots), n_out, C_shard)`` blocks (zero past the stack's
end), which
:func:`~tpudas_torch.parallel.distributed.process_allgather` gathers
into the single-process result.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudas_torch.parallel.sharding import ShardedTensor, to_device

__all__ = ["batched_rolling_mean", "batched_cascade_decimate"]


def _slot_index(mesh, batch_axis, ch_axis=None) -> list:
    """``index[b][c]``: the grid entry of batch slot ``b`` and channel
    shard ``c`` (one shard when ``ch_axis`` is None; every other axis at
    0)."""
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
            row.append(tuple(index))
        out.append(row)
    return out


def _run_slots(mesh, n, batch_axis, ch_axis, n_ch, out_rows, run):
    """The batched functions' one body: ``run(i, c0, c1, dev)`` is item
    ``i``'s ``(out_rows, c1 - c0)`` result for the pad-and-mask columns
    ``[c0, c1)`` on ``dev``.  Each slot of ``batch_axis`` takes a
    contiguous block of ``ceil(n / slots)`` items (the stack zero-padded
    to the slot multiple, as a sharded leading axis lies), split over
    the channel shards; this rank runs the slots' channel shards it
    holds, each a ``(per, out_rows, w)`` block zero past the stack's
    end.  Returns the ``(n, out_rows, n_ch)`` tensor on the first
    shard's device, or over a mesh that spans ranks this rank's blocks.
    """
    index = _slot_index(mesh, batch_axis, ch_axis)
    per = -(-int(n) // len(index))
    w = -(-int(n_ch) // len(index[0]))
    local = set(mesh.local_coords())
    coords, parts = [], []
    for b, row in enumerate(index):
        for c, ix in enumerate(row):
            if ix not in local:
                continue
            dev = mesh.devices[ix]
            block = torch.zeros((per, int(out_rows), w), dtype=torch.float32,
                                device=dev)
            for k, i in enumerate(range(b * per, min((b + 1) * per, n))):
                block[k] = run(i, c * w, (c + 1) * w, dev)
            coords.append(ix)
            parts.append(block)
    out = ShardedTensor(parts, coords=coords, spec=(batch_axis, None, ch_axis),
                        global_shape=(n, int(out_rows), int(n_ch)),
                        mesh=mesh, dtype=torch.float32)
    return out if mesh.spans_ranks else out.assemble()


def batched_rolling_mean(mesh, batch, w: int, s: int, batch_axis="ch"):
    """Rolling mean over a (B, T, C) stack of windows/patches, the batch
    axis split over the mesh's ``batch_axis``.  Each patch runs the
    single-patch device reduction (the same fixed pairwise window sums
    and NaN warm-up rows), so every patch's result is byte-identical to
    its own ``rolling_reduce``.  Returns a (B, n_out, C) float32 tensor
    on the mesh's first device, or over a mesh that spans ranks this
    rank's blocks (see the module docstring)."""
    from tpudas_torch.ops.rolling import _reduce_window

    stack = batch if isinstance(batch, torch.Tensor) else np.asarray(batch)
    B, T, C = (int(n) for n in stack.shape)

    def run(i, _c0, _c1, dev):  # channels whole
        x = to_device(stack[i], dev).to(torch.float32)
        return _reduce_window(x, int(w), int(s), "mean")

    return _run_slots(mesh, B, batch_axis, None, C, (T - 1) // int(s) + 1,
                      run)


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
    (W, n_out, C) float32 tensor on the mesh's first device, or over a
    mesh that spans ranks this rank's blocks (see the module
    docstring)."""
    from tpudas_torch.ops.fir import _dtype_of, cascade_decimate

    stack = stack if isinstance(stack, torch.Tensor) else np.asarray(stack)
    dtype = _dtype_of(stack)
    if qscale is not None:
        if dtype != torch.int16:
            raise ValueError(f"qscale given but data dtype is {stack.dtype}")
    elif dtype != torch.float32:
        stack = (stack.to(torch.float32) if isinstance(stack, torch.Tensor)
                 else stack.astype(np.float32))
    W, T, C = (int(n) for n in stack.shape)
    if ch_axis not in mesh.shape:
        ch_axis = None

    def run(i, c0, c1, dev):
        # the shard's columns cross as they lie (no host copy of a
        # whole-width window); pad columns are made on the device
        x = to_device(stack[i][:, c0:min(c1, C)], dev)
        if x.shape[1] < c1 - c0:
            x = torch.nn.functional.pad(x, (0, c1 - c0 - x.shape[1]))
        return cascade_decimate(x, plan, phase, n_out, engine,
                                qscale=qscale)

    return _run_slots(mesh, W, batch_axis, ch_axis, C, n_out, run)
