"""Channel-axis sharding: the zero-communication layout.

The port's counterpart of :mod:`tpudas.parallel.sharding`.  Every kernel
of the port works on each channel alone, so a ``(time, channel)`` block
split into column blocks over a mesh's ``ch`` axis runs each shard's
kernels with no communication at all.  A sharded array is a
:class:`ShardedTensor`: a tuple of per-shard ``(rows, C_local)`` tensors,
shard ``i`` on the ``i``-th device of the ``ch`` axis.

Non-divisible channel counts take the **pad-and-mask** layout: the
channel axis is zero-padded up to a multiple of the shard count before
placement, and the pad columns are dropped when a result is gathered
(:func:`pad_channels`, the ``n_ch`` trim of :func:`gather_leaves`).
Zero columns are exact for every kernel of the port (channels are
independent, and a zero column stays zero through the linear filters),
so padded carry state trims back to the bytes of an unsharded run.

Host <-> device traffic of the sharded stream path is counted in
``tpudas_parallel_transfer_bytes_total{direction="place"|"gather"}`` and
timed under the ``parallel.place`` / ``parallel.gather`` spans.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span

__all__ = [
    "ChannelLayout",
    "ShardedTensor",
    "channel_sharding",
    "shard_channels",
    "column_shards",
    "split_columns",
    "channel_pad",
    "pad_channels",
    "place_block",
    "place_carry_leaves",
    "gather_leaves",
    "gather_columns",
    "is_device_resident",
    "to_device",
    "zero_block",
]


class ShardedTensor(tuple):
    """A ``(rows, C)`` array split over channels: a tuple of per-shard
    ``(rows, C / n)`` tensors, each on its shard's device."""

    __slots__ = ()

    @property
    def shape(self) -> tuple:
        return (int(self[0].shape[0]),
                sum(int(s.shape[1]) for s in self))

    @property
    def dtype(self):
        return self[0].dtype

    @property
    def devices(self) -> list:
        return [s.device for s in self]

    def numel(self) -> int:
        return sum(s.numel() for s in self)


@dataclass(frozen=True)
class ChannelLayout:
    """How a ``(time, channel)`` array lies on a mesh: time whole on
    every shard, channels split in equal column blocks over ``devices``
    (the ``ch_axis`` of the mesh).  The port has no ``NamedSharding``:
    this descriptor is what :func:`channel_sharding` returns in its
    place.  ``spec`` spells the layout as JAX's ``P(None, ch_axis)``."""

    devices: tuple
    ch_axis: str = "ch"

    @property
    def spec(self) -> tuple:
        return (None, self.ch_axis)


def _count_transfer(direction: str, nbytes: int) -> None:
    """Host<->device traffic of the sharded stream path: the proof that
    a steady round no longer round-trips the carry through the host."""
    get_registry().counter(
        "tpudas_parallel_transfer_bytes_total",
        "bytes explicitly moved between host and the mesh by the "
        "sharded streaming path",
        labelnames=("direction",),
    ).inc(int(nbytes), direction=direction)


def channel_sharding(mesh, ch_axis="ch") -> ChannelLayout:
    """The layout of a (time, channel) array on ``mesh``: time whole,
    channels split over every device of ``ch_axis``."""
    return ChannelLayout(tuple(mesh.axis_devices(ch_axis)), ch_axis)


def _padded_nbytes(x, pad: int) -> int:
    """Bytes of ``x`` with ``pad`` zero columns appended (the width a
    block is placed at)."""
    shape = tuple(np.shape(x))
    item = (x.element_size() if isinstance(x, torch.Tensor)
            else np.asarray(x).dtype.itemsize)
    return int(np.prod(shape[:-1])) * (shape[-1] + pad) * item


def zero_block(x, r0: int, r1: int, c0: int, c1: int):
    """Rows ``[r0, r1)`` and columns ``[c0, c1)`` of the (T, C) numpy
    array or tensor ``x``, zero outside it (the pad-and-mask layout and
    the stream's zero boundary), in ``x``'s dtype and place."""
    T, C = int(x.shape[0]), int(x.shape[1])
    shape = (r1 - r0, c1 - c0)
    if isinstance(x, torch.Tensor):
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    else:
        out = np.zeros(shape, dtype=x.dtype)
    a, b = max(r0, 0), min(r1, T)
    cb = min(c1, C)
    if a < b and c0 < cb:
        out[a - r0 : b - r0, : cb - c0] = x[a:b, c0:cb]
    return out


def to_device(block, dev):
    """A block as a contiguous tensor on ``dev``."""
    if isinstance(block, torch.Tensor):
        return block.contiguous().to(dev, non_blocking=True)
    return torch.from_numpy(np.ascontiguousarray(block)).to(dev)


def split_columns(x, devices) -> ShardedTensor:
    """Block ``i`` of ``ceil(C / n)`` columns of the (T, C) numpy array
    or tensor ``x`` on ``devices[i]``, zero past column C (pad-and-mask).
    Consecutive blocks on one device cross to it as one copy of their
    column range (the whole window when every shard shares one card),
    padded and split there."""
    n, C = len(devices), int(x.shape[1])
    w = -(-C // n)
    out, i = [], 0
    while i < n:
        j = i
        while j + 1 < n and devices[j + 1] == devices[i]:
            j += 1
        c0, c1 = i * w, (j + 1) * w
        part = to_device(x[:, c0 : min(c1, C)], devices[i])
        if part.shape[1] < c1 - c0:
            part = torch.nn.functional.pad(part, (0, c1 - c0 - part.shape[1]))
        out.extend(part[:, k * w : (k + 1) * w].contiguous()
                   for k in range(j - i + 1))
        i = j + 1
    return ShardedTensor(out)


def column_shards(x, mesh, ch_axis="ch") -> ShardedTensor:
    """The pad-and-mask column blocks of a (T, C) numpy array or tensor,
    each on its device of the mesh's ``ch_axis``: how the window path
    lays a window on the mesh (its transfer is the window's own, so it
    is neither counted nor spanned as stream placement)."""
    return split_columns(x, mesh.axis_devices(ch_axis))


def shard_channels(array, mesh, ch_axis="ch") -> ShardedTensor:
    """Place a (T, C) array (numpy or tensor, C a multiple of the shard
    count) with channels split over the mesh's ``ch_axis``, each column
    block moved to its device."""
    devices = mesh.axis_devices(ch_axis)
    C = int(np.shape(array)[1])
    if C % len(devices):
        raise ValueError(
            f"{C} channels do not split evenly over {len(devices)} shards "
            "(pad_channels first)"
        )
    return split_columns(array, devices)


def channel_pad(n_ch: int, mesh, ch_axis="ch") -> int:
    """Zero columns appended to an ``n_ch``-channel array so the channel
    axis splits evenly over the mesh (pad-and-mask layout)."""
    return -int(n_ch) % int(mesh.shape[ch_axis])


def pad_channels(x, mesh, ch_axis="ch"):
    """Zero-pad the channel axis (the last axis) of ``x`` to the shard
    multiple: numpy pads on the host, a tensor on its device.  An
    already divisible ``x`` is returned as it is."""
    pad = channel_pad(np.shape(x)[-1], mesh, ch_axis)
    if not pad:
        return x
    if isinstance(x, torch.Tensor):
        return torch.nn.functional.pad(x, (0, pad))
    widths = [(0, 0)] * (np.ndim(x) - 1) + [(0, pad)]
    return np.pad(x, widths)


def place_block(x, mesh, ch_axis="ch", keep_dtype=False) -> ShardedTensor:
    """Pad-and-place one (T, C) input block for the sharded stream step:
    channels split over ``ch_axis``, time whole, under the
    ``parallel.place`` span and counted as ``place`` traffic.

    ``keep_dtype=True`` places the block in its own dtype (raw int16:
    half the bytes; dequantization happens in the shard's step); the
    default converts to float32."""
    with span("parallel.place", rows=int(np.shape(x)[0])):
        if isinstance(x, torch.Tensor):
            host = x if keep_dtype else x.to(torch.float32)
        else:
            host = np.asarray(x) if keep_dtype else np.asarray(x, np.float32)
        # counted at the padded width, as the JAX package places it; the
        # pad columns are made on the device
        _count_transfer("place", _padded_nbytes(
            host, channel_pad(np.shape(host)[1], mesh, ch_axis)))
        return column_shards(host, mesh, ch_axis)


def place_carry_leaves(bufs, mesh, ch_axis="ch") -> tuple:
    """Pad-and-place a tuple of per-stage carry leaves ((p_i, C) each,
    numpy or tensors) onto the mesh as float32 — once, at stream open or
    resume; after that the leaves stay on the devices (the sharded step
    returns sharded leaves, and the driver gathers only on its save
    cadence)."""
    with span("parallel.place", leaves=len(bufs)):
        out = []
        for b in bufs:
            if isinstance(b, torch.Tensor):
                leaf = b.to(torch.float32)
            else:
                leaf = np.asarray(b, np.float32)
            _count_transfer("place", _padded_nbytes(
                leaf, channel_pad(np.shape(leaf)[1], mesh, ch_axis)))
            out.append(column_shards(leaf, mesh, ch_axis))
        return tuple(out)


def is_device_resident(x) -> bool:
    """True for a tensor or a :class:`ShardedTensor` (what the stream
    step returns), False for host numpy: what the save cadence counts as
    a gather rather than a no-op copy."""
    return isinstance(x, (torch.Tensor, ShardedTensor))


def _to_host(b) -> np.ndarray:
    if isinstance(b, ShardedTensor):
        return np.concatenate(
            [s.detach().to("cpu", torch.float32).numpy() for s in b], axis=1)
    if isinstance(b, torch.Tensor):
        return b.detach().to("cpu", torch.float32).numpy()
    return np.asarray(b, np.float32)


def gather_leaves(bufs, n_ch: int | None = None) -> tuple:
    """Gather a tuple of (possibly sharded, possibly pad-and-masked)
    carry leaves to host numpy float32, trimming the channel axis to the
    logical ``n_ch``: the serialization form, byte-identical to the
    leaves an unsharded run carries.  Device leaves are counted as
    ``gather`` traffic, under the ``parallel.gather`` span."""
    moved = sum(int(b.numel()) * 4 for b in bufs if is_device_resident(b))
    with span("parallel.gather", leaves=len(bufs)):
        if moved:
            _count_transfer("gather", moved)
        out = []
        for b in bufs:
            arr = _to_host(b)
            if n_ch is not None and arr.ndim == 2 and arr.shape[1] > n_ch:
                arr = np.ascontiguousarray(arr[:, : int(n_ch)])
            out.append(arr)
        return tuple(out)


def gather_columns(parts, n_ch: int | None = None, device=None):
    """One tensor from per-shard column blocks (a :class:`ShardedTensor`
    or a list of tensors), on ``device`` (default the first shard's),
    trimmed to ``n_ch`` columns: how a sharded step hands its
    (decimated, small) output to the caller."""
    parts = list(parts)
    dev = parts[0].device if device is None else torch.device(device)
    out = (torch.cat([p.to(dev) for p in parts], dim=1)
           if len(parts) > 1 else parts[0].to(dev))
    if n_ch is not None and out.shape[1] > n_ch:
        out = out[:, : int(n_ch)].contiguous()
    return out
