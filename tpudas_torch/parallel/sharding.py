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
timed under the ``parallel.place`` / ``parallel.gather`` spans; bytes
received from other ranks land in the same counter, ``direction`` then
naming the kind and the transport (``halo:gloo-host``).

Over a mesh that spans ``torch.distributed`` ranks a
:class:`ShardedTensor` holds this rank's shards only, each with its grid
coordinates; :func:`shards_from_callback` (the counterpart of
``jax.make_array_from_callback``) cuts them from a host array every
rank holds, and
:func:`~tpudas_torch.parallel.distributed.process_allgather` puts the
global array back together.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span

__all__ = [
    "ChannelLayout",
    "ShardedTensor",
    "shards_from_callback",
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
    "staged_leaves",
    "is_device_resident",
    "to_device",
    "zero_block",
]


class ShardedTensor(tuple):
    """A ``(rows, C)`` array split over channels: a tuple of per-shard
    ``(rows, C / n)`` tensors, each on its shard's device.

    Placed on a mesh by grid position, it also carries ``coords`` (one
    grid index per shard), ``spec`` (the mesh axis each array dimension
    is split over, None where it is whole, as JAX's ``PartitionSpec``),
    ``global_shape`` and ``mesh``; over a mesh that spans ranks it holds
    this rank's shards only (possibly none, ``dtype`` then given)."""

    def __new__(cls, parts=(), coords=None, spec=None, global_shape=None,
                mesh=None, dtype=None):
        self = super().__new__(cls, parts)
        self.coords = None if coords is None else [tuple(c) for c in coords]
        self.spec = None if spec is None else tuple(spec)
        self.global_shape = (None if global_shape is None
                             else tuple(int(n) for n in global_shape))
        self.mesh = mesh
        self._dtype = dtype
        return self

    @property
    def shape(self) -> tuple:
        if self.global_shape is not None:
            return self.global_shape
        return (int(self[0].shape[0]),
                sum(int(s.shape[1]) for s in self))

    @property
    def dtype(self):
        return self[0].dtype if len(self) else self._dtype

    @property
    def devices(self) -> list:
        return [s.device for s in self]

    def numel(self) -> int:
        return sum(s.numel() for s in self)

    def block_offsets(self) -> list:
        """Each shard's offset along every array dimension: its grid
        index along the dimension's mesh axis (``spec``) times its
        extent there."""
        out = []
        for part, coord in zip(self, self.coords):
            out.append([
                (0 if axis is None
                 else coord[self.mesh.axis_names.index(axis)])
                * int(part.shape[d]) for d, axis in enumerate(self.spec)])
        return out

    def assemble(self, device=None):
        """The global array of a placed tensor whose shards all lie in
        this process (every shard in its grid place, trimmed to
        ``global_shape``), on ``device`` (default the first shard's)."""
        dev = self[0].device if device is None else torch.device(device)
        return _assemble(self.global_shape,
                         list(zip(self, self.block_offsets())), dev,
                         self.dtype)


def _assemble(global_shape, pieces, dev, dtype):
    """The global array from ``(block, offsets)`` pieces, trimmed to
    ``global_shape`` (pad-and-mask blocks reach past it)."""
    extent = [max(o[d] + int(p.shape[d]) for p, o in pieces)
              for d in range(len(global_shape))]
    out = torch.zeros(extent, dtype=dtype, device=dev)
    for p, o in pieces:
        out[tuple(slice(a, a + int(n)) for a, n in zip(o, p.shape))] = \
            p.to(dev)
    return out[tuple(slice(0, int(n)) for n in global_shape)].contiguous()


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


def shards_from_callback(shape, mesh, spec, callback) -> ShardedTensor:
    """The counterpart of ``jax.make_array_from_callback(shape,
    NamedSharding(mesh, P(*spec)), callback)``: this rank's shards of a
    ``shape`` array laid out by ``spec`` (one mesh axis name or None per
    dimension, each split dimension a multiple of its axis), each cut by
    ``callback(index)`` (``index`` a tuple of slices into the global
    array; a numpy array or tensor back) and placed on its device.  Every
    rank calls it with the same arguments and cuts only its own shards;
    the bytes placed are counted as ``place`` traffic."""
    shape = tuple(int(n) for n in shape)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    step = []
    for n, axis in zip(shape, spec):
        k = 1 if axis is None else int(mesh.shape[axis])
        if n % k:
            raise ValueError(
                f"dimension {n} does not split evenly over {k} shards of "
                f"mesh axis {axis!r}")
        step.append(n // k)
    coords = mesh.local_coords()
    parts = []
    with span("parallel.place", shards=len(coords)):
        for coord in coords:
            index = tuple(
                slice(None) if axis is None else slice(
                    coord[mesh.axis_names.index(axis)] * w,
                    (coord[mesh.axis_names.index(axis)] + 1) * w)
                for axis, w in zip(spec, step))
            block = callback(index)
            _count_transfer("place", int(np.asarray(block).nbytes)
                            if not isinstance(block, torch.Tensor)
                            else block.numel() * block.element_size())
            parts.append(to_device(block, mesh.devices[coord]))
    return ShardedTensor(parts, coords=coords, spec=spec, global_shape=shape,
                         mesh=mesh)


def _count_transfer(direction: str, nbytes: int) -> None:
    """Host<->device traffic of the sharded stream path (``place``,
    ``gather``): the proof that a steady round no longer round-trips the
    carry through the host.  Bytes a rank receives from other ranks are
    counted here too, as ``<kind>:<transport>`` (``halo:nccl``,
    ``allgather:gloo-host``, ...; see
    :func:`~tpudas_torch.parallel.distributed.transport_for`)."""
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


def _host_leaf(b, n_ch: int | None) -> np.ndarray:
    """One leaf as host float32, its channel axis trimmed to ``n_ch``."""
    arr = _to_host(b)
    if n_ch is not None and arr.ndim == 2 and arr.shape[1] > n_ch:
        arr = np.ascontiguousarray(arr[:, : int(n_ch)])
    return arr


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
        return tuple(_host_leaf(b, n_ch) for b in bufs)


class _PinnedPool:
    """Page-locked host buffers for :func:`staged_leaves`, shared by
    every carry save of the process.  A save takes a buffer at least as
    large as its card leaves and gives it back once its file is
    written, so saves running at once (a fleet's members, each on its
    own thread) never share one.  A buffer is allocated the first time
    a size is needed and replaced by a larger one when a save needs
    more, never shrunk: page-locking an 800 MB carry's bytes anew for
    every save would cost more than the copy saves."""

    def __init__(self):
        self._lock = threading.Lock()
        self._idle = []

    def take(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            sizes = [b.numel() for b in self._idle]
            fits = [i for i, n in enumerate(sizes) if n >= nbytes]
            if fits:
                return self._idle.pop(min(fits, key=sizes.__getitem__))
            if self._idle:  # grown: the largest idle buffer is let go
                self._idle.pop(max(range(len(sizes)),
                                   key=sizes.__getitem__))
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def give(self, buf: torch.Tensor) -> None:
        with self._lock:
            self._idle.append(buf)


_PINNED = _PinnedPool()
_STAGE_ALIGN = 4096  # each leaf's offset in the staging buffer


def _card_source(b, n_ch: int | None):
    """A leaf on CUDA cards as one tensor on its card, trimmed to
    ``n_ch`` columns (a sharded leaf's shards joined on the first
    shard's card, so its D2H is one contiguous copy); None for a leaf
    on the host."""
    if isinstance(b, ShardedTensor):
        if not len(b) or any(s.device.type != "cuda" for s in b):
            return None
        return gather_columns(b, n_ch)
    if not (isinstance(b, torch.Tensor) and b.device.type == "cuda"):
        return None
    if n_ch is not None and b.ndim == 2 and b.shape[1] > n_ch:
        b = b[:, : int(n_ch)]
    return b.detach()


@contextmanager
def staged_leaves(bufs, n_ch: int | None = None):
    """:func:`gather_leaves` through page-locked memory, for the carry
    save: yields the same host float32 arrays, byte for byte.  Each leaf
    on a CUDA card (a tensor, or a :class:`ShardedTensor` of card
    shards) is copied with ``non_blocking`` into a staging buffer from
    a process-wide pool, one sync for them all, and its array is a view
    of that buffer, valid until the block exits and the buffer goes
    back to the pool.  Host leaves (numpy after a load, tensors on the
    CPU) are used as they are.  Counted as :func:`gather_leaves` counts
    (``gather`` traffic; the caller spans it), and by path in
    ``tpudas_stream_carry_staged_bytes_total``: ``pinned`` for the card
    leaves' bytes, ``direct`` for the host leaves'."""
    moved = sum(int(b.numel()) * 4 for b in bufs if is_device_resident(b))
    if moved:
        _count_transfer("gather", moved)
    buf, out, streams = None, [], set()
    nbytes = {"pinned": 0, "direct": 0}
    try:
        srcs = [_card_source(b, n_ch) for b in bufs]
        sizes = [0 if s is None else -(-s.numel() * 4 // _STAGE_ALIGN)
                 * _STAGE_ALIGN for s in srcs]
        if any(sizes):
            buf = _PINNED.take(sum(sizes))
        try:
            off = 0
            for b, src, size in zip(bufs, srcs, sizes):
                if src is None:
                    out.append(_host_leaf(b, n_ch))
                    nbytes["direct"] += out[-1].nbytes
                    continue
                view = buf[off : off + src.numel() * 4].view(
                    torch.float32).view(src.shape)
                view.copy_(src, non_blocking=True)
                streams.add(torch.cuda.current_stream(src.device))
                out.append(view.numpy())
                nbytes["pinned"] += src.numel() * 4
                off += size
        finally:  # no copy into the buffer outlives this block
            for stream in streams:
                stream.synchronize()
        counter = get_registry().counter(
            "tpudas_stream_carry_staged_bytes_total",
            "carry leaf bytes a save wrote, by path: pinned (a card "
            "leaf's D2H through a page-locked staging buffer) or direct "
            "(a host leaf written as it is)",
            labelnames=("path",),
        )
        for path, n in nbytes.items():
            if n:
                counter.inc(n, path=path)
        yield tuple(out)
    finally:
        if buf is not None:
            _PINNED.give(buf)


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
