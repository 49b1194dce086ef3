"""Device mesh construction: a (time, ch) grid of devices.

The port's counterpart of :mod:`tpudas.parallel.mesh`.  A JAX mesh is
single-controller within a process: one process holds a
``jax.sharding.Mesh`` over ``jax.devices()`` and ``shard_map`` runs one
body on every shard.  The port keeps that shape: a :class:`DeviceMesh`
is a grid of ``torch.device`` objects, a sharded array is a tuple of
per-shard tensors (each on its shard's device), and a sharded step
launches every shard's kernel before it waits on any of them, so
launches on different cards run concurrently and shards on one card go
in order on its current stream.  ``DeviceMesh.shape`` is a dict keyed by
axis name, as ``Mesh.shape`` is, so every ``mesh.shape["ch"]`` reads the
same in both packages.

Across processes the JAX mesh is multi-controller: every process holds
the same global mesh and runs only the shards on its own devices.  A
:class:`DeviceMesh` built from
:func:`tpudas_torch.parallel.distributed.global_mesh_devices` is that
mesh over ``torch.distributed`` ranks: its entries are
:class:`RankDevice` pairs, :meth:`DeviceMesh.rank_of` names the rank
holding each grid entry and :meth:`DeviceMesh.local_coords` this rank's
own.  Only the rank-aware functions of :mod:`tpudas_torch.parallel`
(the halo exchange, the sharded pipeline and the batched paths) run
over a mesh that spans ranks; every process-local consumer
(:meth:`DeviceMesh.axis_devices`, the drivers) raises on one.  A grid
whose entries all lie on this rank is a process-local mesh.

Devices: on the card :func:`make_mesh` / :func:`resolve_mesh` take
``cuda:0 .. cuda:N-1`` of this process; ``device="cpu"`` builds N
logical CPU shards (the counterpart of the JAX tests' virtual host
devices), on which the kernels' plain versions run per shard.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["CPU_SHARDS", "DeviceMesh", "RankDevice", "device_count",
           "make_mesh", "resolve_mesh", "this_rank"]

# logical CPU shards a CPU mesh may hold (the JAX tests' 8 virtual host
# devices, conftest.py)
CPU_SHARDS = 8


@dataclass(frozen=True)
class RankDevice:
    """A mesh entry on a ``torch.distributed`` rank: ``device`` is that
    rank's own device (``cuda:0`` on two ranks may be two cards)."""

    rank: int
    device: torch.device


def this_rank() -> int:
    """This process's rank in the initialized ``torch.distributed``
    group, 0 outside one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


class DeviceMesh:
    """A grid of ``torch.device`` objects with named axes.

    ``grid`` is a nested sequence (one level per axis) or a flat
    sequence, which with two axis names becomes one row: ``(time=1,
    ch=N)``.  Every device must be of one type.  A grid may name one
    device several times: ``DeviceMesh([torch.device("cuda", 0)] * 2)``
    runs two channel shards on one card, in order on its stream.  That
    layout proves the sharding code (pad-and-mask, placement, per-shard
    launches, halo copies, gather) on a one-card host; ``mesh=N`` and
    ``TPUDAS_MESH=N`` never build it (they take N distinct cards).

    Entries given as :class:`RankDevice` pairs (every entry, or none)
    place the grid over ranks: ``ranks`` holds each entry's rank, and a
    mesh with an entry on another rank :attr:`spans_ranks`."""

    def __init__(self, grid, axis_names=("time", "ch")):
        axis_names = tuple(axis_names)
        given = np.asarray(grid, dtype=object)
        flat = list(given.reshape(-1))
        tagged = [isinstance(d, RankDevice) for d in flat]
        if any(tagged) and not all(tagged):
            raise ValueError(
                "a device mesh's entries are all RankDevice pairs or none")
        rows = np.empty(given.shape, dtype=object)
        rows.reshape(-1)[:] = [torch.device(d.device if t else d)
                               for d, t in zip(flat, tagged)]
        ranks = np.asarray([d.rank if t else -1 for d, t in zip(flat, tagged)],
                           dtype=np.int64).reshape(given.shape)
        if rows.ndim == 1 and len(axis_names) == 2:
            rows = rows.reshape(1, -1)
            ranks = ranks.reshape(1, -1)
        if rows.ndim != len(axis_names):
            raise ValueError(
                f"a {rows.ndim}-D device grid needs {rows.ndim} axis "
                f"names, got {axis_names}"
            )
        if rows.size == 0:
            raise ValueError("a device mesh needs at least one device")
        types = {d.type for d in rows.reshape(-1)}
        if len(types) != 1:
            raise ValueError(f"a device mesh holds one device type, got {types}")
        self.devices = rows
        # -1: an entry of this process (no rank given)
        self.ranks = ranks
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, (int(n) for n in rows.shape)))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_type(self) -> str:
        return self.devices.reshape(-1)[0].type

    @property
    def spans_ranks(self) -> bool:
        """True when an entry lies on another ``torch.distributed`` rank
        than this process's."""
        tagged = self.ranks[self.ranks >= 0]
        return bool((tagged != this_rank()).any())

    def rank_of(self, index) -> int:
        """The rank holding grid entry ``index`` (a tuple of axis
        indices): this process's rank for an untagged entry."""
        r = int(self.ranks[tuple(index)])
        return this_rank() if r < 0 else r

    def local_coords(self) -> list:
        """The grid indices of this rank's entries, in grid order."""
        me = this_rank()
        return [tuple(int(i) for i in ix)
                for ix in np.ndindex(*self.devices.shape)
                if int(self.ranks[ix]) in (-1, me)]

    def require_local(self, what: str) -> None:
        """Raise the ``ValueError`` every process-local consumer gives a
        mesh that :attr:`spans_ranks`, naming ``what`` and the mesh."""
        if self.spans_ranks:
            raise ValueError(
                f"{what} runs a process-local mesh, and {self!r} spans "
                "torch.distributed ranks (as a JAX driver refuses an "
                "array spanning other processes); over such a mesh run "
                "tpudas_torch.parallel.pipeline.sharded_cascade_decimate "
                "/ sharded_lowpass_decimate or the batched functions of "
                "tpudas_torch.parallel.batch"
            )

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, every other axis at index 0 (the
        layout a channel split over ``axis`` places its shards on).  A
        process-local accessor: it raises on a mesh that spans ranks."""
        self.require_local("a channel-sharded step")
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return list(self.devices[tuple(index)])

    def unique_devices(self) -> list:
        """The distinct devices of the grid, in grid order (process-local,
        as :meth:`axis_devices`)."""
        self.require_local("a sharded step")
        out = []
        for d in self.devices.reshape(-1):
            if d not in out:
                out.append(d)
        return out

    def __repr__(self):
        grid = [str(d) for d in self.devices.reshape(-1)]
        if (self.ranks >= 0).any():
            grid = [f"{r}:{d}" for r, d in zip(self.ranks.reshape(-1), grid)]
        return f"DeviceMesh({self.shape}, devices={grid})"


def _available(device=None) -> list:
    """The devices a mesh of ``device``'s type may take: this process's
    cards, or :data:`CPU_SHARDS` logical CPU shards."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * CPU_SHARDS
    if dev.type != "cuda":
        raise ValueError(
            f"tpudas_torch runs on 'cuda' or 'cpu', got {str(dev)!r}")
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_count(device=None) -> int:
    """Devices a mesh may span: this process's cards (``device`` None or
    CUDA; 0 without one), or the logical CPU shards for ``"cpu"``."""
    return len(_available(device))


def make_mesh(n_devices=None, time_shards=1, axis_names=("time", "ch"),
              device=None) -> DeviceMesh:
    """A 2-D (time, channel) mesh over the first ``n_devices`` devices
    (default: all of them) of ``device``'s type (default the cards).

    ``time_shards=1`` gives pure channel sharding, the zero-communication
    layout.  Raise ``time_shards`` to shard long windows along time (a
    halo then crosses between time neighbours)."""
    devices = _available(device)
    if n_devices is not None:
        n = int(n_devices)
        if n > len(devices):
            raise ValueError(
                f"mesh={n} exceeds the {len(devices)} available devices")
        devices = devices[:n]
    n = len(devices)
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' for a mesh of "
            "logical CPU shards")
    if n % time_shards != 0:
        raise ValueError(
            f"time_shards={time_shards} must divide device count {n}"
        )
    nc = n // time_shards
    return DeviceMesh([devices[t * nc : (t + 1) * nc]
                       for t in range(time_shards)], axis_names)


def resolve_mesh(mesh=None, env="TPUDAS_MESH", device=None):
    """Driver-facing mesh resolution: the one place ``mesh=`` /
    ``TPUDAS_MESH=N`` turn into a :class:`DeviceMesh`.

    - a ``DeviceMesh``: returned as it is;
    - an int ``N`` (or ``TPUDAS_MESH=N`` when ``mesh is None``): a pure
      channel-sharding mesh over the first N devices of ``device``'s type
      (:func:`make_mesh` with ``time_shards=1``);
    - ``None`` / ``0`` / ``1``: no mesh (single-device execution).

    Also sets the ``tpudas_parallel_shards`` gauge to the resolved
    channel-shard count (1 when unsharded).  A mesh that spans
    ``torch.distributed`` ranks raises: the drivers run process-local
    meshes."""
    if mesh is None:
        raw = os.environ.get(env, "").strip()
        if raw:
            mesh = int(raw)
    if isinstance(mesh, (int, np.integer)) and not isinstance(mesh, bool):
        n = int(mesh)
        if n < 0:
            raise ValueError(f"mesh device count must be >= 0, got {n}")
        avail = device_count(device)
        if n > avail:
            raise ValueError(
                f"mesh={n} exceeds the {avail} available devices"
            )
        mesh = None if n in (0, 1) else make_mesh(n, device=device)
    if mesh is not None:
        mesh.require_local("the driver")
    from tpudas_torch.obs.registry import get_registry

    get_registry().gauge(
        "tpudas_parallel_shards",
        "channel shards of the active mesh (1 = unsharded)",
    ).set(1 if mesh is None else int(mesh.shape.get("ch", 1)))
    return mesh
