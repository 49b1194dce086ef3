"""Halo exchange for a sharded time axis.

The port's counterpart of :mod:`tpudas.parallel.halo`.  The overlap-save
edge buffer is a halo: when the time axis of a window is split across
devices, each shard needs ``halo`` rows of its neighbours before
filtering so its outputs are seam-free.  JAX moves them with
``lax.ppermute`` inside ``shard_map``; here the shards are the tensors
this process holds, each at its grid place, and a halo whose neighbour
is held here too is a device-to-device copy of the neighbour's head or
tail rows (``tensor.to(device, non_blocking=True)``, ordered after the
neighbour's pending work by PyTorch's cross-device copy).  Boundary
shards receive zeros: the zero-padded stream-boundary semantics the
single-device path has.

Over a mesh that spans ``torch.distributed`` ranks, a halo whose
neighbour lies on another rank crosses point to point, every send and
receive of the rank posted together in one ``batch_isend_irecv`` (so two
neighbours never wait on each other), under the backend's transport
(:func:`~tpudas_torch.parallel.distributed.transport_for`: NCCL moves
CUDA tensors directly, gloo CPU tensors, a CUDA halo under gloo through
host memory).  The bytes received are counted in
``tpudas_parallel_transfer_bytes_total`` as ``halo:<transport>``; a
failed send or receive raises.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["exchange_halo_time", "fir_halo_rows"]


def fir_halo_rows(plan, n_loc: int, n_ch_local: int = 1,
                  engine: str = "auto") -> int:
    """One-sided (look-ahead) halo width, in full-rate input rows, a time
    shard must receive from its right neighbour so its ``n_loc`` local
    cascade outputs have their complete filter support: the cascade's
    exact input need for ``n_loc`` outputs
    (:func:`tpudas_torch.ops.fir.cascade_input_need`, the telescoped
    ``(k + B) * R`` of every stage) less the shard's own
    ``n_loc * ratio`` rows.  Every stage of the port consumes exactly
    that, whatever the engine or the width, so ``n_ch_local`` and
    ``engine`` only keep the JAX signature."""
    from tpudas_torch.ops.fir import cascade_input_need

    return cascade_input_need(plan, int(n_loc)) - int(n_loc) * int(plan.ratio)


def exchange_halo_time(blocks, halo: int, axis_name: str = "time",
                       n_shards: int | None = None,
                       left: bool = True, right: bool = True,
                       mesh=None, coords=None) -> list:
    """Each time shard of ``blocks`` extended with its neighbours'
    halos: the left neighbour's last ``halo`` rows before it and the
    right neighbour's first ``halo`` rows after it, zeros at the
    stream's ends.  A one-sided exchange (``left=False`` for a causal
    consumer that only looks ahead) moves half the rows.

    Without a ``mesh``, ``blocks`` is a list of ``(T_local, ...)``
    tensors in time order, each on its own device (``axis_name`` and
    ``n_shards`` keep the JAX signature; ``n_shards`` must match the
    list when given).  With one, ``blocks`` are this rank's blocks at
    the grid indices ``coords`` (default :meth:`DeviceMesh.local_coords
    <tpudas_torch.parallel.mesh.DeviceMesh.local_coords>`), and a
    block's neighbours are the entries one step along ``axis_name``, on
    whichever rank holds them."""
    blocks = list(blocks)
    if mesh is None:
        if n_shards is not None and int(n_shards) != len(blocks):
            raise ValueError(f"n_shards={n_shards} but {len(blocks)} time "
                             "shards were given")
        grid, at, coords = (len(blocks),), 0, [(i,) for i in
                                               range(len(blocks))]
        rank_of = None
    else:
        at, grid = mesh.axis_names.index(axis_name), mesh.devices.shape
        if n_shards is not None and int(n_shards) != grid[at]:
            raise ValueError(f"n_shards={n_shards} but mesh axis "
                             f"{axis_name!r} has {grid[at]} shards")
        coords = [tuple(c) for c in (mesh.local_coords() if coords is None
                                     else coords)]
        rank_of = mesh.rank_of
    if halo <= 0 or not (left or right):
        return blocks
    t_local = int(blocks[0].shape[0]) if blocks else 0
    if blocks and halo > t_local:
        raise ValueError(
            f"halo ({halo}) exceeds the local time-shard length "
            f"({t_local}); use fewer time shards or a longer block"
        )
    mine = dict(zip(coords, blocks))

    def step(ix, d):
        t = ix[at] + d
        return ix[:at] + (t,) + ix[at + 1:] if 0 <= t < grid[at] else None

    # every halo message of the whole grid, in one order every rank
    # walks: (receiving entry, side, sending entry); the message's tag is
    # its place in that order
    messages = [(ix, side, src)
                for ix in np.ndindex(*grid)
                for side, d in (("left", -1), ("right", 1))
                if (left if side == "left" else right)
                for src in (step(ix, d),) if src is not None]
    got, sends, recvs = {}, [], []
    for tag, (dst, side, src) in enumerate(messages):
        if dst in mine and src in mine:
            got[(dst, side)] = _rows(mine[src], side, halo).to(
                mine[dst].device, non_blocking=True)
        elif src in mine:
            sends.append((tag, rank_of(dst), _rows(mine[src], side, halo)))
        elif dst in mine:
            recvs.append((tag, rank_of(src), dst, side))
    if sends or recvs:
        _exchange_across_ranks(sends, recvs, mine, halo, got)
    out = []
    for coord, block in zip(coords, blocks):
        zeros = torch.zeros((halo,) + tuple(block.shape[1:]),
                            dtype=block.dtype, device=block.device)
        parts = []
        if left:
            parts.append(got.get((coord, "left"), zeros))
        parts.append(block)
        if right:
            parts.append(got.get((coord, "right"), zeros))
        out.append(torch.cat(parts, dim=0))
    return out


def _exchange_across_ranks(sends, recvs, mine, halo, got) -> None:
    """Post every cross-rank send ``(tag, peer, rows)`` and receive
    ``(tag, peer, entry, side)`` in one ``batch_isend_irecv``, wait for
    all of them, and put each received halo into ``got`` on its entry's
    device."""
    import torch.distributed as dist

    from tpudas_torch.parallel.distributed import (
        _count_rank_bytes,
        _to_wire,
        transport_for,
    )

    ops, bufs = [], []
    for tag, peer, rows in sends:
        rows = rows.contiguous()
        ops.append(dist.P2POp(dist.isend, _to_wire(rows, transport_for(rows)),
                              peer, tag=tag))
    for tag, peer, dst, side in recvs:
        like = mine[dst]
        transport = transport_for(like)
        buf = torch.empty((halo,) + tuple(like.shape[1:]), dtype=like.dtype,
                          device="cpu" if transport == "gloo-host"
                          else like.device)
        ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
        bufs.append((dst, side, buf, transport))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for dst, side, buf, transport in bufs:
        _count_rank_bytes("halo", transport, buf.numel() * buf.element_size())
        got[(dst, side)] = buf.to(mine[dst].device)


def _rows(block, side: str, halo: int):
    """The rows of ``block`` its neighbour takes as its ``side`` halo:
    the tail for the neighbour's left halo, the head for its right."""
    return block[-halo:] if side == "left" else block[:halo]
