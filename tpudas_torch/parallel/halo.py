"""Halo exchange for a sharded time axis.

The port's counterpart of :mod:`tpudas.parallel.halo`.  The overlap-save
edge buffer is a halo: when the time axis of a window is split across
devices, each shard needs ``halo`` rows of its neighbours before
filtering so its outputs are seam-free.  JAX moves them with
``lax.ppermute`` inside ``shard_map``; here the shards are a list of
tensors held by one process, and a halo is a device-to-device copy of
the neighbour's head or tail rows (``tensor.to(device,
non_blocking=True)``, ordered after the neighbour's pending work by
PyTorch's cross-device copy).  Boundary shards receive zeros: the
zero-padded stream-boundary semantics the single-device path has.
"""

from __future__ import annotations

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
                       left: bool = True, right: bool = True) -> list:
    """Each time shard of ``blocks`` (a list of ``(T_local, ...)``
    tensors in time order, each on its own device) extended with its
    neighbours' halos: the left neighbour's last ``halo`` rows before it
    and the right neighbour's first ``halo`` rows after it, zeros at the
    stream's ends.  A one-sided exchange (``left=False`` for a causal
    consumer that only looks ahead) moves half the rows.  ``axis_name``
    and ``n_shards`` keep the JAX signature (``n_shards`` must match the
    list when given)."""
    blocks = list(blocks)
    if n_shards is not None and int(n_shards) != len(blocks):
        raise ValueError(
            f"n_shards={n_shards} but {len(blocks)} time shards were given")
    if halo <= 0 or not (left or right):
        return blocks
    t_local = int(blocks[0].shape[0])
    if halo > t_local:
        raise ValueError(
            f"halo ({halo}) exceeds the local time-shard length "
            f"({t_local}); use fewer time shards or a longer block"
        )
    out = []
    for i, block in enumerate(blocks):
        dev = block.device
        zeros = torch.zeros((halo,) + tuple(block.shape[1:]),
                            dtype=block.dtype, device=dev)
        parts = []
        if left:
            parts.append(blocks[i - 1][-halo:].to(dev, non_blocking=True)
                         if i > 0 else zeros)
        parts.append(block)
        if right:
            parts.append(blocks[i + 1][:halo].to(dev, non_blocking=True)
                         if i + 1 < len(blocks) else zeros)
        out.append(torch.cat(parts, dim=0))
    return out
