"""Parallel execution over a device mesh.

The port's counterpart of :mod:`tpudas.parallel`, with a process-local
mesh in place of JAX's single-controller one
(:class:`~tpudas_torch.parallel.mesh.DeviceMesh`):

- **channel sharding** (zero communication): every kernel works on each
  channel alone, so column blocks of a window or a stream block run on
  their devices with no collectives
  (:mod:`tpudas_torch.parallel.sharding`);
- **time sharding** with halo exchange: the engine's edge buffer IS a
  halo; when a window's time axis is split, neighbours copy halo rows
  device to device (:mod:`tpudas_torch.parallel.halo`,
  :mod:`tpudas_torch.parallel.pipeline`);
- **data parallelism over windows/patches**: independent windows split
  over a mesh axis (:mod:`tpudas_torch.parallel.batch`);
- **multi-host** through ``torch.distributed``
  (:mod:`tpudas_torch.parallel.distributed`).

The JAX package's ``compat.shard_map`` keyword shim has no counterpart:
the port has no ``shard_map``.
"""

from tpudas_torch.parallel.mesh import make_mesh, device_count, resolve_mesh
from tpudas_torch.parallel.sharding import shard_channels, channel_sharding
from tpudas_torch.parallel.halo import exchange_halo_time
from tpudas_torch.parallel.pipeline import sharded_lowpass_decimate
from tpudas_torch.parallel.batch import batched_rolling_mean

__all__ = [
    "make_mesh",
    "device_count",
    "resolve_mesh",
    "shard_channels",
    "channel_sharding",
    "exchange_halo_time",
    "sharded_lowpass_decimate",
    "batched_rolling_mean",
]
