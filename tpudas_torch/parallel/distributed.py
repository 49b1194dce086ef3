"""Multi-host initialization hooks.

The port's counterpart of :mod:`tpudas.parallel.distributed`.  Within one
process the mesh needs no setup (:mod:`tpudas_torch.parallel.mesh`).
Across processes — one per host, or one per card — the port uses
``torch.distributed``: :func:`initialize_multihost` joins the process
group from its arguments or the environment the JAX hook reads
(``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``), over
NCCL on the card and gloo on the CPU, and is a no-op without them, so
single-process use and the CPU meshes of the tests are untouched.  The
filesystem stays the durable channel between rounds, as in the
reference's crash-only design.

A process drives only its own cards, as a JAX process drives only its
addressable devices; the global mesh is a description every process
holds.  Inside a group of more than one rank :func:`global_mesh_devices`
returns every rank's devices in rank order, each a
:class:`~tpudas_torch.parallel.mesh.RankDevice`, and a
:class:`~tpudas_torch.parallel.mesh.DeviceMesh` over them spans the
ranks: each rank runs its own shards, and the halo crosses ranks point to
point (:mod:`tpudas_torch.parallel.halo`).  :func:`process_allgather` is
the counterpart of ``multihost_utils.process_allgather``: it gathers a
rank-spanning sharded result into one tensor on every rank.

The backend's own rule sets the transport of every cross-rank tensor
(:func:`transport_for`): NCCL moves CUDA tensors directly; gloo sends
CPU tensors only, so a CUDA tensor under gloo is copied through host
memory explicitly (``"gloo-host"``).  The bytes a rank receives are
counted in ``tpudas_parallel_transfer_bytes_total`` by kind and
transport (``direction="halo:gloo-host"``, ``"allgather:nccl"``, ...).
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = [
    "initialize_multihost",
    "is_distributed",
    "global_mesh_devices",
    "process_allgather",
    "transport_for",
]

_initialized = False


def initialize_multihost(
    coordinator_address=None, num_processes=None, process_id=None,
    device=None,
):
    """Idempotent ``torch.distributed.init_process_group`` from the
    arguments or the environment (``COORDINATOR_ADDRESS`` as
    ``host:port``, ``NUM_PROCESSES``, ``PROCESS_ID``), at
    ``tcp://COORDINATOR_ADDRESS``; the backend is ``nccl`` when
    ``device`` (default: the card when there is one) is CUDA and
    ``gloo`` otherwise.  Returns True when this call joined the group,
    False when it was a no-op (already joined, or single-process)."""
    global _initialized
    if _initialized:
        return False
    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = os.environ.get("NUM_PROCESSES")
    # NB: `process_id or env` would drop process 0, the coordinator
    if process_id is None:
        process_id = os.environ.get("PROCESS_ID")
    if not coordinator_address or num_processes is None or process_id is None:
        return False
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    import torch.distributed as dist

    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )
    _initialized = True
    return True


def is_distributed() -> bool:
    """True when this process is in a process group of more than one."""
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _local_devices(device=None) -> list:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def global_mesh_devices(device=None, local_devices=None) -> list:
    """The devices a mesh is built over, ordered for mesh construction.

    Outside a group of more than one rank: this process's devices, its
    cards (``device`` None or CUDA) or one CPU device.  Inside one:
    every rank's devices in rank order, each a
    :class:`~tpudas_torch.parallel.mesh.RankDevice` tagged with its
    rank, from one ``all_gather_object`` of each rank's list (this
    process's cards, or ``local_devices`` when given: four logical CPU
    shards are ``[torch.device("cpu")] * 4``)."""
    local = ([torch.device(d) for d in local_devices]
             if local_devices is not None else _local_devices(device))
    if not is_distributed():
        return local
    import torch.distributed as dist

    from tpudas_torch.parallel.mesh import RankDevice

    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, [str(d) for d in local])
    return [RankDevice(rank, torch.device(d))
            for rank, names in enumerate(gathered) for d in names]


def transport_for(tensor) -> str:
    """How ``tensor`` crosses ranks under the group's backend: ``"nccl"``
    (a CUDA tensor, moved directly), ``"gloo"`` (a CPU tensor) or
    ``"gloo-host"`` (a CUDA tensor under gloo, copied through host
    memory).  A CPU tensor under NCCL raises: NCCL moves device memory
    only."""
    import torch.distributed as dist

    backend = str(dist.get_backend()).lower()
    if backend == "nccl":
        if tensor.device.type != "cuda":
            raise ValueError(
                f"NCCL moves CUDA tensors only, got one on {tensor.device}")
        return "nccl"
    if backend == "gloo":
        return "gloo-host" if tensor.device.type == "cuda" else "gloo"
    raise ValueError(f"unsupported torch.distributed backend {backend!r}")


def _to_wire(tensor, transport: str):
    """``tensor`` as the transport sends it: in host memory for
    ``"gloo-host"``, as it is otherwise."""
    return tensor.cpu() if transport == "gloo-host" else tensor


def _count_rank_bytes(kind: str, transport: str, nbytes: int) -> None:
    """Bytes this rank received from other ranks, in the transfer
    counter as ``<kind>:<transport>``."""
    from tpudas_torch.parallel.sharding import _count_transfer

    _count_transfer(f"{kind}:{transport}", nbytes)


def _wire_device(x, parts):
    """Where this rank's payload crosses from: its first shard's device,
    or (a rank holding no shard) the device type of ``x``'s mesh, so an
    empty payload goes over the same transport as the others' (NCCL
    takes CUDA tensors only)."""
    if parts:
        return parts[0].device
    mesh = getattr(x, "mesh", None)
    if mesh is not None and mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_allgather(x, tiled: bool = False, device=None):
    """The counterpart of ``multihost_utils.process_allgather``: a
    tensor on every rank (on ``device``, default the first local
    shard's or ``x``'s).

    - ``x`` a rank-spanning
      :class:`~tpudas_torch.parallel.sharding.ShardedTensor` (what the
      sharded pipeline and the batched functions return over a mesh that
      spans ranks): the global array, every rank's shards in their grid
      places, trimmed to its ``global_shape``; ``tiled`` changes
      nothing, as for a global JAX array;
    - ``x`` a tensor (this rank's value): every rank's, concatenated
      along axis 0 (``tiled=True``) or stacked on a new one.

    Outside an initialized group it is ``x`` itself (or its local shards
    assembled).  Inside one, a group of one rank included, each rank's
    payload crosses as one ``all_gather`` of a flat buffer under the
    backend's transport (:func:`transport_for`), counted as
    ``allgather`` bytes.  A rank that holds no shard sends an empty
    payload from its mesh's device type."""
    import torch.distributed as dist

    from tpudas_torch.parallel.sharding import ShardedTensor, _assemble

    sharded = isinstance(x, ShardedTensor) and x.coords is not None
    parts = list(x) if sharded else [x]
    wdev = _wire_device(x, parts)
    dev = wdev if device is None else torch.device(device)
    if not (dist.is_available() and dist.is_initialized()):
        if sharded:
            return x.assemble(dev)
        return x.to(dev) if tiled else x.to(dev)[None]
    world = dist.get_world_size()
    meta = [(tuple(p.shape), o) for p, o in zip(
        parts, x.block_offsets() if sharded else [None])]
    metas = [None] * world
    dist.all_gather_object(metas, meta)
    dtype = x.dtype
    flat = (torch.cat([p.reshape(-1).to(wdev) for p in parts]) if parts
            else torch.empty(0, dtype=dtype, device=wdev))
    sizes = [sum(int(np.prod(s)) for s, _o in m) for m in metas]
    transport = transport_for(flat)
    wire = _to_wire(flat, transport)
    wire = torch.nn.functional.pad(wire, (0, max(sizes) - wire.numel()))
    bufs = [torch.empty_like(wire) for _ in range(world)]
    dist.all_gather(bufs, wire.contiguous())
    rank = dist.get_rank()
    _count_rank_bytes("allgather", transport, sum(
        n for r, n in enumerate(sizes) if r != rank) * flat.element_size())
    pieces = []
    for buf, m in zip(bufs, metas):
        at = 0
        for shape, offs in m:
            n = int(np.prod(shape))
            pieces.append((buf[at:at + n].reshape(shape).to(dev), offs))
            at += n
    if sharded:
        return _assemble(x.global_shape, pieces, dev, dtype)
    blocks = [p for p, _o in pieces]
    return torch.cat(blocks) if tiled else torch.stack(blocks)
