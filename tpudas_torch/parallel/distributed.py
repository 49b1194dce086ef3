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

A process drives only its own cards, so :func:`global_mesh_devices`
returns this process's devices: the JAX package's global mesh over every
host's devices has no counterpart here.
"""

from __future__ import annotations

import os

import torch

__all__ = ["initialize_multihost", "is_distributed", "global_mesh_devices"]

_initialized = False


def initialize_multihost(
    coordinator_address=None, num_processes=None, process_id=None,
    device=None,
):
    """Idempotent ``torch.distributed.init_process_group`` from the
    arguments or the environment (``COORDINATOR_ADDRESS`` as
    ``host:port``, ``NUM_PROCESSES``, ``PROCESS_ID``), at
    ``tcp://COORDINATOR_ADDRESS``; the backend is ``nccl`` when
    ``device`` (default: the card when there is one) is CUDA, else
    ``gloo``.  Returns True when this call joined the group, False when
    it was a no-op (already joined, or single-process)."""
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


def global_mesh_devices(device=None) -> list:
    """This process's devices, ordered for mesh construction: its cards
    (``device`` None or CUDA) or one CPU device.  A process cannot drive
    another process's card, so unlike the JAX hook this is never the
    devices of every host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]
