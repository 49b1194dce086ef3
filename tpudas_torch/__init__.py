"""tpudas_torch: the PyTorch/CUDA port of tpudas.

The module layout mirrors ``tpudas/`` so each counterpart is found at
the same path, and the package exports the JAX package's names (plus
:func:`~tpudas_torch.device.resolve_device`).  The port imports torch,
numpy, scipy and the standard library only; the JAX package is its
reference, never its dependency.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"`` (see
:mod:`tpudas_torch.device`).

:mod:`tpudas_torch.compat` is the DASCore-compatible entry over this
surface.
"""

from tpudas_torch import integrity, obs, resilience, serve
from tpudas_torch.core import units
from tpudas_torch.core.mapping import FrozenDict
from tpudas_torch.core.patch import Patch
from tpudas_torch.core.timeutils import to_datetime64, to_timedelta64
from tpudas_torch.device import resolve_device
from tpudas_torch.io.spool import BaseSpool, DirectorySpool, MemorySpool, spool

__version__ = "0.8.0"

__all__ = [
    "resolve_device",
    "Patch",
    "spool",
    "integrity",
    "obs",
    "resilience",
    "serve",
    "BaseSpool",
    "MemorySpool",
    "DirectorySpool",
    "to_datetime64",
    "to_timedelta64",
    "FrozenDict",
    "units",
    "__version__",
]
