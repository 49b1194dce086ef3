"""DASCore-compatible API over the port: the counterpart of the repo's
``dascore/`` shim, with its names, backed by :mod:`tpudas_torch`."""

from tpudas_torch import (
    Patch,
    __version__,
    spool,
    to_datetime64,
    to_timedelta64,
)
from tpudas_torch.compat.dascore import units, utils

__all__ = [
    "Patch",
    "spool",
    "to_datetime64",
    "to_timedelta64",
    "units",
    "utils",
    "__version__",
]
