"""Storage/IO layer: dasdae HDF5 and tdas files, directory index, spools.

The port's counterpart of :mod:`tpudas.io`: format-dispatched
read/write (``patch.io.write(path, "dasdae")`` — lf_das.py:232) and
directory spool indexing (``dc.spool(path).update()`` —
low_pass_dascore.ipynb:78).  IO is host-side; the engine moves each
assembled window to the card in one transfer.
"""

from tpudas_torch.io.spool import spool, BaseSpool, MemorySpool, DirectorySpool
from tpudas_torch.io.registry import write_patch, read_file, scan_file

__all__ = [
    "spool",
    "BaseSpool",
    "MemorySpool",
    "DirectorySpool",
    "write_patch",
    "read_file",
    "scan_file",
]
