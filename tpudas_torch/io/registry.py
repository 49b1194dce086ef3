"""Format dispatch for patch IO.

The port's copy of :mod:`tpudas.io.registry`: the reference's
format-dispatched write call (``patch.io.write(path, "dasdae")`` —
lf_das.py:232) and DASCore's format-agnostic read (``dc.spool(path)``
accepts any supported file, lf_das.py:215): when no format is given,
reads sniff the file's magic bytes.
"""

from __future__ import annotations

from tpudas_torch.io import dasdae, tdas

_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"

_FORMATS = {
    "dasdae": (dasdae.read_dasdae, dasdae.write_dasdae, dasdae.scan_dasdae),
    "tdas": (tdas.read_tdas, tdas.write_tdas, tdas.scan_tdas),
}

# ordered (name, predicate-over-head-bytes); first match wins
_SNIFFERS = [
    ("tdas", lambda head: head[:4] == b"TDAS"),
    ("dasdae", lambda head: head[: len(_HDF5_MAGIC)] == _HDF5_MAGIC),
]


def _resolve(name):
    try:
        return _FORMATS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown IO format {name!r}; known: {sorted(_FORMATS)}"
        ) from None


def sniff_format(path) -> str:
    """Identify a file's format from its magic bytes."""
    with open(path, "rb") as fh:
        head = fh.read(16)
    for name, pred in _SNIFFERS:
        if pred(head):
            return name
    raise ValueError(
        f"cannot determine IO format of {path!r} from its magic bytes; "
        f"known formats: {sorted(_FORMATS)}"
    )


def write_patch(patch, path, format="dasdae", **kwargs):
    _, write, _ = _resolve(format)
    return write(patch, path, **kwargs)


def read_file(path, format=None, **kwargs):
    """Read a file -> [Patch]. ``format=None`` sniffs the magic bytes."""
    read, _, _ = _resolve(format if format is not None else sniff_format(path))
    return read(path, **kwargs)


def scan_file(path, format=None):
    """Index-record scan. ``format=None`` sniffs the magic bytes."""
    _, _, scan = _resolve(format if format is not None else sniff_format(path))
    return scan(path)
